"""Timing and device-information helpers."""
