"""Sequence generation (camera paths)."""
