"""Denoiser and end-to-end pipeline modules."""
