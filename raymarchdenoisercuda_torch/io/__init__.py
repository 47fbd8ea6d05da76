"""Image and dataset I/O, and sequence generation (``io/generate.py``)."""

from .image import (
    ImageIOError,
    load_png,
    save_png,
    load_plane,
    save_plane,
    to_planar_float,
    from_planar_float,
)
from .dataset import load_frame, save_frame, list_frames, iter_sequence, frame_dir
