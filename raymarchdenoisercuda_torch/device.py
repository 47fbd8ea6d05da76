"""The device the port's entry points create their tensors on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``.  ``None`` means the CUDA card: the
    entry points run there unless the caller asks for the CPU
    (``device="cpu"``), and raise where there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
