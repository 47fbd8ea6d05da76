"""SVGF denoiser: demodulate -> temporal step -> à-trous sweep -> remodulate.

Counterpart of ``raymarchdenoisercuda_tpu/models/svgf.py`` (inference: the
temporal step is the fused one and the spatial sweep keeps no adjoint
state).  With ``impl="auto"`` the temporal step and the sweep go through
their kernel wrappers, which launch K3 and K1 for CUDA tensors and run the
plain versions for CPU tensors; ``impl="plain"`` runs the plain versions on
any device (the on-card oracle of the kernel path).

Albedo demodulation: SVGF filters irradiance ``render / max(albedo, eps)``
and multiplies the albedo back afterwards, so texture is not blurred.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import SVGFParams
from ..gbuffer import GBuffer, History
from ..ops.atrous import svgf_spatial_ref
from ..ops.atrous_cuda import svgf_spatial_cuda
from ..ops.temporal import temporal_accumulate
from ..ops.temporal_cuda import temporal_accumulate_cuda

_ALBEDO_EPS = 1e-3
# Surfaces darker than this are emissive/unlit and pass through
# un-demodulated: dividing by a near-zero albedo turns the light's pixels
# into huge irradiance outliers that bleed into their neighbours.
_EMISSIVE_THRESH = 0.02

IMPLS = ("auto", "plain")


def demodulate(color: torch.Tensor, albedo: torch.Tensor) -> torch.Tensor:
    lit = torch.amax(albedo, dim=0, keepdim=True) > _EMISSIVE_THRESH
    return torch.where(lit, color / torch.clamp(albedo, min=_ALBEDO_EPS), color)


def remodulate(irradiance: torch.Tensor, albedo: torch.Tensor) -> torch.Tensor:
    lit = torch.amax(albedo, dim=0, keepdim=True) > _EMISSIVE_THRESH
    return torch.where(lit, irradiance * torch.clamp(albedo, min=_ALBEDO_EPS),
                       irradiance)


def svgf_denoise_frame(
    gbuf: GBuffer,
    history: History,
    *,
    params: SVGFParams = SVGFParams(),
    weight_math: str = "exact",
    demodulate_albedo: bool = True,
    impl: str = "auto",
) -> Tuple[GBuffer, History]:
    """Denoise one frame; returns (gbuffer with ``denoised``, new history).

    The new history's colour is the output of level ``params.feedback_level``
    of the sweep; its previous depth/normal are this frame's."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl: {impl!r}")
    temporal, spatial = ((temporal_accumulate_cuda, svgf_spatial_cuda)
                         if impl == "auto"
                         else (temporal_accumulate, svgf_spatial_ref))
    work = (gbuf.replace(render=demodulate(gbuf.render, gbuf.albedo))
            if demodulate_albedo else gbuf)
    integrated, variance, new_history = temporal(work, history, params=params)
    filtered, _, feedback = spatial(integrated, variance, gbuf.normal,
                                    gbuf.depth, params=params,
                                    weight_math=weight_math,
                                    return_feedback=True)
    new_history = new_history.replace(color=feedback)
    denoised = (remodulate(filtered, gbuf.albedo) if demodulate_albedo
                else filtered)
    return gbuf.replace(denoised=denoised), new_history


def svgf_denoise_sequence(frames, *, params: SVGFParams = SVGFParams(),
                          history: Optional[History] = None, **kw):
    """Denoise an iterable of GBuffers, threading the history through;
    yields the denoised GBuffers."""
    for gbuf in frames:
        if history is None:
            history = History.zeros(*gbuf.shape, device=gbuf.device)
        out, history = svgf_denoise_frame(gbuf, history, params=params, **kw)
        yield out


class SVGFDenoiser(nn.Module):
    """The denoiser as a module: holds its static configuration."""

    def __init__(self, params: SVGFParams = SVGFParams(),
                 weight_math: str = "exact", demodulate_albedo: bool = True,
                 impl: str = "auto"):
        super().__init__()
        self.params = params
        self.weight_math = weight_math
        self.demodulate_albedo = demodulate_albedo
        self.impl = impl

    def forward(self, gbuf: GBuffer,
                history: History) -> Tuple[GBuffer, History]:
        return svgf_denoise_frame(gbuf, history, params=self.params,
                                  weight_math=self.weight_math,
                                  demodulate_albedo=self.demodulate_albedo,
                                  impl=self.impl)
