"""SVGF denoiser: demodulate -> temporal step -> à-trous sweep -> remodulate.

Counterpart of ``raymarchdenoisercuda_tpu/models/svgf.py``.  With
``impl="auto"`` the temporal step and the sweep go through their kernel
wrappers, which launch the kernels for CUDA tensors and run the plain twins
for CPU tensors:

* ``temporal="auto"``/``"fused"``: the fused inference step (K3), then the
  inference sweep (K1 without weight writes) — no gradient, as the JAX
  package's ``spatial_bwd="auto"`` resolves it;
* ``temporal="ad"``: the differentiable step (where only the render takes a
  gradient K3 with its adjoint K16, elsewhere K4, adjoint K5/K6, and the
  plain epilogue) and the stored-weight sweep (K1 in store mode, adjoint
  K2) — the training path.

``spatial_bwd`` picks the sweep's adjoint as the JAX package's does
(``svgf_spatial_ad_cuda``'s ``bwd_impl``): ``"auto"`` is ``"none"`` after
the fused inference step and ``"stored"`` after ``temporal="ad"``;
``"stored_f32"`` stores float32 weights (K2b), ``"recompute"`` re-derives
them (K1b, K14).  The kernel path's sweep is detached, as the JAX
package's is: the full adjoint through the weights is
``svgf_spatial_ad_cuda(weight_grads=True)``.

``precision="bf16"`` runs the kernel path's sweep level by level through
the bfloat16 forms of K1b and K14 (``svgf_spatial_ad_cuda(precision=
"bf16")``, the JAX package's ``svgf_spatial_pallas(precision="bf16")``),
whatever ``spatial_bwd`` says, as JAX's per-level path does.

``impl="plain"`` runs the plain PyTorch versions on any device, with
autograd gradients (the JAX package's ``impl="reference"``; the on-card
oracle of the kernel path); ``detach_weights`` applies to it, and
``spatial_bwd`` and ``precision`` do not: it is the float32 sweep whatever
``precision`` says, as JAX's ``impl="reference"`` ignores it.  It is also
the path that runs ``SVGFParams.pyramid_from`` (the kernel path refuses
it, as JAX's ``impl="pallas"`` does).

Albedo demodulation: SVGF filters irradiance ``render / max(albedo, eps)``
and multiplies the albedo back afterwards, so texture is not blurred.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import SVGFParams
from ..gbuffer import GBuffer, History
from ..ops.atrous import PRECISIONS, svgf_spatial_ref
from ..ops.atrous_cuda import BWD_IMPLS, svgf_spatial_ad_cuda
from ..ops.temporal import temporal_accumulate, temporal_accumulate_ad
from ..ops.temporal_cuda import (fused_step_route,
                                 temporal_accumulate_ad_cuda,
                                 temporal_accumulate_cuda)
from ..utils.timing import (count, count_device, span, span_backward,
                            spanned, tracing)

_ALBEDO_EPS = 1e-3
# Surfaces darker than this are emissive/unlit and pass through
# un-demodulated: dividing by a near-zero albedo turns the light's pixels
# into huge irradiance outliers that bleed into their neighbours.
_EMISSIVE_THRESH = 0.02

IMPLS = ("auto", "plain")
TEMPORALS = ("auto", "fused", "ad")
SPATIAL_BWDS = ("auto",) + BWD_IMPLS


def demodulate(color: torch.Tensor, albedo: torch.Tensor) -> torch.Tensor:
    lit = torch.amax(albedo, dim=0, keepdim=True) > _EMISSIVE_THRESH
    return torch.where(lit, color / torch.clamp(albedo, min=_ALBEDO_EPS), color)


def remodulate(irradiance: torch.Tensor, albedo: torch.Tensor) -> torch.Tensor:
    lit = torch.amax(albedo, dim=0, keepdim=True) > _EMISSIVE_THRESH
    return torch.where(lit, irradiance * torch.clamp(albedo, min=_ALBEDO_EPS),
                       irradiance)


@spanned("rdt.denoise")
def svgf_denoise_frame(
    gbuf: GBuffer,
    history: History,
    *,
    params: SVGFParams = SVGFParams(),
    detach_weights: bool = True,
    weight_math: str = "exact",
    demodulate_albedo: bool = True,
    impl: str = "auto",
    temporal: str = "auto",
    motion_grad: bool = True,
    spatial_bwd: str = "auto",
    precision: str = "f32",
) -> Tuple[GBuffer, History]:
    """Denoise one frame; returns (gbuffer with ``denoised``, new history).

    The new history's colour is the output of level ``params.feedback_level``
    of the sweep; its previous depth/normal are this frame's.  ``temporal``
    and ``impl`` are as in the module docstring; ``motion_grad=False`` drops
    the motion gradient of the differentiable step (exact when the loss does
    not depend on motion through it, as in material-only training);
    ``spatial_bwd`` and ``precision`` (``"f32"`` or ``"bf16"``; ignored by
    ``impl="plain"``) as in the module docstring.

    Its spans (``utils.timing.span``): ``rdt.denoise`` (its self time the
    (de)modulation and the history's bookkeeping), ``rdt.temporal`` and
    ``rdt.atrous``, and in the backward ``rdt.temporal.bwd`` (the temporal
    step's adjoint); while they record, the counters ``reprojected_px``
    (the pixels whose history was taken, on the device) and ``pixels``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl: {impl!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision: {precision!r}")
    if temporal not in TEMPORALS:
        raise ValueError(f"unknown temporal: {temporal!r}")
    if spatial_bwd not in SPATIAL_BWDS:
        raise ValueError(f"unknown spatial_bwd: {spatial_bwd!r}")
    if impl == "auto" and not detach_weights:
        raise ValueError("detach_weights=False needs impl='plain': the "
                         "kernel path of svgf_denoise_frame is detached, as "
                         "the JAX package's is; the full adjoint through "
                         "the weights is svgf_spatial_ad_cuda("
                         "weight_grads=True)")
    ad = temporal == "ad"
    work = (gbuf.replace(render=demodulate(gbuf.render, gbuf.albedo))
            if demodulate_albedo else gbuf)
    # K3 and its adjoint K16 (one Function with a span of its own), where
    # only the render takes a gradient
    fused_ad = ad and impl == "auto" and fused_step_route(
        work, history, params, motion_grad)
    with span("rdt.temporal"):
        if ad:
            step = (temporal_accumulate_ad_cuda if impl == "auto"
                    else temporal_accumulate_ad)
            integrated, variance, new_history = step(
                work, history, params=params, motion_grad=motion_grad)
        else:
            step = (temporal_accumulate_cuda if impl == "auto"
                    else temporal_accumulate)
            integrated, variance, new_history = step(work, history,
                                                     params=params)
    if tracing():
        count_device("reprojected_px", (new_history.length > 1).sum())
        count("pixels", new_history.length.numel())
        if not fused_ad:
            # the epilogue's adjoint is autograd's (the gather's, K5/K6,
            # has its own span where the history takes a gradient)
            span_backward("rdt.temporal.bwd", (integrated, variance),
                          (work.render,))
    spatial_kw = dict(params=params, weight_math=weight_math,
                      return_feedback=True)
    with span("rdt.atrous"):
        if impl == "auto":
            if spatial_bwd == "auto":
                # the fused inference step makes the frame gradient-free
                spatial_bwd = "stored" if ad else "none"
            filtered, _, feedback = svgf_spatial_ad_cuda(
                integrated, variance, gbuf.normal, gbuf.depth,
                bwd_impl=spatial_bwd, precision=precision, **spatial_kw)
        else:
            filtered, _, feedback = svgf_spatial_ref(
                integrated, variance, gbuf.normal, gbuf.depth,
                detach_weights=detach_weights, **spatial_kw)
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
                 impl: str = "auto", precision: str = "f32"):
        super().__init__()
        self.params = params
        self.weight_math = weight_math
        self.demodulate_albedo = demodulate_albedo
        self.impl = impl
        self.precision = precision

    def forward(self, gbuf: GBuffer,
                history: History) -> Tuple[GBuffer, History]:
        return svgf_denoise_frame(gbuf, history, params=self.params,
                                  weight_math=self.weight_math,
                                  demodulate_albedo=self.demodulate_albedo,
                                  impl=self.impl, precision=self.precision)
