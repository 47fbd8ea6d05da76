"""End-to-end pipeline: raymarch -> SVGF, and the training step.

Counterpart of ``raymarchdenoisercuda_tpu/models/pipeline.py``:
``render_and_denoise`` and the frame modules serve BASELINE config 3 (an
animated raymarched scene, temporally accumulated and denoised);
``make_train_step`` is config 4 (a pixel loss through SVGF and the
raymarcher's shading, optimising the material albedo table with Adam).
Each takes ``rm_params`` to the renderer as it is: with
``RaymarchParams(coarse_seed=True)`` (off by default) the kernel path
marches from the cone seed (K15, then the seeded K7); the plain path
ignores the flag.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import CameraParams, RaymarchParams, SVGFParams
from ..gbuffer import GBuffer, History
from ..ops.raymarch import Camera, Materials, Scene, render_gbuffer
from ..utils.timing import span, spanned
from .svgf import SVGFDenoiser, svgf_denoise_frame


def render_and_denoise(
    scene: Scene,
    camera: Camera,
    prev_camera: Optional[Camera],
    history: History,
    generator: Optional[torch.Generator] = None,
    *,
    cam_cfg: CameraParams = CameraParams(),
    rm_params: RaymarchParams = RaymarchParams(),
    svgf_params: SVGFParams = SVGFParams(),
    weight_math: str = "exact",
    light_sample: Optional[torch.Tensor] = None,
    impl: str = "auto",
    temporal: str = "auto",
    motion_grad: bool = True,
    precision: str = "f32",
) -> Tuple[GBuffer, History]:
    """One frame: render the G-buffer, then denoise it.

    The defaults are the reference's (exact weights, radius 2); the adopted
    serving mode is ``weight_math="fast"`` with ``SVGFParams(radius=1)``.
    ``light_sample`` and ``impl`` are as in ``render_gbuffer``;
    ``temporal``, ``motion_grad`` and ``precision`` as in
    ``svgf_denoise_frame`` (``temporal="ad"`` is the differentiable path;
    ``precision="bf16"`` the sweep's bfloat16 kernels, exact weights)."""
    gbuf = render_gbuffer(scene, camera, prev_camera, generator,
                          cam_cfg=cam_cfg, params=rm_params,
                          light_sample=light_sample, impl=impl)
    return svgf_denoise_frame(gbuf, history, params=svgf_params,
                              weight_math=weight_math, impl=impl,
                              temporal=temporal, motion_grad=motion_grad,
                              precision=precision)


class TrainState(NamedTuple):
    """State of material-table training (the JAX package's ``TrainState``;
    ``optimizer`` holds Adam's moments and step, where the JAX package keeps
    optax's ``opt_state``, and ``generator`` replaces the PRNG key)."""

    albedo: torch.Tensor                  # (M, 3) leaf being optimised
    optimizer: torch.optim.Adam
    history: History
    generator: Optional[torch.Generator]


def init_train_state(albedo_init: torch.Tensor, height: int, width: int,
                     generator: Optional[torch.Generator] = None, *,
                     lr: float = 1e-2) -> TrainState:
    """Fresh state: a copy of ``albedo_init`` as the optimised leaf, Adam at
    ``lr`` with optax's defaults (``betas=(0.9, 0.999)``, ``eps=1e-8``, the
    same update as ``optax.adam``), and an empty history."""
    albedo = albedo_init.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([albedo], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(albedo, opt, History.zeros(
        height, width, device=albedo.device), generator)


def make_train_step(
    base_scene: Scene,
    camera: Camera,
    target: torch.Tensor,               # (3, H, W) reference render
    *,
    cam_cfg: CameraParams = CameraParams(),
    rm_params: RaymarchParams = RaymarchParams(),
    svgf_params: SVGFParams = SVGFParams(),
    impl: str = "auto",
) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """The training step of BASELINE config 4: render the scene with the
    state's albedo table, denoise with the differentiable temporal step
    (``temporal="ad"``, no motion gradient: motion depends on geometry, not
    on materials) and the stored-weight sweep, take ``mean((denoised −
    target)²)``, step Adam, and clip the albedo to [0, 1].

    ``train_step(state, light_sample=None) -> (state, loss)``: the albedo
    leaf and the optimizer's moments are updated in place (the leaf's
    ``.grad`` keeps this step's gradient until the next step); the returned
    history is detached, so the graph does not grow across steps.
    ``light_sample`` (3, H, W) replaces the draw from the state's
    generator (the tests pass the JAX package's sample).

    Its spans (``utils.timing.span``): the unit ``rdt.step``, and inside it
    ``rdt.forward`` (render, denoise, loss), ``rdt.backward`` and
    ``rdt.optim`` (Adam's step and the clip)."""

    def train_step(state: TrainState,
                   light_sample: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        with span("rdt.step", unit=True):
            state.optimizer.zero_grad(set_to_none=True)
            with span("rdt.forward"):
                scene = dataclasses.replace(
                    base_scene, materials=dataclasses.replace(
                        base_scene.materials, albedo=state.albedo))
                out, new_hist = render_and_denoise(
                    scene, camera, None, state.history, state.generator,
                    cam_cfg=cam_cfg, rm_params=rm_params,
                    svgf_params=svgf_params, light_sample=light_sample,
                    impl=impl, temporal="ad", motion_grad=False)
                loss = torch.mean((out.denoised - target) ** 2)
            with span("rdt.backward"):
                loss.backward()
            with span("rdt.optim"):
                state.optimizer.step()
                with torch.no_grad():
                    state.albedo.clamp_(0.0, 1.0)
            new_hist = History(**{f.name: getattr(new_hist, f.name).detach()
                                  for f in dataclasses.fields(History)})
        return state._replace(history=new_hist), loss.detach()

    return train_step


_SCENE_FIELDS = tuple(f.name for f in dataclasses.fields(Scene)
                      if f.name != "materials")


class Renderer(nn.Module):
    """The raymarcher as a module: the scene and material tensors are
    buffers (so ``.to(device)`` moves them); the configs are static."""

    def __init__(self, scene: Scene, cam_cfg: CameraParams = CameraParams(),
                 params: RaymarchParams = RaymarchParams(),
                 impl: str = "auto"):
        super().__init__()
        for name in _SCENE_FIELDS:
            self.register_buffer(name, getattr(scene, name))
        self.register_buffer("albedo", scene.materials.albedo)
        self.register_buffer("emission", scene.materials.emission)
        self.cam_cfg = cam_cfg
        self.params = params
        self.impl = impl

    @property
    def scene(self) -> Scene:
        return Scene(materials=Materials(self.albedo, self.emission),
                     **{n: getattr(self, n) for n in _SCENE_FIELDS})

    def forward(self, camera: Camera, prev_camera: Optional[Camera] = None,
                generator: Optional[torch.Generator] = None,
                light_sample: Optional[torch.Tensor] = None) -> GBuffer:
        return render_gbuffer(self.scene, camera, prev_camera, generator,
                              cam_cfg=self.cam_cfg, params=self.params,
                              light_sample=light_sample, impl=self.impl)


class FramePipeline(nn.Module):
    """Renderer + SVGF denoiser: one call renders and denoises a frame,
    the serving unit: the span ``rdt.frame`` (``utils.timing.span``)."""

    def __init__(self, scene: Scene, cam_cfg: CameraParams = CameraParams(),
                 rm_params: RaymarchParams = RaymarchParams(),
                 svgf_params: SVGFParams = SVGFParams(),
                 weight_math: str = "exact", impl: str = "auto",
                 precision: str = "f32"):
        super().__init__()
        self.renderer = Renderer(scene, cam_cfg, rm_params, impl=impl)
        self.denoiser = SVGFDenoiser(svgf_params, weight_math, impl=impl,
                                     precision=precision)

    @spanned("rdt.frame", unit=True)
    def forward(self, camera: Camera, prev_camera: Optional[Camera],
                history: History,
                generator: Optional[torch.Generator] = None,
                light_sample: Optional[torch.Tensor] = None
                ) -> Tuple[GBuffer, History]:
        gbuf = self.renderer(camera, prev_camera, generator, light_sample)
        return self.denoiser(gbuf, history)
