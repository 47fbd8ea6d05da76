"""End-to-end frame pipeline: raymarch -> SVGF (inference).

Counterpart of ``render_and_denoise`` in
``raymarchdenoisercuda_tpu/models/pipeline.py`` (BASELINE config 3: an
animated raymarched scene, temporally accumulated and denoised).  The
training step comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import CameraParams, RaymarchParams, SVGFParams
from ..gbuffer import GBuffer, History
from ..ops.raymarch import Camera, Materials, Scene, render_gbuffer
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
) -> Tuple[GBuffer, History]:
    """One frame: render the G-buffer, then denoise it.

    The defaults are the reference's (exact weights, radius 2); the adopted
    serving mode is ``weight_math="fast"`` with ``SVGFParams(radius=1)``.
    ``light_sample`` and ``impl`` are as in ``render_gbuffer``."""
    gbuf = render_gbuffer(scene, camera, prev_camera, generator,
                          cam_cfg=cam_cfg, params=rm_params,
                          light_sample=light_sample, impl=impl)
    return svgf_denoise_frame(gbuf, history, params=svgf_params,
                              weight_math=weight_math, impl=impl)


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
    """Renderer + SVGF denoiser: one call renders and denoises a frame."""

    def __init__(self, scene: Scene, cam_cfg: CameraParams = CameraParams(),
                 rm_params: RaymarchParams = RaymarchParams(),
                 svgf_params: SVGFParams = SVGFParams(),
                 weight_math: str = "exact", impl: str = "auto"):
        super().__init__()
        self.renderer = Renderer(scene, cam_cfg, rm_params, impl=impl)
        self.denoiser = SVGFDenoiser(svgf_params, weight_math, impl=impl)

    def forward(self, camera: Camera, prev_camera: Optional[Camera],
                history: History,
                generator: Optional[torch.Generator] = None,
                light_sample: Optional[torch.Tensor] = None
                ) -> Tuple[GBuffer, History]:
        gbuf = self.renderer(camera, prev_camera, generator, light_sample)
        return self.denoiser(gbuf, history)
