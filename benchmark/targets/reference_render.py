"""The image that a material fitter aims at: the scene under its own albedo
table, rendered and denoised by the plain reference from an empty history,
with a light draw of its own from the seed (stream 3 of
``traffic.seeds``), from the training camera.  The fit starts from a
perturbed table and moves it back towards the scene's."""

from __future__ import annotations

import torch

from .. import traffic as traffic_gen
from ..reference import denoise, render


def make(program):
    from ..drivers import reference_camera, reference_scene
    dev = program.device
    gen = traffic_gen.light_generator(program.seed, torch, dev, stream=3)
    with torch.no_grad():
        g = render.render(reference_scene(program.arrays, dev),
                          reference_camera(program.traffic, 0, dev), None,
                          gen, program.ref_cfg(), program.config["raymarch"])
        hist = denoise.zero_history(program.H, program.W,
                                    dtype=torch.float32, device=dev)
        image, _ = denoise.denoise(g, hist, program.config["svgf"])
    return image.contiguous()
