#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (each prints lines starting with its number; any failure raises and
the script exits non-zero without printing a result):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``raymarchdenoisercuda_torch/ops/cuda/*.cu``
   (one nvcc per source, in parallel) and print ptxas's registers, stack
   and spills of the à-trous level forward's instantiations (K1/K1b, each
   radius), of K9's, K14's, K2/K2b's, K7's, K8's, K13's, K3/K3b's (and
   K3's unbounded step's), K16's, K15's
   (both routes, and the camera route's first launch), K10's and K11's
   2-D bodies (r 0-4), K12's staged form (r <= 4), KG's,
   KGb's (and its rounding pass), KGp's, K4/K4c's and K5/K6's (K5c/K6c;
   6 and 10 gradient planes, and past max_motion 59 the bucketed
   scatter's code-and-count, scan, placement, sort and gather kernels and
   K5's motion term), K10's and K11's 1-D passes and K12's
   rolling-row tile past r 4 (its ring and its chunked form), and of K1b's
   and K14's bf16
   forms (each radius, staged or not, spacing 1 apart, K1b's with the
   σ-denominator fused too), and print the bf16 forms' SASS instruction
   mix a tap (``utils/profile.py sass``; a reading, it fails nothing);
   fail if K2/K2b or K14 in any form (staged or through the caches,
   compiled radius or any), K1/K1b or a bf16 form of K1b or K14 at a
   compiled radius, or if K2/K2b or K14 lacks a form, K9 at r <= 1, K7, K8,
   K13 or K15 on a compiled scene, K3/K3b (or its unbounded step), K16,
   K15's first camera launch,
   K10
   or K11 at r <= 4 or in a 1-D pass, a K12 form, a KG, KGb or KGp kernel
   or a K4-K6 kernel (the scatter's included) uses local memory (K9 at r2
   and wider spills: printed, not failed; the wide bf16 forms fail above
   ``BF16_WIDE_LOCAL_B`` of stack and spills);
3. hold each kernel against its plain PyTorch version on the card at the
   1080p shapes of the main paths, values and gradients, and time both
   with CUDA events: K1 à-trous level (inference and store mode), K2
   stored-weight adjoint, K1b level with a given σ-denominator, K2b
   stored adjoint from float32 weights, K14 recompute adjoint, K9 adjoint
   through the weights, K3 temporal step (and its unbounded step on
   motion to ±28 pixels and a served frame's with ``max_motion=None``,
   bit-equal to the route it replaced: KGp, KG and the plain epilogue,
   timed beside it), K16 its adjoint for the render
   (the training step's; bit-equal to its twin), K4 reprojection gather, K5/K6
   its adjoints (on random, integer, zero and a served frame's motion,
   their history gradient the same on a second launch, timed on the random
   and the served input, with ``grid_sample``'s forward and backward timed
   beside them as the library yardstick), K1 in the serving mode at each level
   0-4, K7 march (the Cornell box, ``random_scene`` and a scene of other
   counts) and K8 shadow + shading (the Cornell box and ``random_scene``),
   each naming its instantiation (compiled scene or runtime counts), K10
   box filter at r2 d1, r1 d3 and r2 d3 (a deeper call bit-equal to its
   levels launched one at a time; ``avg_pool2d`` beside r2 d1), K11
   gaussian at depth 1 and 2 (bit-equal to its twin; a depthwise
   ``conv2d`` beside it), each timed by CUDA events and by device time
   under the profiler beside its bound, K12 cross-bilateral filter (r2; r1 and r4, the
   staged form's widest, beside it), K13 shadow
   visibility (Cornell box and ``random_scene``, each naming its
   instantiation), K1 at radius 0 and 3
   beside 1 and 2, K15 cone seed (from ray planes, from the camera, on a
   quarter tile of 3840x2160) and the seeded K7 on both scenes (its
   instantiation named), with the seeded march held to the unseeded one
   and K7 seeded and unseeded, K15 and the seed passes timed against
   their SDF-evaluation bounds, and the clamped gather of unbounded motion
   (KG) and its adjoint (KGb) on the channel-minor stack that KGp builds
   (bit-equal to its plain twin) and on a planar one (laid out by KGp in
   the wrappers), timed on phase 3's and a served frame's input, KGb
   split into its kernels by the profiler; the wide forms beside their
   bounds: K5/K6 past max_motion 59 (the bucketed scatter) at 60 and 96
   on random motion to ±7 and ±(M + 1) px, at 1000 on ±7 px and on a sink
   at 128 (its four texels bit for bit to the float32 sums in the
   kernels' order), repeatable, with ``grid_sample``'s backward on the
   same motion beside them, K5c/K6c on a quarter tile's canvas, the
   scatter route at max_motion 6 bit-equal to the staged gather and both
   timed, K10, K11 and K12 at radius 17 and 24 and K10 and K11 at radius
   90 and at 17 with depth 2 (K10 and K11 as two 1-D passes a level, the
   gaussian taps in a device array; K12's rolling-row tile), each against
   its twin, with device time, ``avg_pool2d`` beside K10 and the
   depthwise ``conv2d`` numerator beside K11, and K10 and K11 on both
   routes (the 2-D body and the 1-D passes) at the radii around their
   crossovers, device time in turns; K1b's and K14's bf16 forms
   (``precision="bf16"``; K1b's with the σ-denominator given, and fused,
   written and not, bit-equal to ``sigma_denominator``'s) at level 1, r1
   and r2, against their twins, timed by CUDA events and by device time
   beside the float32 forms (K1 beside the fused one); K2, K2b and K14
   past radius 2 (r3, r4, r5 at levels 1 and 4, whole frame and a quarter
   tile) against their twins, the form the wrapper picks (staged, or the
   centres through the caches past the staging budget) bit-equal to the
   other, both timed by CUDA events beside the twin and the bound;
4. the serving path: 16 frames of the animated Cornell sequence at
   1920x1080 (``orbit_camera``) through ``FramePipeline`` (render ->
   temporal -> 5-level à-trous, radius 1, fast weights); the first 3
   frames match the plain path;
5. the training step (BASELINE config 4): ``make_train_step`` at
   1920x1080 on the Cornell scene, radius 1, 5 levels, exact weights,
   Adam at lr 1e-2 against a seeded target (its temporal step K3 and
   K16: only the render takes a gradient); 1 warm-up and 8 timed steps
   (ms/step, peak memory); the first 2 steps match the plain path;
6. the temporal gradient path: ``svgf_denoise_frame(temporal="ad")`` at
   1080p differentiated with respect to motion and history (K4 and the
   plain epilogue), with the motion gradient (K5) and without it (K6);
   gradients match the plain path;
7. the reference's own surface: the CLI's ``-t`` case runner
   (``raymarchdenoisercuda_torch.cli``) on the 1920x1080 filter, spatial,
   temporal, raymarch and device cases, on the card;
8. the dataset: ``generate_sequence`` writes 2 frames at 1920x1080 and
   16 light samples a pixel (K7, then K13 once a sample), read back with
   ``load_float_frame`` (exactly) and ``load_frame`` (to the PNGs'
   quantisation); frame 0 matches the plain path's render from the same
   seed; ``apply_filter`` runs all four filter types on the loaded frame,
   kernel path against plain path;
9. the spatial adjoints: ``svgf_spatial_ad_cuda``, the 5-level sweep
   forward and backward at 1920x1080 with exact weights, at radius 0 to
   3 (config 4's is 1; at 3 the adjoints' staged forms past radius 2, K2w,
   K2bw, K14w, must launch), in each adjoint mode (``stored``, ``stored_f32``,
   ``recompute``, ``recompute`` with ``chained=False``,
   ``weight_grads=True``), timed per forward+backward with peak memory;
   gradients against the plain path (the whole sweep, except the radius-2
   ``weight_grads`` one, which is held level by level); and the
   ``precision="bf16"`` sweep (K1b-bf16 with σ fused and written,
   K14-bf16) at r1 and r2, timed (events and device time) with peak
   memory, gradients against the plain bf16 path (the twins
   level by level), its colour gradient at cosine >= 0.99 against the
   float32 recompute sweep's (``tools/quality_eval.py``'s criterion);
10. the sharded path (``parallel/``) on this card's (1, 1, 1) mesh at
   3840x2160: (a) the kernels' tile forms (K1, K1b, K2, K14 with a tile
   origin, the frame's bounds and margin-writing adjoints; K3b, K4c,
   K5c/K6c on history canvases) on a 4K frame cut into 2x2 tiles and into
   8-row tiles, which the level-4 reach exceeds, each tile's canvas sliced
   from the frame (zeros past its border), held against the plain twins
   and the whole-frame kernels and timed with CUDA events (``grid_sample``
   beside K4c-K6c; K4c-K6c also on the served frame's first quarter tile
   at this size), then the temporal gradient on the history canvas
   (K4c; K5c with the motion gradient, K6c without) against the unsharded
   one (K4, K5, K6), and K15 from the camera and the seeded K7 on whole
   3840x2160 frames against their plain twins (the shapes of 11(e), (f)); (b)
   ``make_sharded_pipeline`` for 8 orbit frames against the unsharded
   ``FramePipeline``; (c) ``make_sharded_train_step``, 1 warm-up and 5
   timed steps, against ``make_train_step``; (d) ``cli -t
   SHARDED_SPATIAL``; (e) the weak-scaling harness's one-rank row
   (``parallel.scaling``: the sweep forward and backward on a 3840x2160
   tile; one card, so t(1), not a scaling number), and the same step on
   one NCCL rank spawned by ``parallel.distributed.spawn_group``;
11. the seeded and unbounded paths: (a) phase 4's sequence with
   ``RaymarchParams(coarse_seed=True)`` (K15, the seeded K7) alternating
   with the unseeded one, ms/frame of both, frames held to the unseeded
   ones by the seeded bounds (hit flips, p99 of the depth and denoised
   differences); (b) the config-4 train step seeded against the unseeded
   one, its first frame held by the same bounds; (c)
   a serving sequence (K3's unbounded step) and (d) a ``temporal="ad"``
   gradient pass (KGp, KG, KGb) with ``SVGFParams(max_motion=None)``
   against the plain path; (e)
   the sharded pipeline at 3840x2160 and (f) the sharded train step
   (config 5), seeded, against the unsharded seeded ones;
12. the geometry gradient at 1920x1080 through the implicit-function
   adjoint: ``render_gbuffer``'s loss differentiated with respect to the
   spheres, boxes and planes through K7 and K8 against the plain path,
   the same with ``coarse_seed`` (K15, K7s), and the seeded march alone
   against the plain seeded march (atol 2e-3·max);
13. the denoiser-quality gate (``utils/denoise_quality.py``): Cornell and
   clutter orbits at 256², 16 frames, 1024-sample references (K7, K13),
   SVGF with fast weights at r1 and r2, 5 iterations; PSNR and SSIM of
   input and output printed; fails below ``tests/test_quality.py``'s
   thresholds;
14. ``precision="bf16"`` serving: 8 Cornell orbit frames at 1920x1080
   through ``FramePipeline(precision="bf16")`` (K3, then K1b-bf16 level by
   level with the σ-denominator fused: every level launches the fused
   form, and ``sigma_denominator`` never runs on the card; radius 1,
   exact weights) beside the float32 pipeline on the same
   frames, each bf16 frame's PSNR against the float32 frame >= 45 dB
   (``tools/quality_eval.py``'s criterion, peak the float32 frame's max),
   the two pipelines' walls in ``BF16_WALL_ROUNDS`` rounds of turns (bf16,
   f32, f32, bf16), their medians and quartiles;
   and the half-resolution deep levels (``pyramid_from=3``) on phase 13's
   Cornell orbit through the plain path (``score(impl="plain")``), printed
   beside the same plain sweep without them and phase 13's kernel path.

Phases 4 to 9, 10(a)'s temporal gradient, 10(b)-(e), 11, 12, 13 and 14
are the main paths: every kernel's launch count is set to 0 just before
each and read just after, and each fails if one of its kernels never launched.
The line before the last is a JSON object with one entry per kernel (an
entry that is a form of another entry's kernel, its launches counted on
both, names that kernel under ``"form_of"``); the last line is
``{"ok": true, "device": {...}}``.
No JAX is imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from raymarchdenoisercuda_torch import cli
from raymarchdenoisercuda_torch.config import (
    CameraParams, FilterParams, FilterType, RaymarchParams, SVGFParams)
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.io import load_frame
from raymarchdenoisercuda_torch.io.generate import (
    generate_sequence, load_float_frame, orbit_camera)
from raymarchdenoisercuda_torch.models.pipeline import (
    FramePipeline, init_train_state, make_train_step, render_and_denoise)
from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_frame
from raymarchdenoisercuda_torch.ops import (atrous, atrous_cuda, boxfilter,
                                            filters, filters_cuda, raymarch,
                                            temporal, temporal_cuda)
from raymarchdenoisercuda_torch.ops.atrous_cuda import (
    atrous_level, atrous_level_bwd_cuda, atrous_level_bwd_stored_cuda,
    atrous_level_bwd_stored_f32_cuda, atrous_level_cuda,
    atrous_level_fwd_cuda, atrous_level_wgrad_bwd_cuda, svgf_spatial_ad_cuda,
    svgf_spatial_cuda)
from raymarchdenoisercuda_torch.ops.common import (
    Tile, finite_diff_gradients, frame_canvas)
from raymarchdenoisercuda_torch.ops.cuda import _build
from raymarchdenoisercuda_torch.ops.filters_cuda import (
    BOX_PASS_RADIUS, GAUSS_PASS_RADIUS, box_filter_cuda, box_level_groups,
    cross_bilateral_cuda, gaussian_filter_cuda)
from raymarchdenoisercuda_torch.ops.raymarch_cuda import (
    cone_launch, cone_seed_cuda, march_gbuf_cuda, march_gbuf_seeded_cuda,
    scene_key, shadow_factor_cuda, shadow_shade_cuda)
from raymarchdenoisercuda_torch.ops.temporal_cuda import (
    clamped_gather_bwd_cuda, clamped_gather_cuda, gather_bwd_cuda,
    gather_bwd_hist_cuda, gather_canvas_bwd_cuda,
    gather_canvas_bwd_hist_cuda, gather_canvas_cuda, gather_cuda,
    history_stack_channel_minor_cuda, reproject_clamped_cuda,
    temporal_accumulate_ad_cuda, temporal_accumulate_canvas_cuda,
    temporal_accumulate_cuda, temporal_bwd_cuda)
from raymarchdenoisercuda_torch.parallel import scaling, sharded
from raymarchdenoisercuda_torch.parallel.distributed import spawn_group
from raymarchdenoisercuda_torch.parallel.mesh import make_mesh
from raymarchdenoisercuda_torch.utils import denoise_quality, tiling
from raymarchdenoisercuda_torch.utils.profile import clamped_split, sass_lines
from raymarchdenoisercuda_torch.utils.seeded_inputs import (
    clamped_inputs, gather_inputs, ordered_texel_sums, served_clamped_inputs,
    served_inputs, sink_motion, sink_texels)
from raymarchdenoisercuda_torch.utils.timing import (
    CudaTimer, cuda_time_ms, device_ms, nvidia_smi_name_power)

SEQ_FRAMES = 16
CHECK_FRAMES = 3
SERVING = SVGFParams(radius=1)       # the adopted mode: radius 1 ...
SERVING_WEIGHTS = "fast"             # ... with fast tap weights
TRAIN = SVGFParams(iterations=5, radius=1)   # config 4, exact weights
TRAIN_STEPS = 8                      # timed, after one warm-up step
CHECK_STEPS = 2
DATA_FRAMES = 2                      # phase 8: frames and light samples
DATA_SPP = 16
CLI_CASES = ("FILTER_BASELINE|FILTER_TILED|FILTER_CROSS|SVGF_SPATIAL|"
             "RAYMARCH|TEMPORAL|DEVICE_STATS")
M = SVGFParams().max_motion
# H100 SXM data sheet: HBM rate and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
WRAPPERS = {"K1": atrous_level_cuda, "K2": atrous_level_bwd_stored_cuda,
            "K1b": atrous_level_fwd_cuda,
            "K2b": atrous_level_bwd_stored_f32_cuda,
            "K14": atrous_level_bwd_cuda, "K9": atrous_level_wgrad_bwd_cuda,
            "K3": temporal_accumulate_cuda, "K4": gather_cuda,
            "K5": gather_bwd_cuda, "K6": gather_bwd_hist_cuda,
            "K7": march_gbuf_cuda, "K8": shadow_shade_cuda,
            "K10": box_filter_cuda, "K11": gaussian_filter_cuda,
            "K12": cross_bilateral_cuda, "K13": shadow_factor_cuda,
            "K3b": temporal_accumulate_canvas_cuda, "K4c": gather_canvas_cuda,
            "K5c": gather_canvas_bwd_cuda,
            "K6c": gather_canvas_bwd_hist_cuda,
            "K15": cone_seed_cuda, "K7s": march_gbuf_seeded_cuda,
            "KG": clamped_gather_cuda, "KGb": clamped_gather_bwd_cuda,
            "KGp": history_stack_channel_minor_cuda,
            "K16": temporal_bwd_cuda,
            # the bf16 forms count apart from their float32 wrappers; the
            # fused-σ launches of K1b-bf16 count on both of its counts (the
            # kernels line marks the fused form "form_of" K1b-bf16)
            "K1b-bf16": atrous_level_fwd_cuda.bf16,
            "K1b-bf16-fused": atrous_level_fwd_cuda.bf16_fused,
            "K14-bf16": atrous_level_bwd_cuda.bf16,
            # K14 and K2/K2b past radius 2, their staged forms: counted on
            # the wrappers' own counts too
            "K14w": atrous_level_bwd_cuda.wide,
            "K2w": atrous_level_bwd_stored_cuda.wide,
            "K2bw": atrous_level_bwd_stored_f32_cuda.wide,
            # K5/K6 (K5c/K6c) past max_motion 59 and K12 past r 4: their
            # redesigned forms count apart from the wrappers' own too
            "K5w": gather_bwd_cuda.scatter,
            "K6w": gather_bwd_hist_cuda.scatter,
            "K5cw": gather_canvas_bwd_cuda.scatter,
            "K6cw": gather_canvas_bwd_hist_cuda.scatter,
            "K12w": cross_bilateral_cuda.rolling,
            # K10 and K11 from r 5: the 1-D passes, counted on the
            # wrappers' own counts too
            "K10w": box_filter_cuda.passes,
            "K11w": gaussian_filter_cuda.passes}
PALLAS = "raymarchdenoisercuda_tpu/ops/pallas/"
CUDA_SRC = "raymarchdenoisercuda_torch/ops/cuda/"
KERNELS = {
    "K1": ("atrous_level", CUDA_SRC + "atrous_level.cuh",
           PALLAS + "atrous_tpu.py:172"),
    "K2": ("atrous_bwd_stored", CUDA_SRC + "atrous.cu",
           PALLAS + "atrous_tpu.py:361"),
    "K1b": ("atrous_level_sigma", CUDA_SRC + "atrous_level.cuh",
            PALLAS + "atrous_tpu.py:780"),
    "K2b": ("atrous_bwd_stored_f32", CUDA_SRC + "atrous.cu",
            PALLAS + "atrous_tpu.py:661"),
    "K14": ("atrous_bwd_recompute", CUDA_SRC + "atrous.cu",
            PALLAS + "atrous_tpu.py:865"),
    "K9": ("atrous_wgrad_bwd", CUDA_SRC + "atrous.cu",
           PALLAS + "atrous_tpu.py:1465"),
    "K3": ("temporal_step", CUDA_SRC + "temporal.cu",
           PALLAS + "temporal_tpu.py:57"),
    "K4": ("reproject_gather", CUDA_SRC + "temporal.cu",
           PALLAS + "temporal_tpu.py:446"),
    "K5": ("reproject_gather_bwd", CUDA_SRC + "temporal.cu",
           PALLAS + "temporal_tpu.py:606"),
    "K6": ("reproject_gather_bwd_hist", CUDA_SRC + "temporal.cu",
           PALLAS + "temporal_tpu.py:518"),
    "K7": ("march_gbuf", CUDA_SRC + "raymarch.cu",
           PALLAS + "raymarch_tpu.py:115"),
    "K8": ("shadow_shade", CUDA_SRC + "raymarch.cu",
           PALLAS + "raymarch_tpu.py:468"),
    "K10": ("box_filter", CUDA_SRC + "filters.cu", PALLAS + "box_tpu.py:53"),
    "K11": ("gaussian_filter", CUDA_SRC + "filters.cu",
            PALLAS + "filters_tpu.py:41"),
    "K12": ("cross_bilateral", CUDA_SRC + "filters.cu",
            PALLAS + "filters_tpu.py:135"),
    "K13": ("shadow_visibility", CUDA_SRC + "raymarch.cu",
            PALLAS + "raymarch_tpu.py:408"),
    "K3b": ("temporal_step_canvas", CUDA_SRC + "temporal.cu",
            PALLAS + "temporal_tpu.py:861"),
    "K4c": ("reproject_gather_canvas", CUDA_SRC + "temporal.cu",
            PALLAS + "temporal_tpu.py:946"),
    "K5c": ("reproject_gather_canvas_bwd", CUDA_SRC + "temporal.cu",
            PALLAS + "temporal_tpu.py:987"),
    "K6c": ("reproject_gather_canvas_bwd_hist", CUDA_SRC + "temporal.cu",
            PALLAS + "temporal_tpu.py:1010"),
    "K15": ("cone_seed", CUDA_SRC + "raymarch.cu",
            PALLAS + "raymarch_tpu.py:214"),
    "K7s": ("march_gbuf_seeded", CUDA_SRC + "raymarch.cu",
            PALLAS + "raymarch_tpu.py:115"),
    # no TPU kernel: with unbounded motion the JAX package runs jnp
    # (bilinear_gather_many and its autodiff)
    "KG": ("clamped_gather", CUDA_SRC + "temporal.cu",
           "raymarchdenoisercuda_tpu/ops/temporal.py:41"),
    "KGb": ("clamped_gather_bwd", CUDA_SRC + "temporal.cu",
            "raymarchdenoisercuda_tpu/ops/temporal.py:41"),
    # the channel-minor stack that bilinear_gather_many builds
    "KGp": ("clamped_gather_stack", CUDA_SRC + "temporal.cu",
            "raymarchdenoisercuda_tpu/ops/temporal.py:57"),
    # no TPU kernel: the JAX package differentiates its epilogue by
    # autodiff; K16 is the fused step's (K3's) adjoint for the render
    "K16": ("temporal_step_bwd", CUDA_SRC + "temporal.cu",
            "raymarchdenoisercuda_tpu/ops/temporal.py:184"),
    # precision="bf16" of atrous_level_fwd_pallas / atrous_level_bwd_pallas
    "K1b-bf16": ("atrous_level_sigma_bf16", CUDA_SRC + "atrous_level.cuh",
                 PALLAS + "atrous_tpu.py:780"),
    # ... with the σ-denominator fused (the bf16 sweep's route on the card)
    "K1b-bf16-fused": ("atrous_level_bf16_fused_sigma",
                       CUDA_SRC + "atrous_level.cuh",
                       PALLAS + "atrous_tpu.py:780"),
    "K14-bf16": ("atrous_bwd_recompute_bf16", CUDA_SRC + "atrous.cu",
                 PALLAS + "atrous_tpu.py:865"),
    # past max_motion 59: the bucketed scatter of K5/K6 (K5c/K6c)
    "K5w": ("reproject_gather_bwd_scatter", CUDA_SRC + "temporal.cu",
            PALLAS + "temporal_tpu.py:606"),
    "K6w": ("reproject_gather_bwd_hist_scatter", CUDA_SRC + "temporal.cu",
            PALLAS + "temporal_tpu.py:518"),
    "K5cw": ("reproject_gather_canvas_bwd_scatter", CUDA_SRC + "temporal.cu",
             PALLAS + "temporal_tpu.py:987"),
    "K6cw": ("reproject_gather_canvas_bwd_hist_scatter",
             CUDA_SRC + "temporal.cu", PALLAS + "temporal_tpu.py:1010"),
    # past r 4: K12's rolling-row tile
    "K12w": ("cross_bilateral_rolling", CUDA_SRC + "filters.cu",
             PALLAS + "filters_tpu.py:135"),
    # from r 5: K10's and K11's 1-D passes
    "K10w": ("box_filter_passes", CUDA_SRC + "filters.cu",
             PALLAS + "box_tpu.py:53"),
    "K11w": ("gaussian_filter_passes", CUDA_SRC + "filters.cu",
             PALLAS + "filters_tpu.py:41"),
    # past r 2: K14's staged one-output form, K2/K2b's staged kernel
    "K14w": ("atrous_bwd_recompute_wide", CUDA_SRC + "atrous.cu",
             PALLAS + "atrous_tpu.py:865"),
    "K2w": ("atrous_bwd_stored_wide", CUDA_SRC + "atrous.cu",
            PALLAS + "atrous_tpu.py:361"),
    "K2bw": ("atrous_bwd_stored_f32_wide", CUDA_SRC + "atrous.cu",
             PALLAS + "atrous_tpu.py:661"),
}
# a form of another entry's kernel whose launches that entry's count
# holds too: its line names the kernel ("form_of"), so a sum of the line's
# launches counts the entries without it
FORM_OF = {"K1b-bf16-fused": "K1b-bf16", "K5w": "K5", "K6w": "K6",
           "K5cw": "K5c", "K6cw": "K6c", "K12w": "K12", "K14w": "K14",
           "K2w": "K2", "K2bw": "K2b", "K10w": "K10", "K11w": "K11"}
# per-tap float operations of K1's weight math and accumulation, of K2's
# tap, of K14's (the recomputed weight and K2's sum), of K9's two passes
# together and of K12's tap (weights, three colour products, the sums),
# counted from the kernel sources (a transcendental counts as one)
K1_TAP_FLOPS = 40
K2_TAP_FLOPS = 14
K14_TAP_FLOPS = 48
K9_TAP_FLOPS = 169
K12_TAP_FLOPS = 37
# phase 9: the adjoint modes, and the fwd+bwd steps timed in each
ADJOINT_MODES = (("stored", dict(bwd_impl="stored")),
                 ("stored_f32", dict(bwd_impl="stored_f32")),
                 ("recompute", dict(bwd_impl="recompute")),
                 ("recompute chained=False", dict(bwd_impl="recompute",
                                                  chained=False)),
                 ("weight_grads", dict(weight_grads=True)))
ADJOINT_STEPS = 5
# phase 10: the sharded path at 3840x2160 on the (1, 1, 1) mesh
UHD_H, UHD_W = 2160, 3840
UHD_FRAMES = 8
UHD_STEPS = 5                        # timed, after one warm-up step
# phase 11: the seeded and unbounded-motion paths
SEEDED = RaymarchParams(coarse_seed=True)
UNBOUNDED = SVGFParams(radius=1, max_motion=None)
UNBOUNDED_FRAMES = 4
SEEDED_UHD_FRAMES = 4
SEEDED_UHD_STEPS = 2                 # timed, after one warm-up step
# phase 3's wide forms: K5/K6 past max_motion 59 (the bucketed scatter) on
# phase 3's random motion (±7 px), on motion to ±(M + 1) and on the sink,
# WIDE_REPORTED the case on the kernels line (K5w, K6w), K5c/K6c at the
# bounds of WIDE_CANVAS_MOTIONS on ±(M + 1); K10-K12 past
# radius 16 (K10 and K11 as 1-D passes, the taps in a device array; K12
# past r 4 the rolling-row tile)
WIDE_MOTIONS = ((60, "±7 px"), (60, "wide"), (96, "±7 px"), (96, "wide"),
                (1000, "±7 px"), (128, "sink"))
WIDE_REPORTED = (96, "wide")
WIDE_CANVAS_MOTIONS = (60, 96)
WIDE_RADII = (17, 24)
WIDEST_RADIUS = 90                   # K10 and K11 only
# the largest radius K10's and K11's 2-D bodies are compiled at, just
# below the crossover, where both routes (the 2-D body and the 1-D passes)
# run: timed in turns
CROSSOVER_RADIUS = min(BOX_PASS_RADIUS, GAUSS_PASS_RADIUS) - 1
# phase 3's adjoints past radius 2 (K2, K2b, K14): radii and levels held to
# their twins, whole frame and tile; the case on the kernels line
WIDE_ADJOINT_RADII = (3, 4, 5)
WIDE_ADJOINT_LEVELS = (1, 4)
WIDE_ADJOINT_REPORTED = (3, 1)
# phase 10: the weak-scaling harness's one-rank row (a tile of the frame)
SCALING_STEPS = 3
# phase 12: the geometry gradient; phase 13: the quality gate at the card
# size (tools/denoise_quality.py's defaults, fast weights) and its
# thresholds (tests/test_quality.py's)
GEOMETRY = ("sphere_params", "box_params", "plane_params")
GEOMETRY_TOL = 2e-3
GATE = dict(size=256, frames=16, spp_ref=1024, warmup=4)
GATE_CASES = (("r1", dict(radius=1, iterations=5)),
              ("r2", dict(radius=2, iterations=5)))
GATE_BARS = {"cornell": dict(gain=2.2, ssim=0.96, ssim_gain=0.05),
             "clutter": dict(gain=-0.3, ssim=0.945, ssim_gain=0.10)}
# phases 9 and 14: precision="bf16" against float32, the criteria of
# tools/quality_eval.py (frame PSNR and gradient cosine); phase 14's
# serving frames and the pyramid's first half-resolution level
BF16_PSNR_DB = 45.0
BF16_GRAD_COS = 0.99
BF16_FRAMES = 8
# the walls of phase 14 in rounds of turns bf16, f32, f32, bf16
BF16_WALL_ROUNDS = 5
# the wide-radius (R = -1) bf16 forms spill: stack plus spills up to 32 B
# at the time of writing (PERF.md, section 7); phase 2 fails above it
BF16_WIDE_LOCAL_B = 32
BF16_SERVING = SVGFParams(radius=1)          # exact weights: bf16 has no fast
PYRAMID_FROM = 3


# ptxas's names of the level forward's instantiations, level_kernel<R,
# MATH, SDEN, STORE, TILE> or level_kernel_2b (R = -1: the taps in device
# memory), and of the weight-gradient adjoint's, wgrad_kernel<R, STAGED>
# (ops/cuda/atrous*.cu*)
K1_MANGLED = re.compile(r"(?:12level_kernel|15level_kernel_2b)ILi(n?\d+)ELi"
                        r"(\d+)ELb([01])ELi(\d+)ELb([01])EE")
K9_MANGLED = re.compile(r"12wgrad_kernelILi(n?\d+)ELb([01])EE")
# the recompute adjoint's, atrous_bwd_kernel<R, STAGED, TILE>, the
# stored-weight adjoint's, atrous_bwd_stored_kernel<WT, R, TILE> (through
# the caches) and atrous_bwd_stored_staged_kernel<WT, R, TILE> (R = -1:
# any radius), and the march's and the shading pass's, march_kernel and
# shade_kernel<NS, NB, NP> (-1: counts known at run time)
K14_MANGLED = re.compile(r"17atrous_bwd_kernelILi(n?\d+)ELb([01])ELb([01])EE")
K2_MANGLED = re.compile(r"(24atrous_bwd_stored|31atrous_bwd_stored_staged)"
                        r"_kernelI(13__nv_bfloat16|f)Li(n?\d+)ELb([01])EE")
# the (radius, staged) forms of K14 and K2/K2b the build must hold, each
# whole frame and tile: K14 through the caches at 0-2 and any radius,
# staged at 1-4 and any radius; K2/K2b through the caches at 0 and any
# radius, staged at 1-3 and any radius
_K2_FORMS = {(0, False), (-1, False), (1, True), (2, True), (3, True),
             (-1, True)}
ADJOINT_FORMS = {"K14": {(0, False), (1, False), (2, False), (-1, False),
                         (1, True), (2, True), (3, True), (4, True),
                         (-1, True)},
                 "K2": _K2_FORMS, "K2b": _K2_FORMS}
K7_MANGLED = re.compile(r"12march_kernelILi(n?\d+)ELi(n?\d+)ELi(n?\d+)EE")
K8_MANGLED = re.compile(r"12shade_kernelILi(n?\d+)ELi(n?\d+)ELi(n?\d+)EE")
# the shadow pass's, shadow_kernel<NS, NB, NP>, and the temporal step's,
# temporal_kernel<TILE, PX, CLAMPED> (TILE: K3's tile form and K3b; PX
# pixels a thread; CLAMPED: the unbounded step)
K13_MANGLED = re.compile(r"13shadow_kernelILi(n?\d+)ELi(n?\d+)ELi(n?\d+)EE")
K3_MANGLED = re.compile(r"15temporal_kernelILb([01])ELi\d+ELb([01])EE")


def k3_form(m):
    """The form of K3 a K3_MANGLED match names."""
    return ("K3 tile/K3b" if m.group(1) == "1" else
            "K3 unbounded" if m.group(2) == "1" else "K3")


# the fused step's adjoint, temporal_bwd_kernel (K16)
K16_MANGLED = re.compile(r"19temporal_bwd_kernel")
# the cone seed's march, cone_kernel<NS, NB, NP, CAMERA> (CAMERA: its cones
# from the camera), and its first launch on that route, cone_delta_kernel;
# the cross-bilateral filter's staged form, cross_bilateral_staged_kernel<R,
# PX> (r <= 4)
K15_MANGLED = re.compile(r"11cone_kernelILi(n?\d+)ELi(n?\d+)ELi(n?\d+)ELb"
                         r"([01])EE")
K15_DELTA_MANGLED = re.compile(r"17cone_delta_kernel")
K12_MANGLED = re.compile(r"29cross_bilateral_staged_kernelILi(\d+)ELi(\d+)EE")
# the box filter's, box_filter_kernel<R> (K10), and the gaussian's,
# gaussian_filter_kernel<R> (K11), R 0-4
K10_MANGLED = re.compile(r"(17box_filter|22gaussian_filter)_kernelILi(\d+)EE")
# the clamped gather's (KG, the 10 planes channel-minor), its adjoint's
# (KGb) and the adjoint's rounding pass, and the channel-minor stack's
# (KGp)
KG_KERNELS = {re.compile(r"21clamped_gather_kernelE"): "KG",
              re.compile(r"25clamped_gather_bwd_kernelE"): "KGb",
              re.compile(r"19round_planes_kernel"): "KGb round",
              re.compile(r"26stack_channel_minor_kernel"): "KGp"}
# the bounded gather's, gather_kernel<TILE> (K4; K4c), and its adjoint's,
# gather_bwd_kernel<TILE, MG, NP> (K5 with the motion term MG, K6 without;
# K5c/K6c; NP: 6 or 10 gradient planes compiled)
K4_MANGLED = re.compile(r"13gather_kernelILb([01])EE")
K5_MANGLED = re.compile(r"17gather_bwd_kernelILb([01])ELb([01])ELi(\d+)EE")
# past max_motion 59, the bucketed scatter: its code-and-count,
# placement, scan (three passes) and sort kernels, its gather,
# scatter_gather_kernel<NP>, and K5's motion term, motion_term_kernel<TILE>
K5_SCATTER = {re.compile(r"20scatter_count_kernel"): "code and count",
              re.compile(r"18scan_blocks_kernel"): "scan blocks",
              re.compile(r"16scan_sums_kernel"): "scan sums",
              re.compile(r"15scan_add_kernel"): "scan add",
              re.compile(r"20scatter_place_kernel"): "placement",
              re.compile(r"19scatter_sort_kernel"): "sort"}
K5_SCATTER_GATHER = re.compile(r"21scatter_gather_kernelILi(\d+)EE")
K5_MOTION = re.compile(r"18motion_term_kernelILb([01])EE")
# K10's and K11's 1-D passes (from BOX_PASS_RADIUS and GAUSS_PASS_RADIUS,
# and past r 16), pass_y_kernel<GAUSS> and pass_x_kernel<GAUSS>, and K12's
# rolling-row tile past r 4, cross_bilateral_rolling_kernel<ROLL> (ROLL:
# the ring; else chunked)
K1011_PASS = re.compile(r"13pass_([xy])_kernelILb([01])EE")


def pass_form(m):
    """The K10/K11 pass a K1011_PASS match names."""
    return f"{'K11' if m.group(2) == '1' else 'K10'} pass along {m.group(1)}"
K12_ROLLING = re.compile(r"30cross_bilateral_rolling_kernelILb([01])EE")
# the bf16 forms: level_bf16_kernel<R, STAGED, STORE, FUSED, S1> (K1b-bf16;
# FUSED: the σ-denominator fused; S1: spacing 1) and
# atrous_bwd_bf16_kernel<R, STAGED, S1> (K14-bf16); R = -1: any radius
K1B_BF16_MANGLED = re.compile(r"17level_bf16_kernelILi(n?\d+)ELb([01])ELb"
                              r"([01])ELb([01])ELb([01])EE")
K14_BF16_MANGLED = re.compile(r"22atrous_bwd_bf16_kernelILi(n?\d+)ELb([01])"
                              r"ELb([01])EE")
K1_MATHS = ("fast", "fast luma", "exact", "exact luma")
K1_STORES = ("none", "N", "bf16", "f32")


def phase(n, msg):
    print(f"phase {n}: {msg}", flush=True)


def max_err(a, b, mask=None):
    d = (a.float() - b.float()).abs()
    if mask is not None:
        d = d[..., mask]
    return float(d.max()) if d.numel() else 0.0


def check_close(name, got, want, *, atol, rtol=0.0, mask=None):
    """Raise unless |got - want| <= atol + rtol·|want| (where ``mask``)."""
    got, want = got.float(), want.float()
    if mask is not None:
        got, want = got[..., mask], want[..., mask]
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"atol={atol:.3g} rtol={rtol:.3g} (max |diff| "
            f"{float((got - want).abs().max()):.3g})")


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_planes(H, W, dev, seed):
    """Seeded SVGF inputs of the main paths' shapes."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return dict(color=t(rng.random((3, H, W))),
                variance=t(0.02 * rng.random((H, W))), normal=t(n),
                depth=t(0.3 + 0.5 * rng.random((H, W))),
                motion=t((rng.random((2, H, W)) - 0.5) * 14.0),
                h_color=t(rng.random((3, H, W))),
                h_moments=t(rng.random((2, H, W))),
                h_length=t(np.floor(rng.random((H, W)) * 6)))


def adjoint_instantiation(name):
    """``(kernel, R, staged, tile)`` of a K14 or K2/K2b instantiation's
    mangled name (R = -1: any radius), else None."""
    m = K14_MANGLED.search(name)
    if m:
        R, staged, tile = (int(v.replace("n", "-")) for v in m.groups())
        return "K14", R, staged == 1, tile == 1
    m = K2_MANGLED.search(name)
    if m:
        return ("K2" if m.group(2).startswith("13") else "K2b",
                int(m.group(3).replace("n", "-")), m.group(1).startswith("31"),
                m.group(4) == "1")
    return None


def adjoint_resources(report):
    """Print ptxas's registers, stack and spills of K14's and K2/K2b's
    instantiations in ``report`` (``{mangled name: (registers, stack,
    spill stores, spill loads)}``); return those that use local memory;
    raise unless the report holds every form of :data:`ADJOINT_FORMS`,
    whole frame and tile, and no other."""
    found = {k: set() for k in ADJOINT_FORMS}
    local = []
    for name, res in sorted(report.items()):
        form = adjoint_instantiation(name)
        if form is None:
            continue
        kernel, R, staged, tile = form
        label = (f"{kernel} {f'r{R}' if R >= 0 else 'any r'}"
                 f"{' staged' if staged else ''}{' tile' if tile else ''}")
        phase(2, f"{label}: {res[0]} registers, stack {res[1]} B, spills "
                 f"{res[2] + res[3]} B")
        found[kernel].add((R, staged, tile))
        if res[1] or res[2] or res[3]:
            local.append(label)
    for kernel, forms in ADJOINT_FORMS.items():
        want = {(R, st, tile) for R, st in forms for tile in (False, True)}
        if found[kernel] != want:
            raise AssertionError(f"phase 2: {kernel} instantiations "
                                 f"{sorted(found[kernel])} in ptxas's "
                                 f"report, expected {sorted(want)}")
    return local


def report_resources():
    """Print ptxas's registers, stack and spills of K1/K1b's, K9's, K14's,
    K2/K2b's, K7's, K8's, K13's, K3/K3b's (and K3's unbounded step's),
    K15's, K10's, K11's (and their
    1-D passes), K12's (staged and rolling), KG's, KGb's, KGp's,
    K4/K4c's, K5/K6's (staged, and the scatter route's kernels) and
    K1b-bf16's and K14-bf16's instantiations (the build's
    report); raise if K2/K2b or K14 in any form, or one of K1/K1b (or a
    bf16 form) at a compiled radius, K9 at r <= 1, K7, K8, K13 or K15 on a
    compiled scene,
    K3/K3b (or its unbounded step), K15's first camera launch, K10 or K11
    (a 2-D body or a 1-D pass), a K12 form, a KG, KGb or KGp kernel or a
    K4-K6 kernel uses local memory, or if K3/K3b (or its unbounded step),
    a compiled K13 or K15, a K10 or K11,
    a K12 form, a KG, KGb or KGp kernel, a K4-K6 instantiation or a bf16
    form is missing from the report."""
    k1, k9, local, k3, k13, k15, k12, kg = {}, {}, [], [], [], [], [], []
    k456, k1011, bf16 = [], [], []
    report = _build.resource_report()
    local += adjoint_resources(report)
    for name, res in sorted(report.items()):
        m = K10_MANGLED.search(name)
        if m:
            kernel = "K10" if m.group(1).startswith("17") else "K11"
            R = int(m.group(2))
            phase(2, f"{kernel} r{R}: {res[0]} registers, stack {res[1]} B, "
                     f"spills {res[2] + res[3]} B")
            k1011.append((kernel, R))
            if res[1] or res[2] or res[3]:
                local.append(f"{kernel} r{R}")
        m = (K4_MANGLED.search(name) or K5_MANGLED.search(name)
             or K5_SCATTER_GATHER.search(name) or K5_MOTION.search(name))
        form = next((f"K5/K6 scatter {f}" for r, f in K5_SCATTER.items()
                     if r.search(name)), None)
        if m:
            tile = " tile" if m.group(1) == "1" else ""
            form = (f"K4{tile}" if m.re is K4_MANGLED else
                    f"K{5 if m.group(2) == '1' else 6}{tile} NP {m.group(3)}"
                    if m.re is K5_MANGLED else
                    f"K5/K6 scatter gather NP {m.group(1)}"
                    if m.re is K5_SCATTER_GATHER else
                    f"K5{tile} motion term")
        if form:
            phase(2, f"{form}: {res[0]} registers, stack {res[1]} B, "
                     f"spills {res[2] + res[3]} B")
            k456.append(form)
            if res[1] or res[2] or res[3]:
                local.append(form)
        form = next((f for r, f in KG_KERNELS.items() if r.search(name)),
                    None)
        if form:
            phase(2, f"{form}: {res[0]} registers, stack {res[1]} B, "
                     f"spills {res[2] + res[3]} B")
            kg.append(form)
            if res[1] or res[2] or res[3]:
                local.append(form)
        m = K15_MANGLED.search(name)
        if m:
            counts = tuple(int(v.replace("n", "-")) for v in m.groups()[:3])
            route = "camera" if m.group(4) == "1" else "planes"
            phase(2, f"K15 {counts if counts[0] >= 0 else 'runtime counts'}"
                     f" {route}: {res[0]} registers, stack {res[1]} B, "
                     f"spills {res[2] + res[3]} B")
            if counts[0] >= 0:
                k15.append((counts, route))
                if res[1] or res[2] or res[3]:
                    local.append(f"K15 {counts} {route}")
        if K15_DELTA_MANGLED.search(name):
            phase(2, f"K15 camera delta launch: {res[0]} registers, stack "
                     f"{res[1]} B, spills {res[2] + res[3]} B")
            if res[1] or res[2] or res[3]:
                local.append("K15 camera delta launch")
        m = K1011_PASS.search(name) or K12_ROLLING.search(name)
        if m:
            form = (pass_form(m) if m.re is K1011_PASS else
                    "K12 r > 4 rolling " + ("ring" if m.group(1) == "1"
                                            else "chunked"))
            phase(2, f"{form}: {res[0]} registers, stack {res[1]} B, "
                     f"spills {res[2] + res[3]} B")
            k1011.append(form)
            if res[1] or res[2] or res[3]:
                local.append(form)
        m = K12_MANGLED.search(name)
        if m:
            R, px = int(m.group(1)), int(m.group(2))
            phase(2, f"K12 staged r{R} ({px} pixel{'s' if px > 1 else ''} a"
                     f" thread): {res[0]} registers, stack {res[1]} B, "
                     f"spills {res[2] + res[3]} B")
            k12.append(R)
            if res[1] or res[2] or res[3]:
                local.append(f"K12 staged r{R}")
        m = K7_MANGLED.search(name)
        if m:
            counts = tuple(int(v.replace("n", "-")) for v in m.groups())
            phase(2, f"K7 {counts if counts[0] >= 0 else 'runtime counts'}"
                     f": {res[0]} registers, stack {res[1]} B, spills "
                     f"{res[2] + res[3]} B")
            if counts[0] >= 0 and (res[1] or res[2] or res[3]):
                local.append(f"K7 {counts}")
        m = K8_MANGLED.search(name)
        if m:
            counts = tuple(int(v.replace("n", "-")) for v in m.groups())
            phase(2, f"K8 {counts if counts[0] >= 0 else 'runtime counts'}"
                     f": {res[0]} registers, stack {res[1]} B, spills "
                     f"{res[2] + res[3]} B")
            if counts[0] >= 0 and (res[1] or res[2] or res[3]):
                local.append(f"K8 {counts}")
        m = K13_MANGLED.search(name)
        if m:
            counts = tuple(int(v.replace("n", "-")) for v in m.groups())
            phase(2, f"K13 {counts if counts[0] >= 0 else 'runtime counts'}"
                     f": {res[0]} registers, stack {res[1]} B, spills "
                     f"{res[2] + res[3]} B")
            if counts[0] >= 0:
                k13.append(counts)
                if res[1] or res[2] or res[3]:
                    local.append(f"K13 {counts}")
        if K16_MANGLED.search(name):
            phase(2, f"K16: {res[0]} registers, stack {res[1]} B, spills "
                     f"{res[2] + res[3]} B")
            k3.append("K16")
            if res[1] or res[2] or res[3]:
                local.append("K16")
        m = K3_MANGLED.search(name)
        if m:
            form = k3_form(m)
            phase(2, f"{form}: {res[0]} registers, stack {res[1]} B, "
                     f"spills {res[2] + res[3]} B")
            k3.append(form)
            if res[1] or res[2] or res[3]:
                local.append(form)
        m = K1B_BF16_MANGLED.search(name) or K14_BF16_MANGLED.search(name)
        if m:
            R, staged = int(m.group(1).replace("n", "-")), m.group(2) == "1"
            form = (("K1b-bf16" if m.re is K1B_BF16_MANGLED else "K14-bf16")
                    + f" r{R if R >= 0 else '>2'}"
                    + ("" if staged else " unstaged")
                    + (" float weights" if m.re is K1B_BF16_MANGLED
                       and m.group(3) == "1" else "")
                    + (" spacing 1" if m.groups()[-1] == "1" else "")
                    + (" fused σ" if m.re is K1B_BF16_MANGLED
                       and m.group(4) == "1" else ""))
            phase(2, f"{form}: {res[0]} registers, stack {res[1]} B, "
                     f"spills {res[2] + res[3]} B")
            bf16.append(form)
            if R >= 0 and (res[1] or res[2] or res[3]):
                local.append(form)
            if R < 0 and sum(res[1:4]) > BF16_WIDE_LOCAL_B:
                local.append(f"{form} (stack and spills {sum(res[1:4])} B "
                             f"> {BF16_WIDE_LOCAL_B})")
        m = K1_MANGLED.search(name)
        if m:
            R, math, sden, store, tile = (int(v.replace("n", "-"))
                                          for v in m.groups())
            k1.setdefault(R, {})[(math, sden, store, tile)] = res
        m = K9_MANGLED.search(name)
        if m:
            k9[(int(m.group(1).replace("n", "-")), int(m.group(2)))] = res
    if not k1 or not k9:
        raise AssertionError("phase 2: no K1 or K9 kernel in ptxas's report")
    if sorted(k3) != ["K16", "K3", "K3 tile/K3b", "K3 unbounded"] or len(
            k13) != 2:
        raise AssertionError(f"phase 2: K3/K3b, K16 {k3} or compiled K13 "
                             f"{k13} missing from ptxas's report")
    if len(k15) != 4 or sorted(k12) != [0, 1, 2, 3, 4]:
        raise AssertionError(f"phase 2: compiled K15 {k15} or staged K12 "
                             f"{sorted(k12)} missing from ptxas's report")
    if len(set(k456)) != 20:
        raise AssertionError(f"phase 2: K4/K4c and K5/K6 (K5c/K6c) "
                             f"instantiations {sorted(k456)} in ptxas's "
                             f"report, expected 2, 8 staged, 6 of the "
                             f"scatter, its gather at NP 6 and 10 and 2 "
                             f"motion terms")
    want = sorted([(k, R) for k in ("K10", "K11") for R in range(5)]
                  + [f"K1{k} pass along {a}" for k in (0, 1) for a in "xy"]
                  + ["K12 r > 4 rolling ring",
                     "K12 r > 4 rolling chunked"], key=str)
    if sorted(k1011, key=str) != want:
        raise AssertionError(f"phase 2: K10/K11 instantiations "
                             f"{sorted(k1011)} in ptxas's report, expected "
                             f"{want}")
    # K1b-bf16: r0-r2 (r1 and r2 at spacing 1 apart) and the wide radius
    # staged, the wide one unstaged too (7), each with and without float
    # weights (14), and each with the σ-denominator fused (7); K14-bf16: 7
    fused = sum(f.startswith("K1b-bf16") and f.endswith("fused σ")
                for f in bf16)
    if (sum(f.startswith("K1b-bf16") for f in bf16) != 21 or fused != 7
            or sum(f.startswith("K14-bf16") for f in bf16) != 7):
        raise AssertionError(f"phase 2: bf16 forms {sorted(bf16)} in "
                             f"ptxas's report, expected 21 K1b-bf16 (7 "
                             f"with the σ fused) and 7 K14-bf16 "
                             f"instantiations")
    if sorted(kg) != sorted(KG_KERNELS.values()):
        raise AssertionError(f"phase 2: KG/KGb/KGp kernels {kg} in ptxas's "
                             f"report, expected {list(KG_KERNELS.values())}")
    for R, found in sorted(k1.items()):
        regs = [res[0] for res in found.values()]
        frame = max(res[1] for res in found.values())
        spill = max(res[2] + res[3] for res in found.values())
        main = ", ".join(
            f"{'K1b' if sden else 'K1'} {K1_MATHS[math]} "
            f"{K1_STORES[store]}{' tile' if tile else ''} {res[0]}"
            for (math, sden, store, tile), res in sorted(found.items())
            if (math, sden, store) in ((0, 0, 0), (2, 0, 2), (2, 1, 1)))
        phase(2, f"K1 r{R if R >= 0 else '>2'}: {len(found)} "
                 f"instantiations, {min(regs)}-{max(regs)} registers, stack "
                 f"<= {frame} B, spills <= {spill} B; registers: {main}")
        if R >= 0 and (frame or spill):
            local.append(f"K1 r{R}")
    for (R, staged), (regs, frame, st, ld) in sorted(k9.items()):
        phase(2, f"K9 r{R if R >= 0 else '>2'}"
                 f"{' staged' if staged else ''}: {regs} registers, stack "
                 f"{frame} B, spills {st + ld} B")
        # K9 at r2 and with its taps in memory spills 36-40 B (PERF.md,
        # section 7): printed, not failed; r0-r1 must have none
        if 0 <= R <= 1 and (frame or st or ld):
            local.append(f"K9 r{R}{' staged' if staged else ''}")
    if local:
        raise AssertionError(f"phase 2: local memory in {local}")


def report_sass_mix():
    """Print the bf16 forms' SASS instruction mix, each class's static
    count over the taps of a compiled radius (``utils/profile.py``'s
    ``sass``): a reading only; nothing fails on it."""
    try:
        lines = list(sass_lines())
    except (OSError, RuntimeError) as e:
        phase(2, f"SASS instruction mix not read: {e}")
        return
    for line in lines:
        phase(2, f"SASS {line}")


def check_k1(P, results):
    args = (P["color"], P["variance"], P["normal"], P["depth"])
    HW = P["depth"].numel()
    # radius 0 (one tap) and 3 (the taps in device memory) beside 1 and 2
    for radius in (0, 1, 2, 3):
        for wm in ("exact", "fast"):
            params = SVGFParams(radius=radius)
            got = svgf_spatial_cuda(*args, params=params, weight_math=wm,
                                    return_feedback=True)
            want = atrous.svgf_spatial_ref(*args, params=params,
                                           weight_math=wm,
                                           return_feedback=True)
            for name, a, b in zip(("color", "variance", "feedback"), got,
                                  want):
                tol = (dict(atol=0.0, rtol=5e-5) if wm == "exact"
                       else dict(atol=2e-4 * float(b.abs().max())))
                check_close(f"K1 r{radius} {wm} {name}", a, b, **tol)
            err = max(max_err(a, b) for a, b in zip(got, want))
            ms = cuda_time_ms(lambda: svgf_spatial_cuda(
                *args, params=params, weight_math=wm), repeats=10)
            plain_ms = cuda_time_ms(lambda: atrous.svgf_spatial_ref(
                *args, params=params, weight_math=wm), repeats=3)
            phase(3, f"K1 r{radius} {wm}: ok, max |err| {err:.3g}, "
                     f"{ms:.4f} ms/sweep (5 levels), plain {plain_ms:.4f} ms")
            if radius == SERVING.radius and wm == SERVING_WEIGHTS:
                # inputs 10 floats a pixel, outputs 4
                results["K1"] = dict(
                    max_abs_err=err, ms=ms / SERVING.iterations,
                    plain_ms=plain_ms / SERVING.iterations,
                    bytes=56 * HW, flops=K1_TAP_FLOPS * 9 * HW)
    # the serving mode at each level: the row-lattice tile's halo and the
    # reach of its taps grow with the spacing
    zgrad = finite_diff_gradients(P["depth"])
    b_ms, b_by = bound(56 * HW, K1_TAP_FLOPS * 9 * HW)
    per_level = []
    for level in range(SERVING.iterations):
        per_level.append(cuda_time_ms(lambda: atrous_level_cuda(
            *args, zgrad, level=level, params=SERVING,
            weight_math=SERVING_WEIGHTS), repeats=20))
    phase(3, f"K1 r{SERVING.radius} {SERVING_WEIGHTS} a level, levels 0-"
             f"{SERVING.iterations - 1}: "
             + ", ".join(f"{ms:.4f}" for ms in per_level)
             + f" ms; bound {b_ms:.4f} ms ({b_by}, 56 B/px)")


def check_k1_store_k2(P, results):
    """K1 in store mode (values, bf16 weights, N) and K2 on its weights,
    each level against the plain twins on the same inputs."""
    color, var, normal, depth = (P["color"], P["variance"], P["normal"],
                                 P["depth"])
    zgrad = finite_diff_gradients(depth)
    H, W = depth.shape
    HW = H * W
    g = torch.Generator(color.device).manual_seed(1)
    gc = torch.randn((3, H, W), generator=g, device=color.device)
    gv = torch.randn((H, W), generator=g, device=color.device)
    for radius in (1, 2):
        taps = (2 * radius + 1) ** 2
        for wm in ("exact", "fast"):
            params = SVGFParams(radius=radius)
            c, v = color, var
            errs = [0.0, 0.0]
            for level in range(params.iterations):
                kw = dict(level=level, params=params, weight_math=wm)
                got = atrous_level_cuda(c, v, normal, depth, zgrad,
                                        store=True, **kw)
                want = atrous.atrous_level_ref(c, v, normal, depth, zgrad,
                                               return_weights=True, **kw)
                w_want = want[2].to(torch.bfloat16)
                for name, a, b in (("color", got[0], want[0]),
                                   ("variance", got[1], want[1]),
                                   ("N", got[3], want[3])):
                    tol = (dict(atol=0.0, rtol=5e-5) if wm == "exact"
                           else dict(atol=2e-4 * float(b.abs().max())))
                    check_close(f"K1 store r{radius} {wm} l{level} {name}",
                                a, b, **tol)
                # one bf16 step: expf/torch.exp (or the fast polynomial's
                # seams) can put a weight on either side of a rounding
                check_close(f"K1 store r{radius} {wm} l{level} weights",
                            got[2], w_want, atol=1e-30, rtol=2.0 ** -7)
                errs[0] = max(errs[0], max_err(got[2], w_want))
                k2 = atrous_level_bwd_stored_cuda(got[2], got[3], gc, gv,
                                                  level=level, radius=radius)
                k2_want = atrous.atrous_level_bwd_stored_ref(
                    got[2], got[3], gc, gv, level=level, radius=radius)
                for name, a, b in zip(("d_color", "d_variance"), k2,
                                      k2_want):
                    check_close(f"K2 r{radius} {wm} l{level} {name}", a, b,
                                atol=1e-12 * float(b.abs().max()),
                                rtol=1e-6)
                errs[1] = max(errs[1], max(max_err(a, b)
                                           for a, b in zip(k2, k2_want)))
                c, v = want[0], want[1]
            lvl_args = (color, var, normal, depth, zgrad)
            kw = dict(level=0, params=params, weight_math=wm)
            ms = cuda_time_ms(lambda: atrous_level_cuda(
                *lvl_args, store=True, **kw), repeats=20)
            plain_ms = cuda_time_ms(lambda: atrous.atrous_level_ref(
                *lvl_args, return_weights=True, **kw), repeats=3)
            w, norm = got[2], got[3]
            ms2 = cuda_time_ms(lambda: atrous_level_bwd_stored_cuda(
                w, norm, gc, gv, level=0, radius=radius), repeats=20)
            plain2 = cuda_time_ms(lambda: atrous.atrous_level_bwd_stored_ref(
                w, norm, gc, gv, level=0, radius=radius), repeats=3)
            # inputs 10 floats, outputs c, v, N and the bf16 weights
            st_bytes = 60 + 2 * taps
            st_ms, st_by = bound(st_bytes * HW, K1_TAP_FLOPS * taps * HW)
            phase(3, f"K1 store r{radius} {wm}: ok (5 levels), max |err| "
                     f"weights {errs[0]:.3g}, {ms:.4f} ms/level (bound "
                     f"{st_ms:.4f}, {st_by}, {st_bytes} B/px), plain "
                     f"{plain_ms:.4f} ms; K2: ok, max |err| {errs[1]:.3g}, "
                     f"{ms2:.4f} ms/level, plain {plain2:.4f} ms")
            if radius == TRAIN.radius and wm == "exact":
                # bf16 weights, N, gc, gv in; dc, dv out
                results["K2"] = dict(
                    max_abs_err=errs[1], ms=ms2, plain_ms=plain2,
                    bytes=(2 * taps + 4 + 12 + 4 + 16) * HW,
                    flops=K2_TAP_FLOPS * taps * HW)


def _level_inputs(P, radius, seed):
    """One level's inputs on the 1080p planes: c, v, n, z, ∇z, σ, and
    seeded cotangents gc, gv."""
    color, var, normal, depth = (P["color"], P["variance"], P["normal"],
                                 P["depth"])
    g = torch.Generator(color.device).manual_seed(seed)
    gc = torch.randn(color.shape, generator=g, device=color.device)
    gv = torch.randn(var.shape, generator=g, device=color.device)
    return (color, var, normal, depth, finite_diff_gradients(depth),
            atrous.sigma_denominator(var, SVGFParams(radius=radius)), gc, gv)


WGRAD_NAMES = ("d_color", "d_variance", "d_normal", "d_depth", "d_zgrad",
               "d_sigma")


def check_adjoint_kernels(P, results):
    """K1b (a given σ-denominator, float32 weight store), K2b (float32
    weights), K14 and K9 at level 1, radius 1 and 2, each against its plain
    twin on the same inputs.  Tolerances: K1b rtol 5e-5 as K1's exact
    weights (weights too: expf/powf against torch's, an ulp each); K2b
    rtol 1e-6 as K2 (the same operations in the same order); K14 atol
    1e-5·max (its weights are K1's, an ulp from the twin's, summed over
    cotangents of both signs); K9 atol 1e-4·max on each of its six planes
    (the same, through the products of the weight's derivatives)."""
    HW = P["depth"].numel()
    for radius in (1, 2):
        taps = (2 * radius + 1) ** 2
        params = SVGFParams(radius=radius)
        kw = dict(level=1, params=params)
        c, v, n, z, zg, sd, gc, gv = _level_inputs(P, radius, 10 + radius)
        got = atrous_level_fwd_cuda(c, v, n, z, zg, sd, save_weights=True,
                                    **kw)
        want = atrous.atrous_level_ref(c, v, n, z, zg, sigma_denom=sd,
                                       return_weights=True, **kw)
        want = (want[0], want[1], want[3], want[2])     # c, v, N, w
        for name, a, b in zip(("color", "variance", "N", "weights"), got,
                              want):
            check_close(f"K1b r{radius} {name}", a, b,
                        atol=1e-12 * float(b.abs().max()), rtol=5e-5)
        err1b = max(max_err(a, b) for a, b in zip(got, want))
        oc, ov, norm, w = got
        ms1b = cuda_time_ms(lambda: atrous_level_fwd_cuda(
            c, v, n, z, zg, sd, **kw), repeats=20)
        ms1b_w = cuda_time_ms(lambda: atrous_level_fwd_cuda(
            c, v, n, z, zg, sd, save_weights=True, **kw), repeats=20)
        plain1b = cuda_time_ms(lambda: atrous.atrous_level_ref(
            c, v, n, z, zg, sigma_denom=sd, return_weights=True, **kw),
            repeats=3)

        k2b = atrous_level_bwd_stored_f32_cuda(w, norm, gc, gv, level=1,
                                               radius=radius)
        k2b_want = atrous.atrous_level_bwd_stored_ref(w, norm, gc, gv,
                                                      level=1, radius=radius)
        for name, a, b in zip(("d_color", "d_variance"), k2b, k2b_want):
            check_close(f"K2b r{radius} {name}", a, b,
                        atol=1e-12 * float(b.abs().max()), rtol=1e-6)
        err2b = max(max_err(a, b) for a, b in zip(k2b, k2b_want))
        ms2b = cuda_time_ms(lambda: atrous_level_bwd_stored_f32_cuda(
            w, norm, gc, gv, level=1, radius=radius), repeats=20)
        plain2b = cuda_time_ms(lambda: atrous.atrous_level_bwd_stored_ref(
            w, norm, gc, gv, level=1, radius=radius), repeats=3)

        k14 = atrous_level_bwd_cuda(c, n, z, zg, sd, norm, gc, gv, **kw)
        k14_want = atrous.atrous_level_bwd_ref(c, n, z, zg, sd, norm, gc, gv,
                                               **kw)
        for name, a, b in zip(("d_color", "d_variance"), k14, k14_want):
            check_close(f"K14 r{radius} {name}", a, b,
                        atol=1e-5 * float(b.abs().max()))
        err14 = max(max_err(a, b) for a, b in zip(k14, k14_want))
        ms14 = cuda_time_ms(lambda: atrous_level_bwd_cuda(
            c, n, z, zg, sd, norm, gc, gv, **kw), repeats=20)
        plain14 = cuda_time_ms(lambda: atrous.atrous_level_bwd_ref(
            c, n, z, zg, sd, norm, gc, gv, **kw), repeats=3)

        wargs = (c, v, n, z, zg, sd, oc, ov, norm, gc, gv)
        k9 = atrous_level_wgrad_bwd_cuda(*wargs, **kw)
        k9_want = atrous.atrous_level_wgrad_bwd_ref(*wargs, **kw)
        for name, a, b in zip(WGRAD_NAMES, k9, k9_want):
            check_close(f"K9 r{radius} {name}", a, b,
                        atol=1e-4 * float(b.abs().max()))
        err9 = max(max_err(a, b) / float(b.abs().max())
                   for a, b in zip(k9, k9_want))
        ms9 = cuda_time_ms(lambda: atrous_level_wgrad_bwd_cuda(*wargs, **kw),
                           repeats=20)
        plain9 = cuda_time_ms(lambda: atrous.atrous_level_wgrad_bwd_ref(
            *wargs, **kw), repeats=3)
        phase(3, f"r{radius} level 1: K1b ok, max |err| {err1b:.3g}, "
                 f"{ms1b:.4f} ms ({ms1b_w:.4f} with float32 weights), plain "
                 f"{plain1b:.4f} ms; K2b ok, {err2b:.3g}, {ms2b:.4f} ms, "
                 f"plain {plain2b:.4f} ms; K14 ok, {err14:.3g}, {ms14:.4f} "
                 f"ms, plain {plain14:.4f} ms; K9 ok, max |err|/max "
                 f"{err9:.3g}, {ms9:.4f} ms, plain {plain9:.4f} ms")
        # bytes a pixel, inputs once and outputs once: K1b c, v, n, z, ∇z,
        # σ in, c, v, N out; K2b float32 weights, N, gc, gv in, dc, dv
        # out; K14 c, n, z, ∇z, σ, N, gc, gv in, dc, dv out; K9 c, v, n,
        # z, ∇z, σ, out_c, out_v, N, gc, gv in, its six gradients out
        k9_err = max(max_err(a, b) for a, b in zip(k9, k9_want))
        for k, (err, ms, plain, bytes_px, flops) in {
                "K1b": (err1b, ms1b, plain1b, 64, K1_TAP_FLOPS),
                "K1b float weights": (err1b, ms1b_w, plain1b,
                                      64 + 4 * taps, K1_TAP_FLOPS),
                "K2b": (err2b, ms2b, plain2b, 4 * taps + 36, K2_TAP_FLOPS),
                "K14": (err14, ms14, plain14, 76, K14_TAP_FLOPS),
                "K9": (k9_err, ms9, plain9, 124, K9_TAP_FLOPS)}.items():
            cost = dict(bytes=bytes_px * HW, flops=flops * taps * HW)
            b_ms, b_by = bound(cost["bytes"], cost["flops"])
            phase(3, f"r{radius} {k} bound {b_ms:.4f} ms ({b_by}, "
                     f"{bytes_px} B/px)")
            if radius == TRAIN.radius and k in KERNELS:
                results[k] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                  **cost)


def _wide_adjoint_cases(P, radius, level):
    """K2, K2b and K14 at ``radius`` and ``level`` on phase 3's 1080p
    planes: ``{label: (kernel, launch(**form), twin(), bytes a pixel,
    pixels, staging key)}`` for the whole frame and for the lower right
    quarter tile (its origin, the frame's bounds, margin gradients).  The
    weights are K1b's float weights (bf16 for K2), N is K1b's."""
    params = SVGFParams(radius=radius)
    taps = (2 * radius + 1) ** 2
    c, v, n, z, zg, sd, gc, gv = _level_inputs(P, radius, 20 + radius)
    kw = dict(level=level, params=params)
    _, _, norm, w = atrous_level_fwd_cuda(c, v, n, z, zg, sd,
                                          save_weights=True, **kw)
    wb = w.to(torch.bfloat16)
    H, W = z.shape
    th, tw = H // 2, W // 2
    tile, h = Tile((th, tw), (H, W)), radius << level

    def cut(x):
        return x[..., th:, tw:].contiguous()

    cases = {}
    for where in ("whole", "tile"):
        tiled = where == "tile"
        npx = (H - th) * (W - tw) if tiled else H * W
        sk = dict(level=level, radius=radius, out_halo=h if tiled else 0)
        for kn, wrapper, wt, bytes_px in (
                ("K2", atrous_level_bwd_stored_cuda, wb, 2 * taps + 36),
                ("K2b", atrous_level_bwd_stored_f32_cuda, w, 4 * taps + 36)):
            args = tuple(cut(x) if tiled else x for x in (wt, norm, gc, gv))
            cases[f"{kn} {where}"] = (
                kn, lambda a=args, wr=wrapper, k=sk, **f: wr(*a, **k, **f),
                lambda a=args, k=sk: atrous.atrous_level_bwd_stored_ref(
                    *a, **k), bytes_px, npx, "K2")
        args = (c, n, z, zg, sd, norm, gc, gv)
        k14kw = dict(kw)
        if tiled:
            args = tuple(frame_canvas(x, tile, H - th, W - tw, h)
                         for x in (c, n, z)) + tuple(
                cut(x) for x in (zg, sd, norm, gc, gv))
            k14kw.update(tile=tile, out_halo=h)
        cases[f"K14 {where}"] = (
            "K14", lambda a=args, k=k14kw, **f: atrous_level_bwd_cuda(
                *a, **k, **f),
            lambda a=args, k=k14kw: atrous.atrous_level_bwd_ref(*a, **k), 76,
            npx, "K14")
    return cases


def check_wide_adjoints(P, results):
    """K2 (bf16 weights), K2b (float weights) and K14 past radius 2: at
    radius 3, 4 and 5, levels 1 and 4, whole frame and the lower right
    quarter tile, each against its plain twin on the same inputs (phase
    3's tolerances: K2/K2b rtol 1e-6, K14 atol 1e-5·max) and the form the
    wrapper picks (``utils.tiling.adjoint_staged``: staged, or the centres
    through the caches past the staging budget) bit-equal to the other
    form (staged where its tile fits a block); each timed with CUDA
    events beside the other form, the twin and its bound (the whole
    case's bytes: inputs once, outputs once at its pixels; the taps'
    operations)."""
    for radius in WIDE_ADJOINT_RADII:
        taps = (2 * radius + 1) ** 2
        for level in WIDE_ADJOINT_LEVELS:
            for label, (kn, launch, twin, bytes_px, npx, key) in \
                    _wide_adjoint_cases(P, radius, level).items():
                name = f"{label} r{radius} l{level}"
                got, want = launch(), twin()
                for out, a, b in zip(("d_color", "d_variance"), got, want):
                    if kn == "K14":
                        check_close(f"{name} {out}", a, b,
                                    atol=1e-5 * float(b.abs().max()))
                    else:
                        check_close(f"{name} {out}", a, b,
                                    atol=1e-12 * float(b.abs().max()),
                                    rtol=1e-6)
                err = max(max_err(a, b) for a, b in zip(got, want))
                staged = tiling.adjoint_staged(key, radius, level)
                rows, cols = tiling.staged_tile(radius, level)
                fits = (rows * cols * tiling.STAGED_PIXEL_BYTES[key]
                        <= tiling.SMEM_PER_BLOCK)
                forms = {staged: launch}
                text = f"{'staged' if staged else 'through the caches'}"
                if fits or staged:
                    other = launch(staged=not staged)
                    if not all(torch.equal(a, b)
                               for a, b in zip(got, other)):
                        raise AssertionError(f"phase 3: {name}: the staged "
                                             f"and cache-read forms differ")
                    forms[not staged] = (
                        lambda f=launch, st=not staged: f(staged=st))
                ms = {st: cuda_time_ms(f, repeats=20)
                      for st, f in forms.items()}
                plain = cuda_time_ms(twin, repeats=3)
                flops = (K14_TAP_FLOPS if kn == "K14" else K2_TAP_FLOPS)
                b_ms, b_by = bound(bytes_px * npx, flops * taps * npx)
                phase(3, f"{name}: ok, max |err| {err:.3g}; {text} "
                         f"{ms[staged]:.4f} ms"
                         + (f", {'through the caches' if staged else 'staged'}"
                            f" {ms[not staged]:.4f} ms" if len(ms) > 1
                            else "")
                         + f"; plain {plain:.4f} ms; bound {b_ms:.4f} ms "
                           f"({b_by}, {bytes_px} B/px)")
                if ((radius, level) == WIDE_ADJOINT_REPORTED
                        and label.endswith("whole")):
                    results[f"{kn}w"] = dict(
                        max_abs_err=err, ms=ms[staged], plain_ms=plain,
                        bytes=bytes_px * npx, flops=flops * taps * npx)


# the bf16 forms against their twins: the same bf16 operations in the same
# order, bit-equal but where a weight-times-value product falls below
# float32's normal range (the kernel's fma, the twin's product and sum)
BF16_TWIN_TOL = dict(atol=1e-37, rtol=2.0 ** -23)


def check_bf16_kernels(P, results):
    """K1b-bf16 (σ given; σ fused, written and not) and K14-bf16
    (``precision="bf16"``) at level 1, radius 1 and 2, against their twins
    on the same inputs (``BF16_TWIN_TOL``; the fused σ bit-equal to
    ``sigma_denominator``'s), and timed beside the float32 forms on those
    inputs (K1b, and for the fused form K1 with its fused σ, exact weights;
    K14), by CUDA events and by device time under the profiler.  Bounds:
    the planes are read as float32 and rounded as they are staged, so the
    bytes are the float32 forms' (64 B/px, K14 76), and the fused form
    reads no σ (60 B/px, 64 with σ written); the operations, counted as
    the float32 forms' at the float32 rate, bound neither."""
    HW = P["depth"].numel()
    for radius in (1, 2):
        taps = (2 * radius + 1) ** 2
        params = SVGFParams(radius=radius)
        kw = dict(level=1, params=params)
        kb = dict(kw, precision="bf16")
        c, v, n, z, zg, sd, gc, gv = _level_inputs(P, radius, 10 + radius)
        got = atrous_level_fwd_cuda(c, v, n, z, zg, sd, **kb)
        want = atrous.atrous_level_ref(c, v, n, z, zg, sigma_denom=sd,
                                       return_weights=True, **kb)
        want = (want[0], want[1], want[3])              # c, v, N
        for name, a, b in zip(("color", "variance", "N"), got, want):
            check_close(f"K1b-bf16 r{radius} {name}", a, b, **BF16_TWIN_TOL)
        err1b = max(max_err(a, b) for a, b in zip(got, want))
        fw = atrous_level_fwd_cuda(c, v, n, z, zg, None,
                                   return_sigma_denom=True, **kb)
        fn = atrous_level_fwd_cuda(c, v, n, z, zg, None, **kb)
        if not torch.equal(fw[3], sd):
            raise AssertionError(f"phase 3: K1b-bf16 r{radius}: the fused "
                                 f"σ-denominator differs from "
                                 f"sigma_denominator's (max |diff| "
                                 f"{max_err(fw[3], sd):.3g})")
        for name, a, b, x in zip(("color", "variance", "N"), fw, want, fn):
            check_close(f"K1b-bf16 fused r{radius} {name}", a, b,
                        **BF16_TWIN_TOL)
            if not torch.equal(a, x):
                raise AssertionError(f"phase 3: K1b-bf16 fused r{radius} "
                                     f"{name}: σ written and not differ")
        errf = max(max_err(a, b) for a, b in zip(fw, want))
        norm = got[2]
        k14 = atrous_level_bwd_cuda(c, n, z, zg, sd, norm, gc, gv, **kb)
        k14_want = atrous.atrous_level_bwd_ref(c, n, z, zg, sd, norm, gc, gv,
                                               **kb)
        for name, a, b in zip(("d_color", "d_variance"), k14, k14_want):
            check_close(f"K14-bf16 r{radius} {name}", a, b, **BF16_TWIN_TOL)
        err14 = max(max_err(a, b) for a, b in zip(k14, k14_want))
        calls = {
            "K1b-bf16": lambda: atrous_level_fwd_cuda(c, v, n, z, zg, sd,
                                                      **kb),
            "K1b-bf16-fused": lambda: atrous_level_fwd_cuda(
                c, v, n, z, zg, None, **kb),
            "K1b-bf16-fused σ written": lambda: atrous_level_fwd_cuda(
                c, v, n, z, zg, None, return_sigma_denom=True, **kb),
            "K1b": lambda: atrous_level_fwd_cuda(c, v, n, z, zg, sd, **kw),
            "K1": lambda: atrous_level_cuda(c, v, n, z, zg, **kw),
            "K14-bf16": lambda: atrous_level_bwd_cuda(c, n, z, zg, sd, norm,
                                                      gc, gv, **kb),
            "K14": lambda: atrous_level_bwd_cuda(c, n, z, zg, sd, norm, gc,
                                                 gv, **kw)}
        ms = {k: cuda_time_ms(f, repeats=20) for k, f in calls.items()}
        dms = {k: device_ms(f, 20) for k, f in calls.items()}
        plain1b = cuda_time_ms(lambda: atrous.atrous_level_ref(
            c, v, n, z, zg, sigma_denom=sd, **kb), repeats=3)
        plainf = cuda_time_ms(lambda: atrous.atrous_level_ref(
            c, v, n, z, zg, sigma_denom=atrous.sigma_denominator(v, params),
            **kb), repeats=3)
        plain14 = cuda_time_ms(lambda: atrous.atrous_level_bwd_ref(
            c, n, z, zg, sd, norm, gc, gv, **kb), repeats=3)
        for k, (err, plain, bytes_px, f32) in {
                "K1b-bf16": (err1b, plain1b, 64, "K1b"),
                "K1b-bf16-fused": (errf, plainf, 60, "K1"),
                "K1b-bf16-fused σ written": (errf, plainf, 64, "K1"),
                "K14-bf16": (err14, plain14, 76, "K14")}.items():
            flops = K14_TAP_FLOPS if f32 == "K14" else K1_TAP_FLOPS
            cost = dict(bytes=bytes_px * HW, flops=flops * taps * HW)
            b_ms, b_by = bound(cost["bytes"], cost["flops"])
            phase(3, f"r{radius} level 1 {k}: ok, max |err| {err:.3g}; "
                     f"{ms[k]:.4f} ms events, {dms[k]:.4f} ms device "
                     f"({b_ms / dms[k]:.2f} of the bound); float32 {f32} "
                     f"{ms[f32]:.4f} ms events, {dms[f32]:.4f} ms device "
                     f"(bf16/f32 {dms[k] / dms[f32]:.3f}); bound "
                     f"{b_ms:.4f} ms ({b_by}, {bytes_px} B/px); plain "
                     f"{plain:.4f} ms")
            if radius == TRAIN.radius and k in KERNELS:
                results[k] = dict(max_abs_err=err, ms=ms[k], plain_ms=plain,
                                  **cost)


def check_k3(P, results):
    g = GBuffer(render=P["color"], albedo=P["color"], normal=P["normal"],
                depth=P["depth"], motion=P["motion"])
    h = History(color=P["h_color"], moments=P["h_moments"],
                length=P["h_length"], prev_depth=P["depth"],
                prev_normal=P["normal"])
    params = SVGFParams()
    got = temporal_accumulate_cuda(g, h, params=params)
    want = temporal.temporal_accumulate(g, h, params=params)
    pairs = [("integrated", got[0], want[0]), ("variance", got[1], want[1]),
             ("moments", got[2].moments, want[2].moments)]
    for name, a, b in pairs:
        check_close(f"K3 {name}", a, b, atol=1e-6, rtol=1e-5)
    check_close("K3 length", got[2].length, want[2].length, atol=0.0)
    err = max(max_err(a, b) for _, a, b in pairs)
    ms = cuda_time_ms(lambda: temporal_accumulate_cuda(g, h, params=params),
                      repeats=20)
    plain_ms = cuda_time_ms(lambda: temporal.temporal_accumulate(
        g, h, params=params), repeats=3)
    # render, motion, depth, normal, 10 history planes in; 7 planes out;
    # ~60 flops a pixel, and ~8 a tap of the 7x7 window on the pixels
    # whose new history is short (this input's share)
    short = float((got[2].length < params.variance_boost_frames).float()
                  .mean())
    HW = g.depth.numel()
    results["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bytes=104 * HW, flops=(60 + 49 * 8 * short) * HW)
    phase(3, f"K3: ok, max |err| {err:.3g}, {ms:.4f} ms, plain "
             f"{plain_ms:.4f} ms")
    check_k3_unbounded(g, h)


def check_k3_unbounded(g, h):
    """K3's unbounded step (``max_motion=None``) on phase 3's input with
    its motion scaled to ±28 pixels and on the served frame's with
    ``max_motion=None``: bit-equal to the route it replaced (the history
    stacked by KGp, KG, the plain epilogue), at K3's tolerance to the
    plain step; the three timed."""
    unbounded = SVGFParams(max_motion=None)
    H, W = g.depth.shape
    ins = {"±28 px": (g.replace(motion=g.motion * 4.0), h),
           "served frame": served_inputs(H, W, g.device, unbounded=True)}
    for label, (gi, hi) in ins.items():
        got = temporal_accumulate_cuda(gi, hi, params=unbounded)

        def old():
            return temporal.temporal_step_clamped(
                gi, hi, unbounded, reproject_clamped_cuda,
                history_stack_channel_minor_cuda)

        want = old()
        for name, a, b in zip(("integrated", "variance", "moments",
                               "length"),
                              (got[0], got[1], got[2].moments, got[2].length),
                              (want[0], want[1], want[2].moments,
                               want[2].length)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"K3 unbounded {label} {name} != the clamped route at "
                    f"{int((a != b).sum())} elements")
        plain = temporal.temporal_accumulate(gi, hi, params=unbounded)
        for name, a, b in (("integrated", got[0], plain[0]),
                           ("variance", got[1], plain[1]),
                           ("moments", got[2].moments, plain[2].moments)):
            check_close(f"K3 unbounded {label} {name}", a, b, atol=1e-6,
                        rtol=1e-5)
        ms = cuda_time_ms(lambda: temporal_accumulate_cuda(
            gi, hi, params=unbounded), repeats=20)
        old_ms = cuda_time_ms(old, repeats=20)
        plain_ms = cuda_time_ms(lambda: temporal.temporal_accumulate(
            gi, hi, params=unbounded), repeats=3)
        phase(3, f"K3 unbounded, {label}: bit-equal to KGp + KG + the plain "
                 f"epilogue; {ms:.4f} ms, that route {old_ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms")


def check_k16(P, results):
    """K16, the fused step's adjoint, on phase 3's input (K3's): bit-equal
    to its plain twin, with the cotangents of integrated and variance (the
    training step's; the new moments take none there)."""
    g = GBuffer(render=P["color"], albedo=P["color"], normal=P["normal"],
                depth=P["depth"], motion=P["motion"])
    h = History(color=P["h_color"], moments=P["h_moments"],
                length=P["h_length"], prev_depth=P["depth"],
                prev_normal=P["normal"])
    params = SVGFParams()
    with torch.no_grad():
        _, _, nh = temporal_accumulate_cuda(g, h, params=params)
    gen = torch.Generator(g.device).manual_seed(16)
    gi = torch.randn(P["color"].shape, generator=gen, device=g.device)
    gv = torch.randn(P["depth"].shape, generator=gen, device=g.device)

    def run(fn):
        return lambda: fn(g, h, nh.moments, nh.length, gi, gv, None,
                          params=params)

    got = run(temporal_bwd_cuda)()
    want = temporal.temporal_step_bwd_ref(g, h, nh.moments, nh.length, gi,
                                          gv, None, params)
    if not torch.equal(got, want):
        raise AssertionError(f"K16 != its twin at {int((got != want).sum())}"
                             f" elements (max |diff| {max_err(got, want)})")
    ms = cuda_time_ms(run(temporal_bwd_cuda), repeats=20)
    plain_ms = cuda_time_ms(lambda: temporal.temporal_step_bwd_ref(
        g, h, nh.moments, nh.length, gi, gv, None, params), repeats=3)
    HW = g.depth.numel()
    # read once: render 12, motion 8, depth 4, normal 12, the 8 history
    # planes the validity and clamp read 32, n_new 4, moments 8, the
    # cotangents 16; written: d_render 12; ~400 operations a pixel
    results["K16"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                          bytes=108 * HW, flops=400 * HW)
    b_ms, b_by = bound(108 * HW, 400 * HW)
    phase(3, f"K16: ok, bit-equal to its twin, {ms:.4f} ms ({b_ms / ms:.2f} "
             f"of its bound {b_ms:.4f} ms, {b_by}), plain {plain_ms:.4f} ms")


def _grid(motion):
    """``grid_sample`` coordinates of p + motion (align_corners=True)."""
    H, W = motion.shape[-2:]
    iy = torch.arange(H, device=motion.device, dtype=torch.float32)[:, None]
    ix = torch.arange(W, device=motion.device, dtype=torch.float32)[None, :]
    gx = (ix + motion[1]) * (2.0 / (W - 1)) - 1.0
    gy = (iy + motion[0]) * (2.0 / (H - 1)) - 1.0
    return torch.stack([gx, gy], -1)[None]


def _time_k4_k5_k6(stack, motion, g, repeats=20):
    """(K4, K5, K6) ms a launch on one input, CUDA events."""
    return (cuda_time_ms(lambda: gather_cuda(stack, motion, M),
                         repeats=repeats),
            cuda_time_ms(lambda: gather_bwd_cuda(stack, motion, g, M,
                                                 grad_planes=6),
                         repeats=repeats),
            cuda_time_ms(lambda: gather_bwd_hist_cuda(motion, g, M,
                                                      grad_planes=6),
                         repeats=repeats))


def check_k4_k5_k6(P, results):
    """K4, K5 and K6 against their twins on random (±7 px: some pixels
    beyond max_motion), integer and zero motion and on the served frame's
    (the camera's, coherent), K5's and K6's history gradient the same on a
    second launch; timed on the random and the served input."""
    dev = P["color"].device
    H, W = P["depth"].shape
    HW = H * W
    rng = np.random.default_rng(4)
    stack = torch.cat([P["h_color"], P["h_moments"], P["h_length"][None],
                       P["depth"][None], P["normal"]]).contiguous()
    g = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    rand = (rng.random((2, H, W)) - 0.5) * 2 * (M + 1)   # some beyond M
    served = gather_inputs(H, W, dev, "served")
    inputs = {kind: (stack, torch.from_numpy(m.astype(np.float32)).to(dev),
                     g)
              for kind, m in (("random", rand), ("integer", np.round(rand)),
                              ("zero", np.zeros((2, H, W))))}
    inputs["served"] = served
    tol = dict(atol=1e-6, rtol=1e-5)
    errs = [0.0, 0.0, 0.0]
    for kind, (st, motion, cot) in inputs.items():
        a, b = gather_cuda(st, motion, M), temporal.gather_ref(st, motion, M)
        check_close(f"K4 {kind}", a, b, **tol)
        errs[0] = max(errs[0], max_err(a, b))
        k5 = gather_bwd_cuda(st, motion, cot, M, grad_planes=6)
        want = temporal.gather_bwd_ref(st, motion, cot, M, motion_grad=True,
                                       grad_planes=6)
        for name, a, b in zip(("d_hist", "d_motion"), k5, want):
            check_close(f"K5 {kind} {name}", a, b, **tol)
        errs[1] = max(errs[1], max(max_err(a, b) for a, b in zip(k5, want)))
        k6 = gather_bwd_hist_cuda(motion, cot, M, grad_planes=6)
        check_close(f"K6 {kind} d_hist", k6[0], want[0], **tol)
        errs[2] = max(errs[2], max_err(k6[0], want[0]))
        if float(k6[1].abs().max()) != 0.0:
            raise AssertionError("K6: nonzero d_motion")
        again = (gather_bwd_cuda(st, motion, cot, M, grad_planes=6)[0],
                 gather_bwd_hist_cuda(motion, cot, M, grad_planes=6)[0])
        if not (torch.equal(again[0], k5[0]) and torch.equal(again[1],
                                                             k6[0])):
            raise AssertionError(f"K5/K6 {kind}: d_hist differs between "
                                 f"two launches")
    motion = inputs["random"][1]
    inside = ((motion[0].abs() <= M) & (motion[1].abs() <= M)).float().mean()
    # a within pixel reads its <= 4 taps; count the pixels this input has
    frac = float(inside)
    ms4, ms5, ms6 = _time_k4_k5_k6(stack, motion, g)
    served_ms = _time_k4_k5_k6(*served)
    plain4 = cuda_time_ms(lambda: temporal.gather_ref(stack, motion, M),
                          repeats=3)
    plain5 = cuda_time_ms(lambda: temporal.gather_bwd_ref(
        stack, motion, g, M, motion_grad=True, grad_planes=6), repeats=3)
    plain6 = cuda_time_ms(lambda: temporal.gather_bwd_ref(
        None, motion, g, M, motion_grad=False, grad_planes=6), repeats=3)
    # library yardstick: bilinear grid_sample with zero padding
    x = stack[None].clone().requires_grad_()
    grid = _grid(motion).requires_grad_()
    lib4 = cuda_time_ms(lambda: F.grid_sample(
        x, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        repeats=20)
    lib5 = _grid_sample_bwd_ms(stack, motion, g, True, repeats=20)
    lib6 = _grid_sample_bwd_ms(stack, motion, g, False, repeats=20)
    results["K4"] = dict(max_abs_err=errs[0], ms=ms4, plain_ms=plain4,
                         library_ms=lib4, bytes=88 * HW,
                         flops=int(4 * (10 * 2 + 8) * frac * HW))
    results["K5"] = dict(max_abs_err=errs[1], ms=ms5, plain_ms=plain5,
                         library_ms=lib5, bytes=104 * HW,
                         flops=int((4 * 6 * 2 + 9 * (6 * 2 + 12))
                                   * frac * HW))
    results["K6"] = dict(max_abs_err=errs[2], ms=ms6, plain_ms=plain6,
                         library_ms=lib6, bytes=72 * HW,
                         flops=int(4 * 6 * 2 * frac * HW))
    phase(3, f"K4/K5/K6: ok on random, integer, zero and served motion "
             f"(K5/K6 d_hist repeatable), max |err| "
             f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}; random: K4 "
             f"{ms4:.4f} ms (plain {plain4:.4f}, grid_sample {lib4:.4f}); K5 "
             f"{ms5:.4f} ms (plain {plain5:.4f}, grid_sample bwd {lib5:.4f}); "
             f"K6 {ms6:.4f} ms (plain {plain6:.4f}, grid_sample bwd "
             f"input-only {lib6:.4f}); served frame: K4 {served_ms[0]:.4f}, "
             f"K5 {served_ms[1]:.4f}, K6 {served_ms[2]:.4f} ms")


def check_filters(P, results):
    """K10, K11 and K12 against their plain twins on the 1080p planes."""
    x = P["color"]
    HW = P["depth"].numel()

    def pool():
        return F.avg_pool2d(x[None], 5, stride=1, padding=2,
                            count_include_pad=False)[0]

    # K10 at the FILTER_TILED / apply_filter(AVERAGE) configuration (r2 d1)
    # and two deeper calls, whose levels run in one launch (bit for bit the
    # per-level launches); avg_pool2d computes the same function at depth 1
    check_close("avg_pool2d vs K10's twin", pool(),
                boxfilter.box_filter(x, radius=2, depth=1), atol=1e-6,
                rtol=1e-5)
    lib = cuda_time_ms(pool, repeats=20)
    errs, lines = [], []
    for r, depth in ((2, 1), (1, 3), (2, 3)):
        got = box_filter_cuda(x, radius=r, depth=depth)
        want = boxfilter.box_filter(x, radius=r, depth=depth)
        check_close(f"K10 r{r} d{depth}", got, want, atol=1e-6, rtol=1e-5)
        errs.append(max_err(got, want))
        one = x
        for _ in range(depth):
            one = box_filter_cuda(one, radius=r, depth=1)
        if not torch.equal(got, one):
            raise AssertionError(f"K10 r{r} d{depth}: not the per-level "
                                 f"launches' floats")

        def call():
            return box_filter_cuda(x, radius=r, depth=depth)

        ms = cuda_time_ms(call, repeats=20)
        dev = device_ms(call, 20)
        plain = cuda_time_ms(lambda: boxfilter.box_filter(
            x, radius=r, depth=depth), repeats=5)
        # 3 planes in, 3 out a call; the separable work, 2(2r + 1) adds
        # and a division an output a level
        flops = 3 * depth * (2 * (2 * r + 1) + 1) * HW
        b_ms, b_by = bound(24 * HW, flops)
        if (r, depth) == (2, 1):
            results["K10"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                  bytes=24 * HW, flops=flops)
        lines.append(f"r{r} d{depth} {ms:.4f} ms (device {dev:.4f}, "
                     f"launches {len(box_level_groups(r, depth))}), bound "
                     f"{b_ms:.4f} ({b_by}), plain {plain:.4f}")
    results["K10"]["max_abs_err"] = max(errs)
    phase(3, f"K10: ok (each deeper call the per-level launches' floats), "
             f"max |err| {max(errs):.3g}; " + "; ".join(lines)
             + f"; avg_pool2d r2 d1 {lib:.4f} ms")

    # K11: r2 sigma 2 at depth 1 and 2, one launch an iteration, its twin's
    # floats; the yardstick is one depthwise conv2d with the 2-D gaussian
    # (the numerator only: no border renormalisation), in full float32
    taps = torch.tensor(filters._gauss_taps(2, 2.0), device=x.device)
    w2 = (taps[:, None] * taps[None, :]).expand(3, 1, 5, 5).contiguous()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    lib = cuda_time_ms(lambda: F.conv2d(x[None], w2, padding=2, groups=3),
                       repeats=20)
    torch.backends.cudnn.allow_tf32 = tf32
    lines = []
    for depth in (1, 2):
        got = gaussian_filter_cuda(x, radius=2, sigma=2.0, depth=depth)
        want = filters.gaussian_filter(x, radius=2, sigma=2.0, depth=depth)
        if not torch.equal(got, want):
            raise AssertionError(f"K11 depth {depth}: not its twin's floats "
                                 f"(max |diff| {max_err(got, want):.3g})")

        def call():
            return gaussian_filter_cuda(x, radius=2, sigma=2.0, depth=depth)

        ms = cuda_time_ms(call, repeats=20)
        dev = device_ms(call, 20)
        plain = cuda_time_ms(lambda: filters.gaussian_filter(
            x, radius=2, sigma=2.0, depth=depth), repeats=5)
        # an iteration: 3 planes in, 3 out; two passes of 5 taps (a
        # product and two sums) and a division
        b_ms, b_by = bound(24 * HW * depth, 96 * HW * depth)
        if depth == 1:
            results["K11"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                  library_ms=lib, bytes=24 * HW,
                                  flops=96 * HW)
        lines.append(f"depth {depth} {ms:.4f} ms (device {dev:.4f}, "
                     f"launches {depth}), bound {b_ms:.4f} ({b_by}), plain "
                     f"{plain:.4f}")
    phase(3, "K11: ok (its twin's floats at depth 1 and 2); "
             + "; ".join(lines)
             + f"; depthwise conv2d (numerator only) {lib:.4f} ms")

    # K12 at FilterParams(CROSS): r2, sigma_n 128 (repeated squaring); r1
    # and r4 (the staged form's widest) checked and timed beside it
    p = FilterParams(type=FilterType.CROSS)
    albedo = P["h_color"]
    args = (x, albedo, P["normal"], P["depth"])
    got = cross_bilateral_cuda(*args, params=p)
    want = filters.cross_bilateral_filter(*args, params=p)
    check_close("K12", got, want, atol=5e-5)
    err = max_err(got, want)
    ms = cuda_time_ms(lambda: cross_bilateral_cuda(*args, params=p),
                      repeats=20)
    others = []
    for r in (1, 4):
        pr = dataclasses.replace(p, radius=r)
        got = cross_bilateral_cuda(*args, params=pr)
        want = filters.cross_bilateral_filter(*args, params=pr)
        check_close(f"K12 r{r}", got, want, atol=5e-5)
        kms = cuda_time_ms(lambda: cross_bilateral_cuda(*args, params=pr),
                           repeats=20)
        others.append(f"r{r} {kms:.4f} ms (max |err| "
                      f"{max_err(got, want):.3g})")
    plain = cuda_time_ms(lambda: filters.cross_bilateral_filter(
        *args, params=p), repeats=3)
    # colour, albedo, normal, depth in (40 B), colour out (12 B)
    results["K12"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bytes=52 * HW, flops=K12_TAP_FLOPS * 25 * HW)
    phase(3, f"K12: ok, max |err| {err:.3g}, {ms:.4f} ms, plain "
             f"{plain:.4f} ms; {', '.join(others)}")


def _wide_motion(base, Mw, kind):
    """Phase 3's random motion (±7 px), scaled to ±(Mw + 1) ("wide"), or
    with the sink at the frame's middle (every source of the (2Mw + 1)^2
    window around it anchored there)."""
    if kind == "wide":
        return base * ((Mw + 1.0) / 7.0)
    if kind == "sink":
        return sink_motion(base, Mw)
    return base


def _grid_sample_bwd_ms(stack, motion, g, both, repeats=10):
    """ms a call of ``grid_sample``'s backward (bilinear, zero padding) on
    ``motion``: the history's and the grid's gradients (``both``) or the
    history's."""
    x = stack[None].clone().requires_grad_()
    grid = _grid(motion).requires_grad_()
    y = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=True)
    wrt = (x, grid) if both else x
    return cuda_time_ms(lambda: torch.autograd.grad(
        y, wrt, g[None], retain_graph=True), repeats=repeats)


def check_wide_forms(P, results):
    """Phase 3's wide forms against their twins on the 1080p planes, each
    timed beside its bound: K5/K6 past max_motion 59 (the bucketed scatter)
    on each of ``WIDE_MOTIONS`` (random ±7 px, motion to ±(M + 1), the
    sink), repeated bit-equal, with ``grid_sample``'s backward on the same
    motion beside them, K5c/K6c on the canvas of the frame's lower right
    quarter tile, and the scatter route at phase 3's max_motion against the
    staged gather there (bit-equal, both timed); K10, K11 and K12 at radius
    17 and 24 and K10 and K11 at radius 90 and at 17 with depth 2 (K10 and
    K11 as a pass along y and one along x a level, the taps of K11 and K12
    in a device array; K12 past r 4 the rolling-row tile), with device
    time, ``avg_pool2d`` beside K10 and the depthwise ``conv2d`` numerator
    beside K11, and both routes of K10 and K11 at r 4, below their
    crossovers (:func:`check_filter_routes`); K10 and K11 bit-equal to their twins,
    K12 atol 5e-5, K5/K6 rtol 1e-5, atol 1e-6 (the sink's
    four texels, which sum tens of thousands of addends that the twin adds
    in another order, bit for bit to the float32 sums in the kernels'
    order).  The bounds count the separable work:
    2(2r + 1) adds and a division an output for K10, 6(2r + 1) operations
    and two divisions for K11."""
    dev = P["color"].device
    H, W = P["depth"].shape
    HW = H * W
    rng = np.random.default_rng(40)
    stack = torch.cat([P["h_color"], P["h_moments"], P["h_length"][None],
                       P["depth"][None], P["normal"]]).contiguous()
    g = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    base = torch.from_numpy(((rng.random((2, H, W)) - 0.5) * 14.0).astype(
        np.float32)).to(dev)
    tol = dict(atol=1e-6, rtol=1e-5)
    b5, _ = bound(104 * HW, 0)
    b6, _ = bound(72 * HW, 0)
    lines, errs = [], []
    for Mw, kind in WIDE_MOTIONS:
        motion = _wide_motion(base, Mw, kind)
        k5 = gather_bwd_cuda(stack, motion, g, Mw, grad_planes=6)
        want = temporal.gather_bwd_ref(stack, motion, g, Mw,
                                       motion_grad=True, grad_planes=6)
        k6 = gather_bwd_hist_cuda(motion, g, Mw, grad_planes=6)
        mask = None
        if kind == "sink":
            # its four texels sum the window's 66,049 sources, which the
            # twin adds in index_add_'s order: held bit for bit to the
            # float32 sums in the kernels' order instead
            texels = sink_texels(H, W)
            exact = torch.from_numpy(ordered_texel_sums(motion, g, Mw,
                                                        texels)).to(dev)
            mask = torch.ones((H, W), dtype=torch.bool, device=dev)
            for i, (qy, qx) in enumerate(texels):
                mask[qy, qx] = False
                for name, dh in (("K5", k5[0]), ("K6", k6[0])):
                    if not torch.equal(dh[:6, qy, qx], exact[i]):
                        raise AssertionError(
                            f"{name} M{Mw} sink texel {(qy, qx)}: not the "
                            f"float32 sum in the kernels' order")
        check_close(f"K5 M{Mw} {kind} d_hist", k5[0], want[0], mask=mask,
                    **tol)
        check_close(f"K5 M{Mw} {kind} d_motion", k5[1], want[1], **tol)
        check_close(f"K6 M{Mw} {kind}", k6[0], want[0], mask=mask, **tol)
        again = (gather_bwd_cuda(stack, motion, g, Mw, grad_planes=6),
                 gather_bwd_hist_cuda(motion, g, Mw, grad_planes=6))
        if not (all(torch.equal(a, b) for a, b in zip(again[0], k5))
                and torch.equal(again[1][0], k6[0])):
            raise AssertionError(f"K5/K6 M{Mw} {kind}: differs between "
                                 f"launches")
        err = max(max_err(k5[0], want[0], mask), max_err(k5[1], want[1]))
        errs.append(err)
        ms5 = cuda_time_ms(lambda: gather_bwd_cuda(
            stack, motion, g, Mw, grad_planes=6), repeats=5)
        ms6 = cuda_time_ms(lambda: gather_bwd_hist_cuda(
            motion, g, Mw, grad_planes=6), repeats=5)
        plain5 = cuda_time_ms(lambda: temporal.gather_bwd_ref(
            stack, motion, g, Mw, motion_grad=True, grad_planes=6),
            repeats=2)
        plain6 = cuda_time_ms(lambda: temporal.gather_bwd_ref(
            None, motion, g, Mw, motion_grad=False, grad_planes=6),
            repeats=2)
        lib5 = _grid_sample_bwd_ms(stack, motion, g, True)
        lib6 = _grid_sample_bwd_ms(stack, motion, g, False)
        lines.append(f"M{Mw} {kind}: max |err| {err:.3g}, K5 {ms5:.4f} ms "
                     f"(bound {b5:.4f}, plain {plain5:.4f}, grid_sample bwd "
                     f"{lib5:.4f}), K6 {ms6:.4f} ms (bound {b6:.4f}, plain "
                     f"{plain6:.4f}, grid_sample bwd input-only {lib6:.4f})")
        if (Mw, kind) == WIDE_REPORTED:
            results["K5w"] = dict(ms=ms5, plain_ms=plain5, library_ms=lib5,
                                  bytes=104 * HW, flops=0)
            results["K6w"] = dict(ms=ms6, plain_ms=plain6, library_ms=lib6,
                                  bytes=72 * HW, flops=0)
    results["K5w"]["max_abs_err"] = results["K6w"]["max_abs_err"] = max(
        errs)
    # the canvas forms on the lower right quarter tile
    th, tw = H // 2, W // 2
    tile = Tile((H - th, W - tw), (H, W))
    errs = []
    for Mw in WIDE_CANVAS_MOTIONS:
        motion = _wide_motion(base, Mw, "wide")
        canvas = frame_canvas(stack, tile, th, tw, Mw + 1)
        m_t, g_t = (x[..., H - th:, W - tw:].contiguous()
                    for x in (motion, g))
        k5c = gather_canvas_bwd_cuda(canvas, m_t, g_t, Mw, tile=tile,
                                     grad_planes=6)
        want = temporal.gather_bwd_ref(canvas, m_t, g_t, Mw, motion_grad=True,
                                       grad_planes=6, tile=tile)
        for name, a, b in zip(("d_canvas", "d_motion"), k5c, want):
            check_close(f"K5c M{Mw} {name}", a, b, **tol)
        k6c = gather_canvas_bwd_hist_cuda(m_t, g_t, Mw, tile=tile,
                                          canvas_shape=canvas.shape,
                                          grad_planes=6)
        check_close(f"K6c M{Mw}", k6c[0], want[0], **tol)
        errs.append(max(max_err(a, b) for a, b in zip(k5c, want)))
        ms5c = cuda_time_ms(lambda: gather_canvas_bwd_cuda(
            canvas, m_t, g_t, Mw, tile=tile, grad_planes=6), repeats=5)
        ms6c = cuda_time_ms(lambda: gather_canvas_bwd_hist_cuda(
            m_t, g_t, Mw, tile=tile, canvas_shape=canvas.shape,
            grad_planes=6), repeats=5)
        plain5c = cuda_time_ms(lambda: temporal.gather_bwd_ref(
            canvas, m_t, g_t, Mw, motion_grad=True, grad_planes=6,
            tile=tile), repeats=2)
        plain6c = cuda_time_ms(lambda: temporal.gather_bwd_ref(
            None, m_t, g_t, Mw, motion_grad=False, grad_planes=6,
            tile=tile, canvas_shape=canvas.shape), repeats=2)
        # grid_sample on the tile's centre (it has no canvas form)
        centre = canvas[:, Mw + 1:Mw + 1 + th, Mw + 1:Mw + 1 + tw]
        lib5c = _grid_sample_bwd_ms(centre.contiguous(), m_t, g_t, True)
        lib6c = _grid_sample_bwd_ms(centre.contiguous(), m_t, g_t, False)
        lines.append(f"K5c/K6c M{Mw} ±{Mw + 1} px quarter tile: K5c "
                     f"{ms5c:.4f} ms (plain {plain5c:.4f}, grid_sample bwd "
                     f"{lib5c:.4f}), K6c {ms6c:.4f} ms (plain "
                     f"{plain6c:.4f}, grid_sample bwd input-only "
                     f"{lib6c:.4f})")
        if Mw == WIDE_REPORTED[0]:
            # a quarter tile's sources: the bytes of a quarter frame
            results["K5cw"] = dict(ms=ms5c, plain_ms=plain5c,
                                   library_ms=lib5c, bytes=104 * th * tw,
                                   flops=0)
            results["K6cw"] = dict(ms=ms6c, plain_ms=plain6c,
                                   library_ms=lib6c, bytes=72 * th * tw,
                                   flops=0)
    results["K5cw"]["max_abs_err"] = results["K6cw"]["max_abs_err"] = max(
        errs)
    # the scatter route at phase 3's max_motion, where the wrappers take
    # the staged gather: the same floats; both timed
    for kind, (st, motion, cot) in (("random", (stack, base, g)),
                                    ("served", gather_inputs(H, W, dev,
                                                             "served"))):
        for k, mg in ((5, True), (6, False)):
            def run(scatter):
                return temporal_cuda._gather_bwd(
                    st if mg else None, motion, cot, M, mg, 6,
                    scatter=scatter)
            if not all(torch.equal(a, b)
                       for a, b in zip(run(False), run(True))):
                raise AssertionError(f"K{k} scatter route at M{M} {kind}: "
                                     f"not the staged gather's floats")
            staged = cuda_time_ms(lambda: run(False), repeats=10)
            scat = cuda_time_ms(lambda: run(True), repeats=10)
            lines.append(f"K{k} M{M} {kind}: scatter route {scat:.4f} ms, "
                         f"staged gather {staged:.4f} (bit-equal)")
    phase(3, "wide K5/K6 (the bucketed scatter past max_motion 59): ok, "
             "repeatable; " + "; ".join(lines))

    x = P["color"]
    albedo = P["h_color"]
    lines = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for r in WIDE_RADII + (WIDEST_RADIUS,):
        taps = 2 * r + 1
        for depth in (1, 2) if r == WIDE_RADII[0] else (1,):
            got = box_filter_cuda(x, radius=r, depth=depth)
            want = boxfilter.box_filter(x, radius=r, depth=depth)
            if depth == 1:
                box_twin = want
            if not torch.equal(got, want):
                raise AssertionError(f"K10 r{r} d{depth}: not its twin's "
                                     f"floats (max |diff| "
                                     f"{max_err(got, want):.3g})")
            got = gaussian_filter_cuda(x, radius=r, sigma=r / 2.0,
                                       depth=depth)
            want = filters.gaussian_filter(x, radius=r, sigma=r / 2.0,
                                           depth=depth)
            if not torch.equal(got, want):
                raise AssertionError(f"K11 r{r} d{depth}: not its twin's "
                                     f"floats (max |diff| "
                                     f"{max_err(got, want):.3g})")

        def pool():
            return F.avg_pool2d(x[None], taps, stride=1, padding=r,
                                count_include_pad=False)[0]

        if r in WIDE_RADII:
            # the same function (at r 90 its 32,761-term sums part from
            # the twin's two 1-D passes by more than this tolerance)
            check_close(f"avg_pool2d r{r} vs K10's twin", pool(), box_twin,
                        atol=1e-6, rtol=1e-5)
        ms10 = cuda_time_ms(lambda: box_filter_cuda(x, radius=r), repeats=5)
        dev10 = device_ms(lambda: box_filter_cuda(x, radius=r), 5)
        plain10 = cuda_time_ms(lambda: boxfilter.box_filter(x, radius=r),
                               repeats=2)
        lib10 = cuda_time_ms(pool, repeats=5)
        b10, by10 = bound(24 * HW, 3 * (2 * taps + 1) * HW)
        ms11 = cuda_time_ms(lambda: gaussian_filter_cuda(
            x, radius=r, sigma=r / 2.0), repeats=5)
        dev11 = device_ms(lambda: gaussian_filter_cuda(
            x, radius=r, sigma=r / 2.0), 5)
        plain11 = cuda_time_ms(lambda: filters.gaussian_filter(
            x, radius=r, sigma=r / 2.0), repeats=2)
        gt = torch.tensor(filters._gauss_taps(r, r / 2.0), device=dev)
        w2 = (gt[:, None] * gt[None, :]).expand(3, 1, taps, taps).contiguous()
        try:
            lib11_ms = cuda_time_ms(lambda: F.conv2d(
                x[None], w2, padding=r, groups=3), repeats=2)
            lib11 = f"{lib11_ms:.4f}"
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
            lib11_ms, lib11 = None, "not measured (out of memory)"
        b11, by11 = bound(24 * HW, 3 * (6 * taps + 2) * HW)
        if r == WIDE_RADII[0]:
            results["K10w"] = dict(max_abs_err=0.0, ms=ms10,
                                   plain_ms=plain10, library_ms=lib10,
                                   bytes=24 * HW,
                                   flops=3 * (2 * taps + 1) * HW)
            results["K11w"] = dict(max_abs_err=0.0, ms=ms11,
                                   plain_ms=plain11, library_ms=lib11_ms,
                                   bytes=24 * HW,
                                   flops=3 * (6 * taps + 2) * HW)
        line = (f"r{r}: K10 {ms10:.4f} ms (device {dev10:.4f}, bound "
                f"{b10:.4f} {by10}, plain {plain10:.4f}, avg_pool2d "
                f"{lib10:.4f}), K11 {ms11:.4f} ms (device {dev11:.4f}, bound "
                f"{b11:.4f} {by11}, plain {plain11:.4f}, depthwise conv2d "
                f"numerator {lib11})")
        if r == WIDE_RADII[0]:
            d10 = device_ms(lambda: box_filter_cuda(x, radius=r, depth=2), 5)
            d11 = device_ms(lambda: gaussian_filter_cuda(
                x, radius=r, sigma=r / 2.0, depth=2), 5)
            line += (f"; depth 2 (bit-equal to the twins): K10 device "
                     f"{d10:.4f} ms, K11 device {d11:.4f}")
        if r in WIDE_RADII:
            p = FilterParams(type=FilterType.CROSS, radius=r)
            args = (x, albedo, P["normal"], P["depth"])
            got = cross_bilateral_cuda(*args, params=p)
            want = filters.cross_bilateral_filter(*args, params=p)
            check_close(f"K12 r{r}", got, want, atol=5e-5)
            err12 = max_err(got, want)
            ms12 = cuda_time_ms(lambda: cross_bilateral_cuda(*args,
                                                             params=p),
                                repeats=3)
            b12, by12 = bound(52 * HW, K12_TAP_FLOPS * taps * taps * HW)
            line += (f", K12 {ms12:.4f} ms (bound {b12:.4f} {by12}; max "
                     f"|err| {err12:.3g})")
            if r == WIDE_RADII[-1]:
                plain12 = cuda_time_ms(lambda: filters.cross_bilateral_filter(
                    *args, params=p), repeats=1)
                line += f", K12's plain {plain12:.4f} ms"
                results["K12w"] = dict(max_abs_err=err12, ms=ms12,
                                       plain_ms=plain12, bytes=52 * HW,
                                       flops=K12_TAP_FLOPS * taps * taps * HW)
        lines.append(line)
    torch.backends.cudnn.allow_tf32 = tf32
    lines += check_filter_routes(x)
    phase(3, "wide K10/K11/K12 (K10 and K11 bit-equal to their twins as "
             "two 1-D passes a level past r 16, the taps in a device "
             "array; K12's rolling-row tile): ok; " + "; ".join(lines))


def check_filter_routes(x):
    """K10 and K11 on both routes, the 2-D body and the 1-D passes, at
    ``CROSSOVER_RADIUS`` and depth 1 and 2, device time in turns (2-D,
    passes, passes, 2-D): K11's routes bit-equal, K10's passes bit-equal
    to its twin and its 2-D body within rtol 1e-5, atol 1e-6."""
    lines = []
    for r in (CROSSOVER_RADIUS,):
        for depth in (1, 2):
            def box(passes):
                if passes:
                    return filters_cuda._separable(x, r, depth, None,
                                                   box_filter_cuda)
                return filters_cuda._box_launches(
                    x, r, box_level_groups(r, depth))

            def gauss(passes):
                if passes:
                    return filters_cuda._gaussian_passes(x, r, r / 2.0,
                                                         depth)
                return filters_cuda._gaussian_launches(x, r, r / 2.0, depth)

            if not torch.equal(box(True), boxfilter.box_filter(
                    x, radius=r, depth=depth)):
                raise AssertionError(f"K10 passes r{r} d{depth}: not its "
                                     f"twin's floats")
            check_close(f"K10 r{r} d{depth} 2-D body vs passes", box(False),
                        box(True), atol=1e-6, rtol=1e-5)
            if not torch.equal(gauss(False), gauss(True)):
                raise AssertionError(f"K11 r{r} d{depth}: its routes' "
                                     f"floats differ")
            times = {}
            for name, f in (("K10", box), ("K11", gauss)):
                ms = {False: [], True: []}
                for passes in (False, True, True, False):
                    ms[passes].append(device_ms(lambda: f(passes), 10))
                times[name] = ms
            lines.append(f"routes r{r} d{depth} (device ms, 2-D / passes, "
                         f"in turns): " + ", ".join(
                             f"{k} {' '.join(f'{t:.4f}' for t in v[False])}"
                             f" / {' '.join(f'{t:.4f}' for t in v[True])}"
                             for k, v in times.items()))
    return lines


def sdf_flops(scene):
    """Float operations of one scene SDF evaluation in K7/K8 (sphere 10,
    box 22, plane 6, plus one compare each)."""
    return (11 * scene.sphere_params.shape[0] + 23 * scene.box_params.shape[0]
            + 7 * scene.plane_params.shape[0])


def march_steps(scene, ro, rd, rm, t0=None):
    """(H, W) SDF evaluations of K7's march loop on these rays, each ray
    from ``t0`` (its cone seed; default 0) until it stops."""
    t = (torch.zeros(ro.shape[1:], device=ro.device) if t0 is None
         else t0.clone())
    steps = torch.zeros_like(t)
    alive = torch.ones_like(t, dtype=torch.bool)
    for _ in range(rm.max_steps):
        d = raymarch.sdf_scene(scene, ro + t[None] * rd, want_mat=False)
        steps += alive.float()
        alive = alive & (d > rm.hit_eps) & (t < rm.max_dist)
        if not bool(alive.any()):
            break
        t = t + torch.where(alive, d, torch.zeros_like(d))
    return steps


def cone_evals(scene, ro_c, rd_c, delta, base, rm):
    """SDF evaluations K15 makes on these cones (the fattened march)."""
    t = torch.zeros(ro_c.shape[1:], device=ro_c.device)
    steps = torch.zeros_like(t)
    alive = torch.ones_like(t, dtype=torch.bool)
    for _ in range(rm.max_steps):
        d = raymarch.sdf_scene(scene, ro_c + t[None] * rd_c, want_mat=False)
        steps += alive.float()
        margin = d - (rm.hit_eps + base) - t * delta
        alive = alive & (margin > 0.0) & (t < rm.max_dist)
        if not bool(alive.any()):
            break
        t = t + torch.where(alive, margin / (1.0 + delta),
                            torch.zeros_like(d))
    return float(steps.sum())


def lanes_busy(steps):
    """The share of SIMD lanes busy in a march of ``steps`` (H, W) SDF
    evaluations a pixel, run as K7/K8 run it: 16x8 blocks, so a warp is 16
    columns by 2 rows, and each warp steps as long as its longest lane."""
    pad = F.pad(steps, (0, (-steps.shape[1]) % 16, 0, (-steps.shape[0]) % 2))
    warps = pad.reshape(pad.shape[0] // 2, 2, pad.shape[1] // 16, 16)
    longest = warps.amax(dim=(1, 3))
    return float(steps.sum() / (32.0 * longest.sum())), float(longest.mean())


def shadow_evals(scene, p, n, light_p, hit, rm):
    """SDF evaluations of K8's shadow march on these inputs."""
    return float(shadow_steps(scene, p, n, light_p, hit, rm)[0].sum())


def shadow_steps(scene, p, n, light_p, hit, rm):
    """(H, W) SDF evaluations of K8's shadow march on these inputs, and
    whether each march ran to the ``shadow_steps`` cap."""
    origin = p + 0.02 * n
    to_l = light_p - origin
    dist_l = torch.sqrt((to_l * to_l).sum(0))
    ld = to_l / torch.clamp(dist_l, min=1e-8)[None]
    dist_l = torch.where(hit, dist_l, torch.zeros_like(dist_l))
    t = torch.zeros_like(dist_l)
    steps = torch.zeros_like(t)
    alive = torch.ones_like(t, dtype=torch.bool)
    for _ in range(rm.shadow_steps):
        d = raymarch.sdf_scene(scene, origin + t[None] * ld, want_mat=False)
        steps += alive.float()
        alive = alive & (d > rm.hit_eps) & (t < dist_l - 0.02)
        if not bool(alive.any()):
            break
        t = t + torch.where(alive, torch.clamp(d, min=0.01),
                            torch.zeros_like(d))
    return steps, alive


def check_k7(scene, label, ro, rd, rm, time_plain=False):
    """K7 on ``scene`` against its plain twin (t atol 1e-4, normal atol
    5e-4 rtol 5e-3, outside hit or material flips on an ulp: an exact tie
    between two primitives, at most 0.1 % of the frame), timed; prints the
    instantiation that ran (``scene_key``) and returns the plain outputs
    and the result entry."""
    before = dict(march_gbuf_cuda.by_key)
    got = march_gbuf_cuda(scene, ro, rd, rm)
    key = [k for k, v in march_gbuf_cuda.by_key.items()
           if v != before.get(k, 0)]
    want = raymarch.march_gbuf(scene, ro, rd, rm)
    same = (got[1] == want[1]) & (got[2] == want[2])
    if float((~same).float().mean()) > 1e-3:
        raise AssertionError(f"K7 {label}: {int((~same).sum())} hit/material "
                             f"flips")
    check_close(f"K7 {label} t", got[0], want[0], atol=1e-4, mask=same)
    check_close(f"K7 {label} normal", got[3], want[3], atol=5e-4, rtol=5e-3,
                mask=same)
    err7 = max(max_err(got[0], want[0], same), max_err(got[3], want[3], same))
    ms = cuda_time_ms(lambda: march_gbuf_cuda(scene, ro, rd, rm), repeats=10)
    plain_ms = (cuda_time_ms(lambda: raymarch.march_gbuf(scene, ro, rd, rm),
                             repeats=2) if time_plain else None)
    HW = ro[0].numel()
    steps = march_steps(scene, ro, rd, rm)
    busy, longest = lanes_busy(steps)
    counts = tuple(x.shape[0] for x in (scene.sphere_params,
                                        scene.box_params, scene.plane_params))
    plain_txt = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
    phase(3, f"K7 {label}: ok, instantiation key {key} (counts {counts}), "
             f"{int((~same).sum())} flips, max |err| {err7:.3g}, {ms:.4f} "
             f"ms{plain_txt}; march loop {float(steps.mean()):.2f} SDF "
             f"evaluations a pixel, {longest:.2f} for a warp's longest lane "
             f"({busy:.3f} of the lanes busy)")
    # ro, rd in; t, hit (1 byte), material, normal out
    return want, dict(max_abs_err=err7, ms=ms, plain_ms=plain_ms,
                      bytes=45 * HW,
                      flops=float((steps + 7.0).sum()) * sdf_flops(scene)
                      + 20 * HW)


def check_k7_k8(H, W, dev, results):
    scene = raymarch.cornell_scene(device=dev)
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev), cfg)
    want, results["K7"] = check_k7(scene, "cornell", ro, rd, rm,
                                   time_plain=True)

    # K8 on the plain march's outputs, so both versions see one input
    t, hit, mat, n = want
    p = ro + t[None] * rd
    alb, em = raymarch._material_lookup(mat, scene.materials.albedo,
                                        scene.materials.emission)
    hit_f = hit.float()[None]
    alb, em = alb * hit_f, em * hit_f
    lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(0),
                               (H, W))
    light = raymarch.light_constants(scene)
    prev = raymarch.prev_camera_constants(orbit_camera(0.1875, device=dev),
                                          cfg)
    args = (scene, p, n, lp, alb, em, hit, light, prev, rm, (W, H))
    results["K8"] = check_k8(args, "cornell", rtol=0.0)
    # the random scene: K8's other compiled instantiation, on its own march;
    # its bodies next to the light render up to ~1e3, where the plain
    # twin's reciprocal multiply by 1/pi (PyTorch on CUDA divides by a
    # Python scalar so) and the kernel's division differ by an ulp or two
    # (2.4e-4 at two pixels of 1080p): rtol 1e-6 beside atol 1e-4
    scene = raymarch.random_scene(seed=3, device=dev)
    (t, hit, mat, n), _ = check_k7(scene, "random", ro, rd, rm)
    # K7's runtime-count instantiation: a scene of other counts
    check_k7(raymarch.random_scene(n_spheres=7, n_boxes=4, seed=5,
                                   device=dev), "odd counts", ro, rd, rm)
    alb, em = raymarch._material_lookup(mat, scene.materials.albedo,
                                        scene.materials.emission)
    hit_f = hit.float()[None]
    lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(0),
                               (H, W))
    check_k8((scene, ro + t[None] * rd, n, lp, alb * hit_f, em * hit_f, hit,
              raymarch.light_constants(scene), prev, rm, (W, H)), "random",
             rtol=1e-6)


def check_k8(args, label, rtol):
    """K8 on ``args`` against its plain twin (render atol 1e-4 and
    ``rtol`` outside visibility flips, at most 0.1 %; motion atol 1e-4),
    timed; prints the instantiation that ran (``scene_key``) and
    returns the result entry."""
    scene, p, n, lp, alb, em, hit, light, prev, rm, _ = args
    before = dict(shadow_shade_cuda.by_key)
    got = shadow_shade_cuda(*args)
    key = [k for k, v in shadow_shade_cuda.by_key.items()
           if v != before.get(k, 0)]
    want = raymarch.shadow_shade(*args)
    same = got[1] == want[1]            # visibility flips, as K7's
    if float((~same).float().mean()) > 1e-3:
        raise AssertionError(f"K8 {label}: {int((~same).sum())} visibility "
                             f"flips")
    check_close(f"K8 {label} render", got[0], want[0], atol=1e-4, rtol=rtol,
                mask=same)
    check_close(f"K8 {label} motion", got[2], want[2], atol=1e-4)
    err8 = max(max_err(got[0], want[0], same), max_err(got[2], want[2]))
    ms = cuda_time_ms(lambda: shadow_shade_cuda(*args), repeats=10)
    plain_ms = cuda_time_ms(lambda: raymarch.shadow_shade(*args), repeats=2)
    HW = hit.numel()
    steps, capped = shadow_steps(scene, p, n, lp, hit, rm)
    evals = float(steps.sum())
    busy, longest = lanes_busy(steps)
    counts = tuple(x.shape[0] for x in (scene.sphere_params,
                                        scene.box_params, scene.plane_params))
    phase(3, f"K8 {label}: ok, instantiation key {key} (counts {counts}), "
             f"{int((~same).sum())} flips, max |err| {err8:.3g}, {ms:.4f} "
             f"ms, plain {plain_ms:.4f} ms; shadow march {evals / HW:.2f} "
             f"SDF evaluations a pixel, {longest:.2f} for a warp's longest "
             f"lane ({busy:.3f} of the lanes busy), "
             f"{100 * float(capped.float().mean()):.2f} % of the pixels at "
             f"the {rm.shadow_steps}-step cap")
    # p, n, light sample, albedo, emission, hit in; render, vis, motion out
    return dict(max_abs_err=err8, ms=ms, plain_ms=plain_ms, bytes=85 * HW,
                flops=evals * sdf_flops(scene) + 80 * HW)


def check_k13(H, W, dev, results):
    """K13 against its plain twin at 1080p on the hit points of both
    scenes (every pixel marches: K13 has no hit mask)."""
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    HW = H * W
    for name, scene in (("cornell", raymarch.cornell_scene(device=dev)),
                        ("random", raymarch.random_scene(device=dev))):
        ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev), cfg)
        t, _hit, _mat, n = march_gbuf_cuda(scene, ro, rd, rm)
        p = ro + t[None] * rd
        lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(2),
                                   (H, W))
        key = scene_key(scene)
        before = shadow_factor_cuda.by_key[key]
        got = shadow_factor_cuda(scene, p, n, lp, rm)
        if shadow_factor_cuda.by_key[key] != before + 1:
            raise AssertionError(f"K13 {name}: not counted under key {key}")
        want = raymarch.shadow_factor(scene, p, n, lp, rm)
        flips = int((got != want).sum())
        if flips > 1e-3 * HW:
            raise AssertionError(f"K13 {name}: {flips} visibility flips")
        ms = cuda_time_ms(lambda: shadow_factor_cuda(scene, p, n, lp, rm),
                          repeats=10)
        plain = cuda_time_ms(lambda: raymarch.shadow_factor(
            scene, p, n, lp, rm), repeats=2)
        phase(3, f"K13 {name}: ok, instantiation key {key}, {flips} flips, "
                 f"lit {float(got.mean()):.3f}"
                 f", {ms:.4f} ms, plain {plain:.4f} ms")
        if name == "cornell":
            # p, n, light sample in; vis out; the shadow march's SDF
            # evaluations on these inputs
            everywhere = torch.ones((H, W), dtype=torch.bool, device=dev)
            results["K13"] = dict(
                max_abs_err=float((got - want).abs().max()), ms=ms,
                plain_ms=plain, bytes=40 * HW,
                flops=shadow_evals(scene, p, n, lp, everywhere, rm)
                * sdf_flops(scene) + 20 * HW)


def check_cone_seed(H, W, dev, results):
    """K15 (from ray planes; from the camera at window origin (0, 0); on a
    quarter tile of 3840x2160 at (1080, 1920)) and the seeded K7 (given the
    camera's seed grid) against their plain twins on the same inputs at
    1080p, Cornell and ``random_scene``: atol 1e-4 as K7's t, the seeded
    K7's normal and flips as K7's.  The seeded march against the unseeded
    K7 by the CPU tests' properties: SDF at the seed >= 0.5·hit_eps, hit
    agreement > 99.8 %, p99 |Δt| < 2·hit_eps, seed <= t + 1e-5.  Cornell:
    the times of K7 unseeded and seeded, K15 alone and the seed passes
    with their glue, each bound by this run's SDF evaluations, and the
    mean march steps a pixel."""
    cfg = CameraParams(width=W, height=H)
    uhd = CameraParams(width=2 * W, height=2 * H)
    rm0, rm1 = RaymarchParams(), SEEDED
    HW = H * W
    cam = orbit_camera(0.25, device=dev)
    ro, rd, _ = raymarch.camera_rays(cam, cfg)
    for name, scene in (("cornell", raymarch.cornell_scene(device=dev)),
                        ("random", raymarch.random_scene(device=dev))):
        routes = {
            "planes": (raymarch.cone_rays(ro, rd), dict(ro=ro, rd=rd)),
            "camera": (raymarch.cone_rays_analytic(cam, cfg, 0, 0, H, W),
                       dict(camera=cam, cam_cfg=cfg, shape=(H, W))),
            "4K quarter tile": (
                raymarch.cone_rays_analytic(cam, uhd, H, W, H, W),
                dict(camera=cam, cam_cfg=uhd, window=(H, W), shape=(H, W)))}
        err15 = 0.0
        for route, (cones, kw) in routes.items():
            got = cone_seed_cuda(scene, rm1, **kw)
            want = raymarch.cone_march(scene, *cones, rm1)
            check_close(f"K15 {name} {route}", got[0], want, atol=1e-4)
            for a, b in zip(got[1:], cones[2:]):
                check_close(f"K15 {name} {route} delta/base", a, b, atol=0.0)
            err15 = max(err15, max_err(got[0], want))
        t_c = cone_seed_cuda(scene, rm1, camera=cam, cam_cfg=cfg,
                             shape=(H, W))[0]
        before = dict(march_gbuf_seeded_cuda.by_key)
        got = march_gbuf_seeded_cuda(scene, ro, rd, t_c, rm1)
        key = [k for k, v in march_gbuf_seeded_cuda.by_key.items()
               if v != before.get(k, 0)]
        want = raymarch.march_gbuf(scene, ro, rd, rm1, seed=t_c)
        same = (got[1] == want[1]) & (got[2] == want[2])
        if float((~same).float().mean()) > 1e-3:
            raise AssertionError(f"K7s {name}: {int((~same).sum())} flips")
        check_close(f"K7s {name} t", got[0], want[0], atol=1e-4, mask=same)
        check_close(f"K7s {name} normal", got[3], want[3], atol=5e-4,
                    rtol=5e-3, mask=same)
        err7s = max(max_err(got[0], want[0], same),
                    max_err(got[3], want[3], same))
        # the seeded march against the unseeded K7
        seed = raymarch.seed_plane(t_c, H, W)
        d_at = raymarch.sdf_scene(scene, ro + seed[None] * rd,
                                  want_mat=False)
        live = seed < rm1.max_dist
        clear = float(d_at[live].min()) / rm1.hit_eps
        t0, h0, _m0, _n0 = march_gbuf_cuda(scene, ro, rd, rm0)
        agree = float((h0 == got[1]).float().mean())
        both = h0 & got[1]
        p99 = float(torch.quantile((t0 - got[0]).abs()[both][::7], 0.99))
        overshoot = float((seed - got[0]).max())
        if (clear < 0.5 or agree <= 0.998 or p99 >= 2 * rm1.hit_eps
                or overshoot > 1e-5):
            raise AssertionError(
                f"seeded march {name}: SDF at the seed {clear:.3g}·hit_eps,"
                f" hit agreement {agree:.5f}, p99 |Δt| {p99:.3g}, seed - t "
                f"{overshoot:.3g}")
        steps0 = march_steps(scene, ro, rd, rm0)
        steps1 = march_steps(scene, ro, rd, rm1, seed)
        phase(3, f"K15 {name}: planes, camera, 4K quarter tile ok, max "
                 f"|err| {err15:.3g}, delta "
                 f"{float(cone_seed_cuda(scene, rm1, ro=ro, rd=rd)[1]):.5f} "
                 f"(planes) / {float(routes['camera'][0][2]):.5f} (camera); "
                 f"K7s: ok, instantiation key {key}, "
                 f"{int((~same).sum())} flips, max |err| "
                 f"{err7s:.3g}; seeded vs unseeded: SDF at the seed >= "
                 f"{clear:.3g}·hit_eps, hits agree {agree:.5f}, p99 |Δt| "
                 f"{p99:.3g}, max(seed - t) {overshoot:.3g}; march steps a "
                 f"pixel {float(steps0.mean()):.3f} unseeded, "
                 f"{float(steps1.mean()):.3f} seeded")
        if name != "cornell":
            continue
        cones = routes["camera"][0]
        cells = cones[0].shape[1] * cones[0].shape[2]
        ms7 = cuda_time_ms(lambda: march_gbuf_cuda(scene, ro, rd, rm0),
                           repeats=20)
        ms7s = cuda_time_ms(lambda: march_gbuf_seeded_cuda(
            scene, ro, rd, t_c, rm1), repeats=20)
        ms15 = cuda_time_ms(lambda: cone_launch(scene, *cones, rm1),
                            repeats=20)
        pass_cam = cuda_time_ms(lambda: cone_seed_cuda(
            scene, rm1, camera=cam, cam_cfg=cfg, shape=(H, W)), repeats=20)
        pass_planes = cuda_time_ms(lambda: cone_seed_cuda(
            scene, rm1, ro=ro, rd=rd), repeats=20)
        march_seeded = cuda_time_ms(lambda: march_gbuf_cuda(
            scene, ro, rd, rm1, camera=cam, cam_cfg=cfg), repeats=20)
        plain15 = cuda_time_ms(lambda: raymarch.cone_march(scene, *cones,
                                                           rm1), repeats=3)
        plain7s = cuda_time_ms(lambda: raymarch.march_gbuf(
            scene, ro, rd, rm1, seed=t_c), repeats=2)
        sdf = sdf_flops(scene)
        evals0 = float((steps0 + 7.0).sum())
        evals1 = float((steps1 + 7.0).sum())
        evals15 = cone_evals(scene, *cones, rm1)
        # K15: six cone planes in, the stops out; K7s as K7 and the seeds
        results["K15"] = dict(max_abs_err=err15, ms=ms15, plain_ms=plain15,
                              bytes=28 * cells, flops=evals15 * sdf
                              + 20 * cells)
        results["K7s"] = dict(max_abs_err=err7s, ms=ms7s, plain_ms=plain7s,
                              bytes=45 * HW + 4 * cells,
                              flops=evals1 * sdf + 20 * HW)
        b7 = bound(45 * HW, evals0 * sdf + 20 * HW)
        b7s = bound(45 * HW + 4 * cells, evals1 * sdf + 20 * HW)
        b15 = bound(28 * cells, evals15 * sdf + 20 * cells)
        phase(3, f"seed timing cornell {W}x{H}: K7 unseeded {ms7:.4f} ms "
                 f"(bound {b7[0]:.4f}, {evals0 / HW:.3f} SDF evaluations a "
                 f"pixel), K7 seeded {ms7s:.4f} ms (bound {b7s[0]:.4f}, "
                 f"{evals1 / HW:.3f}), K15 alone {ms15:.4f} ms (bound "
                 f"{b15[0]:.4f}, {evals15 / cells:.3f} a cell, {cells} "
                 f"cells), seed pass {pass_cam:.4f} ms from the camera "
                 f"(K15's two launches), {pass_planes:.4f} ms from the "
                 f"planes (PyTorch's cones + K15); seeded march_gbuf_cuda "
                 f"(camera seed + K7s) {march_seeded:.4f} ms against the "
                 f"unseeded K7's {ms7:.4f} ({march_seeded / ms7:.3f}x); "
                 f"plain K15 {plain15:.4f}, plain seeded K7 {plain7s:.4f}")


def check_cone_seed_uhd(H, W, dev):
    """K15 from the camera (window origin (0, 0)) and the seeded K7 on whole
    3840x2160 frames, the shapes phases 11(e) and (f) give them on the (1,
    1, 1) mesh (K15 on 540x960 cells), against their plain twins on the same
    inputs, with phase 3's tolerances (K15 atol 1e-4, delta and base exact;
    K7s t atol 1e-4, normal atol 5e-4 rtol 5e-3, at most 0.1 % hit or
    material flips), at 11(e)'s first camera and 11(f)'s."""
    cfg = CameraParams(width=W, height=H)
    scene = raymarch.cornell_scene(device=dev)
    err15 = err7s = 0.0
    flips = []
    for name, cam in (("orbit frame 0", orbit_camera(0.0, device=dev)),
                      ("Cornell camera", raymarch.cornell_camera(device=dev))):
        cones = raymarch.cone_rays_analytic(cam, cfg, 0, 0, H, W)
        got = cone_seed_cuda(scene, SEEDED, camera=cam, cam_cfg=cfg,
                             shape=(H, W))
        want = raymarch.cone_march(scene, *cones, SEEDED)
        check_close(f"K15 {W}x{H} {name}", got[0], want, atol=1e-4)
        for a, b in zip(got[1:], cones[2:]):
            check_close(f"K15 {W}x{H} {name} delta/base", a, b, atol=0.0)
        err15 = max(err15, max_err(got[0], want))
        t_c, cells = got[0], got[0].numel()
        ro, rd, _ = raymarch.camera_rays(cam, cfg)
        got = march_gbuf_seeded_cuda(scene, ro, rd, t_c, SEEDED)
        want = raymarch.march_gbuf(scene, ro, rd, SEEDED, seed=t_c)
        same = (got[1] == want[1]) & (got[2] == want[2])
        flips.append(int((~same).sum()))
        if flips[-1] > 1e-3 * H * W:
            raise AssertionError(f"K7s {W}x{H} {name}: {flips[-1]} flips")
        check_close(f"K7s {W}x{H} {name} t", got[0], want[0], atol=1e-4,
                    mask=same)
        check_close(f"K7s {W}x{H} {name} normal", got[3], want[3],
                    atol=5e-4, rtol=5e-3, mask=same)
        err7s = max(err7s, max_err(got[0], want[0], same),
                    max_err(got[3], want[3], same))
        del ro, rd, got, want, same
    phase(10, f"(a) for 11(e), (f): K15 ({cells} cells) and K7s on whole "
              f"{W}x{H} frames, orbit frame 0 and the Cornell camera, against "
              f"their plain twins: ok, K15 max |err| {err15:.3g}, K7s max "
              f"|err| {err7s:.3g}, flips {flips}")


def channel_minor(stack):
    """The (10, H, W) stack laid out channel-minor by KGp (strides (1,
    10·W, 10)), as the main paths stack the history on the card."""
    return history_stack_channel_minor_cuda(temporal.history_from_stack(
        stack))


def check_clamped_gather(H, W, dev, results):
    """The clamped gather (KG) and its adjoint (KGb) at 1080p against the
    plain twin (under autograd, float64 for the adjoint: its atomics add in
    no fixed order; at the kernel's float32 coordinates p + motion, since
    float64 ones move the bilinear fractions by an ulp of a coordinate),
    motion out to ±28 pixels (taps clamp at the border): rtol 1e-5, atol
    1e-6 (·max for the adjoint); the cotangent on the training path's 6
    planes; the stack channel-minor (the main paths' layout), which KGp
    builds bit for bit as its plain twin does, and planar (the wrappers
    lay it out with KGp: the same values, d_motion bit for bit).  The
    kernels are timed on the channel-minor stack of phase 3's input and of
    a served frame's (the ninth orbit frame with ``max_motion=None``), and
    KGb is split into its memsets, scatter and rounding pass by the
    profiler."""
    stack, motion, g = clamped_inputs(H, W, dev)
    hist = temporal.history_from_stack(stack)
    cm = history_stack_channel_minor_cuda(hist)
    want_p = temporal.history_stack_channel_minor(hist)
    if cm.stride() != want_p.stride() or not torch.equal(cm, want_p):
        raise AssertionError("KGp: not its plain twin's stack")
    want = temporal.bilinear_gather_clamped(stack, motion)
    err = 0.0
    for layout, s in (("planar", stack), ("channel-minor", cm)):
        got = clamped_gather_cuda(s, motion)
        check_close(f"KG {layout}", got, want, atol=1e-6, rtol=1e-5)
        err = max(err, max_err(got, want))
    iy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    ix = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    s64 = stack.double().requires_grad_()
    m64 = torch.stack([(iy + motion[0]).double() - iy.double(),
                       (ix + motion[1]).double() - ix.double()]
                      ).requires_grad_()
    want_b = torch.autograd.grad(temporal.bilinear_gather_clamped(s64, m64),
                                 (s64, m64), g.double())
    err_b, got_b = 0.0, {}
    for layout, s in (("planar", stack), ("channel-minor", cm)):
        got_b[layout] = clamped_gather_bwd_cuda(s, motion, g)
        for name, a, b in zip(("d_stack", "d_motion"), got_b[layout],
                              want_b):
            check_close(f"KGb {layout} {name}", a, b,
                        atol=1e-6 * float(b.abs().max()), rtol=1e-5)
        err_b = max(err_b, *(max_err(a, b)
                             for a, b in zip(got_b[layout], want_b)))
    if not torch.equal(got_b["planar"][1], got_b["channel-minor"][1]):
        raise AssertionError("KGb d_motion depends on the stack's layout")
    del s64, m64, want_b, got_b
    ins = {"±28 px": (cm, motion, g),
           "served frame": served_clamped_inputs(H, W, dev)}
    ins["served frame"] = (channel_minor(ins["served frame"][0]),
                           *ins["served frame"][1:])
    ms = {}
    for label, (s, m, gg) in ins.items():
        ms["KG", label] = cuda_time_ms(lambda: clamped_gather_cuda(s, m),
                                       repeats=20)
        ms["KGb", label] = cuda_time_ms(
            lambda: clamped_gather_bwd_cuda(s, m, gg), repeats=20)
    plain = cuda_time_ms(lambda: temporal.bilinear_gather_clamped(
        stack, motion), repeats=3)
    s, m = (t.clone().requires_grad_() for t in (stack, motion))
    out = temporal.bilinear_gather_clamped(s, m)
    plain_b = cuda_time_ms(lambda: torch.autograd.grad(
        out, (s, m), g, retain_graph=True), repeats=3)
    ms_p = cuda_time_ms(lambda: history_stack_channel_minor_cuda(hist),
                        repeats=20)
    plain_p = cuda_time_ms(lambda: temporal.history_stack_channel_minor(
        hist), repeats=20)
    # the one PyTorch call that builds the same stack: a stack along the
    # last axis of the ten planes
    planes = stack.unbind(0)
    lib_p = cuda_time_ms(lambda: torch.stack(planes, dim=-1), repeats=20)
    HW = H * W
    # KG: 10 planes and the motion in, 10 out, ~4 multiply-adds a plane;
    # KGb: motion, 6 cotangent and 6 history planes in, 6 gradients and
    # the motion's out, ~20 operations a plane; KGp: 10 planes in and out;
    # timed on phase 3's input
    results["KG"] = dict(max_abs_err=err, ms=ms["KG", "±28 px"],
                         plain_ms=plain, bytes=88 * HW,
                         flops=(10 * 6 + 20) * HW)
    results["KGb"] = dict(max_abs_err=err_b, ms=ms["KGb", "±28 px"],
                          plain_ms=plain_b, bytes=88 * HW,
                          flops=(6 * 20 + 20) * HW)
    results["KGp"] = dict(max_abs_err=max_err(cm, want_p), ms=ms_p,
                          plain_ms=plain_p, library_ms=lib_p, bytes=80 * HW,
                          flops=0)
    phase(3, f"KG: ok (both layouts), max |err| {err:.3g}, plain "
             f"{plain:.4f} ms; KGb: ok (float64 twin, d_motion the same "
             f"on both layouts), max |err| {err_b:.3g}, plain (autograd) "
             f"{plain_b:.4f} ms; KGp: bit-equal, {ms_p:.4f} ms, plain "
             f"{plain_p:.4f} ms, torch.stack {lib_p:.4f} ms")
    for (k, label), t in ms.items():
        phase(3, f"{k} {label}: {t:.4f} ms")
    for label, (s, m, gg) in ins.items():
        split = dict(clamped_split(s, m, gg, 10))
        parts = ", ".join(f"{name[:40]} {t:.4f}" for name, t in sorted(
            split["KGb"].items(), key=lambda kv: -kv[1]))
        phase(3, f"KGb {label}, device ms a call by kernel (profiler): "
                 f"{parts}")


def reset_counts():
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_counts(n, expected):
    """The launch counts of a main path's run; fail if one of its kernels
    never launched."""
    counts = {k: w.launches for k, w in WRAPPERS.items()}
    missing = [k for k in expected if counts[k] == 0]
    if missing:
        raise AssertionError(f"phase {n}: kernels never launched on the "
                             f"main path: {missing}")
    return counts


def counted(fn, counts):
    """Run ``fn`` with every launch count set to 0 and add its launches
    to ``counts`` (a main path interleaved with its comparison runs)."""
    reset_counts()
    out = fn()
    for k, w in WRAPPERS.items():
        counts[k] += w.launches
    return out


def require_launched(n, counts, expected):
    missing = [k for k in expected if counts[k] == 0]
    if missing:
        raise AssertionError(f"phase {n}: kernels never launched on the "
                             f"main path: {missing}")
    return counts


def run_sequence(pipe, n_frames, H, W, dev, keep):
    """Render + denoise ``n_frames`` orbit frames; returns the per-frame
    device times (ms) and the first ``keep`` frames' G-buffers (with
    ``denoised``)."""
    gen = torch.Generator(dev).manual_seed(0)
    hist = History.zeros(H, W, device=dev)
    prev, times, kept = None, [], []
    for f in range(n_frames):
        cam = orbit_camera(f / SEQ_FRAMES, device=dev)
        with CudaTimer() as tm:
            out, hist = pipe(cam, prev, hist, gen)
        times.append(tm.ms)
        if not bool(torch.isfinite(out.denoised).all()):
            raise AssertionError(f"frame {f}: non-finite denoised values")
        if out.denoised.shape != (3, H, W):
            raise AssertionError(f"frame {f}: shape {out.denoised.shape}")
        if f < keep:
            kept.append(out)
        prev = cam
    return times, kept


def serving_phase(H, W, dev, n_frames, svgf=SERVING, n=4, label="",
                  expected=("K1", "K3", "K7", "K8")):
    """Phase 4's sequence through ``FramePipeline`` with ``svgf`` (phase
    11(c): unbounded motion), its first frames against the plain path at
    atol 1e-3·max."""
    scene = raymarch.cornell_scene(device=dev)
    pipe_cfg = dict(cam_cfg=CameraParams(width=W, height=H),
                    rm_params=RaymarchParams(), svgf_params=svgf,
                    weight_math=SERVING_WEIGHTS)
    kernel_pipe = FramePipeline(scene, impl="auto", **pipe_cfg)
    plain_pipe = FramePipeline(scene, impl="plain", **pipe_cfg)
    keep = min(CHECK_FRAMES, n_frames)
    reset_counts()
    times, kernel_frames = run_sequence(kernel_pipe, n_frames, H, W, dev,
                                        keep)
    counts = read_counts(n, expected)
    plain_times, plain_frames = run_sequence(plain_pipe, keep, H, W, dev,
                                             keep)
    for f, (a, b) in enumerate(zip(kernel_frames, plain_frames)):
        check_close(f"frame {f} denoised (kernel vs plain)", a.denoised,
                    b.denoised, atol=1e-3 * float(b.denoised.abs().max()))
    steady = times[1:] or times
    phase(n, f"{label}{n_frames} frames {W}x{H}: kernel path "
             f"{sum(times) / len(times):.3f} ms/frame (frames 2-{n_frames}:"
             f" {sum(steady) / len(steady):.3f}), plain path "
             f"{sum(plain_times) / len(plain_times):.3f} ms/frame over "
             f"{keep}; first {keep} frames match; launches {counts}")
    return counts


def compare_seeded(name, a, b, hit_eps):
    """A seeded frame ``a`` against the unseeded ``b`` (both G-buffers with
    ``denoised``): a seeded march stops elsewhere in the hit_eps shell, so
    at most 0.5 % of the pixels may flip their hit or material; on the
    others the depth's p99 |Δ| < 2·hit_eps and the denoised frame's p99 <
    2e-3·max (``tests/test_torch_sharded_train.py``'s bounds; its largest
    |Δ| is not bounded here: the denoiser spreads a flipped pixel's
    difference over its neighbours, and the history into later frames).
    Returns the flipped share, the depth p99, and the denoised p99 and
    largest |Δ| relative to the frame's max."""
    same = (a.albedo == b.albedo).all(0) & ((a.depth > 0) == (b.depth > 0))
    flips = float((~same).float().mean())
    dz = (a.depth - b.depth).abs()[same]
    dd = (a.denoised - b.denoised).abs().amax(0)[same]
    scale = float(b.denoised.abs().max())
    q = [float(torch.quantile(x[::11], 0.99)) for x in (dz, dd)]
    rel = float(dd.max()) / scale
    if flips > 5e-3 or q[0] >= 2 * hit_eps or q[1] >= 2e-3 * scale:
        raise AssertionError(
            f"{name}: seeded vs unseeded: flips {flips:.4%}, depth p99 "
            f"{q[0]:.3g}, denoised p99 {q[1] / scale:.3g}·max, max "
            f"{rel:.3g}·max")
    return dict(flips=flips, depth_p99=q[0], p99=q[1] / scale, max=rel)


def seeded_bounds_text(stats):
    """The worst of :func:`compare_seeded`'s readings over frames, with the
    bounds each was held to."""
    w = {k: max(s[k] for s in stats) for k in stats[0]}
    return (f"flips {w['flips']:.4%} (<= 0.5 %), depth p99 "
            f"{w['depth_p99']:.3g} (< 2·hit_eps), denoised p99 "
            f"{w['p99']:.3g}·max (< 2e-3), largest denoised |Δ| "
            f"{w['max']:.3g}·max (not bounded)")


def seeded_serving_phase(H, W, dev, n_frames):
    """11(a): phase 4's sequence with ``coarse_seed=True`` (K15 from the
    camera and the seeded K7 instead of K7), alternating with the unseeded
    pipeline (unseeded, seeded, unseeded, seeded); the seeded frames held
    to the unseeded ones by :func:`compare_seeded`."""
    scene = raymarch.cornell_scene(device=dev)
    kw = dict(cam_cfg=CameraParams(width=W, height=H), svgf_params=SERVING,
              weight_math=SERVING_WEIGHTS)
    pipes = {False: FramePipeline(scene, rm_params=RaymarchParams(), **kw),
             True: FramePipeline(scene, rm_params=SEEDED, **kw)}
    keep = min(CHECK_FRAMES, n_frames)
    counts = {k: 0 for k in WRAPPERS}
    times, frames = {False: [], True: []}, {}
    for seeded in (False, True, False, True):
        if seeded:
            t, frames[seeded] = counted(lambda: run_sequence(
                pipes[True], n_frames, H, W, dev, keep), counts)
        else:
            t, frames[seeded] = run_sequence(pipes[False], n_frames, H, W,
                                             dev, keep)
        times[seeded].append(t[1:] or t)
    require_launched(11, counts, ("K1", "K3", "K15", "K7s", "K8"))
    if counts["K7"]:
        raise AssertionError("phase 11: the seeded path launched K7")
    stats = [compare_seeded(f"serving frame {f}", a, b, SEEDED.hit_eps)
             for f, (a, b) in enumerate(zip(frames[True], frames[False]))]
    ms = {k: [sum(t) / len(t) for t in v] for k, v in times.items()}
    phase(11, f"(a) serving {W}x{H} with coarse_seed, {n_frames} frames "
              f"twice, frames 2-{n_frames}: seeded "
              f"{ms[True][0]:.3f} / {ms[True][1]:.3f} ms/frame against "
              f"unseeded {ms[False][0]:.3f} / {ms[False][1]:.3f}; first "
              f"{keep} frames against the unseeded ones within the seeded "
              f"bounds: {seeded_bounds_text(stats)}; launches {counts}")
    return counts


def run_train(step, state, n_steps, keep):
    """``n_steps`` train steps; returns per-step device ms, host ms, and
    (loss, albedo gradient, albedo) of the first ``keep``."""
    dev_ms, host_ms, kept = [], [], []
    for k in range(n_steps):
        t0 = time.perf_counter()
        with CudaTimer() as tm:
            state, loss = step(state)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(tm.ms)
        if not bool(torch.isfinite(loss)) or not bool(
                torch.isfinite(state.albedo.grad).all()):
            raise AssertionError(f"train step {k}: non-finite loss/gradient")
        if k < keep:
            kept.append((float(loss), state.albedo.grad.clone(),
                         state.albedo.detach().clone()))
    return state, dev_ms, host_ms, kept


def train_phase(H, W, dev):
    scene = raymarch.cornell_scene(device=dev)
    target = torch.from_numpy(np.random.default_rng(0).random(
        (3, H, W), dtype=np.float32)).to(dev)
    kw = dict(cam_cfg=CameraParams(width=W, height=H),
              rm_params=RaymarchParams(), svgf_params=TRAIN)
    cam = raymarch.cornell_camera(device=dev)
    runs = {}
    for impl in ("auto", "plain"):
        step = make_train_step(scene, cam, target, impl=impl, **kw)
        state = init_train_state(scene.materials.albedo, H, W,
                                 torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if impl == "auto":
            reset_counts()
            n = 1 + TRAIN_STEPS
        else:
            n = CHECK_STEPS
        state, dev_ms, host_ms, kept = run_train(step, state, n, CHECK_STEPS)
        peak = torch.cuda.max_memory_allocated() - base
        if impl == "auto":
            counts = read_counts(5, ("K1", "K2", "K3", "K16", "K7", "K8"))
            dev_ms, host_ms = dev_ms[1:], host_ms[1:]
        runs[impl] = (dev_ms, host_ms, kept, peak)
        del step, state
    for k, (a, b) in enumerate(zip(runs["auto"][2], runs["plain"][2])):
        if abs(a[0] - b[0]) > 1e-5 * abs(b[0]):
            raise AssertionError(f"train step {k}: loss {a[0]} vs plain "
                                 f"{b[0]}")
        # the kernel path's adjoint multiplies the bf16-stored weights
        check_close(f"train step {k} albedo gradient", a[1], b[1],
                    atol=3e-3 * float(b[1].abs().max()))
        check_close(f"train step {k} albedo", a[2], b[2], atol=1e-5)
    (kd, kh, kept, kpeak), (pd, ph, _, ppeak) = runs["auto"], runs["plain"]
    phase(5, f"train step {W}x{H} (config 4, r1, 5 levels, exact): kernel "
             f"path {sum(kd) / len(kd):.3f} ms/step device, "
             f"{sum(kh) / len(kh):.3f} ms/step host wall over {len(kd)} "
             f"steps (min {min(kd):.3f}, max {max(kd):.3f}), peak memory "
             f"{kpeak / 2**30:.3f} GiB; plain path {sum(pd) / len(pd):.3f} "
             f"ms/step over {len(pd)}, peak {ppeak / 2**30:.3f} GiB; first "
             f"{CHECK_STEPS} steps match (loss {kept[0][0]:.6f}, "
             f"{kept[1][0]:.6f}); launches {counts}")
    return counts


def seeded_train_phase(H, W, dev):
    """11(b): the config-4 train step with ``coarse_seed=True`` (K15 from
    the camera, the seeded K7), one warm-up and two timed steps, against
    the unseeded kernel step from the same state.  The first step's frame
    (its forward, rendered and denoised again outside the step from the
    same state, and tied to the step by its loss at phase 5's rtol 1e-5)
    is held to the unseeded one by :func:`compare_seeded`.  The losses and
    the albedo gradients' gap are printed, not bounded: a seeded render
    flips the hit of a few pixels at edges, where one flip moves a squared
    error by up to 18² a channel at the light, and a material that covers
    few pixels at an edge moves its gradient by several per cent
    (3.8e-2·max at 160x96 on the CPU); 11(f) holds the seeded step's
    gradient to the sharded one at phase 5's bound."""
    scene = raymarch.cornell_scene(device=dev)
    target = torch.from_numpy(np.random.default_rng(0).random(
        (3, H, W), dtype=np.float32)).to(dev)
    cam = raymarch.cornell_camera(device=dev)
    cfg = CameraParams(width=W, height=H)
    runs, frames = {}, {}
    counts = {k: 0 for k in WRAPPERS}
    for seeded in (False, True):
        rm = SEEDED if seeded else RaymarchParams()
        step = make_train_step(scene, cam, target, cam_cfg=cfg, rm_params=rm,
                               svgf_params=TRAIN)
        state = init_train_state(scene.materials.albedo, H, W,
                                 torch.Generator(dev).manual_seed(0))
        # the first step's forward, as the step runs it
        albedo = scene.materials.albedo.detach().clone().requires_grad_()
        out, _ = render_and_denoise(
            dataclasses.replace(scene, materials=dataclasses.replace(
                scene.materials, albedo=albedo)),
            cam, None, History.zeros(H, W, device=dev),
            torch.Generator(dev).manual_seed(0), cam_cfg=cfg, rm_params=rm,
            svgf_params=TRAIN, temporal="ad", motion_grad=False)
        frames[seeded] = (types.SimpleNamespace(
            albedo=out.albedo.detach(), depth=out.depth.detach(),
            denoised=out.denoised.detach()),
            float(torch.mean((out.denoised.detach() - target) ** 2)))
        del out, albedo
        if seeded:
            state, dev_ms, _h, kept = counted(lambda: run_train(
                step, state, 3, 3), counts)
        else:
            state, dev_ms, _h, kept = run_train(step, state, 3, 3)
        if abs(frames[seeded][1] - kept[0][0]) > 1e-5 * abs(kept[0][0]):
            raise AssertionError(f"11(b): the first step's loss {kept[0][0]}"
                                 f" against its frame's {frames[seeded][1]}")
        runs[seeded] = (dev_ms[1:], kept)
        del step, state
    require_launched(11, counts, ("K1", "K2", "K3", "K16", "K15", "K7s",
                                  "K8"))
    if counts["K7"]:
        raise AssertionError("phase 11: the seeded train step launched K7")
    stats = compare_seeded("seeded train step 0 frame", frames[True][0],
                           frames[False][0], SEEDED.hit_eps)
    grad_rel = max(max_err(a[1], b[1]) / float(b[1].abs().max())
                   for a, b in zip(runs[True][1], runs[False][1]))
    (sd, sk), (ud, uk) = runs[True], runs[False]
    phase(11, f"(b) train step {W}x{H} (config 4) with coarse_seed: "
              f"{sum(sd) / len(sd):.3f} ms/step device over {len(sd)} "
              f"steps after one, unseeded {sum(ud) / len(ud):.3f}; the first "
              f"step's frame against the unseeded one within the seeded "
              f"bounds: {seeded_bounds_text([stats])}; losses (not bounded) "
              f"{[round(x[0], 6) for x in sk]} vs unseeded "
              f"{[round(x[0], 6) for x in uk]}, albedo gradients apart by "
              f"{grad_rel:.3g}·max (not bounded); launches {counts}")
    return counts


def temporal_grad_phase(H, W, dev, params=TRAIN, motion_scale=M / 7.0,
                        n=6, label="",
                        expected=lambda mg: ("K1", "K2", "K4") + (
                            ("K5",) if mg else ("K6",))):
    """Differentiate the denoised frame with respect to motion and the
    history through ``svgf_denoise_frame(temporal="ad")``: K5 with the
    motion gradient, K6 without it; with ``params.max_motion`` None (phase
    11(d)) the clamped gather and its adjoint, motion out to ±28 pixels."""
    P = random_planes(H, W, dev, seed=5)
    motion = (P["motion"] * motion_scale).contiguous()
    total = {k: 0 for k in WRAPPERS}
    grads = {}
    for impl in ("auto", "plain"):
        for motion_grad in (True, False):
            m = motion.clone().requires_grad_(motion_grad)
            hc = P["h_color"].clone().requires_grad_()
            g = GBuffer(render=P["color"],
                        albedo=torch.full_like(P["color"], 0.7),
                        normal=P["normal"], depth=P["depth"], motion=m)
            h = History(color=hc, moments=P["h_moments"],
                        length=P["h_length"], prev_depth=P["depth"],
                        prev_normal=P["normal"])
            if impl == "auto":
                reset_counts()
            out, _ = svgf_denoise_frame(g, h, params=params, impl=impl,
                                        temporal="ad",
                                        motion_grad=motion_grad)
            (out.denoised ** 2).mean().backward()
            if impl == "auto":
                counts = read_counts(n, expected(motion_grad))
                for k, c in counts.items():
                    total[k] += c
            grads[impl, motion_grad] = (hc.grad, m.grad)
    for motion_grad in (True, False):
        (hk, mk), (hp, mp) = grads["auto", motion_grad], grads["plain",
                                                               motion_grad]
        check_close(f"d_history.color (motion_grad={motion_grad})", hk, hp,
                    atol=3e-3 * float(hp.abs().max()))
        if motion_grad:
            check_close("d_motion", mk, mp, atol=3e-3 * float(mp.abs().max()))
        elif mk is not None:
            raise AssertionError("motion gradient without motion_grad")
    phase(n, f"{label}temporal gradient path {W}x{H}: d_motion and "
             f"d_history match the plain path; launches "
             f"{ {k: v for k, v in total.items() if v} }")
    return total


def cli_phase():
    """The CLI's cases on the card, as ``python -m
    raymarchdenoisercuda_torch.cli -t`` runs them."""
    reset_counts()
    rc = cli.main(["-t", CLI_CASES])
    counts = read_counts(7, ("K10", "K12", "K1", "K3", "K7", "K8"))
    if rc != 0:
        raise AssertionError(f"phase 7: the CLI returned {rc}")
    phase(7, f"cli -t '{CLI_CASES}': all passed; launches {counts}")
    return counts


FILTER_TOLS = {FilterType.AVERAGE: dict(atol=1e-6, rtol=1e-5),
               FilterType.GAUSSIAN: dict(atol=1e-5),
               FilterType.CROSS: dict(atol=5e-5),
               FilterType.WAVELET: dict(atol=0.0, rtol=5e-5)}


def dataset_phase(H, W, dev):
    """generate_sequence at spp > 1, the dataset read back, the spp render
    against the plain path, and apply_filter on the loaded frame."""
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    # the device time of one frame's render (K7, 16 x K13), without the
    # host's PNG and npz writes
    scene = raymarch.cornell_scene(device=dev)
    cam = orbit_camera(0.0, device=dev)
    with torch.no_grad():
        raymarch.render_gbuffer(scene, cam, None, None, cam_cfg=cfg,
                                params=rm, spp=DATA_SPP)
        with CudaTimer() as tm:
            raymarch.render_gbuffer(scene, cam, None, None, cam_cfg=cfg,
                                    params=rm, spp=DATA_SPP)
    with tempfile.TemporaryDirectory() as root:
        reset_counts()
        t0 = time.perf_counter()
        frames = generate_sequence(root, "cornell_anim", DATA_FRAMES,
                                   cam_cfg=cfg, rm_params=rm, spp=DATA_SPP,
                                   seed=0, device=dev)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        for f, g in enumerate(frames):
            fl = load_float_frame(root, "cornell_anim", f + 1, device=dev)
            for name in ("render", "albedo", "normal", "depth", "motion"):
                if not torch.equal(getattr(fl, name), getattr(g, name)):
                    raise AssertionError(f"frame {f}: planes.npz {name}")
            png = load_frame(root, "cornell_anim", f + 1, device=dev)
            for name in ("render", "albedo", "depth"):
                check_close(f"frame {f} {name}.png", getattr(png, name),
                            getattr(g, name).clamp(0.0, 1.0),
                            atol=1.0 / 255)
            # unit normals: 1/255 a component from the quantisation, and up
            # to sqrt(3)/255 more from the renormalisation after loading
            check_close(f"frame {f} normal.png", png.normal, g.normal,
                        atol=3.0 / 255, mask=g.depth > 0)

        # frame 0 against the plain path from the same seed
        want = raymarch.render_gbuffer(
            scene, cam, None, torch.Generator(dev).manual_seed(0),
            cam_cfg=cfg, params=rm, spp=DATA_SPP, impl="plain")
        got = frames[0]
        # the render within atol 1e-4 except where a hit, a material or one
        # sample's visibility flips on an ulp: at most 0.1 % of the frame
        flipped = ((got.albedo - want.albedo).abs().amax(0) > 1e-4) | (
            (got.depth - want.depth).abs() > 1e-4) | (
            (got.render - want.render).abs().amax(0) > 1e-4)
        if float(flipped.float().mean()) > 1e-3:
            raise AssertionError(f"phase 8: {int(flipped.sum())} pixels "
                                 f"flip against the plain render")
        keep = ~flipped
        for name in ("albedo", "depth", "motion"):
            check_close(f"frame 0 {name} (kernel vs plain)",
                        getattr(got, name), getattr(want, name), atol=1e-4,
                        mask=keep)
        check_close("frame 0 normal (kernel vs plain)", got.normal,
                    want.normal, atol=5e-4, rtol=5e-3, mask=keep)

        # the four filter types on the loaded frame, kernel vs plain
        g = load_frame(root, "cornell_anim", 1, device=dev)
        errs = {}
        for ftype in FilterType:
            p = FilterParams(type=ftype)
            a = filters.apply_filter(g, p).denoised
            b = filters.apply_filter(g, p, impl="plain").denoised
            check_close(f"apply_filter {ftype.name}", a, b,
                        **FILTER_TOLS[ftype])
            errs[ftype.name] = max_err(a, b)
    counts = read_counts(8, ("K7", "K11", "K13"))
    phase(8, f"generate_sequence {DATA_FRAMES} frames {W}x{H} spp "
             f"{DATA_SPP}: {gen_s:.3f} s host wall (PNG and npz writes "
             f"included; one frame's render alone {tm.ms:.3f} ms device); "
             f"read back exactly and to the PNG quantisation; "
             f"frame 0 matches the plain path ({int(flipped.sum())} flips); "
             f"apply_filter max |err| {errs}; launches {counts}")
    return counts


def _sweep_grads(fn, ins, cots, diff, **kw):
    """Gradients of sum(wc·c) + sum(wv·v) + sum(wf·feedback) of a sweep
    with respect to the inputs at the indices ``diff``."""
    ins = [t.detach().requires_grad_(k in diff) for k, t in enumerate(ins)]
    oc, ov, fb = fn(*ins, return_feedback=True, **kw)
    wc, wv, wf = cots
    loss = (oc * wc).sum() + (ov * wv).sum() + (fb * wf).sum()
    return torch.autograd.grad(loss, [ins[k] for k in diff])


# tolerances of phase 9, relative to each gradient's max|·|: the bf16
# stored weights as in phase 5; float weights at the JAX package's
# stored_f32-vs-recompute bound; the full adjoint at its d_color,
# d_variance and d_normal bounds, d_normal's for the depth planes
SWEEP_TOLS = {"stored": (3e-3, 3e-3), "stored_f32": (2e-4, 2e-4),
              "recompute": (2e-4, 2e-4),
              "recompute chained=False": (2e-4, 2e-4),
              "weight_grads": (1e-4, 1e-4, 5e-4, 5e-4)}
LEVEL_TOLS = (1e-4, 1e-4, 5e-4, 5e-4, 5e-4, 5e-4)


def check_wgrad_levels(c, v, normal, depth, params, cot_seed):
    """The radius-2 full adjoint held level by level: the K1b/K9 level
    (``atrous_level``) against autograd of the plain level through its
    weights, on each level's inputs from the kernel path's forward; returns
    the largest error relative to its plane's max."""
    zgrad = finite_diff_gradients(depth)
    worst = 0.0
    for lvl in range(params.iterations):
        sd = atrous.sigma_denominator(v, params)
        g = torch.Generator(c.device).manual_seed(cot_seed + lvl)
        gc = torch.randn(c.shape, generator=g, device=c.device)
        gv = torch.randn(v.shape, generator=g, device=c.device)
        grads = []
        for level_fn in (
                lambda *a: atrous_level(*a, lvl, params, True),
                lambda c_, v_, n_, z_, zg_, sd_: atrous.atrous_level_ref(
                    c_, v_, n_, z_, zg_, level=lvl, params=params,
                    detach_weights=False, sigma_denom=sd_)):
            ins = [t.detach().clone().requires_grad_()
                   for t in (c, v, normal, depth, zgrad, sd)]
            oc, ov = level_fn(*ins)
            grads.append(torch.autograd.grad(
                (oc * gc).sum() + (ov * gv).sum(), ins))
        for name, a, b, tol in zip(WGRAD_NAMES, *grads, LEVEL_TOLS):
            scale = float(b.abs().max())
            check_close(f"weight_grads r{params.radius} level {lvl} {name}",
                        a, b, atol=tol * scale)
            worst = max(worst, max_err(a, b) / scale)
        with torch.no_grad():
            c, v = atrous_level(c, v, normal, depth, zgrad, sd, lvl, params)
    return worst


def adjoint_phase(H, W, dev):
    """The 5-level sweep forward and backward at 1080p in every adjoint
    mode of ``svgf_spatial_ad_cuda``, radius 0 to 3, exact weights (radius
    3: the taps in device memory)."""
    P = random_planes(H, W, dev, seed=9)
    ins = (P["color"], P["variance"], P["normal"], P["depth"])
    g = torch.Generator(dev).manual_seed(9)
    cots = (torch.randn((3, H, W), generator=g, device=dev),
            torch.randn((H, W), generator=g, device=dev),
            torch.randn((3, H, W), generator=g, device=dev))
    reset_counts()
    lines = []
    for radius in (0, 1, 2, 3):
        params = SVGFParams(iterations=5, radius=radius)
        detached = None
        for name, kw in ADJOINT_MODES:
            wg = kw.get("weight_grads", False)
            diff = (0, 1, 2, 3) if wg else (0, 1)

            def step():
                return _sweep_grads(svgf_spatial_ad_cuda, ins, cots, diff,
                                    params=params, **kw)

            got = step()
            for k, t in zip(diff, got):
                if t.shape != ins[k].shape or not bool(
                        torch.isfinite(t).all()):
                    raise AssertionError(f"phase 9 {name} r{radius}: "
                                         f"gradient {k} not finite")
            if wg and radius >= 2:
                # the plain sweep through the weights at radius 2 holds
                # ~25 GB of autograd state: held level by level instead
                err = check_wgrad_levels(*ins, params, 90)
                how = "levels held"
            else:
                if wg:
                    want = _sweep_grads(atrous.svgf_spatial_ref, ins, cots,
                                        diff, params=params,
                                        detach_weights=False)
                else:
                    if detached is None:
                        detached = _sweep_grads(atrous.svgf_spatial_ref, ins,
                                                cots, diff, params=params)
                    want = detached
                err = 0.0
                for k, a, b, tol in zip(diff, got, want, SWEEP_TOLS[name]):
                    if radius == 0 and k >= 2:
                        # one tap: the output is its own input whatever the
                        # weight, so d_normal and d_depth are 0 but for
                        # rounding (sigma_n = 128 magnifies it) in both
                        floor = 1e-3 * float(want[0].abs().max())
                        for x in (a, b):
                            check_close(f"phase 9 {name} r0 gradient {k}",
                                        x, torch.zeros_like(x), atol=floor)
                        continue
                    scale = float(b.abs().max())
                    check_close(f"phase 9 {name} r{radius} gradient {k}", a,
                                b, atol=tol * scale)
                    err = max(err, max_err(a, b) / scale)
                how = "sweep held"
            del got
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = cuda_time_ms(step, repeats=ADJOINT_STEPS)
            peak = torch.cuda.max_memory_allocated() - base
            lines.append(f"r{radius} {name}: {ms:.3f} ms fwd+bwd, peak "
                         f"{peak / 2**30:.3f} GiB, max |err|/max {err:.3g} "
                         f"({how})")
            phase(9, lines[-1])
    for radius in (1, 2):
        lines.append(bf16_sweep_case(ins, cots, radius))
        phase(9, lines[-1])
    counts = read_counts(9, ("K1", "K2", "K1b", "K2b", "K14", "K9",
                             "K1b-bf16", "K1b-bf16-fused", "K14-bf16",
                             "K2w", "K2bw", "K14w"))
    phase(9, f"spatial adjoints {W}x{H}, 5 levels, exact weights: all "
             f"modes match the plain path; launches {counts}")
    return counts


def plain_bf16_sweep_grads(ins, cots, params):
    """The ``precision="bf16"`` sweep's colour and variance gradients by
    the plain twins alone: the level forwards (``atrous_level_ref(...,
    precision="bf16")``, each level's σ-denominator of its detached
    variance), then their adjoints in reverse (``atrous_level_bwd_ref(...,
    precision="bf16")``), the feedback's cotangent joining at its level."""
    color, var, normal, depth = (t.detach() for t in ins)
    zg = finite_diff_gradients(depth)
    c, v, saved = color, var, []
    with torch.no_grad():
        for lvl in range(params.iterations):
            sd = atrous.sigma_denominator(v, params)
            oc, ov, _, norm = atrous.atrous_level_ref(
                c, v, normal, depth, zg, level=lvl, params=params,
                sigma_denom=sd, return_weights=True, precision="bf16")
            saved.append((c, sd, norm))
            c, v = oc, ov
        gc, gv = cots[0], cots[1]
        for lvl in reversed(range(params.iterations)):
            if lvl + 1 == params.feedback_level:
                gc = gc + cots[2]
            c_in, sd, norm = saved[lvl]
            gc, gv = atrous.atrous_level_bwd_ref(
                c_in, normal, depth, zg, sd, norm, gc, gv, level=lvl,
                params=params, precision="bf16")
    return gc, gv


def bf16_sweep_case(ins, cots, radius):
    """Phase 9's ``precision="bf16"`` sweep at ``radius``: fwd+bwd through
    K1b-bf16 (σ fused and written) and K14-bf16 against the plain bf16
    path at atol 2^-7·max
    (measured: equal), timed (events, and device time under the profiler:
    the walls hold the per-level host work) with peak memory beside the
    float32 recompute sweep (K1b, K14), its colour gradient at cosine >=
    0.99 against that sweep's."""
    params = SVGFParams(iterations=5, radius=radius)

    def step(precision):
        return _sweep_grads(svgf_spatial_ad_cuda, ins, cots, (0, 1),
                            params=params, bwd_impl="recompute",
                            precision=precision)

    got = step("bf16")
    want = plain_bf16_sweep_grads(ins, cots, params)
    err = 0.0
    for k, a, b in zip((0, 1), got, want):
        scale = float(b.abs().max())
        check_close(f"phase 9 bf16 r{radius} gradient {k}", a, b,
                    atol=2.0 ** -7 * scale)
        err = max(err, max_err(a, b) / scale)
    g32 = step("f32")[0]
    cos = float((got[0] * g32).sum()
                / (got[0].norm() * g32.norm()).clamp_min(1e-30))
    if cos < BF16_GRAD_COS:
        raise AssertionError(f"phase 9 bf16 r{radius}: colour gradient "
                             f"cosine {cos:.6f} < {BF16_GRAD_COS} against "
                             f"the float32 sweep")
    del got, want, g32
    out = []
    for precision in ("bf16", "f32"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_time_ms(lambda: step(precision), repeats=ADJOINT_STEPS)
        peak = torch.cuda.max_memory_allocated() - base
        dms = device_ms(lambda: step(precision), ADJOINT_STEPS)
        out.append(f"{precision} {ms:.3f} ms fwd+bwd ({dms:.3f} ms device), "
                   f"peak {peak / 2**30:.3f} GiB")
    return (f"r{radius} precision='bf16' (recompute, per level): "
            f"{out[0]}; float32 recompute {out[1]}; max |err|/max {err:.3g} "
            f"against the plain bf16 path; colour gradient cosine "
            f"{cos:.6f} against the float32 sweep's")


def _uhd_tiles(H, W):
    """The 2x2 tiles of the frame, and three 8-row tiles (top, middle,
    bottom) whose height the level-4 reach exceeds."""
    th, tw = H // 2, W // 2
    quads = [(Tile((iy * th, ix * tw), (H, W)), th, tw)
             for iy in range(2) for ix in range(2)]
    rows = [(Tile((y, 0), (H, W)), 8, W) for y in (0, H // 2, H - 8)]
    return quads, rows


def _crop(x, tile, th, tw):
    gy, gx = tile.origin
    return x[..., gy:gy + th, gx:gx + tw].contiguous()


def _place(acc, x, tile, m):
    """Add a tile's canvas-sized (margin m) output into a frame padded by
    m (the adjoints' margin gradients add up across tiles)."""
    gy, gx = tile.origin
    acc[..., gy:gy + x.shape[-2], gx:gx + x.shape[-1]] += x


def check_level_tiles(P, results, tile_ms):
    """10(a), à-trous: K1 (fast, and exact storing bf16 weights), K1b, K2
    and K14 with a tile origin and the frame's bounds at levels 1 and 4,
    radius 1, on every tile: each tile's output bit-equal to the whole-
    frame kernel's at its pixels, and within the phase-3 tolerances of its
    plain twin; the adjoints' margin gradients summed over the 2x2 tiles
    equal to the whole-frame adjoint (rtol 1e-5: the sums' order)."""
    color, var, normal, depth = (P["color"], P["variance"], P["normal"],
                                 P["depth"])
    dev = color.device
    H, W = depth.shape
    params = SVGFParams(radius=1)
    zg = finite_diff_gradients(depth)
    sd = atrous.sigma_denominator(var, params)
    g = torch.Generator(dev).manual_seed(10)
    gc = torch.randn((3, H, W), generator=g, device=dev)
    gv = torch.randn((H, W), generator=g, device=dev)
    quads, rows = _uhd_tiles(H, W)
    errs = {}
    for level in (1, 4):
        h = params.radius << level
        kw = dict(level=level, params=params)
        whole_f = atrous_level_cuda(color, var, normal, depth, zg,
                                    weight_math="fast", **kw)
        whole = atrous_level_cuda(color, var, normal, depth, zg, store=True,
                                  **kw)
        whole_b = atrous_level_fwd_cuda(color, var, normal, depth, zg, sd,
                                        **kw)
        whole_k2 = atrous_level_bwd_stored_cuda(whole[2], whole[3], gc, gv,
                                                level=level, radius=1)
        whole_k14 = atrous_level_bwd_cuda(color, normal, depth, zg, sd,
                                          whole_b[2], gc, gv, **kw)
        acc2 = [torch.zeros((3, H + 2 * h, W + 2 * h), device=dev),
                torch.zeros((H + 2 * h, W + 2 * h), device=dev)]
        acc14 = [torch.zeros_like(a) for a in acc2]
        for k, (tile, th, tw) in enumerate(quads + rows):
            cc, vc, nc, dc = (frame_canvas(x, tile, th, tw, h)
                              for x in (color, var, normal, depth))
            zg_t, sd_t, gc_t, gv_t = (_crop(x, tile, th, tw)
                                      for x in (zg, sd, gc, gv))
            lvl = (cc, vc, nc, dc, zg_t)
            got_f = atrous_level_cuda(*lvl, weight_math="fast", tile=tile,
                                      **kw)
            got = atrous_level_cuda(*lvl, store=True, tile=tile, **kw)
            got_b = atrous_level_fwd_cuda(*lvl, sd_t, tile=tile, **kw)
            for a, w in zip(got_f + got + got_b, whole_f + whole + whole_b):
                if not torch.equal(a, _crop(w, tile, th, tw)):
                    raise AssertionError(f"phase 10 level {level} tile {k}: "
                                         f"tile form != whole frame")
            want_f = atrous.atrous_level_ref(*lvl, weight_math="fast",
                                             tile=tile, **kw)
            want = atrous.atrous_level_ref(*lvl, return_weights=True,
                                           tile=tile, **kw)
            want_b = atrous.atrous_level_ref(*lvl, sigma_denom=sd_t,
                                             return_weights=True, tile=tile,
                                             **kw)
            for name, a, b in zip(("color", "variance"), got_f, want_f):
                check_close(f"K1 tile fast l{level} {name}", a, b,
                            atol=2e-4 * float(b.abs().max()))
            for name, a, b in (("color", got[0], want[0]),
                               ("variance", got[1], want[1]),
                               ("N", got[3], want[3]),
                               ("K1b color", got_b[0], want_b[0]),
                               ("K1b N", got_b[2], want_b[3])):
                check_close(f"K1 tile l{level} {name}", a, b, atol=0.0,
                            rtol=5e-5)
            check_close(f"K1 tile l{level} weights", got[2],
                        want[2].to(torch.bfloat16), atol=1e-30,
                        rtol=2.0 ** -7)
            k2 = atrous_level_bwd_stored_cuda(got[2], got[3], gc_t, gv_t,
                                              level=level, radius=1,
                                              out_halo=h)
            k2_want = atrous.atrous_level_bwd_stored_ref(
                got[2], got[3], gc_t, gv_t, level=level, radius=1,
                out_halo=h)
            k14 = atrous_level_bwd_cuda(cc, nc, dc, zg_t, sd_t, got_b[2],
                                        gc_t, gv_t, tile=tile, out_halo=h,
                                        **kw)
            k14_want = atrous.atrous_level_bwd_ref(
                cc, nc, dc, zg_t, sd_t, got_b[2], gc_t, gv_t, tile=tile,
                out_halo=h, **kw)
            for name, a, b in zip(("d_color", "d_variance"), k2, k2_want):
                check_close(f"K2 tile l{level} {name}", a, b,
                            atol=1e-12 * float(b.abs().max()), rtol=1e-6)
            for name, a, b in zip(("d_color", "d_variance"), k14, k14_want):
                check_close(f"K14 tile l{level} {name}", a, b,
                            atol=1e-5 * float(b.abs().max()))
            errs[level] = max([errs.get(level, 0.0)] + [
                max_err(a, b) for a, b in zip(k2 + k14, k2_want + k14_want)])
            if k < len(quads):
                for a, acc in zip(k2, acc2):
                    _place(acc, a, tile, h)
                for a, acc in zip(k14, acc14):
                    _place(acc, a, tile, h)
            if k == 0 and level == 1:
                tile_ms["K1 fast"] = cuda_time_ms(lambda: atrous_level_cuda(
                    *lvl, weight_math="fast", tile=tile, **kw), repeats=20)
                tile_ms["K1 store"] = cuda_time_ms(lambda: atrous_level_cuda(
                    *lvl, store=True, tile=tile, **kw), repeats=20)
                tile_ms["K1b"] = cuda_time_ms(lambda: atrous_level_fwd_cuda(
                    *lvl, sd_t, tile=tile, **kw), repeats=20)
                w_t, n_t, nb_t = got[2], got[3], got_b[2]
                tile_ms["K2"] = cuda_time_ms(
                    lambda: atrous_level_bwd_stored_cuda(
                        w_t, n_t, gc_t, gv_t, level=level, radius=1,
                        out_halo=h), repeats=20)
                tile_ms["K14"] = cuda_time_ms(lambda: atrous_level_bwd_cuda(
                    cc, nc, dc, zg_t, sd_t, nb_t, gc_t, gv_t, tile=tile,
                    out_halo=h, **kw), repeats=20)
        for name, acc, w in zip(("K2 d_color", "K2 d_variance",
                                 "K14 d_color", "K14 d_variance"),
                                acc2 + acc14, whole_k2 + whole_k14):
            check_close(f"{name} l{level}: tiles summed vs whole frame",
                        acc[..., h:h + H, h:h + W], w, rtol=1e-5,
                        atol=1e-6 * float(w.abs().max()))
    phase(10, f"(a) K1 (fast; exact, bf16 store), K1b, K2, K14 tile forms, "
              f"levels 1 and 4, on 4 quarter tiles and 3 8-row tiles of "
              f"{W}x{H}: bit-equal to the whole frame, twins matched, "
              f"margin gradients add up (adjoint max |err| vs twin "
              f"{errs}); ms on a {W // 2}x{H // 2} tile: "
              + ", ".join(f"{k} {v:.4f}" for k, v in tile_ms.items()))


def check_temporal_canvas_tiles(P, results, tile_ms):
    """10(a), temporal: K3b, the tile form of K3, K4c and K5c/K6c on the
    (10, th + 14, tw + 14) history canvas (max_motion 6) of every tile,
    against the whole-frame K3/K4/K5 (bit-equal forwards; the adjoints'
    canvases summed over the 2x2 tiles within the atomics' rounding) and
    the plain twins (phase 3's tolerances); timed on a quarter tile,
    ``grid_sample`` beside K4c-K6c."""
    dev = P["color"].device
    H, W = P["depth"].shape
    params = SVGFParams()
    M = params.max_motion
    mh = M + 1
    stack = torch.cat([P["h_color"], P["h_moments"], P["h_length"][None],
                       P["depth"][None], P["normal"]]).contiguous()
    rng = np.random.default_rng(11)
    cot = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    motion = P["motion"]
    g = GBuffer(render=P["color"], albedo=P["color"], normal=P["normal"],
                depth=P["depth"], motion=motion)
    hist = temporal.history_from_stack(stack)
    whole = temporal_accumulate_cuda(g, hist, params=params)
    whole4 = gather_cuda(stack, motion, M)
    whole5 = gather_bwd_cuda(stack, motion, cot, M, grad_planes=6)
    quads, rows = _uhd_tiles(H, W)
    acc5 = torch.zeros((10, H + 2 * mh, W + 2 * mh), device=dev)
    acc6 = torch.zeros_like(acc5)
    errs = [0.0] * 4
    tol = dict(atol=1e-6, rtol=1e-5)
    for k, (tile, th, tw) in enumerate(quads + rows):
        canvas = frame_canvas(stack, tile, th, tw, mh)
        m_t, cot_t = _crop(motion, tile, th, tw), _crop(cot, tile, th, tw)
        g_t = GBuffer(render=frame_canvas(P["color"], tile, th, tw, 3),
                      albedo=None, normal=_crop(P["normal"], tile, th, tw),
                      depth=_crop(P["depth"], tile, th, tw), motion=m_t)
        got = temporal_accumulate_canvas_cuda(g_t, canvas, params=params,
                                              tile=tile)
        want = temporal.temporal_accumulate(
            g_t, temporal.history_from_stack(canvas), params=params,
            tile=tile)
        for name, a, b, w in (
                ("integrated", got[0], want[0], whole[0]),
                ("variance", got[1], want[1], whole[1]),
                ("moments", got[2].moments, want[2].moments,
                 whole[2].moments),
                ("length", got[2].length, want[2].length, whole[2].length)):
            if not torch.equal(a, _crop(w, tile, th, tw)):
                raise AssertionError(f"K3b tile {k} {name} != whole frame")
            check_close(f"K3b tile {k} {name}", a, b,
                        **(dict(atol=0.0) if name == "length" else tol))
            errs[0] = max(errs[0], max_err(a, b))
        k4 = gather_canvas_cuda(canvas, m_t, M, tile=tile)
        if not torch.equal(k4, _crop(whole4, tile, th, tw)):
            raise AssertionError(f"K4c tile {k} != whole frame")
        k4_want = temporal.gather_ref(canvas, m_t, M, tile=tile)
        check_close(f"K4c tile {k}", k4, k4_want, **tol)
        errs[1] = max(errs[1], max_err(k4, k4_want))
        k5 = gather_canvas_bwd_cuda(canvas, m_t, cot_t, M, tile=tile,
                                    grad_planes=6)
        k5_want = temporal.gather_bwd_ref(canvas, m_t, cot_t, M,
                                          motion_grad=True, grad_planes=6,
                                          tile=tile)
        k6 = gather_canvas_bwd_hist_cuda(m_t, cot_t, M, tile=tile,
                                         canvas_shape=canvas.shape,
                                         grad_planes=6)
        for name, a, b in zip(("d_canvas", "d_motion"), k5, k5_want):
            check_close(f"K5c tile {k} {name}", a, b, **tol)
        check_close(f"K6c tile {k} d_canvas", k6[0], k5_want[0], **tol)
        check_close(f"K5c tile {k} d_motion vs whole frame", k5[1],
                    _crop(whole5[1], tile, th, tw), **tol)
        errs[2] = max(errs[2], max(max_err(a, b) for a, b in zip(k5,
                                                                 k5_want)))
        errs[3] = max(errs[3], max_err(k6[0], k5_want[0]))
        if k < len(quads):
            _place(acc5, k5[0], tile, mh)
            _place(acc6, k6[0], tile, mh)
        if k == 0:
            ms3 = cuda_time_ms(lambda: temporal_accumulate_canvas_cuda(
                g_t, canvas, params=params, tile=tile), repeats=20)
            plain3 = cuda_time_ms(lambda: temporal.temporal_accumulate(
                g_t, temporal.history_from_stack(canvas), params=params,
                tile=tile), repeats=3)
            ms4 = cuda_time_ms(lambda: gather_canvas_cuda(
                canvas, m_t, M, tile=tile), repeats=20)
            plain4 = cuda_time_ms(lambda: temporal.gather_ref(
                canvas, m_t, M, tile=tile), repeats=3)
            ms5 = cuda_time_ms(lambda: gather_canvas_bwd_cuda(
                canvas, m_t, cot_t, M, tile=tile, grad_planes=6), repeats=20)
            plain5 = cuda_time_ms(lambda: temporal.gather_bwd_ref(
                canvas, m_t, cot_t, M, motion_grad=True, grad_planes=6,
                tile=tile), repeats=3)
            ms6 = cuda_time_ms(lambda: gather_canvas_bwd_hist_cuda(
                m_t, cot_t, M, tile=tile, canvas_shape=canvas.shape,
                grad_planes=6), repeats=20)
            plain6 = cuda_time_ms(lambda: temporal.gather_bwd_ref(
                None, m_t, cot_t, M, motion_grad=False, grad_planes=6,
                tile=tile, canvas_shape=canvas.shape), repeats=3)
            # library yardstick: grid_sample on the tile's centre stack
            x = _crop(stack, tile, th, tw)[None].clone().requires_grad_()
            grid = _grid(m_t).requires_grad_()
            lib4 = cuda_time_ms(lambda: F.grid_sample(
                x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True), repeats=20)
            centre = _crop(stack, tile, th, tw)
            lib5 = _grid_sample_bwd_ms(centre, m_t, cot_t, True, repeats=20)
            lib6 = _grid_sample_bwd_ms(centre, m_t, cot_t, False, repeats=20)
            HW = th * tw
            frac = float(((m_t[0].abs() <= M) & (m_t[1].abs() <= M)).float()
                         .mean())
            short = float((got[2].length < params.variance_boost_frames)
                          .float().mean())
            # the same bytes and operations a pixel as K3, K4, K5, K6
            results["K3b"] = dict(ms=ms3, plain_ms=plain3, bytes=104 * HW,
                                  flops=(60 + 49 * 8 * short) * HW)
            results["K4c"] = dict(ms=ms4, plain_ms=plain4, library_ms=lib4,
                                  bytes=88 * HW,
                                  flops=int(4 * (10 * 2 + 8) * frac * HW))
            results["K5c"] = dict(ms=ms5, plain_ms=plain5, library_ms=lib5,
                                  bytes=104 * HW,
                                  flops=int((4 * 6 * 2 + 9 * (6 * 2 + 12))
                                            * frac * HW))
            results["K6c"] = dict(ms=ms6, plain_ms=plain6, library_ms=lib6,
                                  bytes=72 * HW,
                                  flops=int(4 * 6 * 2 * frac * HW))
            tile_ms.update({"K3b": ms3, "K4c": ms4, "K5c": ms5, "K6c": ms6})
    for name, acc in (("K5c", acc5), ("K6c", acc6)):
        check_close(f"{name} canvases summed vs whole-frame K5", acc[
            :, mh:mh + H, mh:mh + W], whole5[0], **tol)
    # the served frame's history and motion at this size (the camera's
    # motion, coherent) on the first quarter tile: K4c bit-equal to K4,
    # the adjoints against their twins; timed beside the random input
    stack_s, motion_s, cot_s = gather_inputs(H, W, dev, "served")
    tile, th, tw = quads[0]
    canvas = frame_canvas(stack_s, tile, th, tw, mh)
    m_t, cot_t = _crop(motion_s, tile, th, tw), _crop(cot_s, tile, th, tw)
    k4 = gather_canvas_cuda(canvas, m_t, M, tile=tile)
    if not torch.equal(k4, _crop(gather_cuda(stack_s, motion_s, M), tile, th,
                                 tw)):
        raise AssertionError("K4c served tile != whole frame")
    k5 = gather_canvas_bwd_cuda(canvas, m_t, cot_t, M, tile=tile,
                                grad_planes=6)
    k5_want = temporal.gather_bwd_ref(canvas, m_t, cot_t, M, motion_grad=True,
                                      grad_planes=6, tile=tile)
    for name, a, b in zip(("d_canvas", "d_motion"), k5, k5_want):
        check_close(f"K5c served tile {name}", a, b, **tol)
    served_ms = (
        cuda_time_ms(lambda: gather_canvas_cuda(canvas, m_t, M, tile=tile),
                     repeats=20),
        cuda_time_ms(lambda: gather_canvas_bwd_cuda(
            canvas, m_t, cot_t, M, tile=tile, grad_planes=6), repeats=20),
        cuda_time_ms(lambda: gather_canvas_bwd_hist_cuda(
            m_t, cot_t, M, tile=tile, canvas_shape=canvas.shape,
            grad_planes=6), repeats=20))
    for k, e in zip(("K3b", "K4c", "K5c", "K6c"), errs):
        results[k]["max_abs_err"] = e
    phase(10, "(a) K3b (and K3's tile form), K4c, K5c, K6c on 4 quarter "
              "tiles and 3 8-row tiles: bit-equal forwards, canvases' "
              "gradients add up to the whole frame's; " + ", ".join(
                  f"{k} {results[k]['ms']:.4f} ms (plain "
                  f"{results[k]['plain_ms']:.4f}"
                  + (f", grid_sample {results[k]['library_ms']:.4f}"
                     if "library_ms" in results[k] else "") + ")"
                  for k in ("K3b", "K4c", "K5c", "K6c"))
              + "; served frame's tile: " + ", ".join(
                  f"{k} {t:.4f} ms" for k, t in zip(("K4c", "K5c", "K6c"),
                                                    served_ms)))


def sharded_temporal_grad_phase(P):
    """10(a), main path: the differentiable temporal step on the (1, 1, 1)
    mesh's history canvas at 4K (K4c; K5c with the motion gradient, K6c
    without), its gradients with respect to motion and the history against
    the unsharded step's (K4; K5, K6), atol 3e-3·max as phase 6."""
    H, W = P["depth"].shape
    mesh = make_mesh()
    params = SVGFParams()
    mh = params.max_motion + 1
    motion = (P["motion"] * (params.max_motion / 7.0)).contiguous()
    stack = torch.cat([P["h_color"], P["h_moments"], P["h_length"][None],
                       P["depth"][None], P["normal"]]).contiguous()
    total = {k: 0 for k in WRAPPERS}
    for motion_grad in (True, False):
        grads = {}
        for path in ("sharded", "unsharded"):
            m = motion.clone().requires_grad_(motion_grad)
            g = GBuffer(render=P["color"], albedo=P["color"],
                        normal=P["normal"], depth=P["depth"], motion=m)
            if path == "sharded":
                leaf = F.pad(stack, (mh, mh, mh, mh)).requires_grad_()
                reset_counts()
                integ, _, _ = sharded.temporal_accumulate_canvas_local(
                    g, leaf, H, W, mesh=mesh, params=params,
                    motion_grad=motion_grad)
                (integ ** 2).mean().backward()
                for k, n in read_counts(10, ("K4c",) + (
                        ("K5c",) if motion_grad else ("K6c",))).items():
                    total[k] += n
                d_hist = leaf.grad[:, mh:mh + H, mh:mh + W]
            else:
                leaf = stack.clone().requires_grad_()
                integ, _, _ = temporal_accumulate_ad_cuda(
                    g, temporal.history_from_stack(leaf), params=params,
                    motion_grad=motion_grad)
                (integ ** 2).mean().backward()
                d_hist = leaf.grad
            grads[path] = (m.grad, d_hist)
        (ms_, hs), (mu, hu) = grads["sharded"], grads["unsharded"]
        check_close(f"canvas d_history (motion_grad={motion_grad})", hs, hu,
                    atol=3e-3 * float(hu.abs().max()))
        if motion_grad:
            check_close("canvas d_motion", ms_, mu,
                        atol=3e-3 * float(mu.abs().max()))
    phase(10, f"(a) temporal gradient on the history canvas {W}x{H}: "
              f"d_motion and d_history match the unsharded step; launches "
              f"{ {k: n for k, n in total.items() if n} }")
    return total


def sharded_pipeline_phase(H, W, dev, n_frames, rm=RaymarchParams(), n=10,
                           label="(b)", expected=("K1", "K3b", "K7", "K8")):
    """10(b): ``make_sharded_pipeline`` (K7/K8 windows, K3b on the history
    canvas, the chained K1 sweep) on the (1, 1, 1) mesh against the
    unsharded ``FramePipeline`` on the same frames and light samples; 11(e)
    the same with ``coarse_seed`` (each tile seeded from the camera at its
    window origin; K15, K7s)."""
    scene = raymarch.cornell_scene(device=dev)
    mesh = make_mesh()
    cfg = dict(cam_cfg=CameraParams(width=W, height=H), rm_params=rm,
               svgf_params=SERVING)
    run = sharded.make_sharded_pipeline(mesh, H, W,
                                        weight_math=SERVING_WEIGHTS, **cfg)
    pipe = FramePipeline(scene, weight_math=SERVING_WEIGHTS, **cfg)
    hs = sharded.init_history_canvas(mesh, H, W, SERVING, device=dev)
    hu = History.zeros(H, W, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    prev, times, utimes = None, [], []
    counts = {k: 0 for k in WRAPPERS}
    for f in range(n_frames):
        cam = orbit_camera(f / SEQ_FRAMES, device=dev)
        lp = raymarch.sample_light(scene, gen, (H, W))
        with CudaTimer() as tm:
            a, hs = counted(lambda: run(scene, cam, prev, hs,
                                        light_sample=lp), counts)
        times.append(tm.ms)
        with torch.no_grad(), CudaTimer() as tm:
            b, hu = pipe(cam, prev, hu, light_sample=lp)
        utimes.append(tm.ms)
        check_close(f"sharded frame {f} denoised (vs unsharded)", a.denoised,
                    b.denoised, atol=1e-3 * float(b.denoised.abs().max()))
        prev = cam
    require_launched(n, counts, expected)
    steady, usteady = times[1:] or times, utimes[1:] or utimes
    phase(n, f"{label} sharded pipeline {W}x{H} on a {mesh.axis_sizes} mesh, "
              f"{n_frames} frames: {sum(steady) / len(steady):.3f} ms/frame "
              f"(frames 2-{n_frames}; unsharded "
              f"{sum(usteady) / len(usteady):.3f}); every frame matches the unsharded path; launches {counts}")
    return counts


def sharded_train_phase(H, W, dev, rm=RaymarchParams(), steps=UHD_STEPS,
                        n=10, label="(c)",
                        expected=("K1", "K2", "K4c", "K7", "K8")):
    """10(c): ``make_sharded_train_step`` (K7/K8 windows, K4c, the stored
    K1/K2 sweep with tile origins; the albedo is differentiated, not the
    history carry, so no gather adjoint runs) on the (1, 1, 1) mesh against
    ``make_train_step``: the same light samples, loss rtol 1e-5, albedo
    gradient atol 3e-3·max, as phase 5; 11(f) the same with
    ``coarse_seed`` (config 5's step; K15, K7s)."""
    scene = raymarch.cornell_scene(device=dev)
    mesh = make_mesh()
    target = torch.from_numpy(np.random.default_rng(0).random(
        (3, H, W), dtype=np.float32)).to(dev)
    kw = dict(cam_cfg=CameraParams(width=W, height=H), rm_params=rm,
              svgf_params=TRAIN)
    cam = raymarch.cornell_camera(device=dev)
    step_s = sharded.make_sharded_train_step(mesh, scene, cam, target, **kw)
    step_u = make_train_step(scene, cam, target, **kw)
    state_s = sharded.init_sharded_train_state(mesh, scene.materials.albedo,
                                               H, W, TRAIN)
    state_u = init_train_state(scene.materials.albedo, H, W)
    gen = torch.Generator(dev).manual_seed(0)
    times, utimes = [], []
    counts = {k: 0 for k in WRAPPERS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for k in range(1 + steps):
        lp = raymarch.sample_light(scene, gen, (H, W))
        with CudaTimer() as tm:
            state_s, ls = counted(lambda: step_s(state_s, light_sample=lp),
                                  counts)
        times.append(tm.ms)
        with CudaTimer() as tm:
            state_u, lu = step_u(state_u, light_sample=lp)
        utimes.append(tm.ms)
        if abs(float(ls) - float(lu)) > 1e-5 * abs(float(lu)):
            raise AssertionError(f"sharded train step {k}: loss {float(ls)} "
                                 f"vs unsharded {float(lu)}")
        check_close(f"sharded train step {k} albedo gradient",
                    state_s.albedo.grad, state_u.albedo.grad,
                    atol=3e-3 * float(state_u.albedo.grad.abs().max()))
    require_launched(n, counts, expected)
    peak = torch.cuda.max_memory_allocated() - base
    t, u = times[1:], utimes[1:]
    phase(n, f"{label} sharded train step {W}x{H} on a {mesh.axis_sizes} "
             f"mesh: "
              f"{sum(t) / len(t):.3f} ms/step over {len(t)} steps after one "
              f"(unsharded {sum(u) / len(u):.3f}); losses and gradients "
              f"match the unsharded step; peak memory of both "
              f"{peak / 2**30:.3f} GiB; launches {counts}")
    return counts


def scaling_phase(H, W, dev):
    """10(e): the weak-scaling harness's one-rank row
    (``parallel.scaling.weak_scaling`` on this card's (1, 1, 1) mesh, a
    3840x2160 tile, the 5-level sweep forward and backward on the chained
    kernels), and the same step on one rank that
    ``parallel.distributed.spawn_group`` starts on the card (the NCCL
    route of more ranks).  One card: the row is t(1), not a scaling
    number."""
    kw = dict(tile=(H, W), steps=SCALING_STEPS)
    reset_counts()
    row = scaling.weak_scaling([1], device=dev, **kw)[0]
    counts = read_counts(10, ("K1b", "K14"))
    spawned = spawn_group(1, "nccl", scaling._step_rank, kw,
                          join_timeout=300)[0]["seconds"]
    if not row["sec_per_step"] > 0 or not spawned > 0:
        raise AssertionError(f"phase 10(e): times {row['sec_per_step']}, "
                             f"{spawned}")
    phase(10, f"(e) weak-scaling row, one rank (not a scaling number): "
              f"{json.dumps(row)}; launches {counts}; one NCCL rank "
              f"spawned: {spawned:.6f} s a step")
    return counts


def _geometry_leaves(scene):
    geo = [getattr(scene, k).clone().requires_grad_() for k in GEOMETRY]
    return dataclasses.replace(scene, **dict(zip(GEOMETRY, geo))), geo


def _check_grads(label, got, want, names, tol=GEOMETRY_TOL):
    errs = []
    for name, a, b in zip(names, got, want):
        scale = float(b.abs().max())
        check_close(f"{label} d_{name}", a, b, atol=tol * scale)
        errs.append(max_err(a, b) / max(scale, 1e-30))
    return max(errs)


def geometry_grad_phase(H, W, dev):
    """12: gradients with respect to the scene's geometry (spheres, boxes,
    planes) at 1920x1080 through the implicit-function adjoint: (a)
    ``render_gbuffer`` (K7, then K8, whose backward hands the hit point's
    and the normal's cotangents to the march) against ``impl="plain"`` on
    the card, d(Σ w·render + Σ depth + Σ w_m·motion); (b) the same with
    ``coarse_seed`` (K15, then K7s): finite, its gap to (a) printed, not
    bounded (the seeded hit points differ within hit_eps); (c) the seeded
    march alone (K7s) against the plain seeded march, d(Σ w_t·t + Σ
    w_n·n) with respect to the geometry and rd.  Bounded: atol 2e-3·max of
    each gradient (the CPU tests' bound against JAX), pixels whose hit,
    material, depth or render differs on an ulp carrying no weight."""
    base = raymarch.cornell_scene(device=dev)
    cfg = CameraParams(width=W, height=H)
    cams = (orbit_camera(0.25, device=dev), orbit_camera(0.1875, device=dev))
    lp = raymarch.sample_light(base, torch.Generator(dev).manual_seed(0),
                               (H, W))
    with torch.no_grad():
        a, b = (raymarch.render_gbuffer(base, *cams, cam_cfg=cfg,
                                        params=RaymarchParams(),
                                        light_sample=lp, impl=impl)
                for impl in ("auto", "plain"))
    keep = ~(((a.albedo - b.albedo).abs().amax(0) > 1e-4)
             | ((a.depth - b.depth).abs() > 1e-4)
             | ((a.render - b.render).abs().amax(0) > 1e-2))
    gen = torch.Generator(dev).manual_seed(6)
    w = torch.rand((3, H, W), generator=gen, device=dev) * keep
    w_m = torch.rand((2, H, W), generator=gen, device=dev) * keep * 1e-3

    def render_grads(impl, rm):
        scene, geo = _geometry_leaves(base)
        g = raymarch.render_gbuffer(scene, *cams, cam_cfg=cfg, params=rm,
                                    light_sample=lp, impl=impl)
        ((w * g.render).sum() + (keep * g.depth).sum()
         + (w_m * g.motion).sum()).backward()
        return [x.grad for x in geo]

    counts = {k: 0 for k in WRAPPERS}
    with CudaTimer() as tm:
        kern = counted(lambda: render_grads("auto", RaymarchParams()),
                       counts)
    plain = render_grads("plain", RaymarchParams())
    err_a = _check_grads("12(a) render_gbuffer", kern, plain, GEOMETRY)
    seeded = counted(lambda: render_grads("auto", SEEDED), counts)
    if not all(bool(torch.isfinite(x).all()) for x in seeded):
        raise AssertionError("12(b): seeded geometry gradient not finite")
    gap_b = max(max_err(x, y) / float(y.abs().max())
                for x, y in zip(seeded, kern))

    ro, rd, _ = raymarch.camera_rays(cams[0], cfg)
    t_c = cone_seed_cuda(base, SEEDED, camera=cams[0], cam_cfg=cfg,
                         shape=(H, W))[0]
    with torch.no_grad():
        k = march_gbuf_seeded_cuda(base, ro, rd, t_c, SEEDED)
        q = raymarch.march_gbuf(base, ro, rd, SEEDED, seed=t_c)
    keep_m = ((k[1] == q[1]) & (k[2] == q[2])
              & ((k[3] - q[3]).abs() <= 5e-4 + 5e-3 * q[3].abs()).all(0))
    w_t = (torch.rand((H, W), generator=gen, device=dev) + 0.5) * keep_m
    w_n = (torch.rand((3, H, W), generator=gen, device=dev) - 0.5) * keep_m

    def march_grads(fn):
        scene, geo = _geometry_leaves(base)
        rdv = rd.clone().requires_grad_()
        t, _hit, _mat, n = fn(scene, rdv)
        ((w_t * t).sum() + (w_n * n).sum()).backward()
        return [x.grad for x in geo] + [rdv.grad]

    kern_c = counted(lambda: march_grads(
        lambda sc, rdv: march_gbuf_seeded_cuda(sc, ro, rdv, t_c, SEEDED)),
        counts)
    plain_c = march_grads(lambda sc, rdv: raymarch.march_gbuf(
        sc, ro, rdv, SEEDED, seed=t_c))
    err_c = _check_grads("12(c) seeded march", kern_c, plain_c,
                         GEOMETRY + ("rd",))
    require_launched(12, counts, ("K7", "K8", "K15", "K7s"))
    phase(12, f"geometry gradients {W}x{H} through the implicit-function "
              f"adjoint: (a) render_gbuffer K7+K8 vs plain, max |err| "
              f"{err_a:.3g}·max (bound {GEOMETRY_TOL:g}), forward+backward "
              f"{tm.ms:.3f} ms; (b) coarse_seed (K15, K7s): finite, gap to "
              f"(a) {gap_b:.3g}·max (not bounded); (c) seeded march K7s vs "
              f"plain {err_c:.3g}·max; {int((~keep).sum())} and "
              f"{int((~keep_m).sum())} flipped pixels unweighted; launches "
              f"{counts}")
    return counts


def quality_phase(dev, kept):
    """13: the denoiser-quality gate at the card size
    (``utils/denoise_quality.py``): the Cornell and clutter orbits at
    256², 16 frames, 1024-sample converged renders (K7, then K13 once a
    sample), scored after 4 frames through ``svgf_denoise_frame`` (K3,
    K1) with fast weights, r1 and r2 at 5 iterations; fails below
    ``tests/test_quality.py``'s thresholds.  Keeps the Cornell sequence
    and its r1 score in ``kept`` for phase 14."""
    counts = {k: 0 for k in WRAPPERS}
    lines = []
    for scene_kind in ("cornell", "clutter"):
        t0 = time.perf_counter()
        seq = counted(lambda: denoise_quality.render_sequence(
            scene_kind=scene_kind, device=dev, **GATE), counts)
        torch.cuda.synchronize()
        t_render = time.perf_counter() - t0
        bars = GATE_BARS[scene_kind]
        for label, kw in GATE_CASES:
            t0 = time.perf_counter()
            q = counted(lambda: denoise_quality.score(
                seq, weight_math="fast", **kw), counts)
            t_score = time.perf_counter() - t0
            if not (q["psnr_gain_db"] > bars["gain"]
                    and q["output_ssim"] > bars["ssim"]
                    and q["output_ssim"] > q["input_ssim"]
                    + bars["ssim_gain"]):
                raise AssertionError(f"phase 13: {scene_kind} {label} "
                                     f"below the gate {bars}: {q}")
            if scene_kind == "cornell" and label == "r1":
                kept.update(cornell=seq, cornell_r1=q)
            lines.append(f"{scene_kind} {label} fast: PSNR "
                         f"{q['input_psnr_db']} -> {q['output_psnr_db']} dB "
                         f"(gain {q['psnr_gain_db']}), SSIM "
                         f"{q['input_ssim']} -> {q['output_ssim']}, scored "
                         f"in {t_score:.2f} s")
        lines.append(f"{scene_kind} rendered in {t_render:.2f} s")
    require_launched(13, counts, ("K1", "K3", "K7", "K8", "K13"))
    phase(13, f"quality gate {GATE['size']}^2, {GATE['frames']} frames, "
              f"{GATE['spp_ref']}-spp references, warm-up {GATE['warmup']}: "
              + "; ".join(lines) + f"; launches {counts}")
    return counts


def bf16_serving_phase(H, W, dev, kept):
    """14: ``FramePipeline(precision="bf16")`` serves ``BF16_FRAMES`` orbit
    frames beside the float32 pipeline (the same configuration: radius 1,
    exact weights); each bf16 frame's PSNR against the float32 frame
    (peak: the float32 frame's max, as ``tools/quality_eval.py``) >=
    ``BF16_PSNR_DB``; the walls (host-bound) in ``BF16_WALL_ROUNDS``
    rounds of turns bf16, f32, f32, bf16, their medians and quartiles of
    the runs' steady means.  Then the half-resolution deep levels on phase
    13's Cornell orbit: ``score(pyramid_from=PYRAMID_FROM, impl="plain")``
    beside the plain sweep without them (r1, exact weights, the JAX tool's
    reference path) and phase 13's kernel-path r1 score."""
    scene = raymarch.cornell_scene(device=dev)
    cfg = dict(cam_cfg=CameraParams(width=W, height=H),
               rm_params=RaymarchParams(), svgf_params=BF16_SERVING,
               weight_math="exact")
    # the σ-denominator's PyTorch glue, counted where it runs on the card
    glue = {"sigma_denominator": 0}
    plain_sigma = atrous_cuda.sigma_denominator

    def counted_sigma(variance, params, **kw):
        glue["sigma_denominator"] += int(variance.is_cuda)
        return plain_sigma(variance, params, **kw)

    reset_counts()
    atrous_cuda.sigma_denominator = counted_sigma
    try:
        times16, frames16 = run_sequence(
            FramePipeline(scene, precision="bf16", **cfg), BF16_FRAMES, H,
            W, dev, BF16_FRAMES)
    finally:
        atrous_cuda.sigma_denominator = plain_sigma
    counts = read_counts(14, ("K1b-bf16", "K1b-bf16-fused", "K3", "K7",
                              "K8"))
    if counts["K1b"] or counts["K1"]:
        raise AssertionError(f"phase 14: the bf16 pipeline launched a "
                             f"float32 level: {counts}")
    levels = BF16_FRAMES * BF16_SERVING.iterations
    if (counts["K1b-bf16-fused"] != levels or counts["K1b-bf16"] != levels
            or glue["sigma_denominator"]):
        raise AssertionError(f"phase 14: the bf16 route launched "
                             f"{counts['K1b-bf16-fused']} fused-σ levels of "
                             f"{counts['K1b-bf16']} (expected {levels}) and "
                             f"ran sigma_denominator {glue} times on the "
                             f"card (expected 0)")
    times32, frames32 = run_sequence(FramePipeline(scene, **cfg),
                                     BF16_FRAMES, H, W, dev, BF16_FRAMES)
    dbs = []
    for f, (a, b) in enumerate(zip(frames16, frames32)):
        want = b.denoised.double()
        mse = float(((a.denoised.double() - want) ** 2).mean())
        peak = float(want.max())
        dbs.append(99.0 if mse == 0 else 10.0 * np.log10(peak * peak / mse))
        if dbs[-1] < BF16_PSNR_DB:
            raise AssertionError(f"phase 14: frame {f} bf16 PSNR "
                                 f"{dbs[-1]:.2f} dB < {BF16_PSNR_DB} "
                                 f"against the float32 frame")
    walls = {"bf16": [times16], "f32": [times32]}
    # the first round's bf16 and f32 runs are the checked ones above
    turns = (("f32", "bf16")
             + ("bf16", "f32", "f32", "bf16") * (BF16_WALL_ROUNDS - 1))
    for precision in turns:
        pipe = FramePipeline(scene, **cfg, **(
            {"precision": precision} if precision == "bf16" else {}))
        walls[precision].append(run_sequence(pipe, BF16_FRAMES, H, W, dev,
                                             0)[0])
    steady = {k: [sum(t[1:]) / len(t[1:]) for t in v]
              for k, v in walls.items()}
    q = {k: np.percentile(v, (25, 50, 75)) for k, v in steady.items()}
    verdict = ("bf16 faster (its upper quartile under f32's lower)"
               if q["bf16"][2] < q["f32"][0] else
               "bf16 slower (its lower quartile over f32's upper)"
               if q["bf16"][0] > q["f32"][2] else
               "unresolved (the quartiles overlap)")
    runs = {k: ", ".join(f"{t:.3f}" for t in v) for k, v in steady.items()}
    phase(14, f"bf16 serving {BF16_FRAMES} frames {W}x{H} (r1, exact), "
              f"ms/frame (frames 2-{BF16_FRAMES}), {len(steady['bf16'])} "
              f"runs each in rounds of turns bf16, f32, f32, bf16: bf16 "
              f"median {q['bf16'][1]:.3f} (quartiles {q['bf16'][0]:.3f}-"
              f"{q['bf16'][2]:.3f}), float32 median {q['f32'][1]:.3f} "
              f"(quartiles {q['f32'][0]:.3f}-{q['f32'][2]:.3f}): {verdict}; "
              f"runs bf16 [{runs['bf16']}], float32 [{runs['f32']}];"
              f" PSNR against the float32 frames "
              + ", ".join(f"{d:.2f}" for d in dbs)
              + f" dB (min {min(dbs):.2f}); σ fused in all {levels} levels, "
              f"sigma_denominator on the card 0 times; launches {counts}")
    seq = kept["cornell"]
    t0 = time.perf_counter()
    pyr = denoise_quality.score(seq, iterations=5, radius=1,
                                pyramid_from=PYRAMID_FROM, impl="plain")
    t_pyr = time.perf_counter() - t0
    flat = denoise_quality.score(seq, iterations=5, radius=1, impl="plain")
    for q in (pyr, flat):
        if not np.isfinite(q["output_psnr_db"]):
            raise AssertionError(f"phase 14: non-finite score {q}")
    k13 = kept["cornell_r1"]
    phase(14, f"pyramid_from={PYRAMID_FROM} (plain path) on phase 13's "
              f"Cornell orbit, r1 exact: PSNR {pyr['input_psnr_db']} -> "
              f"{pyr['output_psnr_db']} dB (gain {pyr['psnr_gain_db']}), "
              f"SSIM {pyr['output_ssim']}, scored in {t_pyr:.2f} s; without "
              f"it (plain): {flat['output_psnr_db']} dB (gain "
              f"{flat['psnr_gain_db']}), SSIM {flat['output_ssim']}; phase "
              f"13 kernel path r1 fast: {k13['output_psnr_db']} dB (gain "
              f"{k13['psnr_gain_db']})")
    return counts


def sharded_cli_phase():
    """10(d): the CLI's SHARDED_SPATIAL case on the card."""
    reset_counts()
    rc = cli.main(["-t", "SHARDED_SPATIAL"])
    counts = read_counts(10, ("K1",))
    if rc != 0:
        raise AssertionError(f"phase 10: cli SHARDED_SPATIAL returned {rc}")
    phase(10, f"(d) cli -t SHARDED_SPATIAL: passed; launches {counts}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=SEQ_FRAMES)
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's register/spill report")
    args = ap.parse_args(argv)
    W, H = args.width, args.height

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = nvidia_smi_name_power()
    phase(1, f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    lib = _build.build(verbose=args.verbose_build)
    _build.kernels()
    phase(2, f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    report_resources()
    report_sass_mix()

    results = {}
    P = random_planes(H, W, dev, seed=0)
    check_k1(P, results)
    check_k1_store_k2(P, results)
    check_adjoint_kernels(P, results)
    check_wide_adjoints(P, results)
    check_bf16_kernels(P, results)
    check_k3(P, results)
    check_k16(P, results)
    check_k4_k5_k6(P, results)
    check_filters(P, results)
    check_wide_forms(P, results)
    check_k7_k8(H, W, dev, results)
    check_k13(H, W, dev, results)
    check_cone_seed(H, W, dev, results)
    check_clamped_gather(H, W, dev, results)
    del P
    torch.cuda.synchronize()

    launches = {k: 0 for k in WRAPPERS}
    for run in (lambda: serving_phase(H, W, dev, args.frames),
                lambda: train_phase(H, W, dev),
                lambda: temporal_grad_phase(H, W, dev), cli_phase,
                lambda: dataset_phase(H, W, dev),
                lambda: adjoint_phase(H, W, dev),
                lambda: seeded_serving_phase(H, W, dev, args.frames),
                lambda: seeded_train_phase(H, W, dev),
                lambda: serving_phase(
                    H, W, dev, UNBOUNDED_FRAMES, svgf=UNBOUNDED, n=11,
                    label="(c) unbounded motion (max_motion=None), ",
                    expected=("K1", "K3", "K7", "K8")),
                lambda: temporal_grad_phase(
                    H, W, dev, params=SVGFParams(iterations=5, radius=1,
                                                 max_motion=None),
                    motion_scale=4.0, n=11,
                    label="(d) unbounded motion (max_motion=None), ",
                    expected=lambda mg: ("K1", "K2", "KG", "KGb",
                                         "KGp"))):
        for k, n in run().items():
            launches[k] += n

    UH, UW = UHD_H, UHD_W
    kept = {}
    P = random_planes(UH, UW, dev, seed=12)
    tile_ms = {}
    check_level_tiles(P, results, tile_ms)
    check_temporal_canvas_tiles(P, results, tile_ms)
    for k, n in sharded_temporal_grad_phase(P).items():
        launches[k] += n
    del P
    check_cone_seed_uhd(UH, UW, dev)
    torch.cuda.synchronize()
    for run in (lambda: sharded_pipeline_phase(UH, UW, dev, UHD_FRAMES),
                lambda: sharded_train_phase(UH, UW, dev), sharded_cli_phase,
                lambda: sharded_pipeline_phase(
                    UH, UW, dev, SEEDED_UHD_FRAMES, rm=SEEDED, n=11,
                    label="(e) coarse_seed:",
                    expected=("K1", "K3b", "K15", "K7s", "K8")),
                lambda: sharded_train_phase(
                    UH, UW, dev, rm=SEEDED, steps=SEEDED_UHD_STEPS, n=11,
                    label="(f) coarse_seed:",
                    expected=("K1", "K2", "K4c", "K15", "K7s", "K8")),
                lambda: scaling_phase(UH, UW, dev),
                lambda: geometry_grad_phase(H, W, dev),
                lambda: quality_phase(dev, kept),
                lambda: bf16_serving_phase(H, W, dev, kept)):
        for k, n in run().items():
            launches[k] += n

    report = []
    for k, (name, source, replaces) in KERNELS.items():
        r = results[k]
        bound_ms, bound_by = bound(r.pop("bytes"), r.pop("flops"))
        report.append(dict(name=name, route="cuda", source=source,
                           replaces=replaces, launches=launches[k],
                           max_abs_err=r["max_abs_err"], ms=r["ms"],
                           plain_ms=r["plain_ms"], bound_ms=bound_ms,
                           bound_by=bound_by,
                           library_ms=r.get("library_ms"),
                           **({"form_of": KERNELS[FORM_OF[k]][0]}
                              if k in FORM_OF else {})))
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
