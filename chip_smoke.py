#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Run from the repository root:

    python3 chip_smoke.py [--parent DIR]

(``--parent``: a checkout of an earlier commit; phase 6 also times its
BVH kernel on the same launches, one by one, its whole-trace kernel on
the same pass of each whole-trace cell, its shade kernel on 7/fused's
shade launches and its probe kernel on the probes, in turns, each bound
to this build's C interface, which each parent build must report: a
parent from e9ce31e on, whose BVH kernel may have the C interface before
BvhOptions (3), called without the options.)

The paths, each a cell: the whole-trace kernel (configs 1 to 5 under
tri_backend="auto", and config 6's 98,304-slot table under "fused": the
TPU's packed form), its nine-row form for a texture skybox (config 3 with
a 2048x1024 RGBE texture, written as an .hdr and read back), the split
per-bounce path with the BVH kernel (config 6 under "auto": the two_level
variant, also with a 2048x1024 8-bit texture; configs 5 and 4 under "bvh":
flat;
config 7's 1.31M triangles under "auto": streamed), the fused per-bounce
path (config 7 under "fused": the streamed BVH variant and the per-bounce
shade kernel, each bounce), the split path with the brute-force triangle
kernel (configs 5 and 6 under "pallas") and with the dense PyTorch loop
(config 4 under "jnp", no kernel), and the BVH kernel's Plucker form
(SRT_BVH_MT=plucker, set for the cell and restored after it: config 6
"auto", two_level; config 7 "auto", streamed; config 6 clustered at
Scene.cluster_size=256, streamed at K = 256, in both forms), and the BVH
kernel's sub-box form (SRT_BVH_SUBBOX=8, set while the cell's own scene
is built and while it runs: config 6 "auto", two_level; config 7
"auto", streamed).  The
lowering probes (simple_raytracer_tpu_torch/scripts/probe_kernel_ops.py)
are a path of their own.  Phases, one line each on stdout:
  1. the card's name and power limit (nvidia-smi), and whether PIL (the
     8-bit skybox loader's dependency) is installed;
  2. the build of the five kernel sources, one nvcc each, and of the
     host library (csrc/host_accel.cpp:
     the binned-SAH BVH build, the STL parse; the host compiler), all
     started together; the
     whole-trace kernel's sections as compiled (a sphere
     test, a plane test, MT, a BSDF sample, a uniform, the gradient sky;
     cuobjdump of each built alone from the kernel's source);
  3. the main paths: each cell at its preset size through
     Renderer(device="cuda"), 4 progressive steps, with every kernel's
     launch counts (in all and per variant) reset just before and read
     just after the cell; the scene build's seconds (once per scene; the
     BVH is the host library's binned SAH), the
     Plucker coefficient table's, the BVH kernel's staged MT table's and
     the triangle kernel's staged table's (once per scene, on first use);
     then the probes' run() and floor_us() (each probe on the four
     seeded inputs of probe_inputs, timed in a CUDA graph and from
     Python, its timing instance; an empty cluster launch), their
     counts reset just before them;
  4. each kernel against its plain PyTorch version on the card, one pass
     of each cell at full size: the whole-trace canvas (config 6 under
     "fused": a full-width band of rows, the plain version being a dense
     loop over 81,920 triangles), and for the texture the nine rows before
     the sample; for the per-bounce cells every BVH launch's (t, slot) on
     live rays, every shade launch's 20 state rows, every triangle
     launch's (t, index) on every ray, dead rays (+inf, 0) included, with
     each launch's live rays; every compacted BVH launch's ray order, made
     inside the launch, against ops/bvh.compact_order (the same count and
     admitted rays), and every BVH launch replayed on the kernel's
     counting instance, its (t, slot) the route's
     (config 6 under "pallas": a band of rows;
     the kernel visits live rays only), and the canvas, and the
     triangle kernel on ragged random tables and ray batches (RAGGED);
     the whole-trace kernel's clustered cells (configs 4, 5 and 6
     "fused") on its counting instance, whose output must be the
     route's, its counts per bounce beside the (cluster, ray) pairs that
     the plain version's rays need (6 "fused": a full pass of the split
     path over the same rays); configs 1, 2, 3 and 3/texture on the same
     counting instance, held to the route's output: per bounce the live
     rays and the warps or warp-steps that carried them, over the launch
     the lanes with a path a warp-step, the fetches of path indices, the
     SM cycles in ray generation, the sphere and plane tests, MT, the
     BSDF sample and the sky, against the blocks' slot time, and the
     blocks an SM holds;
     config 4 under "jnp" against the "pallas"
     route on the same rays; then, for config 6 and configs 5 and 4
     under "bvh", the per-ray gate against a gate-free dense
     Moller-Trumbore over every triangle, on every launch of a pass of
     one full-width band of rows; and the
     nine rows of configs 2, 3 and 4 with the texture at the golden size;
     config 7 "fused" under the Plucker form, every BVH launch against the
     plain version; every launch of the sub-box cells against the gated
     plain version and the ungated kernel (the same launch without its
     gate), and so config 6 at SRT_BVH_SUBBOX=2 and 4 and config 7 under
     "fused" at 8, one pass each; each Plucker launch replayed in the MT form (a report:
     winners changed, largest relative t difference) and, where it was
     compacted, without compaction against the plain version (the first
     such launch of a pass); each probe against its plain version on
     the four seeded inputs (bit for bit on integer values, A and B
     within rtol 1e-6 of the sum on the uniform floats);
  5. the golden-size renders (tests/test_golden.py) against
     tests/goldens/config{1..6}.npz (config 6 also under "fused" and
     "pallas", in the Plucker form, at cluster_size=256 in both forms and
     with SRT_BVH_SUBBOX=8, config 5 under "pallas" and at cluster_size=256 (the whole-trace
     kernel), config 4 under "jnp"; config 7 has none); a 1,025-sphere
     scene (tables above 48 KB of shared memory)
     against the plain version; benchmark_step leaves the canvas and step
     count as they were;
  6. timings with CUDA events, and each kernel's bound (and the texture's
     sample beside the nine-row kernel; the clustered whole-trace cells
     bounded by the BVH rows' rule; with
     --parent the parent's kernel on the pass of every whole-trace cell,
     in turns, every output bit equal to this one's; the walk's
     constants swept: the split point, the ring and the block, and on
     configs 1, 2, 3 and 3/texture the path variants': the
     blocks and the fetch, each a build of its own, every output the
     route's; with --parent also the parent's shade kernel on 7/fused's
     launches, in turns); the triangle kernel's launches
     of a pass one by one (per bounce, with its live rays and what its
     early-out keeps), the pass with every ray dead (the live-ray
     compaction and an empty grid) and with every ray live, its bound
     over the live (ray, triangle) pairs in its early-out form (the
     pairs each test of the form keeps, counted on sampled warps of
     each launch), and full MT over the live pairs and over every ray
     beside it; benchmark_step of
     configs 6 and 7 under "auto" and "fused" side by side; the BVH
     kernel's Plucker form against its MT form on the same launches, in
     turns; every BVH cell's launches one by one (each launch's time and
     its kernels' device times, the order's and compaction's beside the
     walk's; with --parent the parent's kernel on the same launch, in
     turns; compact_order's and prepare's time on the same rays; what
     the walk did, from its counting instance, against the (ray, cluster)
     pairs the plain version's gates admit); the streamed launches
     replayed on two_level (the same walk); two_level's and flat's
     launches on builds of the kernel with the warp walk's constants
     swept (the split point, the ring), in turns with the route;
     the probes' time per call (in a CUDA graph and from Python) beside
     an empty cluster launch of the same shape, the loop's SM cycles an
     iteration and the spans of a CTA (the timing instance), and with
     --parent the parent's probe kernel in turns, in a CUDA graph and
     from Python; cells 6, 7 and
     6/fused (rows 4, 5 and 1b') on the SAH layout against a scene built
     with the NumPy median split (accel.build_bvh(force_python=True)):
     the kernel's pass in turns, its MT pairs and lane-slot MT tests
     (the counting instance), the staged MT table's MB and the median
     build's seconds; the sub-box cells' launches in turns with the
     ungated kernel's on the same rays (with --parent also the parent's
     gated kernel, in turns), and both counting instances' lane-slot MT
     tests, sub-box tests, clusters and chunks skipped and the walk's SM
     cycles (of them, waiting for a super's sub-box block and making its
     words);
  7. where a Renderer.step's time goes (torch.profiler; 20 steps, 5 of
     a per-bounce cell; not the sub-box cells);
  8. the command-line path: simple_raytracer_tpu_torch.cli.main in
     process (--device cuda) at the presets' sizes, every kernel's counts
     reset just before its runs and read just after: config 2 over 4
     steps to a PNG and a PPM with --save-state, resumed for 4 more with
     --load-state and held bit for bit to an uninterrupted 8-step run
     (--time-seed 7), and --warm (which writes nothing); config 3 with
     --skybox (phase 3's seeded 2048x1024 .hdr: rows 1a and 1c); config 4
     with --mesh-path to an OBJ and an STL written by save_obj/save_stl
     from organic_blob, and config 5 from --scene (save_scene; row 1b);
     --aov normals, depth and albedo on configs 2, 5 and 6 (the split
     path: rows 3 and 4); then config 5 with one model moved through
     Renderer.update_scene(refit=True) and one pass (row 1b), the refit's
     host seconds beside a full build's.  After the counts: every
     whole-trace pass of those runs against its plain version on a band
     of rows (the rule of phase 4), every AOV BVH launch against its
     plain version ((t, slot) on every live ray) and each AOV canvas
     against the plain BVH version's (the canvas rule), and each AOV pass
     timed with CUDA events;
  9. multi-device bands on the one card (parallel/, the counts reset just
     before each banded run and read just after): config 2 at 1920x1080
     in 4 bands over ["cuda:0"] * 4, configs 2, 5 and 6 (the split path,
     two_level) and the three showcase scenes at 960x540 in 2 bands, 2
     steps each, every canvas bit for bit the single-device Renderer's
     on the same device scene, with each case's launches, the host
     syncs of a banded step (torch.cuda.set_sync_debug_mode) and
     benchmark_step banded and single; the CLI's config 2 with
     --all-devices --distributed in 2 processes on the card (gloo on
     localhost), rank 0's PNG and checkpoint bit for bit the one-process
     CLI's and no file from rank 1; dryrun_multichip(2);
 10. editing and the viewer on the card (viewer.py, editor.py; the counts
     reset just before the phase and read just after): on configs 2 and 5
     at their presets, a RenderLoop (its thread not started) takes
     add_sphere, update_material (an emission), set_sky, duplicate_shape,
     remove_shape of the original, on config 5 a translate drag_shape of
     a model (a refit) and set_render (one more sample, after its swap),
     each through handle_edit; after each the loop's renderer is cleared
     and stepped at two fixed time seeds, bit for bit a fresh Renderer's
     over a deep copy of the edited scene; the refit's canvas is held to
     the settle rebuild's (update_scene) by the canvas rule of phase 4,
     and the rebuild's canvas is bit for bit the fresh one's.  Then the
     live viewer as serve() starts it, config 2 with the viewer's
     defaults (1 spp, 6 bounces), fps_limit 0, wall-clock seeds, on
     127.0.0.1: at 960x540 /frame.png's size, 3 s of /state (frames/s,
     the FrameTimer's ms/frame, and the frame split into the step's
     launches, image() and the PNG encode), /input "w" (a reset), /pick
     at a sphere's centre pixel, /edit drag_shape, the p screenshot (a
     960x540 PPM), and a set_render swap while the loop runs, /state's
     error null throughout; at 480x272 the frame rate.  At most 40 s;
 11. the JAX package's opt-in switches (SWITCHES; the counts reset just
     before each pass and read just after): configs 6 and 7 under "auto"
     and "fused", one pass under each of SRT_BVH_COMPACT_KEY=morton,
     SRT_BVH_ORDER=rev, SRT_BVH_COMPACT=0 and 1, SRT_BVH_DMA_SLOTS=4 and
     8 (the ring builds, built in phase 2), SRT_BVH_PACKED_VMEM_MAX=700
     (config 6 on streamed), SRT_MEGA_PACKED_MAX=700 (config 6 under
     "fused" on the fused per-bounce path) and SRT_MEGA_MT_SLICES=3 (the
     last three read at import: the module's constant set as an import
     would set it): each pass's radiance bit for bit the switch-free
     pass's, every BVH launch's (t, slot) the switch-free launch's and the
     plain version's on live rays, every compacted order compact_order's
     under the launch's key, the route the switch asks for; the pass and
     its BVH launches timed in turns with the switch-free ones; config 7's
     dense launches (under SRT_BVH_COMPACT=0) replayed with
     sort_rays=True, equal and timed in turns.
Then one JSON line per the kernel table (with the ring builds of phase 11
on config 7) (the triangle kernel's row also
carries its full-MT bounds over the live pairs and over every ray, and
its 6/pallas numbers), the card line again, and the last line {"ok": true, "device": {...}}.  Any failed phase exits non-zero
before the last line.  Without CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import copy
import ctypes
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
from pathlib import Path

import numpy as np
import torch

from simple_raytracer_tpu_torch import accel, cli
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.io.image import load_ppm, load_skybox, save_hdr
from simple_raytracer_tpu_torch.io.obj import save_obj
from simple_raytracer_tpu_torch.io.scene_json import save_scene
from simple_raytracer_tpu_torch.io.stl import save_stl
from simple_raytracer_tpu_torch.models.camera import Camera
from simple_raytracer_tpu_torch.models.materials import Material
from simple_raytracer_tpu_torch.models.meshgen import icosphere
from simple_raytracer_tpu_torch.models.meshgen import organic_blob
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.models import showcase
from simple_raytracer_tpu_torch.models.scene import Scene
from simple_raytracer_tpu_torch.models.shapes import transform_trs
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops import trace as trace_mod
from simple_raytracer_tpu_torch.ops.bounce import bounce_step_plain
from simple_raytracer_tpu_torch.ops.camera import camera_rotation
from simple_raytracer_tpu_torch.ops.camera import generate_rays
from simple_raytracer_tpu_torch.ops.cuda import bounce_kernel as sk
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
from simple_raytracer_tpu_torch.ops.cuda import build
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel as tk
from simple_raytracer_tpu_torch.ops.cuda import triangle_kernel as trk
from simple_raytracer_tpu_torch.ops.intersect import intersect_triangles
from simple_raytracer_tpu_torch.ops import scene_types as tst
from simple_raytracer_tpu_torch.ops.scene_types import whole_trace_variant
from simple_raytracer_tpu_torch.ops.trace import add_sky, trace_rays
from simple_raytracer_tpu_torch.ops.triangle import (intersect_packed_plain,
                                                     moller_trumbore,
                                                     pack_triangles,
                                                     pretest_rejects,
                                                     stage_triangles,
                                                     staged_table)
from simple_raytracer_tpu_torch.ops.vec import Vec3
from simple_raytracer_tpu_torch.parallel.dryrun import dryrun_multichip
from simple_raytracer_tpu_torch.scripts import probe_kernel_ops as probe

STEPS = 4                      # progressive steps on the main path
KWARGS = {3: {"skybox": "gradient"}}        # as tests/test_golden.py
# the cells: label -> (config, tri_backend, the kernel variant it takes,
# the environment: None for the preset's sky, else a texture of TEXTURES)
CELLS = {"1": (1, "auto", "none", None), "2": (2, "auto", "none", None),
         "3": (3, "auto", "small", None),
         "4": (4, "auto", "clustered", None),
         "5": (5, "auto", "clustered", None),
         "6": (6, "auto", "two_level", None),
         "5/bvh": (5, "bvh", "flat", None),
         "4/bvh": (4, "bvh", "flat", None),
         "6/fused": (6, "fused", "clustered", None),
         "7": (7, "auto", "streamed", None),
         "7/fused": (7, "fused", "streamed", None),
         "3/texture": (3, "auto", "small/texture", "rgbe"),
         "6/texture": (6, "auto", "two_level", "ldr"),
         "5/pallas": (5, "pallas", "triangle", None),
         "6/pallas": (6, "pallas", "triangle", None),
         "4/jnp": (4, "jnp", None, None),
         "6/plucker": (6, "auto", "two_level/plucker", None),
         "7/plucker": (7, "auto", "streamed/plucker", None),
         "6/k256": (6, "auto", "streamed", None),
         "6/k256/plucker": (6, "auto", "streamed/plucker", None),
         "6/subbox8": (6, "auto", "two_level/subbox", None),
         "7/subbox8": (7, "auto", "streamed/subbox", None)}
# the MT form of each cell (SRT_BVH_MT, "mt" where not listed) and the
# scene's Scene.cluster_size (None: the automatic rule)
FORMS = {"6/plucker": "plucker", "7/plucker": "plucker",
         "6/k256/plucker": "plucker"}
CLUSTER_SIZES = {"6/k256": 256, "6/k256/plucker": 256, "5/k256": 256}
# the sub-box gate of each cell (SRT_BVH_SUBBOX, "0" where not listed),
# set while its scene is built and while it runs; the divisions that
# phase 4 also checks on each (config 6 at 2 and 4, and config 7's scene
# under "fused" at 8, in that check only)
SUBBOX = {"6/subbox8": "8", "7/subbox8": "8"}
SUBBOX_CHECKS = {"6/subbox8": (("2", None), ("4", None)),
                 "7/subbox8": (("8", "fused"),)}
# the cell after whose phase 4 the sub-box form is checked on partial
# supers (partial_super_check), and the seed of its rays
PARTIAL_CELL, PARTIAL_SEED = "6/subbox8", 22
# the cells of the split per-bounce path with the BVH kernel
SPLIT = ("6", "5/bvh", "4/bvh", "7", "6/texture", "6/plucker", "7/plucker",
         "6/k256", "6/k256/plucker", "6/subbox8", "7/subbox8")
FUSED = ("7/fused",)           # the cells of the fused per-bounce path
PALLAS = ("5/pallas", "6/pallas")   # the split path, the triangle kernel
DENSE = ("4/jnp",)             # the split path, the dense PyTorch loop
# the cells whose per-ray gate is held against a dense loop over every
# triangle (config 7's 2,097,152 triangle slots make that loop minutes)
GATE_CELLS = ("6", "5/bvh", "4/bvh")
# cells held to their plain version on a band of rows: the plain version
# loops densely over config 6's 81,920 triangles
BAND_CELLS = ("6/fused", "6/pallas")
# benchmark_step iterations (and profiled steps) of the slow cells; 20
# for the others
ITERS = {"7": 5, "7/fused": 5, "6/pallas": 5, "4/jnp": 1, "7/plucker": 5,
         "6/plucker": 10, "6/k256": 10, "6/k256/plucker": 10,
         "6/subbox8": 10, "7/subbox8": 5}
# profiled steps (phase 7) of a per-bounce cell, at most: the profiler's
# own cost per event dominates their hundreds of launches a step
PROFILE_STEPS = 5
# the environment textures, at the reference skybox's size (2048 x 1024):
# "rgbe" an HDR image written with save_hdr and read back with
# load_skybox, "ldr" 8-bit values linearized as (u8 / 255)^2.2
TEXTURE_SHAPE = (1024, 2048, 3)
TEXTURE_SEED = 0
GOLDEN_SIZES = {"1": (64, 64), "2": (96, 54), "3": (96, 54), "4": (96, 54),
                "5": (96, 54), "6": (64, 36), "5/bvh": (96, 54),
                "4/bvh": (96, 54),
                "6/fused": (64, 36), "5/pallas": (96, 54),
                "6/pallas": (64, 36), "4/jnp": (96, 54),
                "6/plucker": (64, 36), "6/k256": (64, 36),
                "6/k256/plucker": (64, 36), "5/k256": (96, 54),
                "6/subbox8": (64, 36)}
# golden renders that are no cell: label -> (config, tri_backend, the
# whole-trace variant it must take); cluster_size from CLUSTER_SIZES
GOLDEN_ONLY = {"5/k256": (5, "auto", "clustered")}
GOLDEN_STEPS, GOLDEN_TIME0 = 2, 1000
GOLDEN_RMSE = 2e-3             # tests/test_golden.py's bound
# Kernel vs plain version: the kernels repeat the plain versions' float
# operations in the same order (--fmad=false, no fast math), so the
# canvases should agree to the last bit; a branch that flips on a one-ulp
# difference (a Bernoulli draw at its threshold, the one fma the plain
# version emulates in f64) can move a whole path, so the bound is on the
# RMSE and on the share of pixels that differ, not on the maximum.  The
# BVH kernel's (t, slot) must equal its plain version's on every live ray,
# the triangle kernel's (t, index) on every ray; the shade kernel's state
# rows and the whole-trace kernel's nine rows their plain version's, or
# the canvas must keep to the bound above.
KERNEL_RMSE = 1e-4
KERNEL_DIFF_SHARE = 1e-3       # share of pixels more than 1e-3 apart
HAZARD_MAX = 8                 # non-finite pixels allowed (ln(0) draws)
N_SPHERES = 1025               # 2,048 sphere slots: 64 KB of shared memory
BAND_ROWS = 16                 # the band of the gate and band checks
# the card's published peaks (H100 SXM data sheet, at 700 W)
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
PROBE_CALLS = 100              # probe launches timed per probe
PROBE_TIMED = 10               # launches of a probe's timing instance
# the kernel rows of the JSON line: (name, kernel, TPU kernel (under
# simple_raytracer_tpu/ops/pallas/ unless a path), the cell timed, the
# cells whose launches it counts ("cli": phase 8's, "par": phase 9's,
# "view": phase 10's), the variants counted (None: every variant))
WHOLE = ("1", "2", "3", "4", "5", "6/fused", "cli", "par", "view")
ALL = tuple(CELLS) + ("cli", "par", "view")
ROWS = (
    ("trace_kernel", "trace", "bounce_kernel.py:659", "2", WHOLE, None),
    ("tris_small", "trace", "bounce_kernel.py:238", "3", ("3", "par"),
     "small"),
    ("tris_clustered", "trace", "bounce_kernel.py:291", "5",
     ("4", "5", "cli", "par", "view"), "clustered"),
    ("tris_clustered_packed", "trace", "bounce_kernel.py:376", "6/fused",
     ("6/fused",), "clustered"),
    ("trace_kernel_texture", "trace", "bounce_kernel.py:811", "3/texture",
     ("3/texture", "cli"), "small/texture"),
    ("bvh_flat", "bvh", "bvh_kernel.py:201", "5/bvh", ALL, "flat"),
    ("bvh_two_level", "bvh", "bvh_kernel.py:1040", "6", ALL, "two_level"),
    ("bvh_streamed", "bvh", "bvh_kernel.py:678", "7", ALL, "streamed"),
    ("bvh_two_level_plucker", "bvh", "bvh_kernel.py:629", "6/plucker", ALL,
     "two_level/plucker"),
    ("bvh_streamed_plucker", "bvh", "bvh_kernel.py:629", "7/plucker", ALL,
     "streamed/plucker"),
    ("bvh_two_level_subbox", "bvh", "bvh_kernel.py:474", "6/subbox8", ALL,
     "two_level/subbox"),
    ("bvh_streamed_subbox", "bvh", "bvh_kernel.py:474", "7/subbox8", ALL,
     "streamed/subbox"),
    ("bounce_kernel", "bounce", "bounce_kernel.py:584", "7/fused", ALL,
     "bounce"),
    ("triangle_kernel", "triangle", "triangle_kernel.py:34", "5/pallas", ALL,
     "triangle"),
    ("probe_column_sum", "probe", "scripts/probe_kernel_ops.py:18",
     "probe/A", ("probes",), "A"),
    ("probe_scalar_sum", "probe", "scripts/probe_kernel_ops.py:29",
     "probe/B", ("probes",), "B"),
    ("probe_gated_loop", "probe", "scripts/probe_kernel_ops.py:38",
     "probe/C", ("probes",), "C"),
)
SOURCES = {"trace": "trace_kernel.cu", "bvh": "bvh_kernel.cu",
           "bounce": "bounce_kernel.cu", "triangle": "triangle_kernel.cu",
           "probe": "probe_kernel.cu"}
KERNELS = {"trace": tk.KERNEL, "bvh": bk.KERNEL, "bounce": sk.KERNEL,
           "triangle": trk.KERNEL, "probe": probe.KERNEL}


@contextlib.contextmanager
def knob(name: str, value: str):
    """The environment variable ``name`` set to ``value``, restored
    after."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


@contextlib.contextmanager
def form_env(label: str):
    """SRT_BVH_MT set to the cell's MT form and SRT_BVH_SUBBOX to its
    sub-box gate, restored after."""
    with knob("SRT_BVH_MT", FORMS.get(label, "mt")), \
            knob("SRT_BVH_SUBBOX", SUBBOX.get(label, "0")):
        yield


def in_form(renderers: dict):
    """The cells' (label, (renderer, camera)), each with SRT_BVH_MT set
    to its MT form while the caller's loop body runs."""
    for label, cell in renderers.items():
        with form_env(label):
            yield label, cell


T0 = time.perf_counter()


def say(msg: str) -> None:
    """One line of the report, with the script's seconds so far."""
    print(f"{msg}  (+{time.perf_counter() - T0:.1f} s)", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, repeats: int = 5, warmup: int = 3) -> list:
    """ms per call from CUDA events around ``iters`` calls, once for each
    of ``repeats`` batches, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def spread(ms: list) -> str:
    return f"median of {len(ms)} batches; min {min(ms):.4f}, max {max(ms):.4f}"


def trace_args(renderer: Renderer, camera, time_seed: int) -> tuple:
    o = renderer.options
    cam = camera.state(o.width / o.height)
    args = (renderer.device_scene, camera_rotation(cam.yaw, cam.pitch),
            cam.position, cam.aspect_ratio, cam.fov_scale, time_seed)
    kw = dict(width=o.width, height=o.height, num_samples=o.num_samples,
              num_bounces=o.num_bounces, ray_tile=renderer.ray_tile)
    return args, kw


def build_all(what: str, kernels) -> None:
    """Build every kernel at once (one nvcc each); fail on any error."""
    try:
        build.build_all(kernels)
    except RuntimeError as exc:
        fail(f"{what}: {exc}")


def build_kernels(extra=()) -> str:
    """Build the five kernel sources, the host library (the host
    compiler) and the ``extra`` kernels at once (one compiler each) and
    report ptxas's registers and spills per variant of the five."""
    build_all("kernel build", (*KERNELS.values(), accel.HOST, *extra))
    parts = []
    # each entry's template arguments: the variant, then a first bool (the
    # trace kernel's counting instance, the BVH kernel's Plucker form), a
    # count of rays a thread, and a second bool (the counting instance)
    for kernel, entry, names, flag in (
            (tk.KERNEL, "trace_kernel", tk.TRI_MODES, "counting"),
            (bk.KERNEL, "bvh_kernel|ray_partials|rank_boxes|bucket_rays|"
             "scan_buckets|scatter_rays|morton_keys", bk.VARIANTS,
             "plucker"),
            (sk.KERNEL, "bounce_kernel", {}, ""),
            (trk.KERNEL, "triangle_kernel(?=E)|compact_live", {}, ""),
            (probe.KERNEL, "column_sum|scalar_sum|gated_loop|empty_cluster",
             None, "")):
        # ptxas reports each entry (template instance) after its name
        modes = {str(v): k for k, v in (names or {}).items()}
        variant = None
        for line in kernel.build_log.splitlines():
            m = re.search(rf"entry function '.*({entry})(?:ILi(\d+)E"
                          rf"(?:(Lb1E)|Lb0E|Li(\d)E)?(Lb1E)?)?", line)
            # the walk's instances: the variant, the Plucker form, the
            # sub-box form, the counting instance
            walk = re.search(r"entry function '.*bvh_kernelILi(\d+)ELb([01])E"
                             r"Lb([01])ELb([01])E", line)
            if walk:
                variant = (modes.get(walk.group(1), walk.group(1))
                           + ("/plucker" if walk.group(2) == "1" else "")
                           + ("/subbox" if walk.group(3) == "1" else "")
                           + ("/counting" if walk.group(4) == "1" else ""))
            elif m and names is None:
                # a probe: its kernel, then the timing instance's flag
                variant = m.group(1) + ("/timed" if m.group(2) == "1"
                                        else "")
            elif m:
                variant = (modes.get(m.group(2), m.group(2) or m.group(1))
                           + (f"/{flag}" if m.group(3) else "")
                           + (f"x{m.group(4)}" if m.group(4) else "")
                           + ("/counting" if m.group(5) else ""))
            elif "registers" in line or "spill" in line:
                parts.append(f"{variant}: "
                             + line.split("ptxas info    : ")[-1].strip())
    return "; ".join(parts) or "no ptxas report"


def triangle_sass() -> str:
    """The triangle kernel as compiled: the
    instructions from a triangle's first shared load to the warp vote
    and its branch (the path of a triangle that no lane keeps), by
    opcode, from cuobjdump -sass of the built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "not measured (no cuobjdump)"
    out = subprocess.run([tool, "-sass", trk.KERNEL.library()._name],
                         capture_output=True, text=True).stdout
    rays = trk.SHAPE[1]
    for func in out.split("Function : ")[1:]:
        if "triangle_kernelE" not in func.split()[0]:
            continue
        ops = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", func)]
        first = ops.index("LDS")
        last = len(ops) - 1 - ops[::-1].index("VOTE")
        body = collections.Counter(ops[first:last + 2])
        n = sum(body.values())
        fp = body["FMUL"] + body["FADD"] + body["FFMA"]
        return (f"{n} instructions for {rays} rays ({n / rays:.2f} a pair): "
                f"{fp} FP32 (FMUL {body['FMUL']}, FADD {body['FADD']}, FFMA "
                f"{body['FFMA']}), " + ", ".join(
                    f"{k} {v}" for k, v in body.most_common()
                    if k not in ("FMUL", "FADD", "FFMA")))
    return "not measured (kernel not found)"


# The whole-trace kernel's sections as compiled: each in a kernel of its
# own, built from the kernel's source (included whole) with its flags, so
# the same device code: one sphere test, one plane test, one MT, one BSDF
# sample, one uniform of the RNG and the gradient sky, each on rays loaded
# from memory and its result stored; "frame" only loads and stores.
SASS_PROBES = r"""
#include "trace_kernel.cu"
#define RAY const float* q = in + 64 * threadIdx.x; \
  const V3 o = mk(q[0], q[1], q[2]), d = mk(q[3], q[4], q[5])
extern "C" __global__ void probe_frame(const float* in, float* out) {
  RAY; out[threadIdx.x] = o.x + o.y + o.z + d.x + d.y + d.z;
}
extern "C" __global__ void probe_sphere(const float* in, float* out) {
  RAY; float t; int i;
  nearest_sphere(q + 8, 1, o, d, t, i);
  out[threadIdx.x] = t + (float)i;
}
extern "C" __global__ void probe_plane(const float* in, float* out) {
  RAY; float t; int i;
  nearest_plane(q + 8, 1, o, d, t, i);
  out[threadIdx.x] = t + (float)i;
}
extern "C" __global__ void probe_mt(const float* in, float* out) {
  RAY; TriHit th = {INFINITY, -1, 0.0f, 0.0f};
  mt_update<false>(q + 8, 0, o, d, th);
  out[threadIdx.x] = th.t + th.u + th.v + (float)th.row;
}
extern "C" __global__ void probe_bsdf(const float* in, float* out) {
  RAY; uint32_t seed = __float_as_uint(q[6]);
  const Scatter sc = sample_bsdf(o, q[7] > 0.0f, d, q + 8, seed);
  out[threadIdx.x] = sc.dir.x + sc.dir.y + sc.dir.z + sc.mask_mul.x
                     + sc.mask_mul.y + sc.mask_mul.z + __uint_as_float(seed);
}
extern "C" __global__ void probe_uniform(const float* in, float* out) {
  RAY; uint32_t seed = __float_as_uint(q[6]);
  out[threadIdx.x] = next_uniform(seed) + o.x + d.x;
}
extern "C" __global__ void probe_sky(const float* in, float* out) {
  RAY; const V3 c = sky_gradient(d, *reinterpret_cast<const TraceParams*>(
      q + 8));
  out[threadIdx.x] = c.x + c.y + c.z + o.x;
}
"""
SASS_OPS = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")


def sass_histograms(cubin: Path) -> dict:
    """Instructions by opcode of each function of a cubin (cuobjdump -sass;
    NOPs left out), by function name."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                         text=True, check=True).stdout
    funcs = {}
    for func in out.split("Function : ")[1:]:
        ops = [m.group(1) for m in SASS_OPS.finditer(func)]
        funcs[func.split()[0]] = collections.Counter(
            op for op in ops if op != "NOP")
    return funcs


def trace_sass(kernel=None) -> str:
    """The whole-trace kernel's sections as compiled (SASS_PROBES) and each
    variant's whole route instance, by opcode; the build of ``kernel``
    (the route's source and flags by default)."""
    kernel = kernel or tk.KERNEL
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not (os.path.exists(nvcc) and os.path.exists(tool)):
        return "not measured (no nvcc or cuobjdump)"
    flags = [f for f in kernel.flags
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        src = Path(tmp) / "sass_probes.cu"
        src.write_text(SASS_PROBES)
        cubin = Path(tmp) / "sass_probes.cubin"
        proc = subprocess.run(
            [nvcc, *flags, "-cubin", "-I", str(kernel.source.parent), "-o",
             str(cubin), str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            fail(f"the SASS probes' build: {proc.stderr}")
        funcs = sass_histograms(cubin)
    parts = []
    frame = sum(funcs["probe_frame"].values())
    for name in ("sphere", "plane", "mt", "bsdf", "uniform", "sky"):
        ops = funcs[f"probe_{name}"]
        fp = ops["FMUL"] + ops["FADD"] + ops["FFMA"]
        parts.append(
            f"{name} {sum(ops.values()) - frame} ({fp} FP32; "
            + ", ".join(f"{k} {v}" for k, v in ops.most_common(12)) + ")")
    for mode, value in tk.TRI_MODES.items():
        key = next((k for k in funcs
                    if re.search(rf"trace_kernelILi{value}ELb0E", k)), None)
        if key is not None:
            ops = funcs[key]
            parts.append(f"route {mode}: {sum(ops.values())} instructions "
                         "(MUFU " + str(ops["MUFU"]) + ", CALL "
                         + str(ops["CALL"]) + ", BRA " + str(ops["BRA"])
                         + ")")
    return (f"instructions a section, less the frame's {frame} (loads of "
            "the ray and table, the store): " + "; ".join(parts))


# Float operations of the kernels, counted from the CUDA sources (adds,
# subtracts, multiplies, divides, square roots, min/max; an fma counts 2;
# the integer hash and compares are left out, so the bound is a floor).
RAYGEN_FLOPS = 42          # 2 uniforms, NDC, screen, rotate, normalize
SPHERE_FLOPS = 21          # one sphere test
PLANE_FLOPS = 14           # one plane test
MT_FLOPS = 46              # one Moller-Trumbore test (mt_update)
# the triangle kernel's early-out form of it: MT to a and x and the margin
# multiply on every pair, then f and u where the early-out keeps the pair,
# q, v and u + v where u passes, t where v passes (47: MT and the margin)
EARLY_OUT_FLOPS = 23
KEPT_FLOPS = 2
U_PASS_FLOPS = 16
V_PASS_FLOPS = 6
PLUCKER_FLOPS = 38         # one Plucker-form test (plucker_slot)
PLUCKER_RAY_FLOPS = 9      # a walked ray's m = o x d (the Plucker form)
SLAB_FLOPS = 24            # one box's slab test, without the margin
INV_DIR_FLOPS = 3          # the reciprocal direction of the traversal
SHADE_FLOPS = 30           # position, normal, front flip, emission
BARY_FLOPS = 44            # barycentric weights and the normal (bounce)
BSDF_FLOPS = 275           # 3 normals (log, cos), 3 uniforms, mixes
SKY_FLOPS = 54             # the gradient sky and the final add
LIVE_RAY_BYTES = 28        # a live ray's o, d and t_init in
HIT_OUT_BYTES = 8          # (t, slot) out, for every ray
SLOT_BYTES = 40 + 4        # a slot's MT columns (v0, e1, e2, active), index
BOX_BYTES = 32             # a box row of the hierarchy
# the shade kernel: 20 state rows in and out, the winner's (t, slot) in
BOUNCE_RAY_BYTES = (20 + 20 + 2) * 4
# the triangle kernel: every ray's alive flag in and (t, index) out, a
# live ray's o, d in; an active triangle's v0, e1, e2 and index in
TRI_RAY_BYTES = 1 + 8
TRI_LIVE_BYTES = 24
TRI_COL_BYTES = 40
# the texture's sample (ops/trace.add_sky on the nine rows): atan2 and the
# coordinates, the taps' set-up and mix, the sun, the final multiply-add;
# the nine rows in and the radiance out per ray, the texture once
SAMPLE_FLOPS = 96
SAMPLE_RAY_BYTES = 36 + 12
# a probe: the (512, 128) f32 array read once and written once
PROBE_BYTES = 2 * probe.ROWS * probe.COLS * 4


def kernel_flops(scene, tri_backend: str, n_rays: int, segments: list,
                 sky: bool = True, work=None) -> float:
    """Float operations this pass's data needs (``segments`` from the plain
    version: live rays, hits, triangle hits per bounce): every live ray
    tests each active sphere and plane, every hit shades, and every hit
    before the last bounce samples the BSDF.  Triangles: a small mesh is
    tested whole (live rays x active triangles x MT); a clustered mesh by
    the rule of the BVH rows, from ``work`` (``clustered_work`` of the
    plain version's rays, which a clustered mesh needs): every live ray
    slab-tests the hierarchy's root boxes, and MT runs over the real slots
    of every cluster whose box the ray may meet before its final t.
    ``sky``: the kernel evaluates the gradient sky (not in the nine-row
    form, whose texture is sampled outside)."""
    n_s = int(scene.spheres.active.sum())
    n_p = int(scene.planes.active.sum())
    tris = scene.triangles
    variant = whole_trace_variant(scene, tri_backend)
    flops = n_rays * (RAYGEN_FLOPS + (SKY_FLOPS if sky else 0))
    for i, (live, hits, _) in enumerate(segments):
        flops += live * (n_s * SPHERE_FLOPS + n_p * PLANE_FLOPS)
        if variant == "small":
            flops += live * int(tris.active.sum()) * MT_FLOPS
        elif variant == "clustered":
            roots = int((tris.clusters.hierarchy.groups[:, 0] < 1.0e37).sum())
            flops += (live * (roots * SLAB_FLOPS + INV_DIR_FLOPS)
                      + work[i][1] * MT_FLOPS)
        flops += hits * SHADE_FLOPS
        if i < len(segments) - 1:
            flops += hits * BSDF_FLOPS
    return float(flops)


def kernel_device_us(prof) -> dict:
    """Device microseconds by kernel name (the last 40 characters of its
    plain name) over a torch.profiler run: kernels only, since the aten
    ops that launch them carry the same time."""
    per_kernel = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0) or 0
        if dev_us > 0 and str(evt.device_type).endswith("CUDA"):
            name = evt.key.replace("(anonymous namespace)::", "")
            name = re.sub(r"^void ", "", name).split("(")[0].split("<")[0]
            per_kernel[name[-40:]] = per_kernel.get(name[-40:], 0.0) + dev_us
    return per_kernel


def step_breakdown(r: Renderer, camera, iters: int = 20) -> str:
    """Host wall time per Renderer.step against the device time of each
    kernel name in it, from torch.profiler over ``iters`` steps."""
    from torch.profiler import ProfilerActivity, profile
    r.step(camera)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            r.step(camera)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    per_kernel = kernel_device_us(prof)
    if not per_kernel:
        return (f"host {wall_ms:.4f} ms/step (profiled); device time not "
                "measured: the profiler recorded no device events")
    busy_ms = sum(per_kernel.values()) / 1e3 / iters
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
    parts = ", ".join(f"{k} {v / 1e3 / iters:.4f} ms" for k, v in top)
    return (f"host {wall_ms:.4f} ms/step (profiled), device busy "
            f"{busy_ms:.4f} ms/step over {len(per_kernel)} kernel names, "
            f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; top: {parts}")


def canvas_diff(k: torch.Tensor, p: torch.Tensor, s: int):
    """(rmse, share of pixels > 1e-3 apart, same non-finite rays) of two
    (3, R) per-ray radiances, over the per-pixel means of S samples."""
    same_bad = bool((torch.isfinite(k) == torch.isfinite(p)).all())
    kp = k.reshape(3, -1, s).mean(dim=2)
    pp = p.reshape(3, -1, s).mean(dim=2)
    ok = torch.isfinite(kp).all(0) & torch.isfinite(pp).all(0)
    rmse = float((kp - pp)[:, ok].pow(2).mean().sqrt())
    share = float(((kp - pp).abs() > 1e-3).any(0)[ok].float().mean())
    return rmse, share, same_bad


def plain_bvh(o, d, alive, t_init, clusters, table, compact=False,
              force_streamed=False):
    """The BVH kernel's wrapper with its plain version on the card, in the
    MT form and with the sub-box gate the wrapper resolves."""
    variant = bk.bvh_variant(clusters, force_streamed)
    form = "plucker" if bvh.resolve_plucker(clusters, variant) else "mt"
    sub = bk.sub_box_gate(clusters, variant)
    if compact:
        order, count = bvh.compact_order(o, d, alive, t_init,
                                         clusters.hierarchy.admission)
        return bvh.intersect_compacted_plain(o, d, alive, t_init, clusters,
                                             table, order, int(count), form,
                                             *sub)
    return bvh.intersect_triangles_bvh_plain(o, d, alive, t_init, clusters,
                                             table, form, *sub)


def sub_gate(prep, clusters) -> tuple:
    """(sub_aabb, sub_div) of a recorded BVH launch, as its plain version
    takes them: the clusters' table and the launch's division in the
    sub-box form, else (None, 8)."""
    rows = prep.params.sub_rows
    return (clusters.sub_aabb, prep.params.k // rows) if rows else (None, 8)


def ungated(prep):
    """A recorded BVH launch without its sub-box gate: the same rays,
    tables, variant and compaction."""
    return dataclasses.replace(with_params(prep, sub_rows=0),
                               tensors=prep.tensors[:7] + (None,))


def plain_triangles(o, d, packed, alive=None, staged=None):
    """The triangle kernel's wrapper with its plain version on the card."""
    return intersect_packed_plain(o, d, packed, alive)


def plain_bounce(state, is_last, scene, tri=None, tables=None):
    """ops/bounce.bounce_step with its plain version on the card."""
    return bounce_step_plain(state, is_last, scene, tri)


class Recorder:
    """Swaps the kernels' launches (and, with ``plain``, the BVH and shade
    wrappers for their plain versions) for one pass, recording each
    launch's prepared arguments and result."""

    def __init__(self, plain: bool = False):
        self.plain = plain
        self.bvh, self.shade, self.tri = [], [], []

    def __enter__(self):
        self.saved = (bk.launch, sk.launch, trk.launch,
                      bk.intersect_triangles_bvh, trace_mod.bounce_step,
                      trk.intersect_triangles_packed)

        def recorder(launch, into):
            def rec(prep, out=None):
                res = launch(prep, out)
                into.append((prep, res))
                return res
            return rec

        bk.launch = recorder(bk.launch, self.bvh)
        sk.launch = recorder(sk.launch, self.shade)
        trk.launch = recorder(trk.launch, self.tri)
        if self.plain:
            bk.intersect_triangles_bvh = plain_bvh
            trace_mod.bounce_step = plain_bounce
            trk.intersect_triangles_packed = plain_triangles
        return self

    def __exit__(self, *exc):
        (bk.launch, sk.launch, trk.launch, bk.intersect_triangles_bvh,
         trace_mod.bounce_step, trk.intersect_triangles_packed) = self.saved
        return False


def per_bounce_pass(r: Renderer, camera, time_seed: int, plain: bool = False,
                    band=None, tri_backend=None):
    """One pass of a per-bounce cell's per-ray radiance, (3, R), by the
    steps render_pass takes (generate_rays, then trace_per_bounce);
    returns it and the Recorder of its launches.
    ``plain`` swaps the kernels for their plain versions; ``band`` =
    (row0, rows) traces only those rows; ``tri_backend`` replaces the
    cell's."""
    o = r.options
    row0, rows = band if band is not None else (0, None)
    with Recorder(plain) as rec:
        cam = camera.state(o.width / o.height)
        orig, dirs, seed = generate_rays(
            o.width, o.height, o.num_samples, time_seed, cam.position,
            camera_rotation(cam.yaw, cam.pitch), cam.aspect_ratio,
            cam.fov_scale, row0=row0, tile_height=rows,
            tile=r.ray_tile if band is None else None, device=r.device)
        color = trace_mod.trace_per_bounce(r.device_scene, orig, dirs, seed,
                                           o.num_bounces,
                                           tri_backend or o.tri_backend)
    return torch.stack(list(color)), rec


def with_params(prep, **fields):
    """A recorded BVH launch with some launch parameters replaced."""
    q = bk.BvhParams()
    for name, _ in bk.BvhParams._fields_:
        setattr(q, name, fields.get(name, getattr(prep.params, name)))
    return dataclasses.replace(prep, params=q)


def bvh_inputs(prep):
    rays = prep.rays
    return (Vec3(rays[0], rays[1], rays[2]), Vec3(rays[3], rays[4], rays[5]),
            rays[6], rays[7])


def admitted(o_, d_, walked, t_final, clusters) -> tuple:
    """What one launch's walked rays must open: the clusters whose box a
    walked ray may meet before its result t (its nearest hit, else its
    t_init), by the plain version's gates.  Any traversal of these boxes
    must test every real slot of such a cluster to know that its hit is
    the nearest.  Returns (real slots over the admitted (cluster, ray)
    pairs, real slots of the distinct admitted clusters, those clusters,
    the supers that hold them, the admitted (cluster, ray) pairs)."""
    real = (clusters.slots >= 0).sum(dim=1)
    seen = torch.zeros(real.shape[0], dtype=torch.bool, device=real.device)
    pair_slots = pairs = 0
    for c, _ in bvh.admitted_pairs(o_, bvh.inverse(d_), walked, t_final,
                                   clusters, bvh.PAIR_CHUNK_ELEMS["cuda"]):
        pair_slots += int(real[c].sum())
        pairs += c.numel()
        seen[c] = True
    opened = seen.nonzero()[:, 0]
    return (pair_slots, int(real[opened].sum()), int(opened.numel()),
            int(torch.unique(opened // bvh.SUPER).numel()), pairs)


def compaction_check(label: str, b: int, prep, clusters) -> None:
    """A compacted launch's ray order, made on the card by the launch,
    against ops/bvh.compact_order under the launch's key on the same rays:
    the same count, the same admitted rays first, and every ray listed
    once; under the Morton key (sorted beside the launch) the whole order
    is compact_order's."""
    o_, d_, alive, t_init = bvh_inputs(prep)
    key = "morton" if prep.options.morton else "super"
    order, count = bvh.compact_order(o_, d_, alive, t_init,
                                     clusters.hierarchy.admission, key)
    n = int(count)
    perm = prep.perm.long()
    if not (int(prep.count) == n
            and torch.equal(perm[:n].sort().values, order[:n].sort().values)
            and torch.equal(perm.sort().values,
                            torch.arange(perm.numel(), device=perm.device))
            and (key == "super" or torch.equal(perm, order))):
        fail(f"cell {label} bounce {b}: the card's compaction ({key} key) "
             f"admits {int(prep.count)} rays, compact_order {n}, or other "
             "rays, or in another order")


def check_bvh_launches(label: str, recorded, clusters, table,
                       count_work: bool = True):
    """Every recorded BVH launch against its plain version, in the
    launch's MT form, on the same rays: (t, slot) equal on every live ray;
    and every launch replayed on the kernel's counting instance, whose (t,
    slot) must be the route's on every ray.  Returns (max |dt|, work per
    launch (walked rays, rays, compacted, ``admitted``'s five counts, live
    rays, the alive flag's bytes; not counted without ``count_work``),
    plain seconds, one report per launch, the counting instance's counts
    per launch)."""
    max_abs, work, plain_s, lines, counted = 0.0, [], 0.0, [], []
    for b, (prep, (t_k, s_k)) in enumerate(recorded):
        o_, d_, alive, t_init = bvh_inputs(prep)
        form = "plucker" if prep.params.plucker else "mt"
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        t_p, s_p = bvh.intersect_triangles_bvh_plain(
            o_, d_, alive, t_init, clusters, table, form,
            *sub_gate(prep, clusters))
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t1
        live = alive > 0
        slot_diff = int((s_k[live] != s_p[live]).sum())
        fin = live & torch.isfinite(t_p) & torch.isfinite(t_k)
        t_same = bool(torch.equal(torch.isinf(t_k[live]),
                                  torch.isinf(t_p[live])))
        diff = (t_k[fin] - t_p[fin]).abs()
        m = float(diff.max()) if diff.numel() else 0.0
        max_abs = max(max_abs, m)
        compact = prep.perm is not None
        # the rays the kernel walks: the admitted prefix when compacted
        walk = live
        if compact:
            walk = live & torch.zeros_like(live).index_fill_(
                0, prep.perm[:int(prep.count)].long(), True)
            compaction_check(label, b, prep, clusters)
        walked = int(walk.sum())
        tri_hits = int((s_k[live] >= 0).sum())
        opened = ""
        if count_work:
            counts = admitted(o_, d_, walk, torch.where(s_k >= 0, t_k,
                                                        t_init), clusters)
            work.append((walked, prep.params.n_rays, compact) + counts
                        + (int(live.sum()), alive.element_size()))
            opened = f", clusters opened {counts[2]}"
        lines.append(f"b{b} {prep.label}: live {int(live.sum())} "
                     f"{'compact' if compact else 'dense'}, walked "
                     f"{walked}, triangle hits {tri_hits}{opened}, slot diff "
                     f"{slot_diff}, max|dt| {m:.3e}")
        if slot_diff or m != 0.0 or not t_same:
            fail(f"cell {label} bounce {b}: the BVH kernel's (t, slot) "
                 f"differ from the plain version on {slot_diff} live "
                 f"rays (max |dt| {m})")
        (t_c, s_c), cnt = bk.launch_counted(prep)
        if not (torch.equal(t_c, t_k) and torch.equal(s_c, s_k)):
            fail(f"cell {label} bounce {b}: the counting instance's "
                 "(t, slot) differ from the route's")
        counted.append(cnt)
    return max_abs, work, plain_s, lines, counted


def ungated_check(label: str, recorded) -> int:
    """Every recorded launch of the sub-box form against the ungated
    kernel on the same rays (the launch without its gate): (t, slot)
    equal on every live ray.  Returns the live rays."""
    live_n = 0
    for b, (prep, (t_k, s_k)) in enumerate(recorded):
        if not prep.params.sub_rows:
            fail(f"cell {label} bounce {b}: {prep.label} has no sub-box gate")
        t_u, s_u = bk.launch(ungated(prep))
        live = prep.rays[6] > 0
        live_n += int(live.sum())
        if not (torch.equal(t_u[live], t_k[live])
                and torch.equal(s_u[live], s_k[live])):
            lost = int((s_u[live] != s_k[live]).sum())
            fail(f"cell {label} bounce {b}: the sub-box form's (t, slot) "
                 f"differ from the ungated kernel's on {lost} live rays")
    return live_n


def subbox_checks(label: str, r: Renderer, camera, recorded, clusters,
                  table, card: str) -> None:
    """Phase 4 of a sub-box cell, beyond the plain version: every launch
    of its pass against the ungated kernel, then a pass at each division
    (and route) of SUBBOX_CHECKS, every BVH launch against the gated plain
    version and the ungated kernel."""
    n = ungated_check(label, recorded)
    rows = recorded[0][0].params.sub_rows
    say(f"[4] cell {label} sub-box form (div {clusters.k // rows}, "
        f"{rows} slots a sub-box) vs the ungated kernel, every launch of "
        f"one full pass: (t, slot) equal on all {n} live rays  [{card}]")
    for div, backend in SUBBOX_CHECKS[label]:
        with knob("SRT_BVH_SUBBOX", div):
            _, rec = per_bounce_pass(r, camera, 4242, tri_backend=backend)
            torch.cuda.synchronize()
            got = {(prep.label, prep.params.sub_rows) for prep, _ in rec.bvh}
            want = {(CELLS[label][2], clusters.k // int(div))}
            if got != want:
                fail(f"cell {label} at SRT_BVH_SUBBOX={div}: launches "
                     f"{got}, want {want}")
            _, _, plain_s, lines, _ = check_bvh_launches(
                f"{label} div {div}", rec.bvh, clusters, table,
                count_work=False)
            n = ungated_check(f"{label} div {div}", rec.bvh)
        say(f"[4] cell {label} at SRT_BVH_SUBBOX={div}"
            + ("" if backend is None else f" under tri_backend={backend}")
            + f": every BVH launch of one full pass vs the gated plain "
            f"version: {'; '.join(lines)}; vs the ungated kernel: (t, slot) "
            f"equal on all {n} live rays; plain BVH {plain_s:.2f} s/pass  "
            f"[{card}]")


def partial_super_check(card: str) -> None:
    """Phase 4: the sub-box form on tables whose cluster count is not a
    multiple of 16 (the last super's sub-box block cut at the table's
    end): the 320-triangle icosphere clustered at K = 64 and at K = 192
    (24-slot ranges across the 64-slot chunks) under SRT_BVH_SUBBOX=8,
    4,096 seeded rays aimed near it (a tenth dead, half with a finite
    t_init), dense and compacted, each launch's (t, slot) against the
    gated plain version and the ungated kernel on every live ray; every
    64th ray live with a NaN direction, which admits every box, so its
    warp walks the supers past the table (their block: the last
    cluster's rows)."""
    rng = np.random.default_rng(PARTIAL_SEED)
    n = 4096
    o = rng.uniform(-3, 3, (n, 3))
    d = rng.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(
        0, 1.2, (n, 1)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_init = np.where(rng.uniform(size=n) < 0.5, np.inf,
                      rng.uniform(0.2, 5.0, n))
    live = rng.uniform(size=n) > 0.1
    d[::64] = np.nan
    live[::64] = True
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, np.float32)).cuda()
    vec = lambda a: Vec3(cuda(a[:, 0]), cuda(a[:, 1]), cuda(a[:, 2]))
    alive = cuda(live)
    rays = (vec(o), vec(d), alive, cuda(t_init))
    live = alive > 0
    lines = []
    for k in (64, 192):
        scene = Scene()
        scene.cluster_threshold = 64
        scene.cluster_size = k
        scene.add_model(scene.pool.append(*icosphere(subdivisions=2)))
        with knob("SRT_BVH_SUBBOX", "8"):
            ds = scene.build("cuda")
            cl, table = ds.triangles.clusters, ds.triangles.table
            n_cl = cl.slots.shape[0]
            if n_cl % bvh.SUPER == 0:
                fail(f"the partial-super check: {n_cl} clusters at K = {k}")
            for compact in (False, True):
                prep = bk.prepare(*rays, cl, table, compact, True)
                if prep.params.sub_rows != k // 8:
                    fail(f"the partial-super check at K = {k}: "
                         f"{prep.label} with {prep.params.sub_rows} rows")
                t_k, s_k = bk.launch(prep)
                t_u, s_u = bk.launch(ungated(prep))
                t_p, s_p = plain_bvh(*rays, cl, table, compact, True)
                torch.cuda.synchronize()
                for name, (t, sl) in (("the gated plain version",
                                       (t_p, s_p)),
                                      ("the ungated kernel", (t_u, s_u))):
                    if not (torch.equal(t[live], t_k[live])
                            and torch.equal(sl[live], s_k[live])):
                        fail(f"the partial-super check at K = {k}"
                             f"{' compacted' if compact else ''}: the "
                             f"sub-box form's (t, slot) differ from {name}'s"
                             f" on {int((sl[live] != s_k[live]).sum())} "
                             "live rays")
                lines.append(f"K = {k} ({n_cl} clusters, the last super's "
                             f"block {n_cl % bvh.SUPER} of {bvh.SUPER}) "
                             f"{'compact' if compact else 'dense'}: hits "
                             f"{int((s_k[live] >= 0).sum())}")
    say(f"[4] the sub-box form on partial supers, {n} rays, (t, slot) "
        f"equal to the gated plain version's and the ungated kernel's on "
        f"all {int(live.sum())} live rays: {'; '.join(lines)}  [{card}]")


def subbox_turns(label: str, res: dict, card: str, parent=None) -> dict:
    """Phase 6 of a sub-box cell: its launches of one pass (the gated
    kernel) and the same launches without the gate (the ungated kernel),
    timed in turns (gated, ungated, ungated, gated; CUDA events, each the
    median of 5 batches), with every (t, slot) of the ungated replay the
    gated one's; with ``parent``, the same gated launches on the parent's
    kernel in turns (parent, this, this, parent), every (t, slot) this
    one's; and what each walk did, from the counting instances: the
    lane-slot MT tests (32 x warp-wide MT steps) and the sub-box tests
    beside the ungated walk's, and the walk's SM cycles waiting for a
    super's sub-box block and making its words."""
    gated = [(pp, oo) for pp, oo in res["recorded"]]
    plain = [(ungated(pp), (torch.empty_like(oo[0]), torch.empty_like(oo[1])))
             for pp, oo in gated]
    med = lambda fn: float(np.median(cuda_ms(fn, iters=2, repeats=5,
                                             warmup=1)))
    run = lambda pairs: med(lambda: [bk.launch(q, o) for q, o in pairs])
    turns = [run(gated), run(plain), run(plain), run(gated)]
    for (_, a), (_, b) in zip(plain, gated):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            fail(f"cell {label}: the ungated replay's (t, slot) differ")
    ungated_counts = [bk.launch_counted(q)[1] for q, _ in plain]
    tot = lambda counts, key: sum(c[key] for c in counts)
    g_ms, u_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    out = dict(gated_ms=g_ms, ungated_ms=u_ms, turns_ms=turns,
               rows=gated[0][0].params.sub_rows)
    parent_note = ""
    if parent is not None:
        got = [(torch.empty_like(oo[0]), torch.empty_like(oo[1]))
               for _, oo in gated]
        runs = [parent_launcher(parent, pp, g)
                for (pp, _), g in zip(gated, got)]
        run_p = lambda: med(lambda: [f() for f in runs])
        p_turns = [run_p(), run(gated), run(gated), run_p()]
        for (_, a), b in zip(gated, got):
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                fail(f"cell {label}: the parent's gated kernel and this one "
                     "differ")
        out["parent_ms"] = (p_turns[0] + p_turns[3]) / 2
        out["parent_this_ms"] = (p_turns[1] + p_turns[2]) / 2
        out["parent_turns_ms"] = p_turns
        parent_note = (
            f"; the parent's gated kernel on the same launches in turns "
            f"(parent, this, this, parent: "
            f"{', '.join(f'{t:.4f}' for t in p_turns)} ms): this / parent "
            f"{out['parent_this_ms'] / out['parent_ms']:.3f}, results equal")
    for name, counts in (("gated", res["counts"]),
                         ("ungated", ungated_counts)):
        for key in ("pairs", "chunks", "slots", "mt_steps", "sub_tests",
                    "sub_skipped", "chunks_skipped", "split", "walk_cycles",
                    "sub_wait_cycles", "sub_word_cycles"):
            out[f"{name}_{key}"] = tot(counts, key)
        out[f"{name}_lane_slots"] = 32 * out[f"{name}_mt_steps"]
    div = gated[0][0].params.k // out["rows"]
    share = lambda key: out[f"gated_{key}"] / max(out["gated_walk_cycles"], 1)
    say(f"[6] cell {label} sub-box form (div {div}) "
        f"against the ungated kernel on the same launches of one pass, in "
        f"turns (gated, ungated, ungated, gated: "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms): gated {g_ms:.4f} ms, "
        f"ungated {u_ms:.4f} ms (gated / ungated {g_ms / u_ms:.3f}); "
        f"results equal{parent_note}; lane-slot MT tests "
        f"{out['gated_lane_slots']} "
        f"against {out['ungated_lane_slots']} ungated "
        f"({out['gated_lane_slots'] / max(out['ungated_lane_slots'], 1):.3f}"
        f"), sub-box slab tests {out['gated_sub_tests']}, clusters skipped "
        f"whole {out['gated_sub_skipped']}, chunks skipped "
        f"{out['gated_chunks_skipped']}, chunks copied {out['gated_chunks']} "
        f"against {out['ungated_chunks']}, MT pairs {out['gated_pairs']} "
        f"against {out['ungated_pairs']}, split chunks {out['gated_split']} "
        f"against {out['ungated_split']}; the warps' walk SM cycles "
        f"{out['gated_walk_cycles']} against {out['ungated_walk_cycles']} "
        f"({out['gated_walk_cycles'] / max(out['ungated_walk_cycles'], 1):.3f}"
        f"), of them waiting for a super's sub-box block "
        f"{out['gated_sub_wait_cycles']} ({share('sub_wait_cycles'):.3f}) "
        f"and making its words {out['gated_sub_word_cycles']} "
        f"({share('sub_word_cycles'):.3f})  [{card}]")
    return out


def check_shade_launches(scene, recorded):
    """Every recorded shade launch against its plain version on the same
    state and winners: the rays whose 20 rows differ in any bit.  Returns
    (rays that differ, max |difference| over finite rows, work per launch
    (live rays, rays that go on, Rp, last), plain seconds, reports)."""
    differ, max_abs, work, plain_s, lines = 0, 0.0, [], 0.0, []
    for b, (prep, out) in enumerate(recorded):
        t, slot, _ = prep.tri
        tri = None if t is None else (t, slot)
        last = bool(prep.params.is_last)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = bounce_step_plain(prep.state, last, scene, tri)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t1
        bad = int((out.view(torch.int32) != ref.view(torch.int32)).any(0)
                  .sum())
        fin = torch.isfinite(out) & torch.isfinite(ref)
        diff = (out - ref).abs()[fin]
        m = float(diff.max()) if diff.numel() else 0.0
        differ += bad
        max_abs = max(max_abs, m)
        live = int((prep.state[7] > 0).sum())
        went_on = int((out[7] > 0).sum())
        work.append((live, went_on, prep.params.n_rays, last))
        lines.append(f"b{b}: live {live}, on {went_on}, rays whose rows "
                     f"differ {bad}, max|d| {m:.3e}")
    return differ, max_abs, work, plain_s, lines


def triangle_work(prep) -> tuple:
    """One triangle launch's work: (rays, live rays, active triangles,
    packed table columns)."""
    n = prep.params.n_rays
    live = n if prep.alive is None else int(prep.alive.sum())
    return n, live, prep.params.n_tris, prep.packed.shape[1]


def check_triangle_launches(label: str, recorded):
    """Every recorded triangle launch against its plain version on the
    same rays and alive mask: (t, index) equal on every ray, a dead ray's
    (+inf, 0) included.  Returns (max |dt|, work per launch (rays, live
    rays, active triangles, table columns), plain seconds, one report per
    launch)."""
    max_abs, work, plain_s, lines = 0.0, [], 0.0, []
    for b, (prep, (t_k, i_k)) in enumerate(recorded):
        rays = prep.rays
        o_, d_ = Vec3(rays[0], rays[1], rays[2]), Vec3(rays[3], rays[4],
                                                       rays[5])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        t_p, i_p = intersect_packed_plain(o_, d_, prep.packed, prep.alive)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t1
        idx_diff = int((i_k != i_p).sum())
        t_same = bool(torch.equal(torch.isinf(t_k), torch.isinf(t_p)))
        fin = torch.isfinite(t_k) & torch.isfinite(t_p)
        diff = (t_k[fin] - t_p[fin]).abs()
        m = float(diff.max()) if diff.numel() else 0.0
        max_abs = max(max_abs, m)
        work.append(triangle_work(prep))
        dead = (~prep.alive if prep.alive is not None
                else torch.zeros_like(i_k, dtype=torch.bool))
        dead_ok = bool(torch.isinf(t_k[dead]).all() and not i_k[dead].any())
        lines.append(f"b{b}: rays {prep.params.n_rays}, live {work[-1][1]},"
                     f" dead (+inf, 0) {dead_ok}, hits "
                     f"{int(torch.isfinite(t_k).sum())}, index diff "
                     f"{idx_diff}, max|dt| {m:.3e}")
        if idx_diff or m != 0.0 or not t_same or not dead_ok:
            fail(f"cell {label} bounce {b}: the triangle kernel's (t, index) "
                 f"differ from the plain version on {idx_diff} rays (max "
                 f"|dt| {m})")
    return max_abs, work, plain_s, lines


VOTE_WARPS = 128     # warps sampled a launch for the early-out's shares


def early_out_shares(prep) -> tuple:
    """What the triangle kernel's early-out leaves on one launch, over
    VOTE_WARPS of its warps spread evenly over the live rays (a warp: 32
    lanes x R rays of the launch's live-ray list, as the kernel takes
    them) against every active triangle: the shares of (live ray,
    triangle) pairs that survive ops/triangle.pretest_rejects, of (warp,
    triangle) pairs whose vote passes, of pairs whose u passes, whose v
    passes too, and that MT accepts."""
    threads, rays = trk.SHAPE
    n_live = (prep.params.n_rays if prep.count is None
              else int(prep.count))
    if n_live == 0:
        return 0.0, 0.0, 0.0, 0.0, 0.0
    device = prep.rays.device
    order = (torch.arange(prep.params.n_rays, device=device)
             if prep.order is None else prep.order.long())
    per_warp = threads // 32
    n_warps = -(-n_live // (threads * rays)) * per_warp
    pick = torch.linspace(0, n_warps - 1, min(VOTE_WARPS, n_warps),
                          device=device).long().unique()
    lane = torch.arange(32, device=device)[None, :, None]
    ray = torch.arange(rays, device=device)[None, None, :]
    pos = ((pick // per_warp * threads * rays + pick % per_warp * 32)
           [:, None, None] + lane + ray * threads).reshape(len(pick), -1)
    real = pos < n_live
    src = order[pos.clamp_max(n_live - 1)].reshape(-1)
    o_ = Vec3(*(prep.rays[i, src][:, None] for i in range(3)))
    d_ = Vec3(*(prep.rays[i, src][:, None] for i in range(3, 6)))
    st = prep.staged
    kept = votes = u_ok = v_ok = hits = 0
    for c0 in range(0, st.shape[0], 2048):
        col = lambda j: Vec3(*(st[None, c0:c0 + 2048, j + i]
                               for i in range(3)))
        a, x, u, v, t = moller_trumbore(o_, d_, col(0), col(4), col(8))
        # a slot past the live rays repeats the last live ray and votes
        may = ~pretest_rejects(a, x)
        r_ = real.reshape(-1, 1)
        # the early-out never drops a pair whose u passes (a == 0 fails)
        u_pass = (u >= 0) & (u <= 1) & r_
        v_pass = u_pass & (v >= 0) & (u + v <= 1)
        kept += int((may & r_).sum())
        votes += int(may.view(len(pick), -1, may.shape[1]).any(1).sum())
        u_ok += int(u_pass.sum())
        v_ok += int(v_pass.sum())
        hits += int((v_pass & (a != 0) & (t > 0)).sum())
    pairs = int(real.sum()) * st.shape[0]
    return (kept / pairs, votes / (len(pick) * st.shape[0]), u_ok / pairs,
            v_ok / pairs, hits / pairs)


def triangle_timing(res: dict) -> dict:
    """Phase 6 of a "pallas" cell: the recorded launches of a pass, all
    together (the kernel's time a pass, ``k_all``, the live-ray compaction
    in each launch included) and one by one (``per``); the same launches
    with every ray dead (``dead``: the compaction and a grid whose blocks
    exit at once) and with every ray live (``every_ray``, the TPU route's
    work), whose live rays must keep their (t, index); each launch's
    early-out shares; the live and all-ray (ray, active triangle) pairs,
    the early-out form's FLOPs and the bytes."""
    rec, work = res["recorded"], res["work"]
    preps = [pp for pp, _ in rec]
    outs = [oo for _, oo in rec]
    keys = [torch.empty(pp.params.n_rays, dtype=torch.int64, device="cuda")
            for pp in preps]
    run = lambda ps: [trk.launch(pp, kk) for pp, kk in zip(ps, keys)]
    each = lambda ps: [float(np.median(cuda_ms(
        lambda pp=pp, kk=kk: trk.launch(pp, kk), iters=1, repeats=3,
        warmup=1))) for pp, kk in zip(ps, keys)]
    k_all = cuda_ms(lambda: run(preps), iters=1, repeats=3, warmup=1)
    per = each(preps)
    if not all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(map(trk.split_key, keys), outs)):
        fail("the triangle kernel's replayed launches differ from the route")
    # read while each launch's live-ray list is the one just replayed
    shares = [early_out_shares(pp) for pp in preps]
    dead = [dataclasses.replace(pp, alive=torch.zeros_like(pp.alive),
                                order=torch.empty_like(pp.order),
                                count=torch.empty_like(pp.count))
            for pp in preps]
    dead_ms = cuda_ms(lambda: run(dead), iters=1, repeats=3, warmup=1)
    if not all(bool((kk == trk.MISS_KEY).all()) for kk in keys):
        fail("the triangle kernel wrote a key for a dead ray")
    every = [dataclasses.replace(pp, alive=None, order=None, count=None)
             for pp in preps]
    every_ms = cuda_ms(lambda: run(every), iters=1, repeats=3, warmup=1)
    for pp, kk, (t_r, i_r) in zip(preps, keys, outs):
        t_e, i_e = trk.split_key(kk)
        if not (torch.equal(t_e[pp.alive], t_r[pp.alive])
                and torch.equal(i_e[pp.alive], i_r[pp.alive])):
            fail("the triangle kernel over every ray differs on live rays")
    flops = sum(live * act * (EARLY_OUT_FLOPS + KEPT_FLOPS * sh[0]
                              + U_PASS_FLOPS * sh[2] + V_PASS_FLOPS * sh[3])
                for (_, live, act, _), sh in zip(work, shares))
    return dict(
        k_all=k_all, per=per, dead=float(np.median(dead_ms)),
        every_ray=float(np.median(every_ms)), shares=shares, flops=flops,
        live_pairs=sum(live * act for _, live, act, _ in work),
        all_pairs=sum(n * act for n, _, act, _ in work),
        nbytes=sum(n * TRI_RAY_BYTES + live * TRI_LIVE_BYTES
                   + act * TRI_COL_BYTES for n, live, act, _ in work))


def rows_check(args, kw, tri_backend: str):
    """The nine-row form (a scene with a texture) against the plain
    version's rows on the same pass: (bit-identical, rays whose rows
    differ, same non-finite rows, max |difference|)."""
    prep = tk.prepare(*args, **kw, tri_backend=tri_backend)
    if prep.n_out != 9:
        fail("a scene with a texture took the three-row form")
    k = tk.launch(prep)
    p = torch.cat([torch.stack(list(v))
                   for v in tk.trace_full_plain(*args, **kw, rows=True)])
    same_bad = bool(torch.equal(torch.isfinite(k), torch.isfinite(p)))
    fin = torch.isfinite(k) & torch.isfinite(p)
    differ = int(((k != p) & fin).any(0).sum())
    diff = (k - p).abs()[fin]
    m = float(diff.max()) if diff.numel() else 0.0
    return differ == 0 and same_bad, differ, same_bad, m


@contextlib.contextmanager
def nearest_hits():
    """Each bounce's rays and nearest hit while the body runs
    trace_rays_rows (either form of the nearest hit): a list of (o, d,
    hit, t) per bounce, yielded."""
    rec = []
    saved = (trace_mod.closest_hit, trace_mod.closest_hit_split)

    def recording(fn):
        def hit_of(scene, o, d, *args, **kw):
            hit = fn(scene, o, d, *args, **kw)
            rec.append((o, d, hit.hit, hit.t))
            return hit
        return hit_of

    trace_mod.closest_hit, trace_mod.closest_hit_split = map(recording,
                                                             saved)
    try:
        yield rec
    finally:
        trace_mod.closest_hit, trace_mod.closest_hit_split = saved


def clustered_work(hits, clusters) -> list:
    """What each bounce of a plain pass (``nearest_hits``) needs of a
    clustered traversal: (live rays, the real slots over the (cluster,
    ray) pairs whose box the live ray may meet before its final t, those
    pairs).  A ray is live at bounce 0 and after each hit."""
    work, alive = [], None
    for o_, d_, hit, t in hits:
        if alive is None:
            alive = torch.ones_like(hit)
        counts = admitted(o_, d_, alive, t, clusters)
        work.append((int(alive.sum()), counts[0], counts[4]))
        alive = alive & hit
    return work


def trace_counts(label: str, args, kw, tri_backend: str) -> list:
    """The whole-trace kernel's counting instance on a full pass, held to
    the route's launch on the same pass (every output bit equal); its
    counts per bounce.  Persistent warps: also the route and the counting
    instance in flight at once on two streams, four times, each launch
    with its own path counter, every output equal to the route's."""
    prep = tk.prepare(*args, **kw, tri_backend=tri_backend)
    k = tk.launch(prep)
    c, counts = tk.launch_counted(prep)
    outs = [c]
    if prep.variant == tk.PERSISTENT:
        streams = (torch.cuda.Stream(), torch.cuda.Stream())
        torch.cuda.synchronize()
        for _ in range(4):
            with torch.cuda.stream(streams[0]):
                outs.append(tk.launch(prep))
            with torch.cuda.stream(streams[1]):
                outs.append(tk.launch_counted(prep)[0])
        torch.cuda.synchronize()
    if any(not torch.equal(k.view(torch.int32), o.view(torch.int32))
           for o in outs):
        fail(f"cell {label}: the counting instance's output, or a launch "
             "on a second stream, differs from the route's")
    return counts


def trace_walk_report(label: str, counts, work) -> str:
    """A clustered cell's counts per bounce (the counting instance) beside
    what the plain version's rays need (``clustered_work``)."""
    parts = []
    for b, (cnt, (live, pair_slots, pairs)) in enumerate(zip(counts, work)):
        n = max(cnt["live"], 1)
        steps = max(cnt["mt_steps"], 1)
        parts.append(
            f"b{b} live {cnt['live']} (plain {live}) in {cnt['warps']} "
            f"warps: boxes tested a live ray {cnt['box_tests'] / n:.2f}, "
            f"clusters admitted a live ray {cnt['admitted'] / n:.3f} "
            f"({cnt['admitted']} pairs against {pairs} under the final t), "
            f"union a warp {cnt['union'] / max(cnt['warps'], 1):.3f}, MT "
            f"lane-steps issued {32 * cnt['mt_steps']} against "
            f"{pair_slots} real slots of the needed pairs, active lanes a "
            f"MT step {cnt['lane_steps'] / steps:.2f}"
            + ("" if "chunks" not in cnt else
               f", chunks {cnt['chunks']} (split {cnt['split']}, wasted "
               f"{cnt['wasted']}), SM cycles a warp "
               f"{cnt['cycles_bounce'] / max(cnt['warps'], 1):.0f} ("
               f"{cnt['cycles_walk'] / max(cnt['cycles_bounce'], 1):.3f} "
               "of them in the walk: waiting for copies "
               f"{cnt['cycles_wait'] / max(cnt['cycles_bounce'], 1):.3f}, "
               f"MT {cnt['cycles_mt'] / max(cnt['cycles_bounce'], 1):.3f})"))
    life = ""
    if "cycles_warp" in counts[0]:
        c0 = counts[0]
        life = (f"; a warp lives {c0['cycles_warp'] / max(c0['warps'], 1):.0f}"
                f" SM cycles on average, its block holds its SM slots "
                f"{c0['cycles_block'] / max(c0['warps'], 1):.0f} (the warps "
                f"live {c0['cycles_warp'] / max(c0['cycles_block'], 1):.3f} "
                "of the slot time)")
    return (f"cell {label} whole-trace traversal per bounce: "
            + "; ".join(parts) + life)


def trace_path_report(label: str, counts, segments, prep) -> str:
    """A ``none`` or ``small`` cell's counts (the counting instance)
    beside the plain version's live rays: per bounce the live rays and the
    warp-steps that carried them (persistent warps; one thread a ray: the
    warps with a live lane, and the share of their lanes live); over the
    launch the warp-steps, the share of their lanes that carried a path,
    the fetches of path indices, and a warp's SM cycles (its share in ray
    generation, the sphere and plane tests, MT, the BSDF sample and the sky
    and writes) against its block's slot time; the blocks an SM holds."""
    c0 = counts[0]
    persistent = c0["steps"] > 0
    parts = [f"b{b} live {cnt['live']} (plain {seg[0]}) in {cnt['warps']} "
             + ("warp-steps" if persistent else
                f"warps ({cnt['live'] / (32 * max(cnt['warps'], 1)):.3f} "
                "of their lanes live)")
             for b, (cnt, seg) in enumerate(zip(counts, segments))]
    sms = torch.cuda.get_device_properties(prep.device).multi_processor_count
    held, held_count = tk.occupancy(prep), tk.occupancy(prep, counting=True)
    block = tk.PATH_BLOCK if persistent else tk.RAY_BLOCK
    blocks = -(-prep.n_rays // block)
    if persistent:
        blocks = min(blocks, held_count * sms)
    warps = blocks * (block // 32)
    steps = c0["steps"] or sum(c["warps"] for c in counts)
    lanes = c0["step_lanes"] or sum(c["live"] for c in counts)
    life = max(c0["cycles_warp"], 1)
    share = lambda key: f"{c0[key] / life:.3f}"
    return (f"cell {label} whole-trace {prep.label} ("
            + ("persistent warps" if persistent else "one thread a ray")
            + ") per bounce: " + "; ".join(parts)
            + f"; over the launch: {steps} warp-steps carried {lanes} lanes "
            f"with a path ({lanes / (32 * max(steps, 1)):.3f} of their "
            f"lanes) for {sum(c['live'] for c in counts)} live ray-bounces, "
            f"{c0['fetches']} fetches of path indices; {warps} warps, each "
            f"living {life / warps:.0f} SM cycles: ray generation "
            f"{share('cycles_gen')}, spheres and planes "
            f"{share('cycles_prims')}, MT {share('cycles_tris')}, BSDF "
            f"{share('cycles_bsdf')}, the sky and writes "
            f"{share('cycles_finish')}; the blocks hold their SM slots "
            f"{c0['cycles_block'] / warps:.0f} cycles a warp (the warps live"
            f" {life / max(c0['cycles_block'], 1):.3f} of the slot time); an"
            f" SM holds {held} blocks of the route ({held_count} of the "
            "counting instance)")


def make_textures(directory: Path) -> dict:
    """The cells' environment textures at the reference skybox's size,
    from TEXTURE_SEED: "rgbe", an HDR sky (a vertical gradient times
    log-normal noise) written with save_hdr into ``directory`` and read
    back with load_skybox (no PIL), and "ldr", 8-bit values linearized as
    (u8 / 255)^2.2."""
    rng = np.random.default_rng(TEXTURE_SEED)
    h, w, _ = TEXTURE_SHAPE
    ramp = np.linspace(0.2, 1.5, h, dtype=np.float32)[:, None, None]
    hdr = (ramp * np.exp(rng.normal(0.0, 0.5, TEXTURE_SHAPE))
           ).astype(np.float32)
    path = directory / "sky.hdr"
    save_hdr(path, hdr)
    u8 = rng.integers(0, 256, TEXTURE_SHAPE, np.uint8)
    return {"rgbe": load_skybox(path),
            "ldr": np.power(u8.astype(np.float32) / 255.0, np.float32(2.2),
                            dtype=np.float32)}


def gate_check(r: Renderer, camera):
    """The per-ray gate (kernel and plain version alike) against a
    gate-free dense Moller-Trumbore over every triangle, on the live rays
    of every BVH launch of one pass of BAND_ROWS full-width rows at the
    image's centre.  The TPU gates a 128-ray sub-block, which admits at
    least what each of its rays admits, so a hit the dense loop finds and
    the gate loses is the most by which the two can differ.  Both run the
    same float operations, so a gate hit the dense loop lacks is a fault.
    Returns (row0, launches, dense hits, rays lost or farther, extra)."""
    row0 = (r.options.height - BAND_ROWS) // 2
    _, rec = per_bounce_pass(r, camera, 4243, band=(row0, BAND_ROWS))
    tris = r.device_scene.triangles
    hits = lost = extra = 0
    for prep, (t_k, s_k) in rec.bvh:
        o_, d_, alive, t_init = bvh_inputs(prep)
        live = alive > 0
        sub = lambda v: Vec3(v.x[live], v.y[live], v.z[live])
        t_d, _, _, _ = intersect_triangles(sub(o_), sub(d_), tris)
        dense = t_d < t_init[live]
        gate = s_k[live] >= 0
        hits += int(dense.sum())
        lost += int((dense & ~(gate & (t_k[live] == t_d))).sum())
        extra += int((gate & ~dense).sum())
    return row0, len(rec.bvh), hits, lost, extra


def sphere_scene() -> Scene:
    """A ground plane and N_SPHERES small spheres: 2,048 sphere slots of 32
    bytes, above the 48 KB of shared memory a launch gets by default."""
    s = Scene()
    s.add_plane((0, -1, 0), (0, 1, 0))
    rng = np.random.default_rng(6)
    lamp = s.add_material(Material(emission=(1.0, 0.9, 0.7),
                                   emission_strength=4.0), "Lamp")
    for j in range(N_SPHERES):
        c = rng.uniform((-4, -0.8, -9), (4, 2.5, -3))
        s.add_sphere(tuple(float(x) for x in c), 0.18,
                     material=lamp if j % 16 == 0 else 0)
    return s


def bvh_bound(clusters, work) -> tuple:
    """(FLOP, bytes) the least a pass's BVH launches need, from what each
    launch's walked rays open (``admitted``), in either MT form: each
    walked ray slab-tests the hierarchy's root boxes, and tests the real
    slots of every cluster it opens in the cheaper form of the launch
    (MT_FLOPS a pair, or PLUCKER_FLOPS a pair and the walked ray's moment
    m = o x d).  Every ray's (t, slot) is written once and its alive flag
    read once, at its dtype (1 B bool on the split path, 4 B f32); a live
    ray's o, d and t_init are read once (a dense launch walks every live
    ray, a compacted one tests every live ray against the admission boxes;
    neither reads a dead ray's).  The compaction's ray order is this
    design's own, not a need of the function.  A launch reads the root
    boxes, the boxes of the opened clusters and of their supers, and the
    opened clusters' MT columns and slot indices once: the Plucker
    coefficients derive from those columns (the TPU kernel derives them
    per cluster), so the port's per-scene table of them is its own choice,
    not a need of the function."""
    roots = int((clusters.hierarchy.groups[:, 0] < 1.0e37).sum())
    flops = nbytes = 0
    for (walked, n, _, pair_slots, slots, opened, supers, _, live,
         alive_bytes) in work:
        flops += (walked * (roots * SLAB_FLOPS + INV_DIR_FLOPS)
                  + min(pair_slots * MT_FLOPS,
                        pair_slots * PLUCKER_FLOPS
                        + walked * PLUCKER_RAY_FLOPS))
        nbytes += n * (HIT_OUT_BYTES + alive_bytes) + live * LIVE_RAY_BYTES
        if walked:
            nbytes += (slots * SLOT_BYTES
                       + (roots + supers + opened) * BOX_BYTES)
    return float(flops), float(nbytes), roots


def shade_bound(scene, work) -> tuple:
    """(FLOP, bytes) the least a pass's shade launches need: each live ray
    tests every active sphere and plane, each ray that goes on shades and
    samples the BSDF (a floor: the last bounce's hits and the triangle
    normals are not counted); 168 bytes per state column."""
    n_s = int(scene.spheres.active.sum())
    n_p = int(scene.planes.active.sum())
    flops = sum(live * (n_s * SPHERE_FLOPS + n_p * PLANE_FLOPS)
                + went_on * (SHADE_FLOPS + BSDF_FLOPS)
                for live, went_on, _, _ in work)
    nbytes = sum(n * BOUNCE_RAY_BYTES for _, _, n, _ in work)
    return float(flops), float(nbytes)


@contextlib.contextmanager
def kernel_as(module, kernel):
    """``module``'s launches (bk, tk or sk: each launches ``module.KERNEL``)
    through another build of its kernel, of the same C interface, while the
    body runs; its launches are counted on it, not on the route's kernel."""
    route = module.KERNEL
    module.KERNEL = kernel
    try:
        yield
    finally:
        module.KERNEL = route


def replay(preps, outs, kernel=None, **fields) -> tuple:
    """ms a pass of recorded BVH launches (with launch parameters replaced
    by ``fields``, on ``kernel`` where given), and whether every (t, slot)
    equals the recorded one."""
    alt = [(with_params(pp, **fields), (torch.empty_like(t),
                                        torch.empty_like(s)))
           for pp, (t, s) in zip(preps, outs)]
    if "variant" in fields:
        names = {v: k for k, v in bk.VARIANTS.items()}
        alt = [(dataclasses.replace(q, variant=names[fields["variant"]]), o)
               for q, o in alt]
    with kernel_as(bk, kernel or bk.KERNEL):
        ms = float(np.median(cuda_ms(lambda: [bk.launch(q, o)
                                              for q, o in alt],
                                     iters=2, repeats=3, warmup=1)))
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for (_, a), b in zip(alt, outs))
    return ms, same


def two_level_report(preps, outs, streamed_ms: float) -> str:
    """The streamed variant's launches of one pass replayed on the
    two_level variant, which launches the same warp walk: the same
    results, and the time beside the streamed launches'."""
    ms, same = replay(preps, outs, variant=bk.VARIANTS["two_level"])
    if not same:
        fail("the streamed and two_level variants disagree")
    return (f"the same launches on two_level {ms:.4f} ms/pass, streamed / "
            f"two_level {streamed_ms / ms:.3f}, results equal")


def device_ms_by_kernel(fn, reps: int = 3) -> dict:
    """Device ms per call of each kernel name that ``fn`` launches
    (torch.profiler over ``reps`` calls, after one unprofiled call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {k: v / 1e3 / reps for k, v in kernel_device_us(prof).items()}


class ParentBvhLibrary:
    """A parent build of the BVH kernel's C interface 3 (e9ce31e to
    0fee89c: no BvhOptions) called through this one: a launch passes its
    arguments without the options, and one whose options ask for a switch
    (the reverse order, the Morton key), which that interface lacks, is
    refused.  Every other name is the library's."""

    def __init__(self, lib):
        self._lib = lib

    @staticmethod
    def _drop_options(args) -> list:
        opt = args[-3]
        if opt.reverse or opt.morton:
            raise ValueError("a parent BVH build of C interface 3 has no "
                             "reverse order and no Morton key")
        return [*args[:-3], *args[-2:]]

    def srt_bvh_launch(self, *args):
        return self._lib.srt_bvh_launch(*self._drop_options(args))

    def srt_bvh_count_launch(self, *args):
        return self._lib.srt_bvh_count_launch(*self._drop_options(args))

    def __getattr__(self, name):
        return getattr(self._lib, name)


class ParentBvhKernel(bk.Kernel):
    """A parent checkout's BVH kernel: a build of this C interface bound
    by bk._bind, or one of interface 3 bound without BvhOptions and called
    through ParentBvhLibrary; any other version is refused."""

    def __init__(self, source: Path):
        super().__init__(source, self.bind)
        self.version = None

    def bind(self, lib) -> None:
        self.version = build.interface(lib, "srt_bvh_interface")
        if self.version != 3:
            bk._bind(lib)          # refuses every version but this one
            return
        lib.srt_bvh_launch.argtypes = (bk.LAUNCH_ARGTYPES[:-3]
                                       + bk.LAUNCH_ARGTYPES[-2:])
        lib.srt_bvh_launch.restype = ctypes.c_int
        lib.srt_bvh_count_launch.argtypes = (bk.COUNT_ARGTYPES[:-3]
                                             + bk.COUNT_ARGTYPES[-2:])
        lib.srt_bvh_count_launch.restype = ctypes.c_int
        lib.srt_bvh_work_words.argtypes = [bk.BvhParams]
        lib.srt_bvh_work_words.restype = ctypes.c_longlong

    def _build(self):
        lib = super()._build()
        return ParentBvhLibrary(lib) if self.version == 3 else lib


def parent_bvh_kernel(parent: Path):
    """The parent checkout's BVH kernel (ParentBvhKernel: this C
    interface, or interface 3)."""
    return ParentBvhKernel(parent / "simple_raytracer_tpu_torch" / "csrc"
                           / "bvh_kernel.cu")


def parent_launcher(kernel, pp, out):
    """A recorded BVH launch on the parent's kernel into ``out``, as a
    callable.  Its launches are counted on the parent's kernel, never on
    the route's."""
    def run():
        with kernel_as(bk, kernel):
            bk.launch(pp, out)

    return run


def walk_launches(label: str, res: dict, clusters, table,
                  parent=None) -> dict:
    """Phase 6 of a BVH cell, one launch at a time: the launch's time (the
    visiting order, the ray compaction and the walk, all on the card), and
    the device time of each of its kernels (torch.profiler: the order's and
    the compaction's kernels beside the walk); with ``parent`` (an earlier
    build of the kernel), the same launch on it in turns (parent, this,
    this, parent), whose (t, slot) must be the route's;
    ops/bvh.compact_order's time on the same rays (the compaction's plain
    version, in PyTorch) and ``prepare``'s, with the route's whole cost a
    pass (launches + ``prepare``); and what the walk did, from the counting
    instance (phase 4), beside what the plain version's gates admit under
    each ray's final t (``admitted``): pairs run against those needed, the
    clusters a warp runs, boxes tested a walked ray, MT lane-steps issued
    against the needed pairs' real slots, active lanes a MT step."""
    per, lines = [], []
    adm = clusters.hierarchy.admission
    for b, ((pp, oo), w, cnt) in enumerate(zip(res["recorded"], res["work"],
                                               res["counts"])):
        o_, d_, alive, t_init = bvh_inputs(pp)
        med = lambda fn: float(np.median(cuda_ms(fn, iters=3, repeats=3,
                                                 warmup=1)))
        run_k = lambda: med(lambda: bk.launch(pp, oo))
        parent_ms, parent_note = None, ""
        if parent is None:
            k_ms = run_k()
        else:
            got = (torch.empty_like(oo[0]), torch.empty_like(oo[1]))
            launch_p = parent_launcher(parent, pp, got)
            run_p = lambda: med(launch_p)

            turns = [run_p(), run_k(), run_k(), run_p()]
            if not (torch.equal(got[0], oo[0]) and torch.equal(got[1],
                                                               oo[1])):
                fail(f"cell {label} bounce {b}: the parent's kernel and "
                     "this one differ")
            parent_ms = (turns[0] + turns[3]) / 2
            k_ms = (turns[1] + turns[2]) / 2
            parent_note = (f", the parent's kernel {parent_ms:.4f} ms in "
                           f"turns ({', '.join(f'{t:.4f}' for t in turns)}; "
                           f"parent / this {parent_ms / k_ms:.2f}x)")
        parts = device_ms_by_kernel(lambda: bk.launch(pp, oo))
        walk_ms = sum(v for k, v in parts.items() if "bvh_kernel" in k)
        compact = pp.perm is not None
        c_ms = (med(lambda: bvh.compact_order(o_, d_, alive, t_init, adm))
                if compact else 0.0)
        prep_ms = med(lambda: bk.prepare(o_, d_, alive, t_init, clusters,
                                         table, compact,
                                         pp.variant == "streamed"))
        walked, pair_slots, pairs_adm, opened = w[0], w[3], w[7], w[5]
        st = max(cnt["stagings"], 1)
        warps = max(cnt["warps"], 1)
        steps = max(cnt["mt_steps"], 1)
        # the work done: the bytes fed to MT (a slot's row) and the
        # lane-slot MT tests issued (32 lanes a warp-wide step)
        row_bytes = 4 * (bvh.PLUCKER_COLS if pp.params.plucker
                         else bvh.STAGED_COLS)
        per.append(dict(kernel_ms=k_ms, walk_ms=walk_ms,
                        order_ms=sum(parts.values()) - walk_ms,
                        parent_ms=parent_ms, compact_order_ms=c_ms,
                        prepare_ms=prep_ms, compact=compact,
                        admitted_pairs=pairs_adm, needed_slots=pair_slots,
                        opened=opened, fed_bytes=cnt["slots"] * row_bytes,
                        mt_issued=32 * cnt["mt_steps"], **cnt))
        lines.append(
            f"b{b} {'compact' if compact else 'dense'} walked {walked} in "
            f"{cnt['warps']} warps: launch {k_ms:.4f} ms (device: "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(parts.items()))
            + f"){parent_note}, compact_order (PyTorch) {c_ms:.4f} ms, "
            f"prepare {prep_ms:.4f} ms; boxes tested a walked ray "
            f"{cnt['box_tests'] / max(walked, 1):.2f}; (warp, cluster) "
            f"visits {cnt['stagings']} ({cnt['stagings'] / warps:.3f} a "
            f"warp; chunks fed {cnt['chunks']}, slots {cnt['slots']}), "
            f"admitting lanes mean {cnt['pairs'] / st:.2f}, by lanes "
            f"{cnt['hist']}, split {cnt['split']}, wasted {cnt['wasted']}; "
            f"fed {per[-1]['fed_bytes'] / 1e6:.3f} MB; MT pairs (ray, "
            f"cluster) {cnt['pairs']} against {pairs_adm} admitted under "
            f"the final t ({opened} clusters opened); warp MT steps "
            f"{cnt['mt_steps']} ({per[-1]['mt_issued']} lane-slot tests "
            f"issued against {pair_slots} real slots of the needed pairs; "
            f"active lanes a MT step "
            f"{cnt['pairs'] * pp.params.k / steps:.2f}); warp slab tests "
            f"groups {cnt['group_tests']}, supers {cnt['super_tests']}, "
            f"clusters {cnt['cluster_tests']}")
    tot = lambda key: sum(x[key] for x in per)
    parent_note = ""
    if parent is not None:
        parent_note = (f", the parent's kernel {tot('parent_ms'):.4f} ms "
                       f"(parent / this "
                       f"{tot('parent_ms') / tot('kernel_ms'):.2f}x)")
    say(f"[6] cell {label} {res['recorded'][0][0].variant} launches one by "
        f"one: {'; '.join(lines)}; a pass: launches {tot('kernel_ms'):.4f} "
        f"ms (the walk {tot('walk_ms'):.4f} ms, the order and compaction "
        f"kernels {tot('order_ms'):.4f} ms){parent_note}, compact_order "
        f"(PyTorch) {tot('compact_order_ms'):.4f} ms, prepare "
        f"{tot('prepare_ms'):.4f} ms, launches + prepare "
        f"{tot('kernel_ms') + tot('prepare_ms'):.4f} ms; fed "
        f"{tot('fed_bytes') / 1e6:.3f} MB, MT pairs "
        f"{tot('pairs')} ({tot('mt_issued')} lane-slot tests issued "
        f"against {tot('needed_slots')} needed), admitted pairs "
        f"{tot('admitted_pairs')}")
    return dict(per_launch=per)


# the cells timed on both BVH builders' layouts (phase 6): the host
# library's binned SAH, the port's default, against the NumPy median split
# (accel.build_bvh with force_python=True), each on a scene build of its
# own; rows 4 (two_level), 5 (streamed) and 1b' (the whole-trace kernel's
# clustered variant over config 6)
BUILDER_CELLS = ("6", "7", "6/fused")


@contextlib.contextmanager
def median_split():
    """Scene builds inside take the NumPy median-split BVH, asked for as
    accel.build_bvh(force_python=True)."""
    saved = accel.build_bvh
    accel.build_bvh = lambda *a, **kw: saved(*a, **{**kw,
                                                 "force_python": True})
    try:
        yield
    finally:
        accel.build_bvh = saved


def layout_pass(label: str, r: Renderer, camera) -> tuple:
    """A cell's kernel launches of one pass on its scene's layout, as a
    callable, and the layout's numbers: the staged MT table's MB, the
    clusters, and what the pass's walk did (its counting instance): MT
    pairs (ray, cluster), lane-slot MT tests issued, (warp, cluster)
    visits, chunks staged and box tests."""
    tris = r.device_scene.triangles
    staged = bvh.staged_slots(tris.clusters, tris.table)
    if label in SPLIT:
        _, rec = per_bounce_pass(r, camera, 4242)
        recorded = rec.bvh

        def run():
            for pp, oo in recorded:
                bk.launch(pp, oo)
        counts = [bk.launch_counted(pp)[1] for pp, _ in recorded]
        pairs, visits = "pairs", "stagings"
    else:
        args, kw = trace_args(r, camera, 4242)
        prep = tk.prepare(*args, **kw, tri_backend=r.options.tri_backend)

        def run():
            tk.launch(prep)
        counts = tk.launch_counted(prep)[1]
        pairs, visits = "admitted", "union"
    tot = lambda key: sum(c[key] for c in counts)
    return run, dict(staged_mb=staged.numel() * staged.element_size() / 1e6,
                     clusters=tris.clusters.slots.shape[0],
                     pairs=tot(pairs), issued=32 * tot("mt_steps"),
                     visits=tot(visits), chunks=tot("chunks"),
                     box_tests=tot("box_tests"))


def builder_turns(card: str, renderers: dict) -> dict:
    """Each of BUILDER_CELLS on the SAH layout (phase 3's scene) and on
    the median split's (a scene built here): the scene build's seconds,
    the kernel's pass time in turns (SAH, median, median, SAH; the same
    camera rays and time seed) and ``layout_pass``'s numbers of each.
    Returns label -> the numbers."""
    out, lines = {}, []
    for label in BUILDER_CELLS:
        r, camera = renderers[label]
        n = CELLS[label][0]
        scene, _, _ = CONFIGS[n](**KWARGS.get(n, {}))
        t0 = time.perf_counter()
        with median_split():
            ds = scene.build("cuda")
        torch.cuda.synchronize()
        median_build_s = time.perf_counter() - t0
        rm = Renderer(r.options, device="cuda")
        rm.set_device_scene(ds)
        (run_s, sah), (run_m, med) = (layout_pass(label, r, camera),
                                      layout_pass(label, rm, camera))
        ms = lambda run: float(np.median(cuda_ms(run, iters=3, repeats=3,
                                                 warmup=1)))
        turns = [ms(run_s), ms(run_m), ms(run_m), ms(run_s)]
        sah_ms, med_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        out[label] = dict(sah_ms=sah_ms, median_ms=med_ms, turns=turns,
                          sah=sah, median=med, median_build_s=median_build_s)
        lines.append(
            f"{label} ({CELLS[label][2]}): SAH {sah_ms:.4f} ms/pass, median "
            f"{med_ms:.4f} ms/pass (turns "
            f"{', '.join(f'{t:.4f}' for t in turns)}; median / SAH "
            f"{med_ms / sah_ms:.3f}); "
            + ", ".join(f"{key} {sah[key]:.6g} against {med[key]:.6g}"
                        for key in sah)
            + f"; the median scene's build {median_build_s:.3f} s")
        del rm, ds
    say(f"[6] the BVH builders' layouts, the kernel's pass in turns, SAH "
        f"(the host library, the default) against the median split "
        f"(force_python): {'; '.join(lines)}  [{card}]")
    return out


# The warp walk's constants swept on the launches of a pass of two_level
# and flat (phase 6), each a build of the BVH kernel with -D flags of the
# source's names: the split point (SRT_BVH_SPLIT_MAX; 0: never split, 32:
# always split) with the route's ring, and the ring's buffers and chunk
# (SRT_BVH_STAGES x SRT_BVH_CHUNK) at the route's split point.
SWEEP_SPLITS = (0, 4, 8, 16, 24, 32)
SWEEP_RINGS = ((3, 64), (4, 64), (2, 32), (4, 32))
SWEEP_KERNELS = {}


def route_constant(name: str) -> int:
    """The default of one of the BVH kernel's -D constants, in its
    source."""
    src = Path(bk.SOURCE).read_text()
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def sweep_kernels() -> dict:
    """The sweep's builds of the BVH kernel, by case name, built at once
    (one nvcc each) on first use."""
    if not SWEEP_KERNELS:
        cases = {f"split {sm}": [f"-DSRT_BVH_SPLIT_MAX={sm}"]
                 for sm in SWEEP_SPLITS}
        for stages, chunk in SWEEP_RINGS:
            cases[f"ring {stages}x{chunk}"] = [f"-DSRT_BVH_STAGES={stages}",
                                               f"-DSRT_BVH_CHUNK={chunk}"]
        SWEEP_KERNELS.update({name: bk.Kernel(bk.SOURCE, bk._bind, flags)
                              for name, flags in cases.items()})
        build_all("the sweep's kernel builds", SWEEP_KERNELS.values())
    return SWEEP_KERNELS


def walk_form(name: str):
    """The form of a walk instance from its mangled name ("mt", "plucker",
    "subbox", each also "/counting"), or None for another kernel."""
    m = re.search(r"bvh_kernelILi\d+ELb([01])ELb([01])ELb([01])E", name)
    if m is None:
        return None
    return (("plucker" if m.group(1) == "1" else
             "subbox" if m.group(2) == "1" else "mt")
            + ("/counting" if m.group(3) == "1" else ""))


def walk_ptxas(kernel) -> dict:
    """ptxas's report of each instance of a build's walk (registers,
    spills), by walk_form."""
    out, form = {}, None
    for line in kernel.build_log.splitlines():
        if "entry function" in line:
            form = walk_form(line)
        elif form is not None and ("registers" in line or "spill" in line):
            text = line.split("ptxas info    : ")[-1].strip()
            out[form] = f"{out[form]}; {text}" if form in out else text
    return out


def registers(report: str) -> int:
    """The registers a thread of one walk_ptxas report."""
    return int(re.search(r"Used (\d+) registers", report).group(1))


def walk_sass(kernels) -> list:
    """Each build's walk instances as compiled: for each kernel of
    ``kernels`` (builds of a BVH kernel source), its source built to a
    cubin with its flags (all at once, one nvcc each), then each walk
    instance's SASS instructions (cuobjdump -sass, addresses and encodings
    left out), by walk_form."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cubins = [Path(tmp) / f"walk{i}.cubin" for i in range(len(kernels))]
        procs = [subprocess.Popen(
            [nvcc, *[f for f in k.flags if f not in ("-shared", "-Xcompiler",
                                                     "-fPIC", "-Xptxas",
                                                     "-v")],
             "-cubin", "-o", str(c), str(k.source)], stderr=subprocess.PIPE,
            text=True) for k, c in zip(kernels, cubins)]
        for proc in procs:
            if proc.wait() != 0:
                fail(f"the walk's SASS build: {proc.stderr.read()}")
        found = []
        for cubin in cubins:
            text = subprocess.run([tool, "-sass", str(cubin)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            funcs = {}
            for func in text.split("Function : ")[1:]:
                form = walk_form(func.split()[0])
                if form is not None:
                    funcs[form] = re.findall(
                        r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", func)
            found.append(funcs)
    return found


def walk_sweep(label: str, res: dict) -> dict:
    """The launches of a pass (two_level or flat) on each build of
    ``sweep_kernels`` and on the route's, in turns, twice: ms a pass, and
    (t, slot) equal to the route's."""
    preps = [pp for pp, _ in res["recorded"]]
    outs = [oo for _, oo in res["recorded"]]
    variant = preps[0].variant
    builds = {"route": bk.KERNEL, **sweep_kernels()}
    ms = collections.defaultdict(list)
    for _ in range(2):
        for name, kernel in builds.items():
            try:
                t, same = replay(preps, outs, kernel)
            except RuntimeError as exc:     # the launch was refused
                fail(f"cell {label}: the sweep's {name}: {exc}")
            if not same:
                fail(f"cell {label}: the sweep's {name} changes a result")
            ms[name].append(t)
    say(f"[6] cell {label} {variant} sweep (ms a pass, two turns; the "
        f"route: split {route_constant('SRT_BVH_SPLIT_MAX')}, ring "
        f"{route_constant('SRT_BVH_STAGES')}x"
        f"{route_constant('SRT_BVH_CHUNK')}): "
        + ", ".join(f"{k}: {v[0]:.4f} / {v[1]:.4f}" for k, v in ms.items())
        + "; results equal; ptxas of each build's walk (MT): "
        + ", ".join(f"{k}: {walk_ptxas(kernel).get('mt', 'no report')}"
                    for k, kernel in builds.items()))
    return dict(ms)


def parent_shade_kernel(parent: Path):
    """The parent checkout's shade kernel (csrc/bounce_kernel.cu, whose
    launch has not changed since the port began: sk._bind)."""
    return bk.Kernel(parent / "simple_raytracer_tpu_torch" / "csrc"
                     / "bounce_kernel.cu", sk._bind)


def shade_turns(preps, outs, parent) -> str:
    """A pass's shade launches on the parent's build and on this one, in
    turns (parent, this, this, parent), every output bit equal."""
    got = [torch.empty_like(oo) for oo in outs]

    def run(kernel, dst):
        with kernel_as(sk, kernel):
            return float(np.median(cuda_ms(
                lambda: [sk.launch(pp, oo) for pp, oo in zip(preps, dst)],
                iters=5, repeats=3, warmup=1)))

    turns = [run(parent, got), run(sk.KERNEL, outs), run(sk.KERNEL, outs),
             run(parent, got)]
    if any(not torch.equal(g.view(torch.int32), o.view(torch.int32))
           for g, o in zip(got, outs)):
        fail("the parent's shade kernel and this one differ")
    ratio = (turns[0] + turns[3]) / (turns[1] + turns[2])
    return (f"the parent's shade kernel {turns[0]:.4f}, {turns[3]:.4f} ms a "
            f"pass against this {turns[1]:.4f}, {turns[2]:.4f} in turns "
            f"(parent / this {ratio:.3f}x), every output equal")


def parent_trace_kernel(parent: Path):
    """The parent checkout's whole-trace kernel, bound to this C interface
    (tk._bind refuses a build of any other)."""
    return bk.Kernel(parent / "simple_raytracer_tpu_torch" / "csrc"
                     / "trace_kernel.cu", tk._bind)


def parent_trace_launch(kernel, prep, out) -> None:
    """A prepared pass on the parent's whole-trace kernel into ``out``
    (not counted as a launch of either build)."""
    fn = kernel.library().srt_trace_launch
    counter = tk.next_path(prep)
    ptrs = [None if t is None else t.data_ptr()
            for t in prep.tables + prep.tri_tables] + [
        out.data_ptr(), None if counter is None else counter.data_ptr()]
    with torch.cuda.device(prep.device):
        stream = torch.cuda.current_stream(prep.device).cuda_stream
        kernel.check(fn(*ptrs, prep.params, stream), "the parent's trace "
                     "kernel")


def parent_probe_kernel(parent: Path):
    """The parent checkout's probe kernel, bound to this C interface
    (probe._bind refuses a build of any other)."""
    return build.Kernel(parent / "simple_raytracer_tpu_torch" / "csrc"
                        / "probe_kernel.cu", probe._bind)


def raw_probe_launch(kernel, name: str, x, out) -> None:
    """Probe ``name`` on a build of the probe kernel (the parent's, or this
    one) into ``out`` through its C interface alone: the same host path
    for either build, not counted as a launch of either."""
    fn = kernel.library().srt_probe_launch
    ptrs = [x.data_ptr(), out.data_ptr(), None]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernel.check(fn(*ptrs, probe.ProbeParams(probe.ROWS, probe.COLS,
                                             probe.PROBES[name][0]),
                    stream), "the parent's probe kernel")


def probe_cuda_inputs() -> dict:
    """probe.probe_inputs() on the card."""
    return {k: torch.from_numpy(v).cuda()
            for k, v in probe.probe_inputs().items()}


def probe_path(card: str) -> tuple:
    """Phase 3's probe path: probe_kernel_ops.run() and floor_us(), every
    kernel's counts reset just before and read just after (a launch
    captured in run()'s CUDA graph counts once; its replays are not
    launches of the wrapper).  Fails where the counts are not what they
    launch, or a probe differs from its plain version.  Returns run()'s
    results, floor_us()'s and the counts."""
    for kernel in KERNELS.values():
        kernel.reset_counts()
    probes = probe.run(calls=PROBE_CALLS, timed_calls=PROBE_TIMED)
    floor = probe.floor_us(calls=PROBE_CALLS)
    torch.cuda.synchronize()
    got = {kind: dict(k.variant_launches) for kind, k in KERNELS.items()}
    # run(): one launch an input, warm-up and timed, captured, timing
    # instance; floor_us(): warm-up, timed, captured
    per_probe = len(probe.probe_inputs()) + 3 + 2 * PROBE_CALLS
    want = {kind: {} for kind in KERNELS}
    want["probe"] = {"empty": 3 + 2 * PROBE_CALLS}
    for name in probe.PROBES:
        want["probe"].update({name: per_probe,
                              f"{name}/timed": PROBE_TIMED})
    say(f"[3] probes (probe_kernel_ops.run, floor_us): launches {got} (want "
        f"{want}); "
        + "; ".join(f"{name} value[0,0]={res['value']:.1f} equal to plain "
                    f"on every seeded input={res['equal']}"
                    for name, res in probes.items())
        + f"  [{card}]")
    if got != want:
        fail(f"probes: launches {got}, want {want}")
    if not all(res["equal"] for res in probes.values()):
        fail(f"probes: run() found outputs that differ from the plain "
             f"versions: {probes}")
    return probes, floor, got


def probe_checks(card: str) -> dict:
    """Phase 4: each probe kernel against its plain version on every
    seeded input (probe.agrees: bit for bit on integer values, A and B
    within probe.RTOL of the sum on the uniform floats); fails on any
    other difference.  Returns each probe's largest |difference|."""
    xs = probe_cuda_inputs()
    errs, lines = {}, []
    for name in probe.PROBES:
        parts = []
        for key, x in xs.items():
            out = probe.launch(name, x, torch.empty_like(x))
            d = float((out - probe.probe_plain(name, x)).abs().max())
            if not probe.agrees(name, x, out):
                fail(f"probe {name} on {key}: the kernel differs from its "
                     f"plain version (max |d| {d})")
            parts.append(f"{key} " + ("equal" if d == 0 else f"|d| {d:.4g}"))
            errs[name] = max(errs.get(name, 0.0), d)
        lines.append(f"{name}: {', '.join(parts)}")
    fired = {key: int((x > 2).any(dim=0).sum()) for key, x in xs.items()}
    say(f"[4] probes vs plain on the seeded inputs (bit for bit on "
        f"integer values; A and B within rtol {probe.RTOL} of the sum on "
        f"the uniform floats; columns C fires: {fired}): "
        f"{'; '.join(lines)}  [{card}]")
    return errs


def span_text(cycles: dict) -> str:
    """A timing instance's spans (probe.spans) as text."""
    return ", ".join(f"{span} {cycles[span]:.0f}" for span in probe.SPANS) \
        + " SM cycles a CTA"


def probe_timings(card: str, probes: dict, floor: dict, errs: dict,
                  timing: dict, library: dict, parent=None) -> dict:
    """Phase 6's probe rows: each probe's time per call at the device's
    pace and launched from Python (phase 3's run()), its loop's cycles
    an iteration, the empty cluster launch's time, the bound, the plain
    version's time; with ``parent`` (an earlier build) its time per call
    and this one's in turns (parent, this, this, parent), each launched
    through raw_probe_launch, in a CUDA graph (probe.graph_us) and from
    Python (probe.events_us), its outputs on
    the ones equal to this one's, and whether its C agrees with the plain
    version on each input.  Fills ``timing`` and ``library`` and returns
    the JSON rows' extra keys by cell."""
    xs = probe_cuda_inputs()
    x = xs["ones"]
    out = torch.empty_like(x)
    bound_ms = PROBE_BYTES / HBM_BYTES_PER_S * 1e3
    floor_ms = floor["us_per_call"] / 1e3
    extra = {}
    for name, (_, trips, what) in probe.PROBES.items():
        res = probes[name]
        k_ms = res["us_per_call"] / 1e3
        p_ms = float(np.median(cuda_ms(lambda: probe.probe_plain(name, x),
                                       iters=PROBE_CALLS)))
        timing[f"probe/{name}"] = ("probe", errs[name], k_ms, p_ms,
                                   bound_ms, "bytes", None)
        # A's and B's function is one PyTorch call, full_like of the sum,
        # their plain version: it is their library time too.  C's is a
        # loop over the columns that fire: several calls, no library call
        if name != "C":
            library[f"probe/{name}"] = p_ms
        row = {"ms_eager": res["us_per_call_eager"] / 1e3,
               "cycles": res["cycles"],
               "floor_ms": floor_ms,
               "floor_ms_eager": floor["us_per_call_eager"] / 1e3}
        notes = []
        if parent is not None:
            out_p = torch.empty_like(x)
            this = lambda: raw_probe_launch(probe.KERNEL, name, x, out)
            theirs = lambda: raw_probe_launch(parent, name, x, out_p)
            theirs()            # its first launch sets its attribute
            torch.cuda.synchronize()
            turns, eager = ([timer(fn, PROBE_CALLS)
                             for fn in (theirs, this, this, theirs)]
                            for timer in (probe.graph_us, probe.events_us))
            if not torch.equal(out_p, out):
                fail(f"probe {name}: the parent's kernel and this one "
                     f"differ on the ones")
            agree = {}
            for key, xi in xs.items():
                got = torch.empty_like(xi)
                raw_probe_launch(parent, name, xi, got)
                agree[key] = probe.agrees(name, xi, got)
            row["parent_us"] = [turns[0], turns[3]]
            row["parent_turns_this_us"] = [turns[1], turns[2]]
            row["parent_eager_us"] = [eager[0], eager[3]]
            row["parent_turns_this_eager_us"] = [eager[1], eager[2]]
            row["parent_agrees"] = agree
            notes.append(f"the parent's kernel {turns[0]:.3f}, "
                         f"{turns[3]:.3f} us a call against this "
                         f"{turns[1]:.3f}, {turns[2]:.3f} in turns "
                         f"(parent / this "
                         f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}"
                         f"x); launched from Python {eager[0]:.3f}, "
                         f"{eager[3]:.3f} against {eager[1]:.3f}, "
                         f"{eager[2]:.3f} in turns (parent / this "
                         f"{(eager[0] + eager[3]) / (eager[1] + eager[2]):.2f}"
                         f"x); the parent's output agrees with the plain "
                         f"version on {agree}")
        extra[f"probe/{name}"] = row
        say(f"[6] probe {name} ({what}): {res['us_per_call']:.3f} us a call "
            f"in a CUDA graph of {PROBE_CALLS} launches, "
            f"{res['us_per_call_eager']:.3f} launched from Python; the loop "
            f"{res['cycles']['per_iter']:.2f} SM cycles an iteration "
            f"({trips} a call; the timing instance: "
            f"{span_text(res['cycles'])}); an empty cluster launch of the "
            f"same shape {floor['us_per_call']:.3f} us "
            f"({floor['us_per_call_eager']:.3f} from Python); plain "
            f"{p_ms * 1e3:.3f} us; bound {bound_ms * 1e3:.4f} us "
            f"({PROBE_BYTES} B / 3.35 TB/s), {bound_ms / k_ms * 100:.2f}% "
            f"of it; " + "; ".join(notes) + f"  [{card}]")
    # the SM clock the cycles ran at (clocks.sm just after them)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for row in extra.values():
        row["sm_clocks"] = clocks
    say(f"[6] probes: the SM clock just after their timings, and its "
        f"maximum (nvidia-smi clocks.sm, clocks.max.sm): {clocks}  [{card}]")
    return extra


# The whole-trace walk's constants swept on the clustered cells' passes
# (phase 6), each a build of the kernel with -D flags of the source's
# names: the split point (0: never split, 32: always), the ring (buffers x
# chunk) and the block (the flat gate, every cluster box without the
# hierarchy, lost 1.6-2.1x on every cell and left the source: PERF.md
# names the commit that builds it)
TRACE_SWEEP = {"split 0": ["-DSRT_TRACE_SPLIT_MAX=0"],
               "split 8": ["-DSRT_TRACE_SPLIT_MAX=8"],
               "split 16": ["-DSRT_TRACE_SPLIT_MAX=16"],
               "split 24": ["-DSRT_TRACE_SPLIT_MAX=24"],
               "ring 2x64": ["-DSRT_TRACE_CHUNK=64"],
               "ring 3x64": ["-DSRT_TRACE_STAGES=3",
                             "-DSRT_TRACE_CHUNK=64"],
               "ring 4x32": ["-DSRT_TRACE_STAGES=4",
                             "-DSRT_TRACE_CHUNK=32"],
               "ring 3x128": ["-DSRT_TRACE_STAGES=3"],
               "block 64": ["-DSRT_TRACE_BLOCK=64"],
               "block 256": ["-DSRT_TRACE_BLOCK=256"]}
# The path variants' constants (none, small) swept on the passes of
# configs 1, 2, 3 and 3/texture (phase 6): the block of persistent warps
# (small) and of one thread a ray (none), and the path indices a
# persistent warp fetches at once
PATH_SWEEP = {"path block 256": ["-DSRT_TRACE_PATH_BLOCK=256"],
              "ray block 128": ["-DSRT_TRACE_RAY_BLOCK=128"],
              "ray block 512": ["-DSRT_TRACE_RAY_BLOCK=512"],
              "fetch 64": ["-DSRT_TRACE_FETCH=64"]}
TRACE_SWEEP_KERNELS = {}


def trace_sweep_kernels(cases: dict) -> dict:
    """The sweeps' builds of the whole-trace kernel (every case of both
    sweeps, built at once on first use), those of ``cases`` by name."""
    if not TRACE_SWEEP_KERNELS:
        TRACE_SWEEP_KERNELS.update({
            name: bk.Kernel(tk.SOURCE, tk._bind, flags)
            for name, flags in {**TRACE_SWEEP, **PATH_SWEEP}.items()})
        build_all("the trace sweep's kernel builds",
                  TRACE_SWEEP_KERNELS.values())
    return {name: TRACE_SWEEP_KERNELS[name] for name in cases}


def trace_registers(kernel, variant: str) -> str:
    """ptxas's registers and spills of a build's variant (the route's
    instance, not the counting one)."""
    entry = f"trace_kernelILi{tk.TRI_MODES[variant]}ELb0E"
    out, on = [], False
    for line in kernel.build_log.splitlines():
        if "entry function" in line:
            on = entry in line
        elif on and ("registers" in line or "spill" in line):
            out.append(line.split("ptxas info    : ")[-1].strip())
    return "; ".join(out) or "no ptxas report"


def trace_sweep(label: str, prep, ref, iters: int) -> dict:
    """A cell's pass on each build of its variant's sweep (TRACE_SWEEP for
    the clustered walk, PATH_SWEEP for the path variants) and on the
    route's, in turns, twice: ms a pass; every output bit equal to the
    route's (no constant changes a result)."""
    walk = prep.variant == "clustered"
    builds = trace_sweep_kernels(TRACE_SWEEP if walk else PATH_SWEEP)
    route = (f"block {tk.WALK_BLOCK}, ring {tk.STAGES}x{tk.CHUNK}, split "
             f"{tk.SPLIT_MAX}, hierarchy" if walk else
             f"path block {tk.PATH_BLOCK}, ray block {tk.RAY_BLOCK}, fetch "
             f"{tk.FETCH}")
    ms = collections.defaultdict(list)
    out = torch.empty_like(ref)
    for _ in range(2):
        for name, kernel in {"route": tk.KERNEL, **builds}.items():
            with kernel_as(tk, kernel):
                try:
                    ms[name].append(float(np.median(cuda_ms(
                        lambda: tk.launch(prep, out), iters=iters,
                        repeats=3, warmup=1))))
                except RuntimeError as exc:     # the launch was refused
                    fail(f"cell {label}: the sweep's {name}: {exc}")
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                fail(f"cell {label}: the sweep's {name} changes a result")
    say(f"[6] cell {label} whole-trace sweep (ms a pass, two turns; the "
        f"route: {route}): "
        + ", ".join(f"{k}: {v[0]:.4f} / {v[1]:.4f}" for k, v in ms.items())
        + f"; results equal; ptxas of each build's {prep.variant} variant: "
        + ", ".join(f"{k}: {trace_registers(kernel, prep.variant)}"
                    for k, kernel in builds.items()))
    return dict(ms)


def as_mt(prep, clusters, table):
    """A recorded BVH launch in the MT form: the same rays, gates and
    variant; only the slot test differs."""
    _, _, *rest = prep.tensors
    return dataclasses.replace(
        with_params(prep, plucker=0),
        tensors=(bvh.staged_slots(clusters, table), None, *rest))


def form_report(recorded, clusters, table) -> tuple:
    """Each recorded Plucker launch replayed in the MT form on the card:
    (live rays whose winning slot changed, largest relative t difference
    over the live rays both forms hit, live rays).  A report, not a
    gate: the two forms round differently."""
    changed, rel, live_n = 0, 0.0, 0
    for prep, (t_p, s_p) in recorded:
        t_m, s_m = bk.launch(as_mt(prep, clusters, table))
        live = prep.rays[6] > 0
        live_n += int(live.sum())
        changed += int((s_p[live] != s_m[live]).sum())
        both = live & (s_p >= 0) & (s_m >= 0)
        if both.any():
            rel = max(rel, float(((t_p[both] - t_m[both]).abs()
                                  / t_m[both].abs()).max()))
    return changed, rel, live_n


def dense_replay(label: str, recorded, clusters, table) -> str:
    """A pass's first compacted launch replayed without compaction (every
    live ray walked), against the plain version: (t, slot) equal on every
    live ray."""
    for b, (prep, _) in enumerate(recorded):
        if prep.perm is None:
            continue
        dense = dataclasses.replace(
            with_params(prep, n_admission=0), perm=None, count=None,
            tensors=prep.tensors[:6] + (None,) + prep.tensors[7:])
        t_k, s_k = bk.launch(dense)
        o_, d_, alive, t_init = bvh_inputs(prep)
        t_p, s_p = bvh.intersect_triangles_bvh_plain(
            o_, d_, alive, t_init, clusters, table,
            "plucker" if prep.params.plucker else "mt")
        live = alive > 0
        if not (torch.equal(s_k[live], s_p[live])
                and torch.equal(t_k[live], t_p[live])):
            fail(f"cell {label}: a dense replay of a compacted launch "
                 "differs from the plain version")
        return (f"b{b} replayed dense ({int(live.sum())} live rays): "
                "(t, slot) equal to the plain version")
    return "no compacted launch"


def form_ab(preps, outs, clusters, table) -> tuple:
    """ms per pass of the recorded Plucker launches and of the same
    launches in the MT form, timed in turns (Plucker, MT, MT, Plucker,
    ...); each a list of batch medians."""
    alt = [as_mt(pp, clusters, table) for pp in preps]
    run = lambda ps: cuda_ms(lambda: [bk.launch(q, o)
                                      for q, o in zip(ps, outs)],
                             iters=3, repeats=1, warmup=1)[0]
    pl_ms, mt_ms = [], []
    for turn in ((preps, alt), (alt, preps)) * 2:
        for ps in turn:
            (pl_ms if ps is preps else mt_ms).append(run(ps))
    return pl_ms, mt_ms


def plucker_checks(label: str, recorded, clusters, table, card: str):
    """A Plucker cell's launches beyond the check against the plain
    version: every one took the form, the first compacted one replayed
    dense against the plain version, and each replayed in the MT form (a
    report)."""
    labels = {prep.label for prep, _ in recorded}
    if not all(prep.params.plucker for prep, _ in recorded):
        fail(f"cell {label}: launches {labels} outside the Plucker form")
    dense = dense_replay(label, recorded, clusters, table)
    changed, rel, live = form_report(recorded, clusters, table)
    say(f"[4] cell {label} ({', '.join(sorted(labels))}): {dense}; the same "
        f"launches in the MT form: {changed} of {live} live rays changed "
        f"winner, largest relative t difference {rel:.3e} (a report, not a "
        f"gate)  [{card}]")


# ragged triangle tables (rows not a multiple of the kernel's 256-row
# tile, none, one) and ray batches (live shares down to a few rays, which
# split the triangle range across blocks): (triangles, rays, live share)
RAGGED = ((1000, 3000, 0.6), (1, 77, 0.6), (0, 50, 0.6), (257, 513, 0.6),
          (20000, 100000, 0.005), (20000, 100000, 0.2))


def ragged_triangle_check(card: str) -> None:
    """The triangle kernel on seeded random tables and rays of RAGGED,
    with and without an alive mask, against the plain version: (t,
    index) equal on every ray."""
    g = np.random.default_rng(0)
    cases = 0
    for n_tris, n_rays, share in RAGGED:
        v0 = g.uniform(-3, 3, (n_tris, 3)).astype(np.float32)
        v1 = (v0 + g.normal(0, 0.8, (n_tris, 3))).astype(np.float32)
        v2 = (v0 + g.normal(0, 0.8, (n_tris, 3))).astype(np.float32)
        packed = torch.from_numpy(
            pack_triangles(v0, v1, v2, g.random(n_tris) < 0.9)).cuda()
        staged = stage_triangles(packed)
        o = torch.from_numpy(g.normal(0, 5, (n_rays, 3)).astype(np.float32))
        d = torch.from_numpy(g.normal(0, 1, (n_rays, 3)).astype(np.float32))
        o, d = o.cuda(), (d / d.norm(dim=1, keepdim=True)).cuda()
        o_, d_ = Vec3(*o.unbind(1)), Vec3(*d.unbind(1))
        alive = torch.from_numpy(g.random(n_rays) < share).cuda()
        for mask in (None, alive):
            t_p, i_p = intersect_packed_plain(o_, d_, packed, mask)
            t_k, i_k = trk.launch(trk.prepare(o_, d_, packed, mask, staged))
            if not (torch.equal(t_k, t_p) and torch.equal(i_k, i_p)):
                fail(f"the triangle kernel on a ragged table ({n_tris} "
                     f"triangles, {n_rays} rays, alive {mask is not None}) "
                     "differs from the plain version")
            cases += 1
    say(f"[4] triangle kernel on ragged tables {RAGGED} (triangles, rays, "
        f"live share), with and without an alive mask: {cases} cases, (t, "
        f"index) equal to the plain version on every ray  [{card}]")


def brute_force_cell(label: str, r: Renderer, camera, card: str) -> dict:
    """Phase 4 of a cell of the "pallas" or "jnp" route.  "pallas": every
    triangle launch of one pass (config 6: of a band of rows, the plain
    loop being dense over 81,920 triangles) against the plain version, and
    the canvas against a plain pass.  "jnp" (no kernel: the route is the
    plain loop itself): the canvas against the "pallas" route's on the same
    rays, which is the same function."""
    s = r.options.num_samples
    band, where = None, "the full pass"
    if label in BAND_CELLS:
        row0 = (r.options.height - BAND_ROWS) // 2
        band = (row0, BAND_ROWS)
        where = f"rows {row0}-{row0 + BAND_ROWS - 1} x {r.options.width}"
    k, rec = per_bounce_pass(r, camera, 4242, band=band)
    torch.cuda.synchronize()
    if label in DENSE:
        p, rec = per_bounce_pass(r, camera, 4242, tri_backend="pallas")
        what = f"the \"pallas\" route ({len(rec.tri)} triangle launches)"
        res = dict(n_rays=k.shape[1])
    else:
        max_abs, work, plain_s, lines = check_triangle_launches(label,
                                                                rec.tri)
        say(f"[4] cell {label} triangle kernel vs plain, every launch of one "
            f"pass on {where}: {'; '.join(lines)}; plain {plain_s:.2f} "
            f"s/pass  [{card}]")
        p, _ = per_bounce_pass(r, camera, 4242, plain=True, band=band)
        what = "the plain version"
        # phase 6 times the launches of a full pass
        full = rec.tri
        if band is not None:
            full = per_bounce_pass(r, camera, 4242)[1].tri
            work = [triangle_work(pp) for pp, _ in full]
        res = dict(max_abs=max_abs, work=work, plain_ms=plain_s * 1e3,
                   recorded=full, n_rays=full[0][0].params.n_rays,
                   where=where)
    torch.cuda.synchronize()
    rmse, share, same_bad = canvas_diff(k, p, s)
    fin = torch.isfinite(k)
    bitexact = bool(torch.equal(k[fin], p[fin])) and same_bad
    say(f"[4] cell {label} canvas on {where} vs {what}: rmse={rmse:.3e} "
        f"share>1e-3={share:.3e} bit-identical={bitexact} non-finite masks "
        f"agree={same_bad}  [{card}]")
    if not (rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
            and same_bad):
        fail(f"cell {label}: the canvas disagrees with {what}")
    return res


# phase 8, the command-line path: the steps of each run, the time seed,
# and the AOV runs' configs
CLI_STEPS = 4                  # config 2: saved, resumed, and in one run
CLI_MESH_STEPS = 2             # configs 3, 4, 5 and the AOVs
CLI_SEED = 7
AOV_CONFIGS = (2, 5, 6)
AOV_MODES = ("normals", "depth", "albedo")


class TraceRecorder:
    """Records every ``trace_full`` call of the block (render_pass imports
    it from its module at each pass): its arguments and per-ray radiance,
    (3, R)."""

    def __enter__(self):
        self.calls = []
        self.saved = tk.trace_full

        def rec(*args, **kw):
            out = self.saved(*args, **kw)
            self.calls.append((args, kw, torch.stack(list(out))))
            return out
        tk.trace_full = rec
        return self

    def __exit__(self, *exc):
        tk.trace_full = self.saved
        return False


def cli_run(argv: list) -> None:
    """One in-process run of the port's CLI on the card."""
    rc = cli.main(argv + ["--device", "cuda"])
    if rc != 0:
        fail(f"cli {' '.join(argv)}: exit {rc}")


def trace_band_check(label: str, args, kw, out) -> tuple:
    """A recorded whole-trace pass against its plain version on a band of
    BAND_ROWS full-width rows at the image's centre (aligned to the ray
    tile's rows, so that its rays are one slice of the pass's), under the
    rule of phase 4.  Returns (max |d|, the rows, the variant)."""
    th = kw["ray_tile"][0] if kw["ray_tile"] is not None else 1
    height, width, s = kw["height"], kw["width"], kw["num_samples"]
    row0 = (height - BAND_ROWS) // 2 // th * th
    base = {k: v for k, v in kw.items() if k != "tri_backend"}
    p = torch.stack(list(tk.trace_full_plain(
        *args, **dict(base, row0=row0, tile_height=BAND_ROWS))))
    k = out[:, row0 * width * s:(row0 + BAND_ROWS) * width * s]
    rmse, share, same_bad = canvas_diff(k, p, s)
    both = torch.isfinite(k) & torch.isfinite(p)
    err = (k - p).abs()[both]
    max_abs = float(err.max()) if err.numel() else 0.0
    variant = (whole_trace_variant(args[0], kw["tri_backend"])
               + ("" if args[0].skybox is None else "/texture"))
    if not (rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
            and same_bad):
        fail(f"cli {label} ({variant}): the whole-trace kernel disagrees "
             f"with its plain version on rows {row0}-{row0 + BAND_ROWS - 1}"
             f" (rmse {rmse:.3e}, share {share:.3e})")
    return max_abs, row0, variant


def cli_phase(card: str, scenes: dict, textures_dir: Path) -> tuple:
    """Phase 8: the port's CLI (cli.main, in process) on the card at each
    preset's own size, every kernel's counts reset just before and read
    just after its runs (and the refit's pass); then every whole-trace
    launch of those runs held to its plain version on a band, every BVH
    launch (the AOVs of configs 5 and 6) to its plain version and the AOV
    canvases to the plain BVH version's, and each AOV pass timed.
    Returns (the counts, and the largest whole-trace and BVH differences,
    each by variant)."""
    from PIL import Image
    t_phase = time.perf_counter()
    tmp = Path(textures_dir)
    seed = ["--time-seed", str(CLI_SEED)]
    mesh_steps = ["--steps", str(CLI_MESH_STEPS)]
    runs = {}                        # label -> (trace calls, BVH launches)
    hdr = tmp / "sky.hdr"            # make_textures' seeded 2048x1024 sky
    pos, nrm = organic_blob(subdivisions=3)
    save_obj(tmp / "blob.obj", pos, nrm)
    save_stl(tmp / "blob.stl", pos)
    scene5, camera5, _ = CONFIGS[5]()
    save_scene(tmp / "config5.json", scene5, camera5)

    def state(name):
        with np.load(tmp / name) as f:
            return f["canvas"], int(f["num_steps"])

    for kernel in KERNELS.values():
        kernel.reset_counts()
    t0 = time.perf_counter()
    c2 = ["--config", "2", "--steps", str(CLI_STEPS)] + seed
    plan = [
        ("2/png", c2 + ["--out", str(tmp / "a.png"), "--save-state",
                        str(tmp / "a.npz")]),
        ("2/ppm", c2 + ["--out", str(tmp / "a.ppm"), "--save-state",
                        str(tmp / "b.npz")]),
        ("2/resume", c2 + ["--out", str(tmp / "r.png"), "--load-state",
                           str(tmp / "a.npz"), "--save-state",
                           str(tmp / "r.npz")]),
        ("2/once", ["--config", "2", "--steps", str(2 * CLI_STEPS)] + seed
         + ["--out", str(tmp / "u.png"), "--save-state",
            str(tmp / "u.npz")]),
        ("2/warm", ["--config", "2", "--warm", "--out",
                    str(tmp / "never.png")]),
        ("3/skybox", ["--config", "3", "--skybox", str(hdr), "--out",
                      str(tmp / "sky.png")] + mesh_steps + seed),
        ("4/obj", ["--config", "4", "--mesh-path", str(tmp / "blob.obj"),
                   "--out", str(tmp / "obj.png")] + mesh_steps + seed),
        ("4/stl", ["--config", "4", "--mesh-path", str(tmp / "blob.stl"),
                   "--out", str(tmp / "stl.png")] + mesh_steps + seed),
        ("5/scene", ["--scene", str(tmp / "config5.json"), "--out",
                     str(tmp / "scene.png")] + mesh_steps + seed),
    ]
    plan += [(f"{n}/{aov}", ["--config", str(n), "--aov", aov, "--out",
                             str(tmp / f"aov{n}{aov}.png"), "--save-state",
                             str(tmp / f"aov{n}{aov}.npz")]
              + mesh_steps + seed)
             for n in AOV_CONFIGS for aov in AOV_MODES]
    seconds = {}
    for label, argv in plan:
        t1 = time.perf_counter()
        with TraceRecorder() as tr, Recorder() as rec:
            cli_run(argv)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t1
        runs[label] = (tr.calls, rec.bvh)
    # the refit: config 5, one model moved, refit=True, one pass
    scene, camera, options = CONFIGS[5]()
    r = Renderer(options, scene, device="cuda")
    before = r.device_scene.triangles.clusters
    scene.models[1].transform = transform_trs((1.1, 0.25, -2.6),
                                              (-math.pi / 6, 0.3, 0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r.update_scene(scene, refit=True)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t1
    with TraceRecorder() as tr:
        r.step(camera, time=CLI_SEED)
    torch.cuda.synchronize()
    runs["5/refit"] = (tr.calls, [])
    main_s = time.perf_counter() - t0
    got = {kind: dict(k.variant_launches) for kind, k in KERNELS.items()}

    want = {kind: {} for kind in KERNELS}
    # config 2: three runs of CLI_STEPS, one of twice that, --warm's pass
    want["trace"] = {"none": 5 * CLI_STEPS + 1,
                     "small/texture": CLI_MESH_STEPS,
                     "clustered": 3 * CLI_MESH_STEPS + 1}
    want["bvh"] = {"flat": len(AOV_MODES) * CLI_MESH_STEPS,
                   "two_level": len(AOV_MODES) * CLI_MESH_STEPS}
    say(f"[8] the CLI (cli.main, in process, --device cuda) at the "
        f"presets' sizes: {len(plan)} runs and a refit's pass in "
        f"{main_s:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
        + f"); launches {got} (want {want})  [{card}]")
    if got != want:
        fail(f"cli: launches {got}, want {want}")
    t_checks = time.perf_counter()

    # checkpoints: a resumed render equals one uninterrupted run
    a, na = state("a.npz")
    b, nb = state("b.npz")
    res_c, n_res = state("r.npz")
    once, n_once = state("u.npz")
    png = np.asarray(Image.open(tmp / "a.png"))
    ppm = load_ppm(tmp / "a.ppm")
    resumed_ok = (np.array_equal(res_c, once) and n_res == n_once
                  == 2 * CLI_STEPS)
    say(f"[8] config 2: {CLI_STEPS} steps to PNG and PPM (images equal: "
        f"{np.array_equal(png, ppm)}, canvases equal: "
        f"{np.array_equal(a, b)}, steps {na}, {nb}); resumed "
        f"{CLI_STEPS} more from the checkpoint against {2 * CLI_STEPS} in "
        f"one run (--time-seed {CLI_SEED}): canvas bit-identical="
        f"{np.array_equal(res_c, once)}, steps {n_res} and {n_once}; "
        f"--warm wrote nothing: {not (tmp / 'never.png').exists()}  "
        f"[{card}]")
    if not (resumed_ok and np.array_equal(png, ppm) and np.array_equal(a, b)
            and na == nb == CLI_STEPS and not (tmp / "never.png").exists()):
        fail("cli: config 2's checkpoints or images")
    for name in ("sky.png", "obj.png", "stl.png", "scene.png"):
        img = np.asarray(Image.open(tmp / name))
        if img.shape != png.shape or img.min() == img.max():
            fail(f"cli: {name} {img.shape}, min {img.min()} max {img.max()}")

    # every whole-trace pass of the runs against its plain version, the
    # largest |d| kept per variant
    trace_max = {}
    lines = []
    for label, (calls, _) in runs.items():
        for args, kw, out in calls:
            m, row0, variant = trace_band_check(label, args, kw, out)
            trace_max[variant] = max(trace_max.get(variant, 0.0), m)
        if calls:
            lines.append(f"{label} {len(calls)} x {variant}")
    say(f"[8] every whole-trace pass of the CLI runs and the refit vs its "
        f"plain version on rows {row0}-{row0 + BAND_ROWS - 1}: "
        f"{'; '.join(lines)}; all within the rule of phase 4 (rmse <= "
        f"{KERNEL_RMSE}, share <= {KERNEL_DIFF_SHARE}), max|d| by "
        f"variant {json.dumps(trace_max)}  [{card}]")

    # the refit: its topology kept, its boxes bound the moved model
    after = r.device_scene.triangles.clusters
    t2 = time.perf_counter()
    scene.build(r.device)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t2
    kept = (torch.equal(before.slots, after.slots)
            and before.k == after.k == scene._cluster_topo[1].k)
    say(f"[8] config 5 refit (models[1] moved): update_scene(refit=True) "
        f"{refit_s:.4f} s against a full build {rebuild_s:.4f} s (host "
        f"seconds, the upload included); K={after.k} and the slots kept: "
        f"{kept}; boxes changed: {not torch.equal(before.aabb, after.aabb)}"
        f"  [{card}]")
    if not kept or torch.equal(before.aabb, after.aabb):
        fail("cli: the refit changed the topology or kept the boxes")

    # the AOVs: every BVH launch against its plain version, the canvases
    # against the plain BVH version's, each pass timed
    bvh_max = {}
    aov_ms = {}
    for n in AOV_CONFIGS:
        ds, camera, options, _, _ = scenes[(n, None, None)]
        for aov in AOV_MODES:
            label = f"{n}/{aov}"
            canvas, steps = state(f"aov{n}{aov}.npz")
            _, recorded = runs[label]
            detail = "no BVH launch"
            if recorded:
                cl, table = ds.triangles.clusters, ds.triangles.table
                by_variant = {}
                for launch in recorded:
                    by_variant.setdefault(launch[0].label, []).append(launch)
                blines = []
                for v, launches in by_variant.items():
                    m, _, _, vlines, _ = check_bvh_launches(
                        f"cli {label}", launches, cl, table,
                        count_work=False)
                    bvh_max[v] = max(bvh_max.get(v, 0.0), m)
                    blines += vlines
                detail = "; ".join(blines)
            r = Renderer(dataclasses.replace(options, aov=aov),
                         device="cuda")
            r.set_device_scene(ds)
            with Recorder(plain=True):
                for i in range(steps):
                    r.step(camera, time=CLI_SEED + i)
            torch.cuda.synchronize()
            plain = r.canvas.cpu().numpy()
            to_rays = lambda c: torch.from_numpy(c / steps).reshape(-1, 3).T
            rmse, share, same_bad = canvas_diff(to_rays(canvas),
                                                to_rays(plain), 1)
            r.clear_canvas()
            ms = cuda_ms(lambda: r.step(camera), iters=5, repeats=3,
                         warmup=1)
            aov_ms[label] = float(np.median(ms))
            say(f"[8] AOV {aov} on config {n} {options.width}x"
                f"{options.height} spp={options.num_samples} "
                f"({CLI_MESH_STEPS} steps): {detail}; canvas vs the plain "
                f"BVH version rmse={rmse:.3e} share>1e-3={share:.3e} "
                f"bit-identical={np.array_equal(canvas, plain)}; a pass "
                f"{aov_ms[label]:.4f} ms ({spread(ms)})  [{card}]")
            if not (np.isfinite(canvas).all() and canvas.std() > 0
                    and rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
                    and same_bad):
                fail(f"cli: the {aov} AOV of config {n}")
    say(f"[8] the CLI phase: {time.perf_counter() - t_phase:.2f} s, of "
        f"which the checks and timings {time.perf_counter() - t_checks:.2f}"
        f" s  [{card}]")
    return got, trace_max, bvh_max


# phase 9, multi-device bands on the one card: the in-process cases
# (label, scene builder, band count), each PAR_STEPS progressive steps
# from PAR_TIME0, banded and on one device; then the CLI in PAR_PROCS
# processes on the card against one process, and the dry run
PAR_STEPS = 2
PAR_TIME0 = 11
PAR_CASES = (
    ("2 1920x1080", lambda: CONFIGS[2](width=1920, height=1080), 4),
    ("2", CONFIGS[2], 2), ("5", CONFIGS[5], 2), ("6", CONFIGS[6], 2),
    ("red_green", showcase.showcase_red_green, 2),
    ("spheres", showcase.showcase_spheres, 2),
    ("model", showcase.showcase_model, 2))
PAR_PROCS = 2
PAR_PROC_TIMEOUT = 120         # seconds each CLI process may take
PAR_BENCH_ITERS = 5            # steps timed, banded and single


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_counts() -> dict:
    return {kind: dict(k.variant_launches) for kind, k in KERNELS.items()}


def add_counts(into: dict, counts: dict) -> None:
    for kind, by_variant in counts.items():
        for v, c in by_variant.items():
            into[kind][v] = into[kind].get(v, 0) + c


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN patterns included."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def host_syncs(fn) -> collections.Counter:
    """The calls of ``fn`` that synchronise the host with the card
    (torch.cuda.set_sync_debug_mode), by the Python line that made them
    and the warning's first words."""
    import warnings
    # the mode's own first use may warn once; keep that out of the count
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(
        f"{Path(w.filename).name}:{w.lineno} "
        f"({' '.join(str(w.message).split()[:6])})" for w in caught)


def steps_seconds(r: Renderer, camera) -> float:
    """Seconds a step of ``r`` over PAR_BENCH_ITERS steps, by the host
    clock with the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_BENCH_ITERS):
        r.step(camera)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / PAR_BENCH_ITERS


def parallel_case(label: str, builder, n: int, card: str) -> dict:
    """One in-process case: the banded canvas over ["cuda:0"] * n against
    the single-device Renderer's on one device scene, bit for bit; the
    banded steps' launches (returned), a banded step's host syncs, the
    time of a step banded and single, and the banded benchmark_step."""
    t0 = time.perf_counter()
    scene, camera, options = builder()
    ds = scene.build("cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    single = Renderer(options, device="cuda")
    banded = Renderer(dataclasses.replace(options, all_devices=True),
                      device=["cuda:0"] * n)
    for r in (single, banded):
        r.set_device_scene(ds)
    times = [PAR_TIME0 + i for i in range(PAR_STEPS)]
    for t in times:
        single.step(camera, time=t)
    torch.cuda.synchronize()
    for kernel in KERNELS.values():
        kernel.reset_counts()
    t1 = time.perf_counter()
    for t in times:
        banded.step(camera, time=t)
    torch.cuda.synchronize()
    banded_s = time.perf_counter() - t1
    got = launch_counts()
    a, b = banded.canvas, single.canvas
    same = same_bits(a, b)
    both = torch.isfinite(a) & torch.isfinite(b)
    max_abs = float((a - b).abs()[both].max()) if bool(both.any()) else 0.0
    variant = whole_trace_variant(ds, options.tri_backend)
    per_step = 1 if variant is not None else options.num_bounces
    kind = "trace" if variant is not None else "bvh"
    want_n = n * PAR_STEPS * per_step
    launched = sum(got[kind].values())
    syncs = host_syncs(lambda: banded.step(camera, time=PAR_TIME0))
    step_ms = {name: steps_seconds(r, camera) * 1e3
               for name, r in (("banded", banded), ("single", single))}
    bench_ms = banded.benchmark_step(camera, iters=PAR_BENCH_ITERS,
                                     warmup=1)["seconds_per_step"] * 1e3
    say(f"[9] {label} {options.width}x{options.height} spp="
        f"{options.num_samples} b={options.num_bounces} in {n} bands over "
        f"cuda:0 (ray tile {banded.ray_tile}; one device {single.ray_tile}):"
        f" {PAR_STEPS} steps, canvas bit-identical to the single-device "
        f"Renderer's: {same}, max|d| {max_abs}; launches {got} "
        f"(want {want_n} {kind}); host syncs in a banded step "
        f"{sum(syncs.values())} {dict(syncs)}; a step banded "
        f"{step_ms['banded']:.4f} ms, single {step_ms['single']:.4f} ms "
        f"(host clock over {PAR_BENCH_ITERS} steps, the card synchronised "
        f"before and after), banded benchmark_step {bench_ms:.4f} ms; the "
        f"first {PAR_STEPS} banded steps {banded_s:.3f} s; build "
        f"{build_s:.3f} s. One card shows no scaling: the bands share it  "
        f"[{card}]")
    if not same:
        fail(f"parallel {label}: the banded canvas differs from the single-"
             f"device one (max|d| {max_abs})")
    if launched != want_n:
        fail(f"parallel {label}: {launched} {kind} launches, want {want_n}")
    return got


def parallel_cli(card: str, tmp: Path) -> None:
    """The CLI's config 2 in PAR_PROCS processes on the one card against
    the one-process CLI: rank 0's PNG and checkpoint bit for bit, no file
    from the others, every exit 0."""
    common = ["--config", "2", "--steps", "4", "--time-seed", "7"]
    cli_run(common + ["--out", str(tmp / "one.png"), "--save-state",
                      str(tmp / "one.npz")])
    port = free_port()
    env = dict(os.environ)
    env.pop("LOCAL_RANK", None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "simple_raytracer_tpu_torch.cli", *common,
         "--all-devices", "--distributed", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(PAR_PROCS),
         "--process-id", str(i), "--out", str(tmp / f"p{i}.png"),
         "--save-state", str(tmp / f"p{i}.npz")],
        cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(PAR_PROCS)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=PAR_PROC_TIMEOUT))
            except subprocess.TimeoutExpired:
                fail(f"parallel cli: a process ran past "
                     f"{PAR_PROC_TIMEOUT} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for i, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"parallel cli: process {i} exited {p.returncode}: "
                 f"{se[-2000:]}")
    from PIL import Image
    png_same = np.array_equal(np.asarray(Image.open(tmp / "p0.png")),
                              np.asarray(Image.open(tmp / "one.png")))
    with np.load(tmp / "p0.npz") as p0, np.load(tmp / "one.npz") as one:
        npz_same = (np.array_equal(p0["canvas"].view(np.int32),
                                   one["canvas"].view(np.int32))
                    and int(p0["num_steps"]) == int(one["num_steps"]))
    others = [f"p{i}.{ext}" for i in range(1, PAR_PROCS)
              for ext in ("png", "npz") if (tmp / f"p{i}.{ext}").exists()]
    bands = [line for _, se in outs for line in se.splitlines()
             if "band(s)" in line]
    say(f"[9] the CLI, config 2 --all-devices --distributed in {PAR_PROCS} "
        f"processes on cuda:0 (gloo over 127.0.0.1:{port}), each with a "
        f"timeout of {PAR_PROC_TIMEOUT} s: exits "
        f"{[p.returncode for p in procs]} in {wall:.2f} s; {bands}; rank "
        f"0's PNG equal to the one-process CLI's: {png_same}, its "
        f"checkpoint bit for bit: {npz_same}; files from the other ranks: "
        f"{others or 'none'}  [{card}]")
    if not (png_same and npz_same and not others):
        fail("parallel cli: the multi-process files")


def parallel_phase(card: str) -> dict:
    """Phase 9: the bands on the one card, in process and across
    processes, and the dry run.  Returns the banded launches."""
    t0 = time.perf_counter()
    totals = {kind: {} for kind in KERNELS}
    for label, builder, n in PAR_CASES:
        add_counts(totals, parallel_case(label, builder, n, card))
    build_dir = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        parallel_cli(card, Path(tmp))
    for kernel in KERNELS.values():
        kernel.reset_counts()
    dryrun_multichip(2)
    torch.cuda.synchronize()
    got = launch_counts()
    add_counts(totals, got)
    say(f"[9] dryrun_multichip(2) on cuda:0 twice: config 2 at 64x16, 1 "
        f"spp, 2 bounces, one step, the shape checked; launches {got}; the "
        f"phase {time.perf_counter() - t0:.2f} s; its launches {totals}  "
        f"[{card}]")
    return totals

# phase 10, editing and the viewer on the card.  The edit path: a
# RenderLoop (its thread not started) on configs 2 and 5 at their presets,
# each command through loop.handle_edit, then the loop's renderer cleared
# and stepped at VIEW_TIMES, against a fresh Renderer over a deep copy of
# the edited scene at the same seeds.  The live server: config 2 with the
# viewer's own defaults (VIEW_SAMPLES spp, VIEW_BOUNCES bounces, as
# `python -m simple_raytracer_tpu_torch.viewer --config 2` renders) at
# 960x540 and at the viewer's default 480x272, fps_limit=0, wall-clock
# seeds
VIEW_TIMES = (21, 22)
VIEW_CONFIGS = (2, 5)
VIEW_SAMPLES, VIEW_BOUNCES = 1, 6
VIEW_SIZES = ((960, 540), (480, 272))
VIEW_POLL_S = 3.0              # seconds of /state polling at 960x540
VIEW_RATE_S = 2.0              # seconds of frame counting at 480x272
VIEW_WAIT_S = 60.0             # the longest wait for the render thread
VIEW_SECONDS = 40.0            # the phase's budget


def view_canvas(r: Renderer, camera) -> torch.Tensor:
    """``r``'s canvas after a clear and a step at each of VIEW_TIMES."""
    r.clear_canvas()
    for t in VIEW_TIMES:
        r.step(camera, time=t)
    torch.cuda.synchronize()
    return r.canvas.clone()


def view_gate(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(passes, rmse, share of pixels more than 1e-3 apart, differing
    pixels, max |d|, same non-finite pixels) of two accumulated canvases
    over len(VIEW_TIMES) passes: the canvas rule of phase 4 (PERF.md
    section 2)."""
    a, b = a / len(VIEW_TIMES), b / len(VIEW_TIMES)
    fa, fb = torch.isfinite(a).all(-1), torch.isfinite(b).all(-1)
    same_bad = bool(torch.equal(fa, fb))
    ok = fa & fb
    d = (a - b).abs()[ok]
    rmse = float(d.pow(2).mean().sqrt()) if d.numel() else 0.0
    differ = int((d > 0).any(-1).sum())
    share = float((d > 1e-3).any(-1).float().mean()) if d.numel() else 0.0
    max_abs = float(d.max()) if d.numel() else 0.0
    passes = (rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
              and same_bad)
    return passes, rmse, share, differ, max_abs, same_bad


def wait_for(what: str, cond, loop=None, seconds: float = VIEW_WAIT_S):
    deadline = time.perf_counter() + seconds
    while not cond():
        if loop is not None and loop.error is not None:
            fail(f"viewer: {what}: the loop's error {loop.error!r}")
        if time.perf_counter() > deadline:
            fail(f"viewer: {what}: not within {seconds} s")
        time.sleep(0.01)


def view_commands(n: int, options) -> list:
    """The edit path's commands on config ``n``: (label, command)."""
    cmds = [
        ("add_sphere", {"op": "add_sphere", "position": [1.6, 0.4, -1.0],
                        "radius": 0.45}),
        ("update_material", {"op": "update_material", "index": 0,
                             "fields": {"emission": [1.0, 0.6, 0.3],
                                        "emission_strength": 1.5}}),
        ("set_sky", {"op": "set_sky", "fields": {
            "sun_intensity": 2.0, "sun_direction": [0.3, -1.0, 0.2],
            "zenith_color": [0.1, 0.2, 0.45]}}),
        ("duplicate_shape", {"op": "duplicate_shape", "kind": "sphere",
                             "index": 0}),
        ("remove_shape", {"op": "remove_shape", "kind": "sphere",
                          "index": 0}),
    ]
    if n == 5:
        cmds.append(("drag_shape", {"op": "drag_shape", "kind": "model",
                                    "index": 0, "mode": "translate",
                                    "dx": 0.04, "dy": -0.03}))
    cmds.append(("set_render", {"op": "set_render",
                                "samples": options.num_samples + 1}))
    return cmds


def view_edits(n: int, card: str) -> dict:
    """The edit path on config ``n`` (see VIEW_TIMES); returns its
    launches."""
    from simple_raytracer_tpu_torch.viewer import RenderLoop
    scene, camera, options = CONFIGS[n]()
    loop = RenderLoop(Renderer(options, scene, device="cuda"), camera,
                      scene=scene, fps_limit=0)
    lines = []
    totals = {kind: {} for kind in KERNELS}
    for label, cmd in view_commands(n, options):
        for kernel in KERNELS.values():
            kernel.reset_counts()
        out = loop.handle_edit(cmd)
        if not out.get("ok"):
            fail(f"viewer edit {label} on config {n}: {out}")
        if label == "set_render":
            want = cmd["samples"]
            wait_for("the set_render swap", lambda: (
                loop._pending_opts is None
                and loop.renderer.options.num_samples == want), loop)
        r = loop.renderer
        extra = ""
        if label == "drag_shape":
            # the refit (A), then the settle rebuild (B)
            a = view_canvas(r, camera)
            r.update_scene(loop.scene)
            got = view_canvas(r, camera)
            ok, rmse, share, differ, max_abs, same_bad = view_gate(a, got)
            extra = (f"; the refit's canvas against the rebuilt one: max|d| "
                     f"{max_abs}, {differ} pixels differ, rmse {rmse:.3e}, "
                     f"share > 1e-3 {share:.2e}, same non-finite "
                     f"{same_bad}")
            if not ok:
                fail(f"viewer config {n}: the refit's canvas is outside "
                     f"the canvas rule against the rebuild{extra}")
        else:
            got = view_canvas(r, camera)
        fresh = Renderer(r.options, copy.deepcopy(loop.scene), device="cuda")
        want = view_canvas(fresh, camera)
        same = same_bits(got, want)
        both = torch.isfinite(got) & torch.isfinite(want)
        max_abs = (float((got - want).abs()[both].max())
                   if bool(both.any()) else 0.0)
        got_counts = launch_counts()
        add_counts(totals, got_counts)
        lines.append(f"{label} {out.get('changed')}: bit-identical {same}, "
                     f"max|d| {max_abs}; launches {got_counts}{extra}")
        if not same:
            fail(f"viewer config {n} after {label}: the loop's canvas "
                 f"differs from a fresh renderer's (max|d| {max_abs})")
    o = loop.renderer.options
    say(f"[10] edits on config {n} {o.width}x{o.height} (RenderLoop."
        f"handle_edit, then {len(VIEW_TIMES)} steps at time seeds "
        f"{VIEW_TIMES} against a fresh Renderer over a deep copy of the "
        f"edited scene): " + "; ".join(lines) + f"  [{card}]")
    return totals


def project(loop, point) -> tuple:
    """The pixel (x, y) whose centre ray (RenderLoop._pixel_ray) passes
    through the world ``point``."""
    cam, o = loop.camera, loop.renderer.options
    cy, sy = math.cos(cam.yaw), math.sin(cam.yaw)
    cp, sp = math.cos(cam.pitch), math.sin(cam.pitch)
    rel = np.asarray(point, np.float64) - np.asarray(cam.position)
    px = rel @ np.array([cy, 0.0, -sy])
    py = rel @ np.array([sy * sp, cp, cy * sp])
    pz = rel @ np.array([-sy * cp, sp, -cy * cp])
    fs, aspect = math.tan(cam.fov / 2.0), o.width / o.height
    return ((px / pz / (fs * aspect) + 1.0) / 2.0 * o.width - 0.5,
            (1.0 - py / pz / fs) / 2.0 * o.height - 0.5)


@contextlib.contextmanager
def live_viewer(width: int, height: int, shot: Path):
    """The viewer as serve() starts it, on config 2 on the card: the first
    step and image() on this thread, then the loop and the HTTP server on
    127.0.0.1 at a free port; yields (loop, get, post) and stops both."""
    from http.server import ThreadingHTTPServer
    import threading
    import urllib.request
    from simple_raytracer_tpu_torch.viewer import RenderLoop, make_handler
    scene, camera, _ = CONFIGS[2]()
    options = RenderOptions(width=width, height=height,
                            num_samples=VIEW_SAMPLES,
                            num_bounces=VIEW_BOUNCES)
    r = Renderer(options, scene=scene, device="cuda")
    r.step(camera)
    r.image()
    r.clear_canvas()
    loop = RenderLoop(r, camera, fps_limit=0, screenshot_path=str(shot),
                      scene=scene)
    loop.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              make_handler(loop, width, height))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=10) as resp:
            return resp.status, resp.read()

    def post(path, payload):
        req = urllib.request.Request(url + path, method="POST",
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())

    try:
        yield loop, get, post
    finally:
        srv.shutdown()
        srv.server_close()
        loop.stop()
        thread.join(timeout=5)
        if loop._thread.is_alive():
            fail("viewer: the render thread did not stop")


def view_state(get, loop) -> dict:
    _, body = get("/state")
    state = json.loads(body)
    if state["error"] is not None:
        fail(f"viewer: /state reports {state['error']}")
    return state


def frame_parts(loop) -> str:
    parts = {k: t.avg * 1e3 for k, t in loop.part_timers.items()}
    return (f"step {parts['step']:.3f} ms (its launches), image() "
            f"{parts['image']:.3f} ms (the wait for the pass, the tonemap, "
            f"the copy), PNG encode {parts['encode']:.3f} ms (means over "
            f"the last {len(loop.timer.times)} frames)")


def view_live(card: str, tmp: Path) -> None:
    """The live server at 960x540 (frames, reset, pick, drag, screenshot,
    a set_render swap while the loop runs), then 480x272 for the rate."""
    from PIL import Image
    w, h = VIEW_SIZES[0]
    shot = tmp / "shot.ppm"
    with live_viewer(w, h, shot) as (loop, get, post):
        status, png = None, b""
        deadline = time.perf_counter() + VIEW_WAIT_S
        while status != 200:
            try:
                status, png = get("/frame.png")
            except urllib.error.HTTPError:
                if time.perf_counter() > deadline:
                    fail("viewer: no frame")
                time.sleep(0.01)
        size = Image.open(io.BytesIO(png)).size
        if size != (w, h):
            fail(f"viewer: /frame.png is {size}")
        first = view_state(get, loop)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < VIEW_POLL_S:
            state = view_state(get, loop)
            time.sleep(0.1)
        rate = (state["frame"] - first["frame"]) / (time.perf_counter() - t0)
        say(f"[10] live viewer, config 2 {w}x{h} {VIEW_SAMPLES} spp "
            f"{VIEW_BOUNCES} bounces, fps_limit 0, wall-clock seeds: "
            f"/frame.png {size}; {rate:.2f} frames/s over {VIEW_POLL_S} s "
            f"of /state ({state['frame'] - first['frame']} frames); "
            f"FrameTimer {state['ms']:.3f} ms/frame (step + image()), "
            f"{state['fps']:.2f} fps; {frame_parts(loop)}  [{card}]")
        resets = loop.reset_count
        post("/input", {"keys": ["w"], "dx": 0, "dy": 0, "wheel": 0,
                        "dt": 0.1})
        wait_for("a reset after input", lambda: loop.reset_count > resets,
                 loop)
        x, y = project(loop, loop.scene.spheres[1].position)
        hit = post("/pick", {"x": x, "y": y})
        if hit.get("shape") != {"kind": "sphere", "index": 1}:
            fail(f"viewer: /pick at sphere 1's centre ({x:.1f}, {y:.1f}) "
                 f"gave {hit}")
        pos0 = loop.scene.spheres[1].position
        out = post("/edit", {"op": "drag_shape", "kind": "sphere",
                             "index": 1, "dx": 0.02, "dy": 0.0})
        if not out.get("ok") or loop.scene.spheres[1].position == pos0:
            fail(f"viewer: drag_shape gave {out}")
        key = {"dx": 0, "dy": 0, "wheel": 0, "dt": 0.03}
        post("/input", dict(key, keys=["p"]))
        post("/input", dict(key, keys=[]))
        wait_for("the screenshot", lambda: loop.screenshot_count >= 1, loop)
        if load_ppm(shot).shape != (h, w, 3):
            fail(f"viewer: the screenshot is {load_ppm(shot).shape}")
        # a second renderer while the loop runs
        frames = view_state(get, loop)["frame"]
        out = post("/edit", {"op": "set_render", "samples": 2})
        if not (out.get("ok") and out.get("compiling")):
            fail(f"viewer: set_render gave {out}")
        wait_for("the live set_render swap", lambda: (
            loop._pending_opts is None
            and loop.renderer.options.num_samples == 2), loop)
        swapped = view_state(get, loop)["frame"]
        wait_for("frames after the swap",
                 lambda: view_state(get, loop)["frame"] > swapped + 2, loop)
        end = view_state(get, loop)
        say(f"[10] live viewer {w}x{h}: /input w reset {resets} -> "
            f"{loop.reset_count}; /pick at ({x:.1f}, {y:.1f}) {hit}; "
            f"drag_shape moved sphere 1 {pos0} -> "
            f"{loop.scene.spheres[1].position}; p wrote a "
            f"{load_ppm(shot).shape} PPM; set_render samples=2 swapped in "
            f"while the loop ran (frame {frames} at the request, {swapped} "
            f"at the swap, {end['frame']} after); error null throughout  "
            f"[{card}]")
    w, h = VIEW_SIZES[1]
    with live_viewer(w, h, shot) as (loop, get, post):
        first = view_state(get, loop)
        t0 = time.perf_counter()
        time.sleep(VIEW_RATE_S)
        state = view_state(get, loop)
        rate = (state["frame"] - first["frame"]) / (time.perf_counter() - t0)
        say(f"[10] live viewer, config 2 {w}x{h} {VIEW_SAMPLES} spp "
            f"{VIEW_BOUNCES} bounces, fps_limit 0: {rate:.2f} frames/s over "
            f"{VIEW_RATE_S} s; FrameTimer {state['ms']:.3f} ms/frame; "
            f"{frame_parts(loop)}  [{card}]")


def viewer_phase(card: str) -> dict:
    """Phase 10: the edit path and the live viewer on the card.  Returns
    the phase's launches."""
    t0 = time.perf_counter()
    totals = {kind: {} for kind in KERNELS}
    for n in VIEW_CONFIGS:
        add_counts(totals, view_edits(n, card))
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    for kernel in KERNELS.values():
        kernel.reset_counts()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        view_live(card, Path(tmp))
    add_counts(totals, launch_counts())
    seconds = time.perf_counter() - t0
    say(f"[10] the viewer phase: {seconds:.2f} s (budget {VIEW_SECONDS} s)"
        f"; its launches {totals}  [{card}]")
    if seconds > VIEW_SECONDS:
        fail(f"viewer: the phase took {seconds:.1f} s")
    return totals


# ---- 11: the JAX package's opt-in switches ----

# each switch set for one pass of configs 6 and 7 under "auto" and "fused";
# name -> (variable, value).  "packed 700" sends config 6's table to
# streamed (768 clusters above the limit) and "mega 700" config 6 under
# "fused" out of the whole-trace kernel into the fused per-bounce path
SWITCH_CELLS = ("6", "6/fused", "7", "7/fused")
SWITCHES = {"morton": ("SRT_BVH_COMPACT_KEY", "morton"),
            "rev": ("SRT_BVH_ORDER", "rev"),
            "compact 0": ("SRT_BVH_COMPACT", "0"),
            "compact 1": ("SRT_BVH_COMPACT", "1"),
            "ring 4": ("SRT_BVH_DMA_SLOTS", "4"),
            "ring 8": ("SRT_BVH_DMA_SLOTS", "8"),
            "packed 700": ("SRT_BVH_PACKED_VMEM_MAX", "700"),
            "mega 700": ("SRT_MEGA_PACKED_MAX", "700"),
            "slices 3": ("SRT_MEGA_MT_SLICES", "3")}
# the switches the port reads once, at import: the module constant each
# sets, which the phase sets as an import under the variable would
IMPORT_KNOBS = {"SRT_BVH_PACKED_VMEM_MAX": (bvh, "PACKED_VMEM_MAX_CLUSTERS"),
                "SRT_MEGA_PACKED_MAX": (tst, "MEGA_PACKED_MAX_CLUSTERS"),
                "SRT_MEGA_MT_SLICES": (tk, "MEGA_MT_SLICES")}
# the ring builds of the switches (SRT_BVH_DMA_SLOTS), each a row of the
# kernels line, timed on cell 7
RING_ROWS = {"ring 4": ("bvh_streamed_ring4", 4),
             "ring 8": ("bvh_streamed_ring8", 8)}
SWITCH_SEED = 4343
# passes timed a turn: one of the split path's host-bound passes (about
# 100 ms), more of the fused paths'
SWITCH_PASS_ITERS = {"6/fused": 5, "7/fused": 2}


@contextlib.contextmanager
def switch(name: str):
    """Switch ``name`` of SWITCHES set while the body runs: its variable,
    and for one the port reads at import the module's constant as an
    import under it would set it; both restored after."""
    var, value = SWITCHES[name]
    with knob(var, value):
        if var not in IMPORT_KNOBS:
            yield
            return
        mod, const = IMPORT_KNOBS[var]
        saved = getattr(mod, const)
        setattr(mod, const, int(value))
        try:
            yield
        finally:
            setattr(mod, const, saved)


def route_pass(r: Renderer, camera, time_seed: int) -> tuple:
    """One pass's per-ray radiance (3, R) by render_pass's route for the
    cell's scene and backend (the whole-trace kernel, else
    trace_per_bounce: the fused or the split path), and the Recorder of
    its BVH and shade launches."""
    o = r.options
    if trace_mod.takes_whole_trace(r.device_scene, o.tri_backend):
        args, kw = trace_args(r, camera, time_seed)
        with Recorder() as rec:
            color = tk.trace_full(*args, **kw, tri_backend=o.tri_backend)
        return torch.stack(list(color)), rec
    return per_bounce_pass(r, camera, time_seed)


def in_turns(base, other, iters: int = 1) -> tuple:
    """ms a call of two callables, in turns (base, other, other, base),
    ``iters`` calls a turn after one unmeasured call of each: (base's two,
    other's two)."""
    base()
    other()
    t = [cuda_ms(fn, iters=iters, repeats=1, warmup=0)[0]
         for fn in (base, other, other, base)]
    return [t[0], t[3]], [t[1], t[2]]


def sort_rays_replay(label: str, recorded, clusters, table) -> str:
    """The recorded dense streamed launches of a pass replayed through the
    wrapper with sort_rays=True (the rays permuted by the first super they
    may meet, the results scattered back): (t, slot) equal to the launch's
    on every ray, and both timed in turns."""
    dense = [(pp, oo) for pp, oo in recorded
             if pp.perm is None and pp.variant == "streamed"]
    if not dense:
        fail(f"cell {label}: no dense streamed launch to sort")

    def sorted_launches():
        out = []
        for pp, _ in dense:
            o_, d_, alive, t_init = bvh_inputs(pp)
            out.append(bk.intersect_triangles_bvh(
                o_, d_, alive, t_init, clusters, table, force_streamed=True,
                sort_rays=True))
        return out

    for (pp, (t_k, s_k)), (t_s, s_s) in zip(dense, sorted_launches()):
        if not (torch.equal(t_s, t_k) and torch.equal(s_s, s_k)):
            fail(f"cell {label}: a launch under sort_rays differs from the "
                 "unsorted launch")
    base, other = in_turns(
        lambda: [bk.launch(pp, oo) for pp, oo in dense], sorted_launches)
    return (f"its {len(dense)} dense streamed launches replayed with "
            f"sort_rays=True: (t, slot) equal on every ray; "
            f"{other[0]:.4f}, {other[1]:.4f} against unsorted {base[0]:.4f}"
            f", {base[1]:.4f} ms a pass in turns (sorted / unsorted "
            f"{sum(other) / sum(base):.3f}; the sort, gathers and scatters "
            "included)")


def switch_phase(card: str, renderers: dict) -> tuple:
    """Phase 11: each switch of SWITCHES set for one pass of each of
    SWITCH_CELLS at its preset size, every kernel's counts reset just
    before the pass and read just after: the per-ray radiance bit for bit
    the switch-free pass's (that of cell 6 where "mega 700" sends
    6/fused to the fused path), every BVH launch's (t, slot) on live rays
    the switch-free launch's and the plain version's, every compacted
    launch's order compact_order's under its key (the whole order under
    "morton"), and the route the switch asks for; the pass and its BVH
    launches timed in turns with the switch-free ones; under "compact 0"
    cell 7's dense launches replayed with sort_rays=True.  Returns the
    kernels line's rows of the ring builds and the launches counted."""
    rings = {name: bk.ring_kernel(depth)
             for name, (_, depth) in RING_ROWS.items()}
    kernels = dict(KERNELS, **{RING_ROWS[n][0]: k for n, k in rings.items()})
    ref = {label: route_pass(*renderers[label], SWITCH_SEED)
           for label in SWITCH_CELLS}
    torch.cuda.synchronize()
    rows, launches = {}, collections.Counter()
    for label in SWITCH_CELLS:
        r, camera = renderers[label]
        tris = r.device_scene.triangles
        cl, table = tris.clusters, tris.table
        for name in SWITCHES:
            var, value = SWITCHES[name]
            for k in kernels.values():
                k.reset_counts()
            with switch(name):
                k_rad, rec = route_pass(r, camera, SWITCH_SEED)
                torch.cuda.synchronize()
                got = {kind: dict(k.variant_launches)
                       for kind, k in kernels.items() if k.launches}
                for kind, k in kernels.items():
                    launches[kind] += k.launches
                base = "6" if (label, name) == ("6/fused", "mega 700") else label
                b_rad, b_rec = ref[base]
                fin = torch.isfinite(k_rad)
                if not (torch.equal(fin, torch.isfinite(b_rad))
                        and torch.equal(k_rad[fin], b_rad[fin])):
                    fail(f"cell {label} under {var}={value}: the radiance "
                         f"differs from the switch-free pass of cell {base}")
                if len(rec.bvh) != len(b_rec.bvh):
                    fail(f"cell {label} under {var}={value}: "
                         f"{len(rec.bvh)} BVH launches, switch-free "
                         f"{len(b_rec.bvh)}")
                for b, ((pp, (t_k, s_k)), (_, (t_b, s_b))) in enumerate(
                        zip(rec.bvh, b_rec.bvh)):
                    live = pp.rays[6] > 0
                    if not (torch.equal(t_k[live], t_b[live])
                            and torch.equal(s_k[live], s_b[live])):
                        fail(f"cell {label} under {var}={value} bounce {b}:"
                             " (t, slot) differ from the switch-free launch")
                want = {"compact 0": lambda pp: pp.perm is None,
                        "compact 1": lambda pp: pp.perm is not None,
                        "morton": lambda pp: (pp.perm is None
                                              or pp.options.morton == 1),
                        "rev": lambda pp: pp.options.reverse == 1,
                        # configs 6 and 7 both hold more than 700
                        "packed 700": lambda pp: pp.variant == "streamed",
                        }.get(name, lambda pp: True)
                if not all(want(pp) for pp, _ in rec.bvh):
                    fail(f"cell {label} under {var}={value}: a launch "
                         "without the switch's form")
                if name in RING_ROWS and any(
                        pp.variant == "streamed" for pp, _ in rec.bvh) \
                        and not rings[name].launches:
                    fail(f"cell {label} under {var}={value}: the ring "
                         "build was never launched")
                if (label, name) == ("6/fused", "mega 700") and not rec.bvh:
                    fail("mega 700 left config 6 under fused in the "
                         "whole-trace kernel")
                note = ""
                if rec.bvh:
                    ring_row = name in RING_ROWS and label == "7"
                    max_abs, work, plain_s, _, _ = check_bvh_launches(
                        f"{label} under {var}={value}", rec.bvh, cl, table,
                        count_work=ring_row)
                    note = (f"; {len(rec.bvh)} BVH launches: (t, slot) the "
                            f"switch-free launches' and the plain "
                            f"version's on live rays (max |dt| {max_abs:.3e})"
                            + ("; every compacted order compact_order's"
                               if any(pp.perm is not None
                                      for pp, _ in rec.bvh) else ""))

            def switched():
                with switch(name):
                    route_pass(r, camera, SWITCH_SEED)

            # the cell's switch-free pass with every switch unset, in turns
            pass_b, pass_s = in_turns(
                lambda: route_pass(r, camera, SWITCH_SEED), switched,
                iters=SWITCH_PASS_ITERS.get(label, 1))
            times = (f"; the pass {pass_s[0]:.4f}, {pass_s[1]:.4f} ms "
                     f"against the switch-free {pass_b[0]:.4f}, "
                     f"{pass_b[1]:.4f} ms in turns (switch / switch-free "
                     f"{sum(pass_s) / sum(pass_b):.3f})")
            if rec.bvh and b_rec.bvh:
                # a recorded launch keeps its form (options, ring build)
                run = lambda recs: lambda: [bk.launch(pp, oo)
                                            for pp, oo in recs]
                bvh_b, bvh_s = in_turns(run(b_rec.bvh), run(rec.bvh),
                                        iters=5)
                times += (f"; its BVH launches {bvh_s[0]:.4f}, "
                          f"{bvh_s[1]:.4f} ms a pass against the "
                          f"switch-free launches' {bvh_b[0]:.4f}, "
                          f"{bvh_b[1]:.4f} ms"
                          + ("" if base == label else f" (cell {base}'s)")
                          + f" ({sum(bvh_s) / sum(bvh_b):.3f})")
                if name in RING_ROWS and label == "7":
                    flops, nbytes, _ = bvh_bound(cl, work)
                    t_ops = flops / FP32_PEAK * 1e3
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    rows[name] = dict(
                        ms=sum(bvh_s) / 2, plain_ms=plain_s * 1e3,
                        max_abs=max_abs, bound_ms=max(t_ops, t_bytes),
                        bound_by=("operations" if t_ops >= t_bytes
                                  else "bytes"))
            if name == "compact 0" and label == "7":
                times += "; " + sort_rays_replay(label, rec.bvh, cl, table)
            say(f"[11] cell {label} under {var}={value}: launches {got}; "
                f"radiance bit-identical to the switch-free pass"
                + ("" if base == label else f" of cell {base}")
                + f"{note}{times}  [{card}]")
    for name, (row, _) in RING_ROWS.items():
        if name not in rows or not launches[row]:
            fail(f"{row}: no launch on config 7")
        rows[name]["launches"] = launches[row]
    return rows, dict(launches)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--parent", type=Path, default=None,
        help="a checkout of an earlier commit of this repository, from "
             "e9ce31e on: its BVH kernel (simple_raytracer_tpu_torch/csrc/"
             "bvh_kernel.cu, this C interface or the one before "
             "BvhOptions), its whole-trace kernel (trace_kernel.cu), "
             "its shade kernel (bounce_kernel.cu) and its probe kernel "
             "(probe_kernel.cu), each with this C interface, are built "
             "beside this one's, and phase 6 times every "
             "BVH launch, the pass of every whole-trace cell, 7/fused's "
             "shade launches and the probes on them too, in turns")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    card = card_line()
    pil = importlib.util.find_spec("PIL") is not None
    say(f"[1] card: {card}; PIL (the 8-bit skybox loader's) installed: "
        f"{pil}")

    t0 = time.perf_counter()
    parent = parent_trace = parent_shade = parent_probe = None
    if args.parent is not None:
        parent = parent_bvh_kernel(args.parent)
        parent_trace = parent_trace_kernel(args.parent)
        parent_shade = parent_shade_kernel(args.parent)
        parent_probe = parent_probe_kernel(args.parent)
    sass_job = None
    if parent is not None:
        # the walk's SASS of both BVH sources, built beside the kernels
        sass_job = concurrent.futures.ThreadPoolExecutor(1).submit(
            walk_sass, (bk.KERNEL, parent))
    # the ring builds of phase 11 (SRT_BVH_DMA_SLOTS), built beside these
    rings = tuple(bk.ring_kernel(depth) for _, depth in RING_ROWS.values())
    ptxas = build_kernels(rings + (() if parent is None else
                                   (parent, parent_trace, parent_shade,
                                    parent_probe)))
    say(f"[2] build: {time.perf_counter() - t0:.2f} s for the five kernel "
        "sources "
        f"(nvcc sm_90a, ctypes; "
        + ", ".join(f"{SOURCES[kind]} {k.build_seconds:.2f} s"
                    for kind, k in KERNELS.items())
        + "; the ring builds " + ", ".join(
            f"{k.tag} {k.build_seconds:.2f} s" for k in rings)
        + ("" if parent is None else
           f"; the parent's {parent.source} {parent.build_seconds:.2f} s, "
           f"{parent_trace.source} {parent_trace.build_seconds:.2f} s, "
           f"{parent_shade.source} {parent_shade.build_seconds:.2f} s, "
           f"{parent_probe.source} {parent_probe.build_seconds:.2f} s")
        + f"); the host library {accel.HOST.source.name} "
        f"{accel.HOST.build_seconds:.2f} s ({accel.HOST.compiler()} "
        f"{' '.join(accel.HOST.flags)}; the BVH build, the STL parse)"
        + f"; ptxas: {ptxas}")
    if parent is not None:
        regs, regs_p = walk_ptxas(bk.KERNEL), walk_ptxas(parent)
        sass, sass_p = sass_job.result()
        say(f"[2] the BVH walk's instances, this build / the parent's: "
            + ", ".join(
                f"{k} {registers(v)} / "
                f"{registers(regs_p[k]) if k in regs_p else None} registers, "
                f"{len(sass.get(k, ()))} / {len(sass_p.get(k, ()))} "
                f"instructions"
                + (", the same SASS" if sass.get(k) == sass_p.get(k)
                   else "")
                for k, v in sorted(regs.items()))
            + " (ptxas, cuobjdump)")
    say(f"[2] triangle kernel {trk.SHAPE[0]}x{trk.SHAPE[1]}, the fast path "
        f"of one triangle (cuobjdump): {triangle_sass()}")
    say(f"[2] whole-trace kernel (cuobjdump): {trace_sass()}")

    # ---- 3: the main paths, each cell's counts reset just before it ----
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        textures = make_textures(Path(tmp))
    say(f"[3] textures {TEXTURE_SHAPE[1]}x{TEXTURE_SHAPE[0]} from seed "
        f"{TEXTURE_SEED}: rgbe through save_hdr/load_skybox, ldr (u8/255)^2.2"
        f"; {time.perf_counter() - t0:.3f} s")
    scenes, renderers = {}, {}
    for label in CELLS:
        n, backend, _, sky = CELLS[label]
        k_forced = CLUSTER_SIZES.get(label)
        key = (n, sky, k_forced) + ((SUBBOX[label],) if label in SUBBOX
                                    else ())
        if key not in scenes:
            # one scene build per config, environment, cluster size and
            # sub-box gate (the table is built only under the knob),
            # shared by cells
            t0 = time.perf_counter()
            kw = dict(KWARGS.get(n, {}))
            if sky is not None and n == 3:
                kw["skybox"] = textures[sky]     # config 3's own argument
            scene, camera, options = CONFIGS[n](**kw)
            if sky is not None:
                scene.skybox = textures[sky]
            scene.cluster_size = k_forced
            t1 = time.perf_counter()
            with form_env(label):
                ds = scene.build("cuda")
            torch.cuda.synchronize()
            scenes[key] = (ds, camera, options, t1 - t0,
                           time.perf_counter() - t1)
            tris = ds.triangles
            say(f"[3] config {n}{'' if sky is None else ' with ' + sky}"
                + ("" if k_forced is None else f", cluster_size={k_forced}")
                + ("" if label not in SUBBOX else
                   f", SRT_BVH_SUBBOX={SUBBOX[label]} (sub-box table "
                   f"{tuple(tris.clusters.sub_aabb.shape)})")
                + f": preset {t1 - t0:.3f} s (its procedural mesh), build "
                f"{scenes[key][4]:.3f} s (the host library's SAH BVH, "
                "clusters, tables, upload): "
                f"{int(tris.active.sum())} triangles"
                + (f", {tris.clusters.slots.shape[0]} clusters of "
                   f"{tris.clusters.k} ({tris.clusters.slots.numel()} slots"
                   f", {tris.table.numel() * 4 / 1e6:.1f} MB table)"
                   if tris.clusters is not None else "")
                + ("" if ds.skybox is None else
                   f"; texture {tuple(ds.skybox.shape)} on {ds.skybox.device}"))
        ds, camera, options, _, _ = scenes[key]
        r = Renderer(dataclasses.replace(options, tri_backend=backend),
                     device="cuda")
        r.set_device_scene(ds)
        renderers[label] = (r, camera)
    totals = {}
    for label, (r, camera) in in_form(renderers):
        want_variant = CELLS[label][2]
        o = r.options
        cl = r.device_scene.triangles.clusters
        if FORMS.get(label) == "plucker" and cl.plucker is None:
            # the coefficient table, built once per scene on first use
            t0 = time.perf_counter()
            coeffs = bvh.plucker_coefficients(cl, r.device_scene.triangles
                                              .table)
            torch.cuda.synchronize()
            say(f"[3] cell {label}: the Plucker coefficient table "
                f"{tuple(coeffs.shape)} ({coeffs.numel() * 4 / 1e6:.1f} MB) "
                f"built in {time.perf_counter() - t0:.4f} s  [{card}]")
        tris = r.device_scene.triangles
        if (label in SPLIT + FUSED and FORMS.get(label) != "plucker"
                and cl.staged is None):
            # the warp walk's staged MT table, built once per scene on the
            # first BVH launch in the MT form
            t0 = time.perf_counter()
            staged = bvh.staged_slots(cl, tris.table)
            torch.cuda.synchronize()
            say(f"[3] cell {label}: the BVH kernel's staged MT table "
                f"{tuple(staged.shape)} ({staged.numel() * 4 / 1e6:.1f} MB) "
                f"built in {time.perf_counter() - t0:.4f} s  [{card}]")
        if label in PALLAS and tris.staged is None:
            # the triangle kernel's staged table, built once per scene on
            # its first launch
            t0 = time.perf_counter()
            staged = staged_table(tris)
            torch.cuda.synchronize()
            say(f"[3] cell {label}: the triangle kernel's staged table "
                f"{tuple(staged.shape)} ({staged.numel() * 4 / 1e6:.1f} MB)"
                f" built in {time.perf_counter() - t0:.4f} s  [{card}]")
        for kernel in KERNELS.values():
            kernel.reset_counts()
        for _ in range(STEPS):
            r.step(camera)
        torch.cuda.synchronize()
        got = {kind: dict(k.variant_launches) for kind, k in KERNELS.items()}
        per_pass = STEPS * o.num_bounces
        want = {kind: {} for kind in KERNELS}
        if label in SPLIT:
            want["bvh"] = {want_variant: per_pass}
        elif label in FUSED:
            want["bvh"] = {want_variant: per_pass}
            want["bounce"] = {"bounce": per_pass}
        elif label in PALLAS:
            want["triangle"] = {want_variant: per_pass}
        elif label not in DENSE:
            want["trace"] = {want_variant: STEPS}
        totals[label] = got
        canvas = r.canvas
        bad = int((~torch.isfinite(canvas).all(dim=-1)).sum())
        img = r.image()
        say(f"[3] cell {label} (config {CELLS[label][0]}, tri_backend="
            f"{o.tri_backend}) {o.width}x{o.height} spp={o.num_samples} "
            f"bounces={o.num_bounces}: {STEPS} steps, launches {got} (want "
            f"{want}); non-finite (ln 0 hazard) pixels={bad}, image "
            f"{img.shape} {img.dtype} min={img.min()} max={img.max()} "
            f"mean={img.mean():.3f}  [{card}]")
        if got != want:
            fail(f"cell {label}: launches {got}, want {want}")
        if bad > HAZARD_MAX:
            fail(f"cell {label}: {bad} non-finite pixels")
        if img.shape != (o.height, o.width, 3) or img.dtype != np.uint8:
            fail(f"cell {label}: image {img.shape} {img.dtype}")
        if img.min() == img.max():
            fail(f"cell {label}: constant image")
    # the probes' own path: their run() and floor_us(), counts reset just
    # before them
    probes, floor, totals["probes"] = probe_path(card)
    say(f"[3] launches per cell: {totals}")

    # ---- 4: kernels vs plain versions, full size, one pass ----
    results = {}
    for label, (r, camera) in in_form(renderers):
        s = r.options.num_samples
        backend = r.options.tri_backend
        ds = r.device_scene
        if label in PALLAS + DENSE:
            if label == PALLAS[0]:
                ragged_triangle_check(card)
            results[label] = brute_force_cell(label, r, camera, card)
            continue
        if label not in SPLIT + FUSED:
            args, kw = trace_args(r, camera, 4242)
            if label in BAND_CELLS:
                # a full-width band of rows at the image's centre
                row0 = (r.options.height - BAND_ROWS) // 2
                run_kw = dict(kw, row0=row0, tile_height=BAND_ROWS,
                              ray_tile=None)
                where = (f"rows {row0}-{row0 + BAND_ROWS - 1} x "
                         f"{r.options.width}")
            else:
                run_kw, where = kw, "the full pass"
            k = torch.stack(list(tk.trace_full(*args, **run_kw,
                                               tri_backend=backend)))
            segments = []
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with nearest_hits() as hits:
                p = torch.stack(list(tk.trace_full_plain(
                    *args, **run_kw, segments=segments)))
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
            counts = work = None
            full_segments = segments
            if label in BAND_CELLS:
                # the work of the full pass, on the split path's pass over
                # the same rays (the same scene; the two shading forms
                # differ by rounding)
                o = r.options
                full_segments = []
                cam = camera.state(o.width / o.height)
                orig, dirs, seed = generate_rays(
                    o.width, o.height, o.num_samples, 4242, cam.position,
                    camera_rotation(cam.yaw, cam.pitch), cam.aspect_ratio,
                    cam.fov_scale, tile=r.ray_tile, device=r.device)
                with nearest_hits() as hits:
                    trace_rays(ds, orig, dirs, seed, o.num_bounces,
                               full_segments, split=True)
            if CELLS[label][2] == "clustered":
                counts = trace_counts(label, args, kw, backend)
                work = clustered_work(hits, ds.triangles.clusters)
                say(f"[4] {trace_walk_report(label, counts, work)}; the "
                    f"counting instance's output equal to the route's  "
                    f"[{card}]")
            else:
                counts = trace_counts(label, args, kw, backend)
                prep = tk.prepare(*args, **kw, tri_backend=backend)
                both_streams = ("; the route and the counting instance "
                                "on two streams at once equal too"
                                if prep.variant == tk.PERSISTENT else "")
                say(f"[4] {trace_path_report(label, counts, segments, prep)}"
                    f"; the counting instance's output equal to the "
                    f"route's{both_streams}  [{card}]")
            both = torch.isfinite(k) & torch.isfinite(p)
            err = (k - p).abs()[both]
            max_abs = float(err.max()) if err.numel() else 0.0
            rmse, share, same_bad = canvas_diff(k, p, s)
            bitexact = bool(torch.equal(k[both], p[both]))
            results[label] = dict(max_abs=max_abs, segments=full_segments,
                                  args=args, kw=kw, counts=counts, work=work,
                                  n_rays=(r.options.width * r.options.height
                                          * s), plain_s=plain_s, where=where)
            say(f"[4] cell {label} kernel vs plain on {where}: "
                f"rmse={rmse:.3e} share>1e-3={share:.3e} max_abs="
                f"{max_abs:.3e} bit-identical={bitexact} non-finite masks "
                f"agree={same_bad} segments(live,hit,triangle hit)="
                f"{segments}; plain {plain_s:.2f} s  [{card}]")
            if not (rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
                    and same_bad):
                fail(f"cell {label}: kernel disagrees with the plain version")
            if ds.skybox is not None:
                rows_ok, differ, same_bad, m = rows_check(args, kw, backend)
                results[label]["max_abs"] = max(max_abs, m)
                say(f"[4] cell {label} nine rows (color, sky_mask, sky_dir) "
                    f"vs plain on the full pass: bit-identical={rows_ok}, "
                    f"rays whose rows differ {differ}, max|d| {m:.3e}, "
                    f"non-finite masks agree={same_bad}  [{card}]")
                if not same_bad:
                    fail(f"cell {label}: the nine rows' non-finite rays "
                         "differ")
            continue
        # a per-bounce path: every BVH launch of one pass (and every shade
        # launch) against the plain version on the same inputs, then the
        # whole canvas
        k, rec = per_bounce_pass(r, camera, 4242)
        torch.cuda.synchronize()
        tris = ds.triangles
        cl, table = tris.clusters, tris.table
        max_abs, work, plain_s, lines, counts = check_bvh_launches(
            label, rec.bvh, cl, table)
        res = dict(max_abs=max_abs, work=work, plain_ms=plain_s * 1e3,
                   recorded=rec.bvh, n_rays=k.shape[1], canvas=k,
                   counts=counts)
        if label in SUBBOX:
            subbox_checks(label, r, camera, rec.bvh, cl, table, card)
            if label == PARTIAL_CELL:
                partial_super_check(card)
        shade_ok = True
        if label in FUSED:
            differ, s_abs, s_work, s_plain, s_lines = check_shade_launches(
                ds, rec.shade)
            shade_ok = differ == 0
            res.update(shade_max_abs=s_abs, shade_work=s_work,
                       shade_plain_ms=s_plain * 1e3, shade=rec.shade)
            say(f"[4] cell {label} shade kernel vs plain, every launch of "
                f"one full pass: {'; '.join(s_lines)}; state rows "
                f"bit-identical={shade_ok}; plain shade {s_plain:.2f} "
                f"s/pass  [{card}]")
        p, _ = per_bounce_pass(r, camera, 4242, plain=True)
        torch.cuda.synchronize()
        rmse, share, same_bad = canvas_diff(k, p, s)
        bitexact = bool(torch.equal(k[torch.isfinite(k)],
                                    p[torch.isfinite(k)])) and same_bad
        results[label] = res
        say(f"[4] cell {label} BVH kernel vs plain, every launch of one "
            f"full pass ({bk.bvh_variant(cl, backend == 'clustered')}): "
            f"{'; '.join(lines)}; canvas rmse={rmse:.3e} share>1e-3="
            f"{share:.3e} bit-identical={bitexact} non-finite masks agree="
            f"{same_bad}; plain BVH {plain_s:.2f} s/pass; counting "
            f"instance equal to the route on {len(counts)} launches  "
            f"[{card}]")
        if not (rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
                and same_bad):
            fail(f"cell {label}: the per-bounce canvas disagrees with its "
                 "plain version")
        if not shade_ok:
            say(f"[4] cell {label}: the shade kernel's rows differ from the "
                "plain version's on some rays; the canvas keeps to the "
                "bound above")
        if label in FUSED:
            same = bool(torch.equal(k, results["7"]["canvas"]))
            say(f"[4] cell {label} vs cell 7 (the split path, the same "
                f"rays): canvases bit-identical={same}")
        if label in GATE_CELLS:
            row0, n_launch, hits, lost, extra = gate_check(r, camera)
            say(f"[4] cell {label} per-ray gate vs dense MT over all "
                f"{int(tris.active.sum())} triangles, rows "
                f"{row0}-{row0 + BAND_ROWS - 1} x {r.options.width}, "
                f"{n_launch} launches: {hits} dense hits, {lost} lost or "
                f"farther under the gate, {extra} gate hits the dense loop "
                f"lacks  [{card}]")
            if extra:
                fail(f"cell {label}: {extra} BVH hits that no triangle gives")
        if FORMS.get(label) == "plucker":
            plucker_checks(label, rec.bvh, cl, table, card)
    # config 7 under "fused" in the Plucker form: every BVH launch of a
    # pass against the plain version, and the split path's canvas
    r, camera = renderers["7/fused"]
    with form_env("7/plucker"):
        k, rec = per_bounce_pass(r, camera, 4242)
        torch.cuda.synchronize()
        tris = r.device_scene.triangles
        _, _, plain_s, lines, _ = check_bvh_launches(
            "7/fused/plucker", rec.bvh, tris.clusters, tris.table,
            count_work=False)
        same = bool(torch.equal(k, results["7/plucker"]["canvas"]))
        say(f"[4] cell 7/fused in the Plucker form, BVH kernel vs plain, "
            f"every launch of one full pass: {'; '.join(lines)}; canvas vs "
            f"cell 7/plucker (the split path, the same rays) bit-identical="
            f"{same}; plain BVH {plain_s:.2f} s/pass  [{card}]")
        plucker_checks("7/fused/plucker", rec.bvh, tris.clusters, tris.table,
                       card)
    # the probes' outputs against their plain versions, every seeded input
    probe_err = probe_checks(card)
    # the nine-row form of every triangle variant at the golden size
    for n in (2, 3, 4):
        w, h = GOLDEN_SIZES[str(n)]
        scene, camera, options = CONFIGS[n](width=w, height=h,
                                            **KWARGS.get(n, {}))
        scene.skybox = textures["rgbe"]
        r = Renderer(options, scene, device="cuda")
        args, kw = trace_args(r, camera, 4244)
        variant = whole_trace_variant(r.device_scene)
        rows_ok, differ, same_bad, m = rows_check(args, kw, "auto")
        k = torch.stack(list(tk.trace_full(*args, **kw)))
        p = torch.stack(list(tk.trace_full_plain(*args, **kw)))
        rmse, share, same = canvas_diff(k, p, options.num_samples)
        say(f"[4] config {n} ({variant}) {w}x{h} with the rgbe texture: "
            f"nine rows bit-identical={rows_ok} (rays whose rows differ "
            f"{differ}, max|d| {m:.3e}); radiance after the sample rmse="
            f"{rmse:.3e} share>1e-3={share:.3e}  [{card}]")
        if not (same_bad and same and rmse <= KERNEL_RMSE
                and share <= KERNEL_DIFF_SHARE):
            fail(f"config {n} with a texture: the nine-row form disagrees "
                 "with the plain version")

    # ---- 5: goldens, the 1,025-sphere scene, benchmark_step's state ----
    for label, (w, h) in GOLDEN_SIZES.items():
        n, backend, variant = (GOLDEN_ONLY[label] if label in GOLDEN_ONLY
                               else CELLS[label][:3])
        scene, camera, options = CONFIGS[n](width=w, height=h,
                                            **KWARGS.get(n, {}))
        scene.cluster_size = CLUSTER_SIZES.get(label)
        with form_env(label):
            r = Renderer(RenderOptions(width=w, height=h,
                                       num_samples=options.num_samples,
                                       num_bounces=options.num_bounces,
                                       tri_backend=backend),
                         scene, device="cuda")
            for kernel in KERNELS.values():
                kernel.reset_counts()
            for i in range(GOLDEN_STEPS):
                r.step(camera, time=GOLDEN_TIME0 + i)
            torch.cuda.synchronize()
        # the route the new goldens must take
        route = ""
        if (label in GOLDEN_ONLY or label in FORMS or label in CLUSTER_SIZES
                or label in SUBBOX):
            kind = "bvh" if label in SPLIT else "trace"
            route = dict(KERNELS[kind].variant_launches)
            if set(route) != {variant}:
                fail(f"golden {label}: launches {route}, want {variant}")
            route = (f" (K={r.device_scene.triangles.clusters.k}, "
                     f"launches {route})")
        canvas = r.canvas.cpu().numpy()
        golden = np.load(f"tests/goldens/config{n}.npz")["canvas"]
        rmse = float(np.sqrt(np.mean((canvas - golden) ** 2)))
        say(f"[5] cell {label} {w}x{h}{route} vs tests/goldens/config{n}.npz"
            f": rmse={rmse:.3e} (bound {GOLDEN_RMSE})")
        if canvas.shape != golden.shape or not np.isfinite(canvas).all() \
                or not rmse < GOLDEN_RMSE:
            fail(f"cell {label}: golden rmse {rmse}")
    spheres = Renderer(RenderOptions(width=256, height=144,
                                     num_samples=1, num_bounces=4),
                       sphere_scene(), device="cuda")
    cam = Camera(position=(0.0, 1.0, 4.0))
    tk.KERNEL.reset_counts()
    spheres.step(cam)
    torch.cuda.synchronize()
    sph_launches = dict(tk.KERNEL.variant_launches)
    args, kw = trace_args(spheres, cam, 77)
    prep = tk.prepare(*args, **kw)
    shared_kb = 4 * sum(t.numel() for t in prep.tables) / 1024
    k = torch.stack(list(tk.trace_full(*args, **kw)))
    p = torch.stack(list(tk.trace_full_plain(*args, **kw)))
    rmse, share, same_bad = canvas_diff(k, p, 1)
    img = spheres.image()
    say(f"[5] {N_SPHERES} spheres "
        f"({spheres.device_scene.spheres.radius.shape[0]} slots, "
        f"{shared_kb:.1f} KB of shared tables, the device allows "
        f"{tk.shared_limit(torch.cuda.current_device()) / 1024:.1f} KB):"
        f" launches {sph_launches}, image mean {img.mean():.3f}; kernel "
        f"vs plain rmse={rmse:.3e} share>1e-3={share:.3e} bit-identical="
        f"{bool(torch.equal(k, p))}  [{card}]")
    if sph_launches != {"none": 1} or shared_kb <= 48 or img.std() == 0 \
            or not (rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
                    and same_bad):
        fail("the 1,025-sphere scene")
    r, camera = renderers["6"]
    before, steps = r.canvas.clone(), r.num_steps
    bench = r.benchmark_step(camera, iters=3, warmup=1)
    kept = bool(torch.equal(before, r.canvas)) and r.num_steps == steps
    say(f"[5] benchmark_step on cell 6 "
        f"({bench['seconds_per_step'] * 1e3:.3f} ms/step) left the canvas "
        f"and step count ({steps}) as they were: {kept}")
    if not kept:
        fail("benchmark_step changed the accumulation state")

    # ---- 6: timings ----
    timing, steps_ms, ab, library, tri_cells = {}, {}, {}, {}, {}
    walk_cells = {}
    for label, (r, camera) in in_form(renderers):
        res = results[label]
        o = r.options
        ds = r.device_scene
        n_rays = res["n_rays"]
        iters = ITERS.get(label, 20)
        slow = iters < 5       # passes of seconds: warm after phase 3
        s_all = [r.benchmark_step(camera, iters=iters,
                                  warmup=1 if slow else 2)["seconds_per_step"]
                 * 1e3 for _ in range(3 if slow else 5)]
        step_ms = steps_ms[label] = float(np.median(s_all))
        extra = ""
        if label in DENSE:
            say(f"[6] cell {label} {o.width}x{o.height} (no kernel: the dense "
                f"PyTorch loop): Renderer.benchmark_step {step_ms:.4f} "
                f"ms/pass ({spread(s_all)})  [{card}]")
            continue
        if label in PALLAS:
            # the triangle kernel's launches of one pass, replayed
            tt = triangle_timing(res)
            k_all = tt["k_all"]
            k_ms = float(np.median(k_all))
            # the bound counts the early-out form's operations; full MT
            # over the live pairs and over every ray beside it
            flops = float(tt["flops"])
            nbytes = float(tt["nbytes"])
            mt_bound = tt["live_pairs"] * MT_FLOPS / FP32_PEAK * 1e3
            all_bound = tt["all_pairs"] * MT_FLOPS / FP32_PEAK * 1e3
            p_ms = res["plain_ms"]
            p_note = (f"plain on {res['where']} (sum over the pass's "
                      "launches, one run)")
            n, _, act, cols = res["work"][0]
            per_b = ", ".join(
                f"b{b} {ms:.4f} ms ({w[1]} live; early-out keeps "
                f"{sh[0]:.3e} of pairs, vote passes {sh[1]:.3e} of (warp, "
                f"triangle), u passes {sh[2]:.3e}, v {sh[3]:.3e}, MT "
                f"accepts {sh[4]:.3e})"
                for b, (ms, w, sh) in enumerate(zip(
                    tt["per"], res["work"], tt["shares"])))
            work = (f"{len(tt['per'])} launches of {n} rays x {act} active "
                    f"triangles ({cols} columns), {trk.SHAPE[0]} threads x "
                    f"{trk.SHAPE[1]} rays a block; per launch: {per_b}; "
                    f"live pairs {tt['live_pairs']:.6g} of "
                    f"{tt['all_pairs']:.6g}, "
                    f"{flops / tt['live_pairs']:.4f} FLOP a live pair in "
                    f"the early-out form; "
                    f"{tt['live_pairs'] / k_ms / 1e6:.2f} G live pairs/s; "
                    f"full MT over the live pairs {mt_bound:.4f} ms; "
                    f"every ray dead "
                    f"(the compaction, an empty grid) {tt['dead']:.4f} ms a "
                    f"pass; the same launches with every ray live (the TPU "
                    f"route's work) {tt['every_ray']:.4f} ms a pass, "
                    f"{tt['all_pairs'] / tt['every_ray'] / 1e6:.2f} G "
                    f"pairs/s; full MT over every ray {all_bound:.4f} ms")
            timing[label] = ("triangle", res["max_abs"])
            tri_cells[label] = dict(
                bound_mt_live_ms=mt_bound, bound_all_rays_ms=all_bound,
                per_launch_ms=tt["per"], dead_ms=tt["dead"],
                every_ray_ms=tt["every_ray"],
                early_out_shares=tt["shares"],
                live_per_launch=[w[1] for w in res["work"]])
        elif label in SPLIT + FUSED:
            cl = ds.triangles.clusters
            # the BVH kernel's launches of one pass, replayed as recorded
            preps = [prep for prep, _ in res["recorded"]]
            outs = [out for _, out in res["recorded"]]
            b_all = cuda_ms(lambda: [bk.launch(pp, oo)
                                     for pp, oo in zip(preps, outs)], iters=5)
            b_ms = float(np.median(b_all))
            plucker = FORMS.get(label) == "plucker"
            flops, nbytes, roots = bvh_bound(cl, res["work"])
            b_bound = max(flops / FP32_PEAK, nbytes / HBM_BYTES_PER_S) * 1e3
            walk_note = (f"{len(preps)} launches; walked rays per launch "
                         f"{[w[0] for w in res['work']]}, clusters opened "
                         f"per launch {[w[5] for w in res['work']]}, "
                         f"{roots} root boxes")
            if label in SUBBOX:
                walk_cells[label] = subbox_turns(label, res, card, parent)
            else:
                walk_cells[label] = walk_launches(label, res, cl,
                                                  ds.triangles.table, parent)
            if preps[0].variant in ("two_level", "flat") \
                    and label not in SUBBOX:
                walk_cells[label]["sweep"] = walk_sweep(label, res)
            bvh_line = (f"BVH kernel {b_ms:.4f} ms/pass ({spread(b_all)}; "
                        f"{walk_note}; bound {b_bound:.4f} ms ({flops:.4g} "
                        f"FLOP, {nbytes:.4g} B), {b_bound / b_ms * 100:.1f}% "
                        f"of it); plain BVH {res['plain_ms']:.3f} ms/pass "
                        "(sum over the pass's launches, one run)")
            if label in FUSED:
                s_preps = [prep for prep, _ in res["shade"]]
                s_outs = [out for _, out in res["shade"]]
                k_all = cuda_ms(lambda: [sk.launch(pp, oo) for pp, oo
                                         in zip(s_preps, s_outs)], iters=5)
                flops, nbytes = shade_bound(ds, res["shade_work"])
                p_ms = res["shade_plain_ms"]
                p_note = ("plain shade (sum over the pass's launches, one "
                          "run)")
                work = f"{len(s_preps)} shade launches; {bvh_line}"
                if parent_shade is not None:
                    work += "; " + shade_turns(s_preps, s_outs, parent_shade)
                timing[label] = ("bounce", res["shade_max_abs"])
            else:
                k_all, p_ms = b_all, res["plain_ms"]
                p_note = "plain BVH (sum over the pass's launches, one run)"
                work = walk_note
                if CELLS[label][2] == "streamed":
                    work += "; " + two_level_report(preps, outs, b_ms)
                if plucker:
                    pl_ms, mt_ms = form_ab(preps, outs, cl,
                                           ds.triangles.table)
                    ab[label] = (float(np.median(pl_ms)),
                                 float(np.median(mt_ms)))
                    work += (f"; the same launches in the MT form, in turns "
                             f"(Plucker {[round(v, 4) for v in pl_ms]}, MT "
                             f"{[round(v, 4) for v in mt_ms]} ms): Plucker / "
                             f"MT {ab[label][0] / ab[label][1]:.3f}")
                timing[label] = ("bvh", res["max_abs"])
            k_ms = float(np.median(k_all))
        else:
            args, kw = res["args"], res["kw"]
            # the kernel alone: arguments packed once, 50 launches a batch
            prep = tk.prepare(*args, **kw, tri_backend=o.tri_backend)
            out = torch.empty((prep.n_out, n_rays), dtype=torch.float32,
                              device="cuda")
            k_all = cuda_ms(lambda: tk.launch(prep, out), iters=50)
            # the parent's kernel on the same pass, in turns (parent,
            # this, this, parent), whose every output bit must be this
            # one's; the variant's constants swept
            iters = 5 if label in BAND_CELLS else 20
            ref = out.clone()
            if parent_trace is not None:
                got = torch.empty_like(out)
                run_p = lambda: cuda_ms(lambda: parent_trace_launch(
                    parent_trace, prep, got), iters=iters, repeats=3,
                    warmup=1)
                run_k = lambda: cuda_ms(lambda: tk.launch(prep, out),
                                        iters=iters, repeats=3, warmup=1)
                turns = [run_p(), run_k(), run_k(), run_p()]
                par = [float(np.median(t)) for t in turns[::3]]
                this = [float(np.median(t)) for t in turns[1:3]]
                differ = int((got.view(torch.int32)
                              != ref.view(torch.int32)).any(0).sum())
                extra += (f"; the parent's kernel on the same pass "
                          f"{par[0]:.4f}, {par[1]:.4f} ms against this "
                          f"{this[0]:.4f}, {this[1]:.4f} ms in turns "
                          f"(parent / this {sum(par) / sum(this):.2f}x); "
                          f"its output: {differ} rays differ")
                res["parent_ms"] = par
                res["this_ms"] = this
                if differ:
                    fail(f"cell {label}: the parent's whole-trace kernel "
                         "and this one differ")
            res["sweep"] = trace_sweep(label, prep, ref, iters)
            if ds.skybox is not None:
                # the texture's sample on the nine rows, as trace_full
                # runs it after the kernel
                rows = tk.split_rows(out)
                x_all = cuda_ms(lambda: add_sky(ds, *rows), iters=20)
                x_ms = float(np.median(x_all))
                texels = ds.skybox.numel() * 4
                x_bound = max(n_rays * SAMPLE_FLOPS / FP32_PEAK,
                              (n_rays * SAMPLE_RAY_BYTES + texels)
                              / HBM_BYTES_PER_S) * 1e3
                extra += (f"; the texture's sample (PyTorch, "
                         f"{tuple(ds.skybox.shape)}) {x_ms:.4f} ms/pass "
                         f"({spread(x_all)}), bound {x_bound:.4f} ms (bytes: "
                         f"{SAMPLE_RAY_BYTES} B a ray and the texture's "
                         f"{texels / 1e6:.1f} MB once), "
                         f"{x_bound / x_ms * 100:.1f}% of it")
                res["sample"] = (x_ms, x_bound)
            w_all = cuda_ms(lambda: tk.trace_full(
                *args, **kw, tri_backend=o.tri_backend), iters=20)
            segments = res["segments"]
            if label in BAND_CELLS:
                # the plain version ran on the band only; the work of the
                # full pass was counted on the split path's pass (phase 4)
                p_ms = res["plain_s"] * 1e3
                p_note = f"plain on {res['where']} (one run)"
                extra += f"; work counted on the split path: {segments}"
            else:
                dense_mesh = ds.triangles.material.shape[0] > 64
                p_all = cuda_ms(lambda: tk.trace_full_plain(*args, **kw),
                                iters=1 if dense_mesh else 2, repeats=3,
                                warmup=1)
                p_ms = float(np.median(p_all))
                p_note = f"plain ({spread(p_all)})"
            k_ms = float(np.median(k_all))
            flops = kernel_flops(ds, o.tri_backend, n_rays, segments,
                                 sky=prep.n_out == 3, work=res["work"])
            if res["work"] is not None:
                extra += "; " + trace_walk_report(label, res["counts"],
                                                  res["work"])
            nbytes = 4.0 * prep.n_out * n_rays
            segs = sum(seg[0] for seg in segments)
            work = (f"{n_rays / k_ms / 1e3:.1f} Mrays/s primary, "
                    f"{segs / k_ms / 1e3:.1f} M segments/s; with the "
                    f"wrapper's per-pass packing "
                    f"{float(np.median(w_all)):.4f} ms ({spread(w_all)})")
            timing[label] = ("trace", res["max_abs"])
        t_ops = flops / FP32_PEAK * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        timing[label] += (k_ms, p_ms, bound_ms,
                          "operations" if t_ops >= t_bytes else "bytes", o)
        if label in tri_cells:
            tri_cells[label].update(ms=k_ms, bound_ms=bound_ms)
        if bound_ms > k_ms:
            fail(f"cell {label}: the kernel's {k_ms:.4f} ms is under its "
                 f"bound {bound_ms:.4f} ms: the bound miscounts the work")
        say(f"[6] cell {label} {o.width}x{o.height}: kernel {k_ms:.4f} "
            f"ms/pass ({spread(k_all)}; {work}); {p_note} {p_ms:.3f} "
            f"ms/pass; Renderer.benchmark_step {step_ms:.4f} ms/pass "
            f"({spread(s_all)}); bound {bound_ms:.4f} ms ({flops:.4g} FLOP "
            f"/ 67 TFLOP/s = {t_ops:.4f} ms; {nbytes:.4g} B / 3.35 TB/s = "
            f"{t_bytes:.4f} ms), {bound_ms / k_ms * 100:.1f}% of bound"
            f"{extra}  [{card}]")
    side = [f"config {n}: auto {steps_ms[str(n)]:.4f} ms, fused "
            f"{steps_ms[f'{n}/fused']:.4f} ms (fused / auto "
            f"{steps_ms[f'{n}/fused'] / steps_ms[str(n)]:.3f})"
            for n in (6, 7)]
    say(f"[6] benchmark_step, tri_backend auto against fused: "
        f"{'; '.join(side)}  [{card}]")
    side = [f"{mt}: MT {timing[mt][2]:.4f} ms, {pl}: Plucker "
            f"{timing[pl][2]:.4f} ms (Plucker / MT "
            f"{timing[pl][2] / timing[mt][2]:.3f}; the Plucker cell's own "
            f"launches in both forms, in turns: {ab[pl][0] / ab[pl][1]:.3f}"
            f"); benchmark_step {steps_ms[mt]:.4f} against "
            f"{steps_ms[pl]:.4f} ms"
            for mt, pl in (("6", "6/plucker"), ("7", "7/plucker"),
                           ("6/k256", "6/k256/plucker"))]
    say(f"[6] BVH kernel per pass, the MT form against the Plucker form: "
        f"{'; '.join(side)}  [{card}]")
    builder_turns(card, renderers)
    # the probes: time per call, the loop's cost an iteration (phase 3's
    # run()), the empty launch beside them, the parent's build in turns
    probe_rows = probe_timings(card, probes, floor, probe_err, timing,
                               library, parent_probe)

    # ---- 7: where a step's time goes ----
    for label, (r, camera) in in_form(renderers):
        if label in SUBBOX:
            continue      # the sub-box cells are timed in phase 6 only
        iters = ITERS.get(label, 20)
        if label in SPLIT + FUSED + PALLAS:
            iters = min(iters, PROFILE_STEPS)
        say(f"[7] cell {label}: {step_breakdown(r, camera, iters)}  "
            f"[{card}]")

    # ---- 8: the command-line path ----
    build_dir = Path(__file__).resolve().parent / "build"
    cli_max = {}    # kernel kind -> variant -> phase 8's largest |d|
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        make_textures(Path(tmp))
        totals["cli"], cli_max["trace"], cli_max["bvh"] = cli_phase(
            card, scenes, Path(tmp))

    # ---- 9: multi-device bands on the one card ----
    totals["par"] = parallel_phase(card)

    # ---- 10: editing and the viewer on the card ----
    for kernel in KERNELS.values():
        kernel.reset_counts()
    totals["view"] = viewer_phase(card)

    # ---- 11: the JAX package's opt-in switches ----
    ring_rows, totals["switch"] = switch_phase(card, renderers)

    entries = []
    for name, kind, line, cell, covered, variant in ROWS:
        _, max_abs, k_ms, p_ms, bound_ms, bound_by, o = timing[cell]
        counted = (variant,) if isinstance(variant, str) else variant
        launches = sum(c for label in covered
                       for v, c in totals[label][kind].items()
                       if counted is None or v in counted)
        # phase 8's largest |d| of the variants this row counts
        errs = [m for v, m in cli_max.get(kind, {}).items()
                if "cli" in covered and (counted is None or v in counted)]
        if kind == "trace":
            errs += [results[c]["max_abs"] for c in covered
                     if c not in ("cli", "par", "view")]
        max_abs = max(errs + [max_abs])
        if launches == 0:
            fail(f"kernel row {name}: no launch on the main path")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"simple_raytracer_tpu_torch/csrc/{SOURCES[kind]}",
            "replaces": (line if line.startswith("scripts/")
                         else f"simple_raytracer_tpu/ops/pallas/{line}"),
            "launches": launches, "max_abs_err": max_abs,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library.get(cell),
            "shape": (f"({probe.ROWS}, {probe.COLS}) f32 ones, one "
                      f"cluster of {probe.CLUSTER} CTAs" if o is None else
                      f"config {CELLS[cell][0]} (tri_backend="
                      f"{o.tri_backend}"
                      + (f", SRT_BVH_MT={FORMS[cell]}" if cell in FORMS
                         else "")
                      + (f", SRT_BVH_SUBBOX={SUBBOX[cell]}"
                         if cell in SUBBOX else "")
                      + f"), {o.width}x{o.height}, {o.num_samples} spp, "
                      f"{o.num_bounces} bounces"
                      + (f"; plain_ms on {results[cell]['where']} only"
                         if cell in BAND_CELLS else "")),
        })
        if kind == "triangle":
            # its full-MT bounds over the live pairs and over every ray
            # (the TPU route's work), and each "pallas" cell's numbers
            for key in ("bound_mt_live_ms", "bound_all_rays_ms"):
                entries[-1][key] = tri_cells[cell][key]
            entries[-1]["cells"] = tri_cells
        if kind == "probe":
            # its time from Python, the loop's cycles, the empty launch
            # and the parent's build (phase 6)
            entries[-1].update(probe_rows[cell])
        if kind == "bvh":
            # the cells of this variant and form, launch by launch (phase
            # 6)
            entries[-1]["cells"] = {
                c: v for c, v in walk_cells.items()
                if CELLS[c][2] == variant}
    for name, (row, depth) in RING_ROWS.items():
        # the ring builds (SRT_BVH_DMA_SLOTS), on config 7's launches of
        # phase 11
        o = renderers["7"][0].options
        v = ring_rows[name]
        entries.append({
            "name": row, "route": "cuda",
            "source": "simple_raytracer_tpu_torch/csrc/bvh_kernel.cu",
            "replaces": "simple_raytracer_tpu/ops/pallas/bvh_kernel.py:678",
            "launches": v["launches"], "max_abs_err": v["max_abs"],
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None,
            "shape": (f"config 7 (tri_backend=auto, SRT_BVH_DMA_SLOTS="
                      f"{depth}: -DSRT_BVH_STAGES={depth}), {o.width}x"
                      f"{o.height}, {o.num_samples} spp, {o.num_bounces} "
                      "bounces; launches: phase 11's passes")})
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
