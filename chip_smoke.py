#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Run from the repository root:

    python3 chip_smoke.py

The paths: the whole-trace kernel (configs 1 to 5 under
tri_backend="auto") and the split per-bounce path with the BVH kernel
(config 6 under "auto": the two_level variant; config 5 under "bvh": the
flat variant).  Phases, one line each on stdout:
  1. the card's name and power limit (nvidia-smi);
  2. the build of both kernels, one nvcc each, started together;
  3. the main paths: each cell at its preset size through
     Renderer(device="cuda"), 4 progressive steps, with every kernel's
     launch counts (in all and per variant) reset just before and read
     just after the cell; the scene build's seconds;
  4. each kernel against its plain PyTorch version on the card, one pass
     of each cell at full size: the whole-trace canvas, and for the split
     cells every BVH launch's (t, slot) on live rays and the canvas; then
     the per-ray gate against a gate-free dense Moller-Trumbore over every
     triangle, on every launch of a pass of one full-width band of rows;
  5. the golden-size renders (tests/test_golden.py) against
     tests/goldens/config{1..6}.npz; a 1,025-sphere scene (tables above
     48 KB of shared memory) against the plain version; benchmark_step
     leaves the canvas and step count as they were;
  6. timings with CUDA events, and each kernel's bound;
  7. where a Renderer.step's time goes (torch.profiler).
Then one JSON line per the kernel table, the card line again, and the
last line {"ok": true, "device": {...}}.  Any failed phase exits non-zero
before the last line.  Without CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.camera import Camera
from simple_raytracer_tpu_torch.models.materials import Material
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.models.scene import Scene
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops.camera import camera_rotation
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel as tk
from simple_raytracer_tpu_torch.ops.camera import generate_rays
from simple_raytracer_tpu_torch.ops.intersect import intersect_triangles
from simple_raytracer_tpu_torch.ops.scene_types import whole_trace_variant
from simple_raytracer_tpu_torch.ops.trace import trace_rays
from simple_raytracer_tpu_torch.ops.vec import Vec3

STEPS = 4                      # progressive steps on the main path
KWARGS = {3: {"skybox": "gradient"}}        # as tests/test_golden.py
# the cells: label -> (config, tri_backend, the kernel variant it takes)
CELLS = {"1": (1, "auto", "none"), "2": (2, "auto", "none"),
         "3": (3, "auto", "small"), "4": (4, "auto", "clustered"),
         "5": (5, "auto", "clustered"), "6": (6, "auto", "two_level"),
         "5/bvh": (5, "bvh", "flat")}
SPLIT = ("6", "5/bvh")         # the cells of the split per-bounce path
GOLDEN_SIZES = {"1": (64, 64), "2": (96, 54), "3": (96, 54), "4": (96, 54),
                "5": (96, 54), "6": (64, 36), "5/bvh": (96, 54)}
GOLDEN_STEPS, GOLDEN_TIME0 = 2, 1000
GOLDEN_RMSE = 2e-3             # tests/test_golden.py's bound
# Kernel vs plain version: the kernels repeat the plain versions' float
# operations in the same order (--fmad=false, no fast math), so the
# canvases should agree to the last bit; a branch that flips on a one-ulp
# difference (a Bernoulli draw at its threshold, the one fma the plain
# version emulates in f64) can move a whole path, so the bound is on the
# RMSE and on the share of pixels that differ, not on the maximum.  The
# BVH kernel's (t, slot) must equal its plain version's on every live ray.
KERNEL_RMSE = 1e-4
KERNEL_DIFF_SHARE = 1e-3       # share of pixels more than 1e-3 apart
HAZARD_MAX = 8                 # non-finite pixels allowed (ln(0) draws)
N_SPHERES = 1025               # 2,048 sphere slots: 64 KB of shared memory
GATE_ROWS = 16                 # the band of the gate check, centred
# the card's published peaks (H100 SXM data sheet, at 700 W)
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12


def say(msg: str) -> None:
    print(msg, flush=True)


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


def build_kernels() -> str:
    """Build both kernels at once (one nvcc each) and report ptxas's
    registers and spills per variant."""
    errors = []

    def build(kernel):
        try:
            kernel.library()
        except RuntimeError as exc:       # nvcc failed: reported below
            errors.append(str(exc))

    threads = [threading.Thread(target=build, args=(k,))
               for k in (tk.KERNEL, bk.KERNEL)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail("kernel build: " + "\n".join(errors))
    parts = []
    for kernel, entry, names in ((tk.KERNEL, "trace_kernel", tk.TRI_MODES),
                                 (bk.KERNEL, "bvh_kernel", bk.VARIANTS)):
        # ptxas reports each template instance after its "entry function"
        modes = {str(v): k for k, v in names.items()}
        variant = None
        for line in kernel.build_log.splitlines():
            m = re.search(rf"entry function '.*{entry}ILi(\d)E", line)
            if m:
                variant = modes.get(m.group(1), m.group(1))
            elif "registers" in line or "spill" in line:
                parts.append(f"{variant}: "
                             + line.split("ptxas info    : ")[-1].strip())
    return "; ".join(parts) or "no ptxas report"


# Float operations of the kernels, counted from the CUDA sources (adds,
# subtracts, multiplies, divides, square roots, min/max; an fma counts 2;
# the integer hash and compares are left out, so the bound is a floor).
RAYGEN_FLOPS = 42          # 2 uniforms, NDC, screen, rotate, normalize
SPHERE_FLOPS = 21          # one sphere test
PLANE_FLOPS = 14           # one plane test
MT_FLOPS = 46              # one Moller-Trumbore test (mt_update)
SLAB_FLOPS = 24            # one box's slab test, without the margin
INV_DIR_FLOPS = 3          # the reciprocal direction of the traversal
SHADE_FLOPS = 30           # position, normal, front flip, emission
BSDF_FLOPS = 275           # 3 normals (log, cos), 3 uniforms, mixes
SKY_FLOPS = 54             # the gradient sky and the final add
BVH_RAY_BYTES = 32 + 8     # a ray in (o, d, alive, t_init), (t, slot) out
TRI_ROW_BYTES = 80 + 4     # a slot row of the table and its index


def kernel_flops(scene, n_rays: int, segments: list) -> float:
    """Float operations this pass's data needs (``segments`` from the plain
    version: live rays, hits, triangle hits per bounce): every live ray
    tests each active sphere and plane, every hit shades, and every hit
    before the last bounce samples the BSDF.  Triangles: a small mesh is
    tested whole (live rays x active triangles x MT); a clustered mesh at
    least slab-tests every real cluster box per live ray, and each ray
    whose nearest hit is a triangle runs MT over the K slots of that
    triangle's cluster."""
    n_s = int(scene.spheres.active.sum())
    n_p = int(scene.planes.active.sum())
    tris = scene.triangles
    variant = whole_trace_variant(scene)
    flops = n_rays * (RAYGEN_FLOPS + SKY_FLOPS)
    for i, (live, hits, tri_hits) in enumerate(segments):
        flops += live * (n_s * SPHERE_FLOPS + n_p * PLANE_FLOPS)
        if variant == "small":
            flops += live * int(tris.active.sum()) * MT_FLOPS
        elif variant == "clustered":
            real = int((tris.clusters.slots[:, 0] >= 0).sum())
            flops += live * (real * SLAB_FLOPS + INV_DIR_FLOPS)
            flops += tri_hits * tris.clusters.k * MT_FLOPS
        flops += hits * SHADE_FLOPS
        if i < len(segments) - 1:
            flops += hits * BSDF_FLOPS
    return float(flops)


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
    per_kernel = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0) or 0
        # kernels only: the aten ops that launch them carry the same time
        if dev_us > 0 and str(evt.device_type).endswith("CUDA"):
            name = evt.key.replace("(anonymous namespace)::", "")
            name = re.sub(r"^void ", "", name).split("(")[0].split("<")[0]
            per_kernel[name[-40:]] = per_kernel.get(name[-40:], 0.0) + dev_us
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


def plain_bvh(o, d, alive, t_init, clusters, table, compact=False):
    """The BVH kernel's wrapper with its plain version on the card."""
    if compact:
        order, count = bvh.compact_order(o, d, alive, t_init,
                                         clusters.hierarchy.admission)
        return bvh.intersect_compacted_plain(o, d, alive, t_init, clusters,
                                             table, order, int(count))
    return bvh.intersect_triangles_bvh_plain(o, d, alive, t_init, clusters,
                                             table)


def split_pass(r: Renderer, camera, time_seed: int, plain: bool = False,
               band=None):
    """One pass of the split path's per-ray radiance, (3, R), by the steps
    render_pass takes (generate_rays, the split trace_rays); returns it
    and the BVH launches it made ([(Prepared, (t, slot))]).  ``plain``
    swaps the BVH kernel for its plain version; ``band`` = (row0, rows)
    traces only those rows."""
    o = r.options
    row0, rows = band if band is not None else (0, None)
    recorded = []
    launch, wrapper = bk.launch, bk.intersect_triangles_bvh

    def record(prep, out=None):
        res = launch(prep, out)
        recorded.append((prep, res))
        return res

    bk.launch = record
    if plain:
        bk.intersect_triangles_bvh = plain_bvh
    try:
        cam = camera.state(o.width / o.height)
        orig, dirs, seed = generate_rays(
            o.width, o.height, o.num_samples, time_seed, cam.position,
            camera_rotation(cam.yaw, cam.pitch), cam.aspect_ratio,
            cam.fov_scale, row0=row0, tile_height=rows,
            tile=r.ray_tile if band is None else None, device=r.device)
        color = trace_rays(r.device_scene, orig, dirs, seed, o.num_bounces,
                           split=True)
    finally:
        bk.launch, bk.intersect_triangles_bvh = launch, wrapper
    return torch.stack(list(color)), recorded


def bvh_inputs(prep):
    rays = prep.rays
    return (Vec3(rays[0], rays[1], rays[2]), Vec3(rays[3], rays[4], rays[5]),
            rays[6], rays[7])


def gate_check(r: Renderer, camera):
    """The per-ray gate (kernel and plain version alike) against a
    gate-free dense Moller-Trumbore over every triangle, on the live rays
    of every BVH launch of one pass of GATE_ROWS full-width rows at the
    image's centre.  The TPU gates a 128-ray sub-block, which admits at
    least what each of its rays admits, so a hit the dense loop finds and
    the gate loses is the most by which the two can differ.  Both run the
    same float operations, so a gate hit the dense loop lacks is a fault.
    Returns (row0, launches, dense hits, rays lost or farther, extra)."""
    row0 = (r.options.height - GATE_ROWS) // 2
    _, recorded = split_pass(r, camera, 4243, band=(row0, GATE_ROWS))
    tris = r.device_scene.triangles
    hits = lost = extra = 0
    for prep, (t_k, s_k) in recorded:
        o_, d_, alive, t_init = bvh_inputs(prep)
        live = alive > 0
        sub = lambda v: Vec3(v.x[live], v.y[live], v.z[live])
        t_d, _, _, _ = intersect_triangles(sub(o_), sub(d_), tris)
        dense = t_d < t_init[live]
        gate = s_k[live] >= 0
        hits += int(dense.sum())
        lost += int((dense & ~(gate & (t_k[live] == t_d))).sum())
        extra += int((gate & ~dense).sum())
    return row0, len(recorded), hits, lost, extra


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    card = card_line()
    say(f"[1] card: {card}")

    t0 = time.perf_counter()
    ptxas = build_kernels()
    say(f"[2] build: {time.perf_counter() - t0:.2f} s for both kernels "
        f"(nvcc sm_90a, ctypes; trace_kernel.cu "
        f"{tk.KERNEL.build_seconds:.2f} s, bvh_kernel.cu "
        f"{bk.KERNEL.build_seconds:.2f} s); ptxas: {ptxas}")

    # ---- 3: the main paths, each cell's counts reset just before it ----
    renderers = {}
    for label, (n, backend, _) in CELLS.items():
        scene, camera, options = CONFIGS[n](**KWARGS.get(n, {}))
        options = dataclasses.replace(options, tri_backend=backend)
        t0 = time.perf_counter()
        r = Renderer(options, scene, device="cuda")
        torch.cuda.synchronize()
        renderers[label] = (r, camera, time.perf_counter() - t0)
    totals = {"trace": {}, "bvh": {}}
    for label, (r, camera, build_s) in renderers.items():
        want_variant = CELLS[label][2]
        o = r.options
        tk.KERNEL.reset_counts()
        bk.KERNEL.reset_counts()
        for _ in range(STEPS):
            r.step(camera)
        torch.cuda.synchronize()
        got = {"trace": dict(tk.KERNEL.variant_launches),
               "bvh": dict(bk.KERNEL.variant_launches)}
        if label in SPLIT:
            want = {"trace": {}, "bvh": {want_variant: STEPS * o.num_bounces}}
        else:
            want = {"trace": {want_variant: STEPS}, "bvh": {}}
        for kind in totals:
            for v, c in got[kind].items():
                totals[kind][v] = totals[kind].get(v, 0) + c
        canvas = r.canvas
        bad = int((~torch.isfinite(canvas).all(dim=-1)).sum())
        img = r.image()
        say(f"[3] cell {label} (config {CELLS[label][0]}, tri_backend="
            f"{o.tri_backend}) {o.width}x{o.height} spp={o.num_samples} "
            f"bounces={o.num_bounces}: scene build {build_s:.3f} s; "
            f"{STEPS} steps, launches {got} (want {want}); non-finite "
            f"(ln 0 hazard) pixels={bad}, image {img.shape} {img.dtype} "
            f"min={img.min()} max={img.max()} mean={img.mean():.3f}  "
            f"[{card}]")
        if got != want:
            fail(f"cell {label}: launches {got}, want {want}")
        if bad > HAZARD_MAX:
            fail(f"cell {label}: {bad} non-finite pixels")
        if img.shape != (o.height, o.width, 3) or img.dtype != np.uint8:
            fail(f"cell {label}: image {img.shape} {img.dtype}")
        if img.min() == img.max():
            fail(f"cell {label}: constant image")
    say(f"[3] launches in all: {totals}")

    # ---- 4: kernels vs plain versions, full size, one pass ----
    results = {}
    for label, (r, camera, _) in renderers.items():
        s = r.options.num_samples
        if label not in SPLIT:
            args, kw = trace_args(r, camera, 4242)
            k = torch.stack(list(tk.trace_full(*args, **kw)))
            segments = []
            p = torch.stack(list(tk.trace_full_plain(*args, **kw,
                                                     segments=segments)))
            torch.cuda.synchronize()
            both = torch.isfinite(k) & torch.isfinite(p)
            err = (k - p).abs()[both]
            max_abs = float(err.max()) if err.numel() else 0.0
            rmse, share, same_bad = canvas_diff(k, p, s)
            bitexact = bool(torch.equal(k[both], p[both]))
            results[label] = dict(max_abs=max_abs, segments=segments,
                                  args=args, kw=kw, n_rays=k.shape[1])
            say(f"[4] cell {label} kernel vs plain: rmse={rmse:.3e} "
                f"share>1e-3={share:.3e} max_abs={max_abs:.3e} "
                f"bit-identical={bitexact} non-finite masks agree={same_bad} "
                f"segments(live,hit,triangle hit)={segments}  [{card}]")
            if not (rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
                    and same_bad):
                fail(f"cell {label}: kernel disagrees with the plain version")
            continue
        # the split path: every BVH launch of one pass against the plain
        # version on the same rays, then the whole canvas
        k, recorded = split_pass(r, camera, 4242)
        torch.cuda.synchronize()
        tris = r.device_scene.triangles
        cl, table = tris.clusters, tris.table
        max_abs, work, plain_s, bounces = 0.0, [], 0.0, []
        for b, (prep, (t_k, s_k)) in enumerate(recorded):
            o_, d_, alive, t_init = bvh_inputs(prep)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            t_p, s_p = bvh.intersect_triangles_bvh_plain(
                o_, d_, alive, t_init, cl, table)
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
            walked = int(prep.count) if compact else int(live.sum())
            tri_hits = int((s_k[live] >= 0).sum())
            work.append((walked, tri_hits, prep.params.n_rays, compact))
            bounces.append(f"b{b}: live {int(live.sum())} "
                           f"{'compact' if compact else 'dense'}, walked "
                           f"{walked}, triangle hits {tri_hits}, slot diff "
                           f"{slot_diff}, max|dt| {m:.3e}")
            if slot_diff or m != 0.0 or not t_same:
                fail(f"cell {label} bounce {b}: the BVH kernel's (t, slot) "
                     f"differ from the plain version on {slot_diff} live "
                     f"rays (max |dt| {m})")
        p, _ = split_pass(r, camera, 4242, plain=True)
        torch.cuda.synchronize()
        rmse, share, same_bad = canvas_diff(k, p, s)
        bitexact = bool(torch.equal(k[torch.isfinite(k)],
                                    p[torch.isfinite(k)])) and same_bad
        results[label] = dict(max_abs=max_abs, work=work,
                              plain_ms=plain_s * 1e3, recorded=recorded,
                              n_rays=k.shape[1])
        say(f"[4] cell {label} BVH kernel vs plain, every launch of one "
            f"full pass ({bk.bvh_variant(cl)}): {'; '.join(bounces)}; "
            f"canvas rmse={rmse:.3e} share>1e-3={share:.3e} "
            f"bit-identical={bitexact} non-finite masks agree={same_bad}; "
            f"plain BVH {plain_s:.2f} s/pass  [{card}]")
        if not (rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
                and same_bad):
            fail(f"cell {label}: the split path's canvas disagrees with its "
                 "plain version")
        row0, n_launch, hits, lost, extra = gate_check(r, camera)
        say(f"[4] cell {label} per-ray gate vs dense MT over all "
            f"{int(r.device_scene.triangles.active.sum())} triangles, rows "
            f"{row0}-{row0 + GATE_ROWS - 1} x {r.options.width}, "
            f"{n_launch} launches: {hits} dense hits, {lost} lost or "
            f"farther under the gate, {extra} gate hits the dense loop "
            f"lacks  [{card}]")
        if extra:
            fail(f"cell {label}: {extra} BVH hits that no triangle gives")

    # ---- 5: goldens, the 1,025-sphere scene, benchmark_step's state ----
    for label, (w, h) in GOLDEN_SIZES.items():
        n, backend, _ = CELLS[label]
        scene, camera, options = CONFIGS[n](width=w, height=h,
                                            **KWARGS.get(n, {}))
        r = Renderer(RenderOptions(width=w, height=h,
                                   num_samples=options.num_samples,
                                   num_bounces=options.num_bounces,
                                   tri_backend=backend),
                     scene, device="cuda")
        for i in range(GOLDEN_STEPS):
            r.step(camera, time=GOLDEN_TIME0 + i)
        canvas = r.canvas.cpu().numpy()
        golden = np.load(f"tests/goldens/config{n}.npz")["canvas"]
        rmse = float(np.sqrt(np.mean((canvas - golden) ** 2)))
        say(f"[5] cell {label} {w}x{h} vs tests/goldens/config{n}.npz: "
            f"rmse={rmse:.3e} (bound {GOLDEN_RMSE})")
        if canvas.shape != golden.shape or not np.isfinite(canvas).all() \
                or not rmse < GOLDEN_RMSE:
            fail(f"cell {label}: golden rmse {rmse}")
    spheres = Renderer(RenderOptions(width=256, height=144, num_samples=1,
                                     num_bounces=4), sphere_scene(),
                       device="cuda")
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
    say(f"[5] {N_SPHERES} spheres ({spheres.device_scene.spheres.radius.shape[0]} "
        f"slots, {shared_kb:.1f} KB of shared tables, the device allows "
        f"{tk.shared_limit(torch.cuda.current_device()) / 1024:.1f} KB): "
        f"launches {sph_launches}, image mean {img.mean():.3f}; kernel vs "
        f"plain rmse={rmse:.3e} share>1e-3={share:.3e} bit-identical="
        f"{bool(torch.equal(k, p))}  [{card}]")
    if sph_launches != {"none": 1} or shared_kb <= 48 or img.std() == 0 \
            or not (rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
                    and same_bad):
        fail("the 1,025-sphere scene")
    r, camera, _ = renderers["6"]
    before, steps = r.canvas.clone(), r.num_steps
    bench = r.benchmark_step(camera, iters=3, warmup=1)
    kept = bool(torch.equal(before, r.canvas)) and r.num_steps == steps
    say(f"[5] benchmark_step on cell 6 ({bench['seconds_per_step'] * 1e3:.3f} "
        f"ms/step) left the canvas and step count ({steps}) as they were: "
        f"{kept}")
    if not kept:
        fail("benchmark_step changed the accumulation state")

    # ---- 6: timings ----
    entries = {}
    timed = {"2": ("trace_kernel", "bounce_kernel.py:659", "trace",
                   sum(totals["trace"].values())),
             "3": ("tris_small", "bounce_kernel.py:238", "trace",
                   totals["trace"].get("small", 0)),
             "5": ("tris_clustered", "bounce_kernel.py:291", "trace",
                   totals["trace"].get("clustered", 0)),
             "5/bvh": ("bvh_flat", "bvh_kernel.py:201", "bvh",
                       totals["bvh"].get("flat", 0)),
             "6": ("bvh_two_level", "bvh_kernel.py:1040", "bvh",
                   totals["bvh"].get("two_level", 0))}
    for label, (r, camera, _) in renderers.items():
        res = results[label]
        o = r.options
        n_rays = res["n_rays"]
        s_all = [r.benchmark_step(camera, iters=20)["seconds_per_step"] * 1e3
                 for _ in range(5)]
        step_ms = float(np.median(s_all))
        if label in SPLIT:
            # the BVH kernel's launches of one pass, replayed as recorded
            preps = [prep for prep, _ in res["recorded"]]
            outs = [out for _, out in res["recorded"]]
            k_all = cuda_ms(lambda: [bk.launch(pp, oo)
                                     for pp, oo in zip(preps, outs)], iters=5)
            k_ms, p_ms = float(np.median(k_all)), res["plain_ms"]
            cl = r.device_scene.triangles.clusters
            n_slots = cl.slots.numel()
            # the least work of this run's data: each walked ray slab-tests
            # the hierarchy's root boxes, and a ray whose nearest hit is a
            # triangle runs MT over the K slots of that triangle's cluster
            roots = int((cl.hierarchy.groups[:, 0] < 1.0e37).sum())
            flops = sum(walked * (roots * SLAB_FLOPS + INV_DIR_FLOPS)
                        + tri_hits * cl.k * MT_FLOPS
                        for walked, tri_hits, _, _ in res["work"])
            nbytes = sum(n * (BVH_RAY_BYTES + (4 if compact else 0))
                         + n_slots * TRI_ROW_BYTES + 32 * cl.aabb.shape[0]
                         for _, _, n, compact in res["work"])
            work = (f"{len(preps)} launches; walked rays per launch "
                    f"{[w[0] for w in res['work']]}, {roots} root boxes")
            p_note = "plain BVH (sum over the pass's launches, one run)"
            w_note = ""
        else:
            args, kw = res["args"], res["kw"]
            # the kernel alone: arguments packed once, 50 launches a batch
            prep = tk.prepare(*args, **kw)
            out = torch.empty((3, n_rays), dtype=torch.float32,
                              device="cuda")
            k_all = cuda_ms(lambda: tk.launch(prep, out), iters=50)
            w_all = cuda_ms(lambda: tk.trace_full(*args, **kw), iters=20)
            dense_mesh = r.device_scene.triangles.material.shape[0] > 64
            p_all = cuda_ms(lambda: tk.trace_full_plain(*args, **kw),
                            iters=1 if dense_mesh else 2, repeats=3,
                            warmup=1)
            k_ms, p_ms = float(np.median(k_all)), float(np.median(p_all))
            flops = kernel_flops(r.device_scene, n_rays, res["segments"])
            nbytes = 12.0 * n_rays
            segs = sum(seg[0] for seg in res["segments"])
            work = (f"{n_rays / k_ms / 1e3:.1f} Mrays/s primary, "
                    f"{segs / k_ms / 1e3:.1f} M segments/s")
            p_note = f"plain ({spread(p_all)})"
            w_note = (f"; with the wrapper's per-pass packing "
                      f"{float(np.median(w_all)):.4f} ms ({spread(w_all)})")
        t_ops = flops / FP32_PEAK * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        say(f"[6] cell {label} {o.width}x{o.height}: kernel {k_ms:.4f} "
            f"ms/pass ({spread(k_all)}; {work}){w_note}; {p_note} "
            f"{p_ms:.3f} ms/pass; Renderer.benchmark_step {step_ms:.4f} "
            f"ms/pass ({spread(s_all)}); bound {bound_ms:.4f} ms "
            f"({flops:.4g} FLOP / 67 TFLOP/s = {t_ops:.4f} ms; {nbytes:.4g} "
            f"B / 3.35 TB/s = {t_bytes:.4f} ms), {bound_ms / k_ms * 100:.1f}% "
            f"of bound  [{card}]")
        if label in timed:
            name, line, kind, count = timed[label]
            if kind == "trace":
                errs = [v["max_abs"] for m, v in results.items()
                        if m not in SPLIT and (name == "trace_kernel"
                                               or CELLS[m][2] == CELLS[label][2])]
            else:
                errs = [res["max_abs"]]
            src = "trace_kernel.cu" if kind == "trace" else "bvh_kernel.cu"
            entries[label] = {
                "name": name, "route": "cuda",
                "source": f"simple_raytracer_tpu_torch/csrc/{src}",
                "replaces": f"simple_raytracer_tpu/ops/pallas/{line}",
                "launches": count, "max_abs_err": max(errs),
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
                "shape": f"config {CELLS[label][0]} (tri_backend="
                         f"{o.tri_backend}), {o.width}x{o.height}, "
                         f"{o.num_samples} spp, {o.num_bounces} bounces",
            }

    # ---- 7: where a step's time goes ----
    for label, (r, camera, _) in renderers.items():
        say(f"[7] cell {label}: {step_breakdown(r, camera)}  [{card}]")

    order = ("2", "3", "5", "5/bvh", "6")
    print(json.dumps({"kernels": [entries[k] for k in order]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
