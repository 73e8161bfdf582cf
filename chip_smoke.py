#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root:

    python3 chip_smoke.py

Phases, one line each on stdout:
  1. the card's name and power limit (nvidia-smi);
  2. the build of the whole-trace kernel (nvcc into build/, via ctypes);
  3. the main path: configs 1 to 5 at their preset sizes through
     Renderer(device="cuda"), 4 progressive steps each, with the kernel's
     launch counts (in all and per triangle variant) reset just before
     and read just after;
  4. the kernel against its plain PyTorch version on the card, one pass of
     each config at full size;
  5. the golden-size renders (tests/test_golden.py) against
     tests/goldens/config{1..5}.npz;
  6. timings with CUDA events, and the kernel's bound;
  7. where a Renderer.step's time goes (torch.profiler).
Then one JSON line per the kernel table (the whole-trace kernel, timed on
config 2, and its two triangle variants, timed on configs 3 and 5), the
card line again, and the last line {"ok": true, "device": {...}}.  Any
failed phase exits non-zero before the last line.  Without CUDA it exits
1 and prints no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops.camera import camera_rotation
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel as tk

STEPS = 4                      # progressive steps on the main path
CONFIG_IDS = (1, 2, 3, 4, 5)
KWARGS = {3: {"skybox": "gradient"}}        # as tests/test_golden.py
VARIANTS = {1: "none", 2: "none", 3: "small", 4: "clustered",
            5: "clustered"}
GOLDEN_SIZES = {1: (64, 64), 2: (96, 54), 3: (96, 54), 4: (96, 54),
                5: (96, 54)}                # tests/test_golden.py
GOLDEN_STEPS, GOLDEN_TIME0 = 2, 1000
GOLDEN_RMSE = 2e-3             # tests/test_golden.py's bound
# Kernel vs plain version: the kernel repeats the plain version's float
# operations in the same order (--fmad=false, no fast math), so the
# canvases should agree to the last bit; a branch that flips on a one-ulp
# difference (a Bernoulli draw at its threshold, the one fma the plain
# version emulates in f64) can move a whole path, so the bound is on the
# RMSE and on the share of pixels that differ, not on the maximum.
KERNEL_RMSE = 1e-4
KERNEL_DIFF_SHARE = 1e-3       # share of pixels more than 1e-3 apart
HAZARD_MAX = 8                 # non-finite pixels allowed (ln(0) draws)
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


# Float operations of the kernel, counted from csrc/trace_kernel.cu (adds,
# subtracts, multiplies, divides, square roots, min/max; an fma counts 2;
# the integer hash and compares are left out, so the bound is a floor).
RAYGEN_FLOPS = 42          # 2 uniforms, NDC, screen, rotate, normalize
SPHERE_FLOPS = 21          # one sphere test
PLANE_FLOPS = 14           # one plane test
MT_FLOPS = 46              # one Moller-Trumbore test (mt_update)
SLAB_FLOPS = 24            # one cluster box's slab test, without the margin
INV_DIR_FLOPS = 3          # the reciprocal direction of the traversal
SHADE_FLOPS = 30           # position, normal, front flip, emission
BSDF_FLOPS = 275           # 3 normals (log, cos), 3 uniforms, mixes
SKY_FLOPS = 54             # the gradient sky and the final add


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
    variant = tk.tri_variant(scene)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    card = card_line()
    say(f"[1] card: {card}")

    t0 = time.perf_counter()
    tk.KERNEL.library()
    # ptxas reports each template instance after its "entry function"
    # line; trace_kernel<0|1|2> are the variants of tk.TRI_MODES
    modes = {str(v): k for k, v in tk.TRI_MODES.items()}
    parts, variant = [], None
    for line in tk.KERNEL.build_log.splitlines():
        m = re.search(r"entry function '.*trace_kernelILi(\d)E", line)
        if m:
            variant = modes.get(m.group(1), m.group(1))
        elif "registers" in line or "spill" in line:
            parts.append(f"{variant}: "
                         + line.split("ptxas info    : ")[-1].strip())
    ptxas = "; ".join(parts)
    say(f"[2] build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, ctypes); "
        f"ptxas: {ptxas or 'no ptxas report'}")

    # ---- 3: the main path ----
    renderers = {}
    for n in CONFIG_IDS:
        scene, camera, options = CONFIGS[n](**KWARGS.get(n, {}))
        renderers[n] = (Renderer(options, scene, device="cuda"), camera)
    tk.KERNEL.reset_counts()
    for n, (r, camera) in renderers.items():
        for _ in range(STEPS):
            r.step(camera)
    torch.cuda.synchronize()
    launches = tk.KERNEL.launches
    variant_launches = dict(tk.KERNEL.variant_launches)
    want = {v: STEPS * list(VARIANTS.values()).count(v)
            for v in set(VARIANTS.values())}
    say(f"[3] launches: {launches} in all, per triangle variant "
        f"{variant_launches} (want {want})")
    if launches != STEPS * len(renderers) or variant_launches != want:
        fail(f"main path launched the kernel {launches} times "
             f"({variant_launches}), want {STEPS * len(renderers)} ({want})")
    for n, (r, camera) in renderers.items():
        o = r.options
        canvas = r.canvas
        bad = int((~torch.isfinite(canvas).all(dim=-1)).sum())
        img = r.image()
        say(f"[3] config {n} {o.width}x{o.height} spp={o.num_samples} "
            f"bounces={o.num_bounces}: {STEPS} steps, variant "
            f"{tk.tri_variant(r.device_scene)}, non-finite (ln 0 hazard) pixels={bad}, "
            f"image {img.shape} {img.dtype} min={img.min()} max={img.max()} "
            f"mean={img.mean():.3f}  [{card}]")
        if bad > HAZARD_MAX:
            fail(f"config {n}: {bad} non-finite pixels")
        if img.shape != (o.height, o.width, 3) or img.dtype != np.uint8:
            fail(f"config {n}: image {img.shape} {img.dtype}")
        if img.min() == img.max():
            fail(f"config {n}: constant image")

    # ---- 4: kernel vs plain version, full size, one pass ----
    results = {}
    for n, (r, camera) in renderers.items():
        args, kw = trace_args(r, camera, 4242)
        k = torch.stack(list(tk.trace_full(*args, **kw)))
        segments = []
        p = torch.stack(list(tk.trace_full_plain(*args, **kw,
                                                 segments=segments)))
        torch.cuda.synchronize()
        both = torch.isfinite(k) & torch.isfinite(p)
        same_bad = bool((torch.isfinite(k) == torch.isfinite(p)).all())
        err = (k - p).abs()[both]
        max_abs = float(err.max()) if err.numel() else 0.0
        s = r.options.num_samples
        kp = k.reshape(3, -1, s).mean(dim=2)
        pp = p.reshape(3, -1, s).mean(dim=2)
        ok = torch.isfinite(kp).all(0) & torch.isfinite(pp).all(0)
        d = (kp - pp)[:, ok]
        rmse = float(d.pow(2).mean().sqrt())
        share = float(((kp - pp).abs() > 1e-3).any(0)[ok].float().mean())
        bitexact = bool(torch.equal(k[both], p[both]))
        results[n] = dict(max_abs=max_abs, segments=segments, args=args,
                          kw=kw, n_rays=k.shape[1])
        say(f"[4] config {n} kernel vs plain: rmse={rmse:.3e} "
            f"share>1e-3={share:.3e} max_abs={max_abs:.3e} "
            f"bit-identical={bitexact} non-finite masks agree={same_bad} "
            f"segments(live,hit,triangle hit)={segments}  [{card}]")
        if not (rmse <= KERNEL_RMSE and share <= KERNEL_DIFF_SHARE
                and same_bad):
            fail(f"config {n}: kernel disagrees with the plain version")

    # ---- 5: golden-size renders against the JAX package's goldens ----
    for n, (w, h) in GOLDEN_SIZES.items():
        scene, camera, options = CONFIGS[n](width=w, height=h,
                                            **KWARGS.get(n, {}))
        r = Renderer(RenderOptions(width=w, height=h,
                                   num_samples=options.num_samples,
                                   num_bounces=options.num_bounces),
                     scene, device="cuda")
        for i in range(GOLDEN_STEPS):
            r.step(camera, time=GOLDEN_TIME0 + i)
        canvas = r.canvas.cpu().numpy()
        golden = np.load(f"tests/goldens/config{n}.npz")["canvas"]
        rmse = float(np.sqrt(np.mean((canvas - golden) ** 2)))
        say(f"[5] config {n} {w}x{h} vs tests/goldens/config{n}.npz: "
            f"rmse={rmse:.3e} (bound {GOLDEN_RMSE})")
        if canvas.shape != golden.shape or not np.isfinite(canvas).all() \
                or not rmse < GOLDEN_RMSE:
            fail(f"config {n}: golden rmse {rmse}")

    # ---- 6: timings ----
    entries = {}
    timed = {2: ("trace_kernel", "bounce_kernel.py:659", launches),
             3: ("tris_small", "bounce_kernel.py:238",
                 variant_launches["small"]),
             5: ("tris_clustered", "bounce_kernel.py:291",
                 variant_launches["clustered"])}
    for n, (r, camera) in renderers.items():
        res = results[n]
        args, kw = res["args"], res["kw"]
        o = r.options
        n_rays = res["n_rays"]
        # the kernel alone: arguments packed once, 50 launches per batch
        # (the host issues a launch in far less time than the kernel runs)
        prep = tk.prepare(*args, **kw)
        out = torch.empty((3, n_rays), dtype=torch.float32, device="cuda")
        k_all = cuda_ms(lambda: tk.launch(prep, out), iters=50)
        w_all = cuda_ms(lambda: tk.trace_full(*args, **kw), iters=20)
        dense_mesh = r.device_scene.triangles.material.shape[0] > 64
        p_all = cuda_ms(lambda: tk.trace_full_plain(*args, **kw),
                        iters=1 if dense_mesh else 2, repeats=3, warmup=1)
        s_all = [r.benchmark_step(camera, iters=20)["seconds_per_step"] * 1e3
                 for _ in range(5)]
        k_ms, w_ms, p_ms, step_ms = (float(np.median(v))
                                     for v in (k_all, w_all, p_all, s_all))
        flops = kernel_flops(r.device_scene, n_rays, res["segments"])
        out_bytes = 12.0 * n_rays
        t_ops, t_bytes = flops / FP32_PEAK * 1e3, out_bytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        segs = sum(seg[0] for seg in res["segments"])
        say(f"[6] config {n} {o.width}x{o.height}: kernel {k_ms:.4f} ms/pass "
            f"({spread(k_all)}; {n_rays / k_ms / 1e3:.1f} Mrays/s primary, "
            f"{segs / k_ms / 1e3:.1f} M segments/s); with the wrapper's "
            f"per-pass packing {w_ms:.4f} ms ({spread(w_all)}); "
            f"plain {p_ms:.3f} ms/pass "
            f"({spread(p_all)}; {n_rays / p_ms / 1e3:.2f} Mrays/s); "
            f"Renderer.benchmark_step {step_ms:.4f} ms/pass ({spread(s_all)}); "
            f"bound {bound_ms:.4f} ms "
            f"({flops:.4g} FLOP / 67 TFLOP/s; {out_bytes:.4g} B / 3.35 TB/s "
            f"= {t_bytes:.4f} ms), {bound_ms / k_ms * 100:.1f}% of bound  "
            f"[{card}]")
        if n in timed:
            name, line, count = timed[n]
            errs = [v["max_abs"] for m, v in results.items()
                    if name == "trace_kernel"
                    or VARIANTS[m] == VARIANTS[n]]
            entries[n] = {
                "name": name, "route": "cuda",
                "source": "simple_raytracer_tpu_torch/csrc/trace_kernel.cu",
                "replaces": f"simple_raytracer_tpu/ops/pallas/{line}",
                "launches": count, "max_abs_err": max(errs),
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
                "shape": f"config {n}, {o.width}x{o.height}, "
                         f"{o.num_samples} spp, {o.num_bounces} bounces",
            }

    # ---- 7: where a step's time goes ----
    for n, (r, camera) in renderers.items():
        say(f"[7] config {n}: {step_breakdown(r, camera)}  [{card}]")

    print(json.dumps({"kernels": [entries[n] for n in sorted(entries)]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
