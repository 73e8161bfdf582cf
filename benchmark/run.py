"""One run of one cell of the port's benchmark.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration, the scene, and a
traffic mix, the frame and the route.  The user is one viewer in a closed
loop: each frame is one ``Renderer.step`` (one progressive pass) then
``Renderer.image()`` (the tonemapped u8 image on the host), back to back.

  set-up   import the program, build the scene (the host BVH, clusters,
           upload), warm every kernel up on the mix's frames, clear the
           canvas.  ``setup_s`` is the time from the start of the run to
           the first measured frame, less the benchmark's own making of
           its inputs (the mesh, cached under benchmark/.cache).
  window   frames until ``--seconds`` have passed; each pass seeded by
           its own RNG time drawn from ``--seed``.  ``mrays_per_s`` is
           W * H * spp * bounces of every frame over the window's wall
           time, ``frame_ms_p95`` the nearest-rank 95th percentile of
           every frame's host time, from the call to ``step`` to
           ``image()`` returning.
  trace    with ``--trace 1``, the same window with the benchmark's
           spans, then ``trace_frames`` more frames under torch.profiler
           (one more before them to warm it); the per-layer metrics are
           read from those (``benchmark/metrics/<name>.py``).
  check    the canvas of pixels drawn from the seed, after every pass of
           the window, and the same pixels of the last frame's image,
           against the plain reference (``reference/``) over the same
           passes and its plain tonemap; each number beside its limit.

The last line of standard output is the result as one JSON object
(``attempted``: the window's frames; ``failed``: all of them when the
check fails, since the canvas sums every pass), with the numbers compared
and their limits last (``checks``) and on the last lines of standard
error.  The run fails, printing no result, without a CUDA card (or with
fewer than the cell asks for), when a profile's events of a launched
kernel do not number the launches the program counted, and when JAX or
the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for _p in (str(BENCH_DIR), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from srtbench import check, profiling, scenes, spec, stats  # noqa: E402
from srtbench.nojax import forbidden_modules  # noqa: E402


class Failed(Exception):
    """A run that cannot give a result: the reason, and the exit code."""

    def __init__(self, reason: str, code: int):
        super().__init__(reason)
        self.code = code


def cache_env(bench_dir: Path = BENCH_DIR) -> None:
    """Kernel and build caches at fixed directories of the checkout."""
    cache = bench_dir / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def program_counts() -> dict:
    """The program's own launch counters, by kernel family."""
    from simple_raytracer_tpu_torch.ops.cuda import (bounce_kernel,
                                                     bvh_kernel, trace_kernel,
                                                     triangle_kernel)
    return {"bvh": bvh_kernel.KERNEL.launches,
            "trace": trace_kernel.KERNEL.launches,
            "shade": bounce_kernel.KERNEL.launches,
            "triangle": triangle_kernel.KERNEL.launches}


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float = T_START, device: str = "cuda",
             root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> dict:
    """Set up, run the window and check one cell; the result's object."""
    import torch

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"], root)
    mix = spec.traffic(cell["traffic"], bench_dir)
    limits = spec.limits(cell_name, bench_dir)
    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_in = time.perf_counter()
    mesh_data = scenes.meshes(cfg, bench_dir / ".cache" / "meshes",
                              bench_dir)
    inputs_s = time.perf_counter() - t_in

    from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
    w, h, spp = mix["width"], mix["height"], mix["samples_per_pass"]
    bounces = cfg["num_bounces"]
    options = RenderOptions(width=w, height=h, num_samples=spp,
                            num_bounces=bounces,
                            tri_backend=mix["tri_backend"],
                            ray_tile=mix["ray_tile"])
    camera = scenes.port_camera(cfg)
    t_scene = time.perf_counter()
    renderer = Renderer(options, scenes.port_scene(cfg, mesh_data),
                        device=device)
    sync()
    scene_build_s = time.perf_counter() - t_scene
    for k in range(mix["warmup_frames"]):
        renderer.step(camera, time=check.pass_time(seed, k, stream=1))
        renderer.image()
    renderer.clear_canvas()
    sync()
    setup_s = time.perf_counter() - t_start - inputs_s

    # the window
    frames, step_s = [], []
    t_window = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        renderer.step(camera, time=check.pass_time(seed, len(frames)))
        t1 = time.perf_counter()
        image = renderer.image()
        t2 = time.perf_counter()
        frames.append((t0, t2))
        step_s.append(t1 - t0)
        if t2 - t_window >= seconds:
            break

    run_info = None
    if trace:
        run_info = traced_frames(renderer, camera, seed, len(frames), mix,
                                 torch, sync)
        run_info.update(scene_build_s=scene_build_s, dispatch_s=step_s)
        image = run_info.pop("image")

    # the check, once the window has closed
    passes = renderer.num_steps
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_pix = w * h
    pixels = check.sample_pixels(seed, n_pix, check.pixel_count(
        mix, passes, spp, n_pix))
    pix_t = torch.as_tensor(pixels, device=device)
    program = renderer.canvas.reshape(-1, 3)[pix_t].cpu().numpy()
    program_image = image.reshape(-1, 3)[pixels]
    del renderer, image
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from reference.tracer import Scene as RefScene, View, render_pixels
    t_ref = time.perf_counter()
    ref_scene = RefScene.from_arrays(scenes.reference_arrays(cfg, mesh_data),
                                     device)
    c = cfg["camera"]
    view = View(tuple(c["position"]), c["yaw"], c["pitch"], c["fov"], w, h,
                spp, bounces)
    times = torch.as_tensor(check.pass_times(seed, passes), device=device)
    reference = render_pixels(ref_scene, view, pix_t, times).cpu().numpy()
    reference_s = time.perf_counter() - t_ref
    numbers = check.compare(program, reference, passes, program_image)
    correct = check.judge(numbers, limits)

    result = {"correct": correct, "attempted": len(frames),
              "failed": 0 if correct else len(frames)}
    if trace:
        result["metrics"], device_extra, breakdown = per_layer(
            bench, cell, cfg, mix, run_info, bench_dir)
    else:
        work = w * h * spp * bounces
        result["metrics"] = end_to_end(bench, cell_name, {
            "mrays_per_s": stats.window_rate(frames, work) / 1e6,
            "frame_ms_p95": stats.percentile(stats.frame_ms(frames), 95),
            "setup_s": setup_s})
        device_extra, breakdown = {}, None
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": cell["chips"], "memory_peak_bytes": int(peak),
        **device_extra}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["info"] = {"frames": len(frames), "passes": passes,
                      "pixels_checked": int(pixels.size),
                      "scene_build_s": scene_build_s, "inputs_s": inputs_s,
                      "reference_s": reference_s,
                      "card": card_power_limit() if cuda else ""}
    result["checks"] = {k: {"value": numbers[k], "limit": v["limit"]}
                        for k, v in limits.items()}
    return result


def traced_frames(renderer, camera, seed, first, mix, torch, sync) -> dict:
    """``trace_frames`` frames under torch.profiler, after one frame that
    warms it; the benchmark's spans around the program's calls."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    n = mix["trace_frames"]
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=n, repeat=1)
                 ) as prof:
        for k in range(n + 1):
            if k == 1:
                before = program_counts()
                t_a = time.perf_counter()
            with record_function("bench.step"):
                renderer.step(camera, time=check.pass_time(seed, first + k))
            with record_function("bench.image"):
                image = renderer.image()
            if k == n:
                t_b = time.perf_counter()
                after = program_counts()
            prof.step()
    sync()
    profile_ = profiling.parse(prof.events())
    launched = {f: after[f] - before[f] for f in after}
    return {"profile": profile_, "frames": n, "window_s": t_b - t_a,
            "launched": launched, "image": image}


def end_to_end(bench, cell_name, values) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec.metrics(bench, cell_name, trace=False)}


def per_layer(bench, cell, cfg, mix, info, bench_dir):
    """(metrics, device's busy_s and window_s, breakdown) of a traced
    run; raises Failed where the profile cannot be read."""
    prof = info["profile"]
    reasons = profiling.guard(prof, info["launched"])
    if reasons:
        raise Failed("; ".join(reasons), 3)
    busy = profiling.busy_seconds(prof.ops)
    run = profiling.TraceRun(
        config=cfg, traffic=mix, width=mix["width"], height=mix["height"],
        num_samples=mix["samples_per_pass"], num_bounces=cfg["num_bounces"],
        frames=info["frames"], profile=prof, window_s=info["window_s"],
        busy_s=busy, dispatch_s=info["dispatch_s"],
        scene_build_s=info["scene_build_s"], launched=info["launched"])
    metrics = {}
    for m in spec.metrics(bench, cell["name"], trace=True):
        value = spec.reader(m["name"], bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = {"device_ops": profiling.device_ops(prof.ops),
                 "idle_gaps": profiling.idle_gaps(prof)}
    return metrics, {"busy_s": busy, "window_s": info["window_s"]}, breakdown


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    try:
        import torch
        need = spec.cell(spec.load_benchmark(), args.workload)["chips"]
        if not torch.cuda.is_available():
            raise Failed("no CUDA device: the benchmark measures the card", 2)
        if torch.cuda.device_count() < need:
            raise Failed(f"the cell needs {need} CUDA device(s), "
                         f"{torch.cuda.device_count()} found", 2)
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
        found = forbidden_modules(sys.modules)
        if found:
            raise Failed("loaded in the measuring process: "
                         + ", ".join(found), 4)
    except Failed as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return exc.code
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
