"""The program's spans and counters read over a cell's scene and mix,
and what turning the spans on costs.

    python3 benchmark/span_readings.py [--seed N] [--reps N] [--out FILE]
        [--cpu] [cell ...]

For each cell (all of ``BENCHMARK.json``'s by default): the warm-up
frames, then ``reps`` rounds of four blocks of ``trace_frames`` profiled
frames (spans off, on, on, off), each block read as ``run.py`` reads its
traced frames (``torch_ops_ms``, ``image_ms``, the device's busy ms) and
the spans-on blocks also by program span (``srtbench/spans.py``: the
designed per-layer metrics, device ms by span and by bounce, idle ms by
gap name, host ms by span); then 2 frames outside the profiler with the
counters on (``bounce_live_share``, ``bvh_admit_share``); then untraced
blocks with spans off and on in turns.  One JSON line a cell on stdout;
``--out`` writes every block's readings.  ``--cpu`` rehearses at 64x32
on the CPU (no device time).  Needs a program with ``utils.metrics.spans``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run as bench_run  # noqa: E402
from srtbench import check, profiling, scenes, spans, spec  # noqa: E402


def setup(cell_name, seed, cpu):
    import torch

    from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"], ROOT)
    mix = spec.traffic(cell["traffic"], BENCH)
    if cpu:
        mix.update(width=64, height=32, trace_frames=2, warmup_frames=1)
    mesh = scenes.meshes(cfg, BENCH / ".cache" / "meshes", BENCH)
    opts = RenderOptions(width=mix["width"], height=mix["height"],
                         num_samples=mix["samples_per_pass"],
                         num_bounces=cfg["num_bounces"],
                         tri_backend=mix["tri_backend"],
                         ray_tile=mix["ray_tile"])
    cam = scenes.port_camera(cfg)
    r = Renderer(opts, scenes.port_scene(cfg, mesh),
                 device="cpu" if cpu else "cuda")
    for k in range(mix["warmup_frames"]):
        r.step(cam, time=check.pass_time(seed, k, stream=1))
        r.image()
    if not cpu:
        torch.cuda.synchronize()
    return r, cam, mix


def profiled(r, cam, n, seed, first, cpu):
    """``run.traced_frames``' loop: n frames profiled after one that warms
    the profiler; (events, host ms a frame)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    acts = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=n, repeat=1)
                 ) as prof:
        for k in range(n + 1):
            if k == 1:
                t_a = time.perf_counter()
            with record_function("bench.step"):
                r.step(cam, time=check.pass_time(seed, first + k))
            with record_function("bench.image"):
                r.image()
            if k == n:
                t_b = time.perf_counter()
            prof.step()
    if not cpu:
        torch.cuda.synchronize()
    return prof.events(), (t_b - t_a) / n * 1e3


def read_block(events, frames, with_spans):
    prof = profiling.parse(events)

    def ms(keep):
        ops = [o for o in prof.ops if keep(o)]
        return sum(o.dur_us for o in ops) / 1e3 / frames if ops else None

    out = {"torch_ops_ms": ms(lambda o: o.span == "step"
                              and o.family is None),
           "image_ms": ms(lambda o: o.span == "image"),
           "busy_ms": profiling.busy_seconds(prof.ops) * 1e3 / frames}
    if not with_spans:
        return out
    ops = spans.attribute(events)
    srt = spans.host_spans(events)
    host = {}
    for start, end, name in srt:
        k = "srt.bounce.*" if name.startswith("srt.bounce.") else name
        host.setdefault(k, []).append((end - start) / 1e3)
    out.update(
        shade_torch_ms=spans.shade_torch_ms(ops, frames),
        nearest_prims_ms=spans.nearest_prims_ms(ops, frames),
        pass_prologue_ms=spans.pass_prologue_ms(events),
        prologues_ms=spans.prologues_ms(events),
        device_ms_by_span=spans.by_span(ops, frames),
        torch_ms_by_bounce=spans.torch_by_bounce(ops, frames),
        idle_ms_by_gap_name=spans.idle_by_name(prof, srt, frames),
        top_gaps=spans.idle_gaps(prof, srt),
        host_ms_by_span={k: sum(v) / frames for k, v in host.items()})
    return out


def cell_run(name, seed, reps, cpu):
    import torch

    from simple_raytracer_tpu_torch.utils import metrics
    t0 = time.perf_counter()
    r, cam, mix = setup(name, seed, cpu)
    n = mix["trace_frames"]
    res = {"cell": name, "setup_s": time.perf_counter() - t0,
           "blocks": [], "frame_ms": {"off": [], "on": []}}
    first = mix["warmup_frames"]
    for _ in range(reps):
        for mode in ("off", "on", "on", "off"):
            metrics.spans(mode == "on")
            try:
                events, per = profiled(r, cam, n, seed, first, cpu)
            finally:
                metrics.spans(False)
            first += n + 1
            res["frame_ms"][mode].append(per)
            res["blocks"].append({"spans": mode, "frame_ms": per,
                                  **read_block(events, n, mode == "on")})
            del events
    metrics.counters(True)
    try:
        for k in range(2):
            r.step(cam, time=check.pass_time(seed, first + k))
            r.image()
        res["counters"] = metrics.read()
    finally:
        metrics.counters(False)
    first += 2
    res.update(spans.shares(res["counters"]))
    untraced = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off") * 2:
        metrics.spans(mode == "on")
        try:
            if not cpu:
                torch.cuda.synchronize()
            ta = time.perf_counter()
            for k in range(n):
                r.step(cam, time=check.pass_time(seed, first + k))
                r.image()
            if not cpu:
                torch.cuda.synchronize()
        finally:
            metrics.spans(False)
        first += n
        untraced[mode].append((time.perf_counter() - ta) / n * 1e3)
    res["untraced_frame_ms"] = untraced
    del r
    if not cpu:
        torch.cuda.empty_cache()
    return res


def summary(res):
    """The cell's line: medians over blocks, and each block's torch_ops_ms
    with spans off and on."""
    on = [b for b in res["blocks"] if b["spans"] == "on"]

    def med(blocks, key):
        v = [b[key] for b in blocks if b.get(key) is not None]
        return statistics.median(v) if v else None

    keys = ("shade_torch_ms", "nearest_prims_ms", "pass_prologue_ms")
    return {
        "cell": res["cell"],
        **{k: med(on, k) for k in keys},
        "bounce_live_share": res["bounce_live_share"],
        "bvh_admit_share": res["bvh_admit_share"],
        "counters": res["counters"],
        "traced_frame_ms_median": {k: statistics.median(v) for k, v in
                                   res["frame_ms"].items()},
        "untraced_frame_ms_median": {
            k: statistics.median(v)
            for k, v in res["untraced_frame_ms"].items()},
        "torch_ops_ms_blocks": [[b["spans"], b["torch_ops_ms"]]
                                for b in res["blocks"]],
        "busy_ms_blocks": [[b["spans"], b["busy_ms"]]
                           for b in res["blocks"]],
        "device_ms_by_span": dict(list(on[-1]["device_ms_by_span"].items()
                                       )[:12]),
        "idle_ms_by_gap_name": dict(list(
            on[-1]["idle_ms_by_gap_name"].items())[:6]),
        "host_ms_by_span": on[-1]["host_ms_by_span"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="*")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 26026)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    bench_run.cache_env()
    cells = args.cells or [c["name"] for c in
                           spec.load_benchmark(ROOT)["workloads"]]
    card = "cpu" if args.cpu else bench_run.card_power_limit()
    print(json.dumps({"card": card}), flush=True)
    out = {"card": card, "seed": args.seed, "cells": {}}
    for name in cells:
        res = cell_run(name, args.seed, args.reps, args.cpu)
        out["cells"][name] = res
        print(json.dumps(summary(res)), flush=True)
        if args.out:
            Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
