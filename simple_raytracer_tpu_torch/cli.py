"""Command-line renderer: a scene file or a preset config to PNG or PPM.

    python -m simple_raytracer_tpu_torch.cli --config 2 --out out.png
    srt-render-torch --scene scene.json --device cpu --out out.ppm

The port's counterpart of ``simple_raytracer_tpu.cli`` (``srt-render``),
with its flags.  ``--device`` (default ``cuda``) takes the place of
``JAX_PLATFORMS``: without a card the CLI exits non-zero unless it is
given ``--device cpu``, which renders with the kernels' plain PyTorch
versions.  ``--all-devices`` renders in horizontal bands over every local
card (``parallel/``; with ``--device cpu``, one band on the CPU), and
``--distributed`` joins a multi-process render before any device is used
(``--coordinator host:port``, ``--num-processes``, ``--process-id``, or
torchrun's environment): under both flags every process renders its
bands on its own card, and only process 0 writes the image and the
checkpoint, which hold the whole image:

    srt-render-torch --config 2 --all-devices --distributed \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0 ...

``--warm`` builds the render path's kernels (``ops/cuda/build.py``) and
runs one pass, writing nothing.  Checkpoints (``--save-state``,
``--load-state``) hold the JAX CLI's ``.npz`` keys, ``canvas`` and
``num_steps``, so either package resumes the other's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time as _time

PROG = "srt-render-torch"


def _positive_seed(v):
    iv = int(v)
    if iv < 1:
        # time=0 collapses every pixel's RNG stream to seed 0
        raise argparse.ArgumentTypeError("--time-seed must be >= 1")
    return iv


def build_parser() -> argparse.ArgumentParser:
    from .models.presets import CONFIGS
    from .ops.trace import AOVS, TRI_BACKENDS

    p = argparse.ArgumentParser(
        prog=PROG, description="Progressive path tracer on PyTorch and "
                               "CUDA (the port of srt-render)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="scene JSON file (io.scene_json format)")
    src.add_argument("--config", type=int, choices=sorted(CONFIGS),
                     help="built-in preset config number")
    p.add_argument("--out", default="out.png",
                   help="output image (.png, or .ppm/.pnm)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--samples", type=int, default=None,
                   help="samples/pixel/step")
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--steps", type=int, default=16,
                   help="progressive accumulation steps")
    p.add_argument("--show-normals", action="store_true",
                   help="the normals view (the same as --aov normals)")
    p.add_argument("--aov", choices=list(AOVS), default=None,
                   help="first-hit AOV render target instead of the "
                        "path-traced image (depth = 1/(1+t) grayscale, "
                        "albedo = hit material color)")
    p.add_argument("--mesh-path", default=None,
                   help="STL/OBJ file for the mesh configs (4 to 6)")
    p.add_argument("--skybox", default=None,
                   help="equirect skybox image file (.hdr, or 8-bit "
                        "through PIL)")
    p.add_argument("--tri-backend", choices=list(TRI_BACKENDS),
                   default="auto", help="triangle intersection route")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; the hand-written "
                        "kernels) or cpu (their plain PyTorch versions)")
    p.add_argument("--time-seed", type=_positive_seed, default=None,
                   help="RNG time seed, >= 1 (default: deterministic "
                        "counter)")
    p.add_argument("--all-devices", action="store_true",
                   help="render in horizontal pixel bands over every local "
                        "card (bit-identical output)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process render: join the process group "
                        "before device use (with --all-devices the bands "
                        "span every process's card; only process 0 writes "
                        "files)")
    p.add_argument("--coordinator", default=None,
                   help="--distributed: process 0's host:port (default: "
                        "torchrun's MASTER_ADDR and MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="--distributed: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="--distributed: this process's rank")
    p.add_argument("--wall-clock-seed", action="store_true",
                   help="seed from the ms clock like the reference app")
    p.add_argument("--save-state", default=None,
                   help="write accumulation checkpoint (.npz)")
    p.add_argument("--load-state", default=None,
                   help="resume accumulation checkpoint (.npz)")
    p.add_argument("--warm", action="store_true",
                   help="build the render path's kernels and run one "
                        "pass, then exit without writing anything")
    p.add_argument("--metrics", action="store_true",
                   help="print per-run throughput metrics JSON, with the "
                        "program's counters over the run (the rays each "
                        "bounce spans and those alive, the BVH compaction's "
                        "rays and admitted rays)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace (Chrome format) "
                        "into this directory, with the program's srt.* "
                        "spans (the pass, each bounce's stages, the BVH "
                        "launch, the image)")
    return p


def warm_kernels() -> list:
    """Build the render path's kernels at once (one nvcc each); returns
    the sources built."""
    from .ops.cuda import (bounce_kernel, bvh_kernel, trace_kernel,
                           triangle_kernel)
    from .ops.cuda.build import build_all
    kernels = [m.KERNEL for m in (trace_kernel, bvh_kernel, bounce_kernel,
                                  triangle_kernel)]
    build_all(kernels)
    return [k.source.name for k in kernels]


def _error(msg: str, rc: int) -> int:
    print(f"{PROG}: error: {msg}", file=sys.stderr)
    return rc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if args.device.split(":")[0] == "cuda" and not torch.cuda.is_available():
        return _error("CUDA is not available; pass --device cpu to render "
                      "with the plain PyTorch versions", 1)
    from .parallel import distributed
    if args.distributed:
        # before the first device is used in this process
        distributed.initialize(args.coordinator, args.num_processes,
                               args.process_id)
    rc = _render(args)
    if args.distributed:
        distributed.shutdown()
    return rc


def _render(args) -> int:
    """Build the scene and the renderer, render, write the files."""
    import numpy as np
    import torch

    from .engine import Renderer
    from .io.image import load_skybox, save_png, save_ppm
    from .models.camera import Camera
    from .parallel import distributed
    from .utils import metrics as srt_metrics
    from .utils.metrics import profiler_trace, ray_throughput

    if args.scene:
        if not os.path.exists(args.scene):
            return _error(f"scene file not found: {args.scene}", 2)
        from .engine import RenderOptions
        from .io.scene_json import load_scene
        scene, camera = load_scene(args.scene)
        if camera is None:
            camera = Camera()
        options = RenderOptions()
    else:
        from .models.presets import CONFIGS
        kwargs = {}
        if args.config in (4, 5, 6) and args.mesh_path:
            kwargs["mesh_path"] = args.mesh_path
        scene, camera, options = CONFIGS[args.config](**kwargs)

    if args.skybox:
        scene.skybox = load_skybox(args.skybox)

    # replace, not rebuild: the preset's other fields (ray_tile, tri_chunk)
    # carry over
    options = dataclasses.replace(
        options,
        width=args.width or options.width,
        height=args.height or options.height,
        num_samples=args.samples or options.num_samples,
        num_bounces=args.bounces or options.num_bounces,
        show_normals=args.show_normals,
        aov=args.aov,
        tri_backend=args.tri_backend,
        all_devices=args.all_devices,
    )
    device = args.device
    if device == "cuda" and args.all_devices:
        device = None           # every local card, or this process's
    elif device == "cuda" and args.distributed:
        device = distributed.process_device()
    r = Renderer(options, scene=scene, device=device)
    if args.all_devices:
        print(f"{PROG}: {r.num_devices} band(s) over "
              + ", ".join(str(d) for d in r.devices)
              + ("" if not distributed.is_multiprocess() else
                 f" in process {distributed.process_index()} of "
                 f"{distributed.process_count()}"), file=sys.stderr)

    if args.warm:
        t0 = _time.perf_counter()
        built = warm_kernels() if r.device.type == "cuda" else []
        r.step(camera, time=1)
        r.image()
        dt = _time.perf_counter() - t0
        what = (f"kernels built: {', '.join(built)}" if built
                else f"no kernel on {r.device}: the plain versions")
        print(f"warmed {options.width}x{options.height} "
              f"s{options.num_samples} b{options.num_bounces} in {dt:.1f}s "
              f"({what})", file=sys.stderr)
        return 0

    if args.load_state:
        data = np.load(args.load_state)
        r.load_state_dict({"canvas": data["canvas"],
                           "num_steps": int(data["num_steps"])})

    counting = args.metrics and not srt_metrics.counters(True)
    t0 = _time.perf_counter()
    prev_ms = 0
    with profiler_trace(args.profile_dir):
        for _ in range(args.steps):
            if args.wall_clock_seed:
                # monotonic: identical timestamps would repeat a pass's
                # RNG streams
                t = max(prev_ms + 1, int(_time.time() * 1000)) & 0xFFFFFFFF
                t = t or 1
                prev_ms = t
            elif args.time_seed is not None:
                # offset by the restored step count, so a resumed render
                # does not repeat the first run's seeds
                t = args.time_seed + r.num_steps
            else:
                t = None
            r.step(camera, time=t)
        img = r.image()         # a copy to the host: the passes have ended
    dt = _time.perf_counter() - t0

    write_files = distributed.should_write_output()
    if write_files:
        if args.out.lower().endswith((".ppm", ".pnm")):
            save_ppm(args.out, img)
        else:
            save_png(args.out, img)
    if args.save_state:
        # every process runs state_dict (a collective across processes);
        # process 0 writes it
        st = r.state_dict()
        if write_files:
            np.savez_compressed(args.save_state, canvas=st["canvas"],
                                num_steps=st["num_steps"])
    if args.metrics:
        m = ray_throughput(options.width, options.height,
                           options.num_samples * args.steps,
                           options.num_bounces, dt)
        # per step, as benchmark_step reports it; dt is the whole run
        m["seconds_per_step"] = dt / max(args.steps, 1)
        m["total_seconds"] = dt
        m["steps"] = args.steps
        m["device"] = (torch.cuda.get_device_name(r.device)
                       if r.device.type == "cuda" else "cpu")
        m["counters"] = srt_metrics.read()
        print(json.dumps(m))
    if counting:
        srt_metrics.counters(False)
    if write_files:
        print(f"wrote {args.out} ({r.num_steps} accumulated steps)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
