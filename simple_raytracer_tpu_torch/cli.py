"""Command-line renderer: a scene file or a preset config to PNG or PPM.

    python -m simple_raytracer_tpu_torch.cli --config 2 --out out.png
    srt-render-torch --scene scene.json --device cpu --out out.ppm

The port's counterpart of ``simple_raytracer_tpu.cli`` (``srt-render``),
with its flags but those of the multi-device slice (``--all-devices``,
``--distributed``, ``--coordinator``, ``--num-processes``,
``--process-id``), which it does not accept yet.  ``--device`` (default
``cuda``) takes the place of ``JAX_PLATFORMS``: without a card the CLI
exits non-zero unless it is given ``--device cpu``, which renders with
the kernels' plain PyTorch versions.  ``--warm`` builds the render
path's kernels (``ops/cuda/build.py``) and runs one pass, writing
nothing.  Checkpoints (``--save-state``, ``--load-state``) hold the JAX
CLI's ``.npz`` keys, ``canvas`` and ``num_steps``, so either package
resumes the other's.
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
                   help="print per-run throughput metrics JSON")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace (Chrome format) "
                        "into this directory")
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

    import numpy as np
    import torch

    if args.device.split(":")[0] == "cuda" and not torch.cuda.is_available():
        return _error("CUDA is not available; pass --device cpu to render "
                      "with the plain PyTorch versions", 1)

    from .engine import Renderer
    from .io.image import load_skybox, save_png, save_ppm
    from .models.camera import Camera
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
    )
    r = Renderer(options, scene=scene, device=args.device)

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

    if args.out.lower().endswith((".ppm", ".pnm")):
        save_ppm(args.out, img)
    else:
        save_png(args.out, img)
    if args.save_state:
        st = r.state_dict()
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
        print(json.dumps(m))
    print(f"wrote {args.out} ({r.num_steps} accumulated steps)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
