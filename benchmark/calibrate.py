"""Readings that set a cell's limits (not part of a benchmark run).

  python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
      --passes <N>

Reads the control on each seed: the reference itself put in the
program's place, computed in bfloat16 (the precision below the
configuration's float32), its image the plain tonemap of its canvas,
compared with the float32 reference by the run's own numbers, over the
pixels and the N passes that a run of that many passes checks.  Each
reading is one JSON line on standard output.  The program's own readings
are its runs' (``run.py``), whose last line holds the numbers compared.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for _p in (str(BENCH_DIR), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from reference.tonemap import tonemap_u8  # noqa: E402
from reference.tracer import Scene as RefScene, View, render_pixels  # noqa
from srtbench import check, scenes, spec  # noqa: E402


def _pieces(cell_name, root, bench_dir):
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"], root)
    mix = spec.traffic(cell["traffic"], bench_dir)
    return cfg, mix, scenes.meshes(cfg, bench_dir / ".cache" / "meshes",
                                   bench_dir)


def _view(cfg, mix):
    c = cfg["camera"]
    return View(tuple(c["position"]), c["yaw"], c["pitch"], c["fov"],
                mix["width"], mix["height"], mix["samples_per_pass"],
                cfg["num_bounces"])


def _checked(seed, passes, mix, device):
    n_pix = mix["width"] * mix["height"]
    pixels = check.sample_pixels(seed, n_pix, check.pixel_count(
        mix, passes, mix["samples_per_pass"], n_pix))
    times = torch.as_tensor(check.pass_times(seed, passes), device=device)
    return torch.as_tensor(pixels, device=device), times


def control_readings(cfg, mix, mesh_data, seeds, passes, device,
                     dtype=torch.bfloat16):
    """The control's numbers on each seed: the reference in ``dtype``
    against the reference in float32."""
    arrays = scenes.reference_arrays(cfg, mesh_data)
    ref32 = RefScene.from_arrays(arrays, device)
    low = RefScene.from_arrays(arrays, device, dtype)
    view = _view(cfg, mix)
    out = []
    for seed in seeds:
        pix, times = _checked(seed, passes, mix, device)
        a = render_pixels(ref32, view, pix, times).cpu().numpy()
        b = render_pixels(low, view, pix, times).cpu().numpy()
        image = tonemap_u8(b, passes)[0]
        out.append(dict(seed=seed, passes=passes, pixels=int(pix.numel()),
                        **check.compare(b, a, passes, image)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--passes", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    cfg, mix, mesh_data = _pieces(args.workload, ROOT, BENCH_DIR)
    t0 = time.perf_counter()
    for r in control_readings(cfg, mix, mesh_data, seeds, args.passes,
                              args.device):
        print(json.dumps(dict(cell=args.workload, kind="control", **r)),
              flush=True)
    print(f"control: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
