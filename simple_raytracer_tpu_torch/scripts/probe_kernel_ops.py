"""Hopper counterparts of the TPU lowering probes of
``scripts/probe_kernel_ops.py`` (``run``, ``kernel_a``/``_b``/``_c``):
what a per-cluster decision of the BVH walk costs on the card.

Each probe is a kernel of ``csrc/probe_kernel.cu``, one thread block over
a (512, 128) f32 array of ones:
  A  the sum through 128 dynamically indexed column reads of a
     shared-memory copy, broadcast to the output;
  B  the same sum through a (128,) shared scratch of column sums read one
     scalar at a time;
  C  a 128-step loop gated by a block vote (``col > 2``) that never fires:
     the output is zeros.
``probe`` launches one on a CUDA tensor (its plain version on a CPU
tensor); ``run`` times each with CUDA events, per call and per loop
iteration, and holds its output to the plain version.  Run on the card:

    python -m simple_raytracer_tpu_torch.scripts.probe_kernel_ops
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.cuda.build import PACKAGE_DIR, Kernel

SOURCE = PACKAGE_DIR / "csrc" / "probe_kernel.cu"
ROWS, COLS = 512, 128
# probe -> (the CUDA source's Probe, its loop's trip count a call, what it
# measures)
PROBES = {
    "A": (0, 2 * COLS, "dynamic column reads of a shared copy"),
    "B": (1, COLS, "scalar reads of a shared scratch at a dynamic index"),
    "C": (2, 2 * COLS, "a loop gated by a block vote that never fires"),
}


class ProbeParams(ctypes.Structure):
    """By-value launch parameters; ``ProbeParams`` in the CUDA source."""
    _fields_ = [("rows", ctypes.c_int32), ("cols", ctypes.c_int32),
                ("which", ctypes.c_int32)]


# srt_probe_launch(x, out, params, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ProbeParams,
                   ctypes.c_void_p]


def _bind(lib: ctypes.CDLL) -> None:
    lib.srt_probe_launch.argtypes = LAUNCH_ARGTYPES
    lib.srt_probe_launch.restype = ctypes.c_int


KERNEL = Kernel(SOURCE, _bind)


def probe_plain(name: str, x: torch.Tensor) -> torch.Tensor:
    """The probe's output: the array's sum everywhere (A, B) or zeros
    (C)."""
    if name == "C":
        return torch.zeros_like(x)
    return torch.full_like(x, x.sum())


def launch(name: str, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch probe ``name`` on the current stream into ``out`` and count
    the launch."""
    for t in (x, out):
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or t.shape != (ROWS, COLS) or not t.is_contiguous()):
            raise ValueError(f"probe kernel: bad tensor {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    p = ProbeParams(ROWS, COLS, PROBES[name][0])
    lib = KERNEL.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.srt_probe_launch(x.data_ptr(), out.data_ptr(), p, stream)
    KERNEL.check(err, "probe kernel")
    KERNEL.count(name)
    return out


def probe(name: str, x: torch.Tensor) -> torch.Tensor:
    """Probe ``name`` ("A", "B" or "C") on a (512, 128) f32 array: the
    kernel for a CUDA tensor, the plain version for a CPU one."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}")
    if x.device.type == "cpu":
        return probe_plain(name, x)
    return launch(name, x, torch.empty_like(x))


def run(device="cuda", calls: int = 100) -> dict:
    """Each probe on the (512, 128) array of ones: its output against the
    plain version (equal bit for bit: the sums are exact) and, on the
    card, its time per call and per loop iteration from CUDA events
    around ``calls`` launches after 3 warm-up launches (None on the
    CPU).  Returns {probe: {"value", "equal", "us_per_call",
    "us_per_iter"}}."""
    device = torch.device(device)
    x = torch.ones((ROWS, COLS), dtype=torch.float32, device=device)
    results = {}
    for name, (_, trips, _) in PROBES.items():
        out = probe(name, x)
        us = None
        if device.type == "cuda":
            for _ in range(3):
                launch(name, x, out)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                launch(name, x, out)
            end.record()
            end.synchronize()
            us = start.elapsed_time(end) * 1e3 / calls
        results[name] = {
            "value": float(out[0, 0]),
            "equal": bool(torch.equal(out, probe_plain(name, x))),
            "us_per_call": us,
            "us_per_iter": None if us is None else us / trips,
        }
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_kernel_ops: CUDA is not available")
        return 1
    print(torch.cuda.get_device_name(0))
    for name, res in run().items():
        print(f"{name} ({PROBES[name][2]}): value[0,0]={res['value']:.1f} "
              f"equal to plain={res['equal']}  {res['us_per_call']:.2f} "
              f"us/call ({res['us_per_iter']:.4f} us/iter)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
