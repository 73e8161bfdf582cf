"""Hopper counterparts of the TPU lowering probes of
``scripts/probe_kernel_ops.py`` (``run``, ``kernel_a``/``_b``/``_c``):
what a per-cluster decision of the BVH walk costs on the card.

Each probe computes its TPU probe's function on any (512, 128) f32 array
(``probe_plain``), as a kernel of ``csrc/probe_kernel.cu``: one
thread-block cluster of 8 CTAs holding the array in shared memory, 64
rows each:
  A  the array's sum through a loop that reads one column at a runtime
     index an iteration, 128 iterations, broadcast to the output;
  B  the same sum through a (128,) shared scratch of column sums read one
     scalar at a time;
  C  out[r, j] = the sum, in ascending c, of x[r, c] over the columns c
     with an entry above 2 in any of the 512 rows, for every j: a
     128-step loop that decides column by column behind a gate batched
     across the cluster.
``probe`` launches one on a CUDA tensor (its plain version on a CPU
tensor).  ``run`` holds each to its plain version on the seeded inputs
of ``probe_inputs`` and, on the card, times it on the array of ones (as
the TPU script does): us per call from CUDA events, at the device's pace
(a CUDA graph of launches) and launched from Python, and the loop's own
SM cycles per iteration from the timing instance (clock64 around the
loop).  ``floor_us`` times an empty cluster launch of the same shape.
Run on the card:

    python -m simple_raytracer_tpu_torch.scripts.probe_kernel_ops
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.cuda.build import PACKAGE_DIR, Kernel, interface

SOURCE = PACKAGE_DIR / "csrc" / "probe_kernel.cu"
ROWS, COLS = 512, 128
CLUSTER = 8            # CTAs of the launch's cluster (kCluster)
# probe -> (the CUDA source's Probe, its loop's trip count a call (one
# column an iteration for A and C, one scalar for B; no loop is unrolled),
# what it measures)
PROBES = {
    "A": (0, COLS, "dynamic column reads of a shared copy"),
    "B": (1, COLS, "scalar reads of a shared scratch at a dynamic index"),
    "C": (2, COLS, "a loop gated column by column across the cluster"),
}
EMPTY = 3              # kEmptyLaunch: a launch of the same shape, no work
# the timing instance's marks of a CTA, SM cycles from its entry, in the
# CUDA source's Mark order
MARKS = ("staged", "loop_start", "loop_end", "fill_start", "fill_end",
         "exit")
# the spans between them (``spans``): the rows' copy in, the work before
# the loop (C's gate, B's column sums), the loop, the reductions, the
# fill's stores, the last cluster barrier, and the whole CTA
SPANS = ("stage", "before_loop", "loop", "combine", "fill", "exit",
         "total")
# A and B on an input that is not integer-valued: another order of adds
# than x.sum(), so within RTOL of the sum; on integer values below 2^24
# every order is exact, and C adds in the plain version's order anywhere
RTOL = 1e-6
# the C interface's version (srt_probe_interface in the CUDA source)
INTERFACE = 2


class ProbeParams(ctypes.Structure):
    """By-value launch parameters; ``ProbeParams`` in the CUDA source."""
    _fields_ = [("rows", ctypes.c_int32), ("cols", ctypes.c_int32),
                ("which", ctypes.c_int32)]


# srt_probe_launch(x, out, cycles, params, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ProbeParams, ctypes.c_void_p]


def _bind(lib: ctypes.CDLL) -> None:
    version = interface(lib, "srt_probe_interface")
    if version != INTERFACE:
        raise RuntimeError(f"probe kernel: the build has C interface "
                           f"{version}, want {INTERFACE}")
    lib.srt_probe_launch.argtypes = LAUNCH_ARGTYPES
    lib.srt_probe_launch.restype = ctypes.c_int


KERNEL = Kernel(SOURCE, _bind)


def probe_inputs(seed: int = 0) -> dict:
    """The probes' inputs, (512, 128) f32 numpy arrays made from ``seed``:
    "ones" (the TPU script's); "ints_0_2", integers 0 to 2 (C never
    fires); "ints_0_3", integers 0 to 2 with 3s in 24 columns: 8 fire in
    rows 0-255 only, 8 in rows 256-511 only, 8 in both; "uniform", floats
    in [0, 2) with one entry in [2, 4) in each of 8 columns."""
    rng = np.random.default_rng(seed)
    shape, half = (ROWS, COLS), ROWS // 2
    ints_0_3 = rng.integers(0, 3, shape).astype(np.float32)
    for i, c in enumerate(rng.permutation(COLS)[:24]):
        if i % 3 != 1:
            ints_0_3[rng.integers(0, half), c] = 3.0
        if i % 3 != 0:
            ints_0_3[rng.integers(half, ROWS), c] = 3.0
    uniform = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    for c in rng.permutation(COLS)[:8]:
        uniform[rng.integers(0, ROWS), c] = rng.uniform(2.0, 4.0)
    return {"ones": np.ones(shape, np.float32),
            "ints_0_2": rng.integers(0, 3, shape).astype(np.float32),
            "ints_0_3": ints_0_3, "uniform": uniform}


def probe_plain(name: str, x: torch.Tensor) -> torch.Tensor:
    """The TPU probe's function: the array's sum everywhere (A, B); for C,
    each row's sum, in ascending column order, over the columns with an
    entry above 2 in any row (the TPU kernel's order), in every column of
    that row (zeros where no column fires)."""
    if name != "C":
        return torch.full_like(x, x.sum())
    s = torch.zeros_like(x[:, 0])
    for c in torch.nonzero((x > 2.0).any(dim=0)).flatten().tolist():
        s = s + x[:, c]
    return s[:, None].expand_as(x).contiguous()


def agrees(name: str, x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether probe ``name``'s output on ``x`` is its plain version's: bit
    for bit, but A and B within RTOL of the sum where ``x`` has values
    that are not integers."""
    want = probe_plain(name, x)
    if name == "C" or bool(torch.equal(x, x.round())):
        return bool(torch.equal(out, want))
    return bool(((out - want).abs() <= RTOL * want.abs()).all())


def _check(t: torch.Tensor) -> None:
    if (t.device.type != "cuda" or t.dtype != torch.float32
            or t.shape != (ROWS, COLS) or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"probe kernel: bad tensor {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _launch(which: int, variant: str, x: torch.Tensor, out: torch.Tensor,
            cycles: torch.Tensor | None = None) -> None:
    for t in (x, out):
        _check(t)
    lib = KERNEL.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.srt_probe_launch(
            x.data_ptr(), out.data_ptr(),
            None if cycles is None else cycles.data_ptr(),
            ProbeParams(ROWS, COLS, which), stream)
    KERNEL.check(err, "probe kernel")
    KERNEL.count(variant)


def launch(name: str, x: torch.Tensor, out: torch.Tensor,
           cycles: torch.Tensor | None = None) -> torch.Tensor:
    """Launch probe ``name`` on the current stream into ``out`` and count
    the launch; with ``cycles`` ((CLUSTER, len(MARKS)) int64 on the
    card) the timing instance, counted as "<name>/timed", which writes
    each CTA's SM cycles from its entry to each mark there."""
    if cycles is not None and (cycles.device != x.device
                               or cycles.dtype != torch.int64
                               or cycles.shape != (CLUSTER, len(MARKS))
                               or not cycles.is_contiguous()):
        raise ValueError("probe kernel: cycles must be (CLUSTER, "
                         "len(MARKS)) int64 on the input's device")
    _launch(PROBES[name][0], name if cycles is None else f"{name}/timed",
            x, out, cycles)
    return out


def launch_empty(x: torch.Tensor, out: torch.Tensor) -> None:
    """An empty cluster launch of the probes' shape (counted as
    "empty")."""
    _launch(EMPTY, "empty", x, out)


def probe(name: str, x: torch.Tensor) -> torch.Tensor:
    """Probe ``name`` ("A", "B" or "C") on a (512, 128) f32 array: the
    kernel for a CUDA tensor, the plain version for a CPU one."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}")
    if x.device.type == "cpu":
        return probe_plain(name, x)
    return launch(name, x, torch.empty_like(x))


def events_us(fn, calls: int) -> float:
    """us a call of ``fn`` launched from Python: CUDA events around
    ``calls`` calls, after 3 warm-up calls (the host's pace where a call
    is shorter than its launch)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def graph_us(fn, calls: int, replays: int = 5) -> float:
    """us a call of ``fn`` at the device's pace: ``calls`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events
    after a warm-up replay; the median over the replays."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    return float(np.median(times))


def spans(name: str, x: torch.Tensor, launches: int = 10) -> dict:
    """The timing instance of probe ``name`` on ``x``, ``launches`` times:
    each of SPANS in SM cycles (between the marks' means over the CTAs;
    the median over the launches), and "per_iter", the loop's over its
    trips."""
    cycles = torch.zeros((CLUSTER, len(MARKS)), dtype=torch.int64,
                         device=x.device)
    out = torch.empty_like(x)
    per_launch = []
    for _ in range(launches):
        launch(name, x, out, cycles)
        at = dict(zip(MARKS, cycles.double().mean(dim=0).tolist()))
        per_launch.append([at["staged"], at["loop_start"] - at["staged"],
                           at["loop_end"] - at["loop_start"],
                           at["fill_start"] - at["loop_end"],
                           at["fill_end"] - at["fill_start"],
                           at["exit"] - at["fill_end"], at["exit"]])
    med = np.median(np.array(per_launch), axis=0)
    res = dict(zip(SPANS, (float(v) for v in med)))
    res["per_iter"] = res["loop"] / PROBES[name][1]
    return res


def run(device="cuda", calls: int = 100, timed_calls: int = 10) -> dict:
    """Each probe on every input of ``probe_inputs`` against its plain
    version (``agrees``; the largest |difference|) and, on the card, on
    the array of ones: us per call at the device's pace (``graph_us``
    over ``calls`` launches) and launched from Python (``events_us``),
    and its SM cycles (``spans`` over ``timed_calls`` launches); None on
    the CPU.  A probe's launches: one an input, 3 + ``calls`` timed from
    Python, ``calls`` captured, and ``timed_calls`` of "<probe>/timed".
    Returns {probe: {"value" (out[0, 0] on the ones), "equal",
    "max_abs_err", "us_per_call", "us_per_call_eager", "cycles"
    (``spans``)}}."""
    device = torch.device(device)
    xs = {k: torch.from_numpy(v).to(device)
          for k, v in probe_inputs().items()}
    x = xs["ones"]
    results = {}
    for name in PROBES:
        outs = {k: probe(name, v) for k, v in xs.items()}
        us = us_eager = cycles = None
        if device.type == "cuda":
            out = torch.empty_like(x)
            us_eager = events_us(lambda: launch(name, x, out), calls)
            us = graph_us(lambda: launch(name, x, out), calls)
            cycles = spans(name, x, timed_calls)
        results[name] = {
            "value": float(outs["ones"][0, 0]),
            "equal": all(agrees(name, xs[k], o) for k, o in outs.items()),
            "max_abs_err": max(float((o - probe_plain(name, xs[k])).abs()
                                     .max()) for k, o in outs.items()),
            "us_per_call": us,
            "us_per_call_eager": us_eager,
            "cycles": cycles,
        }
    return results


def floor_us(device="cuda", calls: int = 100) -> dict:
    """us a call of the empty cluster launch of the probes' shape, as
    ``run`` times the probes: {"us_per_call" (``graph_us``),
    "us_per_call_eager" (``events_us``)}; 3 + 2 ``calls`` launches."""
    x = torch.ones((ROWS, COLS), dtype=torch.float32, device=device)
    out = torch.empty_like(x)
    return {"us_per_call_eager": events_us(lambda: launch_empty(x, out),
                                           calls),
            "us_per_call": graph_us(lambda: launch_empty(x, out), calls)}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_kernel_ops: CUDA is not available")
        return 1
    print(torch.cuda.get_device_name(0))
    for name, res in run().items():
        print(f"{name} ({PROBES[name][2]}): value[0,0]={res['value']:.1f} "
              f"equal to plain on every input={res['equal']} "
              f"(max |d| {res['max_abs_err']:.3g}); "
              f"{res['us_per_call']:.3f} us/call in a CUDA graph, "
              f"{res['us_per_call_eager']:.3f} launched from Python; the "
              f"loop {res['cycles']['per_iter']:.2f} SM cycles/iteration; "
              + ", ".join(f"{k} {res['cycles'][k]:.0f}" for k in SPANS)
              + " SM cycles a CTA")
    floor = floor_us()
    print(f"an empty cluster launch of the same shape: "
          f"{floor['us_per_call']:.3f} us/call in a CUDA graph, "
          f"{floor['us_per_call_eager']:.3f} launched from Python")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
