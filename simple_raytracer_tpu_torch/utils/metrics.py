"""Timing and throughput instrumentation, and the program's spans and
counters.

The port's copy of ``simple_raytracer_tpu.utils.metrics``: a ring buffer
of frame times with min, max, mean and FPS (the reference's frame-time
window, interface.cpp:486-510), the derived ray throughput (W * H *
samples * bounces / t), and ``profiler_trace``, which captures a
``torch.profiler`` trace of a block and exports it for Chrome's trace
viewer.

Spans (``span``) mark the program's layers on torch.profiler's timeline,
on the clock of the device events, each nested in the span open when it
began: ``srt.step`` (a pass), ``srt.rays``, ``srt.whole_trace``,
``srt.bounce.<i>`` with its ``srt.nearest_prims``, ``srt.bvh`` and
``srt.shade``, ``srt.sky``, ``srt.accumulate``; ``srt.image`` with its
``srt.tonemap`` and ``srt.fetch``; ``srt.update_scene``.  Counters
(``count``, ``COUNTERS``) total the rays of the per-bounce paths' bounces
and of the BVH compaction: device values stay on their device until
``read``; the CLI's ``--metrics`` prints them.
Both are off until turned on by ``spans(True)`` or ``counters(True)``;
off, a call site costs one flag test, with no device operation,
allocation or host sync.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Optional

import torch


class FrameTimer:
    """Ring buffer of recent frame times (the frame_time_window analog)."""

    def __init__(self, window: int = 60):
        self.window = window
        self.times = collections.deque(maxlen=window)
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def record(self, seconds: float) -> None:
        self.times.append(seconds)

    @property
    def avg(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def min(self) -> float:
        return min(self.times) if self.times else 0.0

    @property
    def max(self) -> float:
        return max(self.times) if self.times else 0.0

    @property
    def fps(self) -> float:
        a = self.avg
        return 1.0 / a if a > 0 else 0.0

    def summary(self) -> dict:
        return {"avg_ms": self.avg * 1e3, "min_ms": self.min * 1e3,
                "max_ms": self.max * 1e3, "fps": self.fps,
                "frames": len(self.times)}


def ray_throughput(width: int, height: int, num_samples: int,
                   num_bounces: int, seconds_per_step: float) -> dict:
    """Derived metrics: Mray-segments/s and normalized 1080p spp/s."""
    segments = width * height * num_samples * num_bounces
    mrays = segments / seconds_per_step / 1e6
    pixels_1080p = 1920 * 1080
    spp_1080p = (width * height * num_samples) / pixels_1080p / seconds_per_step
    return {
        "mrays_per_second": mrays,
        "spp_per_second_1080p": spp_1080p,
        "seconds_per_step": seconds_per_step,
    }


# the file profiler_trace writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A ``torch.profiler`` capture of the block (the host and, where
    CUDA is available, the card), exported as a Chrome trace to
    ``logdir/trace.json``, with the program's spans turned on for the
    block; nothing when ``logdir`` is None.  The trace is written only
    when the block ends without an exception."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = spans(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        spans(was_on)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


# -- spans -----------------------------------------------------------------
_spans_on = False
_NO_SPAN = contextlib.nullcontext()


def spans(on: bool) -> bool:
    """Turn the program's spans on or off, in every thread; returns whether
    they were on."""
    global _spans_on
    was_on, _spans_on = _spans_on, bool(on)
    return was_on


def span(name: str, index: Optional[int] = None):
    """A context manager marking the block as ``name`` (``name.index``
    with an index) on torch.profiler's timeline, a
    ``torch.profiler.record_function``; while spans are off, one shared
    object that does nothing."""
    if not _spans_on:
        return _NO_SPAN
    return torch.profiler.record_function(
        name if index is None else f"{name}.{index}")


# -- counters --------------------------------------------------------------
# name -> kind: "host" values are Python ints, "device" values 0-d or (1,)
# integer tensors added on their device.  The split and fused per-bounce
# paths count; the whole-trace route counts nothing, its kernel on the card
# and its plain version on the CPU alike.
COUNTERS = {
    "trace.rays": "host",          # rays each bounce's body spans, summed
    "trace.live": "device",        # rays alive entering each bounce, summed
    "bvh.compacted_rays": "host",  # rays of every BVH launch that compacts
    "bvh.admitted": "device",      # the rays those launches admitted
}
_DEVICE_INDEX = {name: i for i, name in enumerate(
    n for n, kind in COUNTERS.items() if kind == "device")}
_counting = False
_lock = threading.Lock()
_host: dict = {}
_device: dict = {}                 # torch.device -> (len(_DEVICE_INDEX),) int64


def counters(on: bool) -> bool:
    """Turn the counters on (from zero) or off, in every thread; returns
    whether they were on."""
    global _counting
    with _lock:
        was_on, _counting = _counting, bool(on)
        if _counting and not was_on:
            _host.clear()
            _device.clear()
    return was_on


def counting() -> bool:
    """Are the counters on?  A call site whose value costs device work
    asks first."""
    return _counting


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` (``COUNTERS``): an int to a
    host counter, an integer tensor to a device counter, on the tensor's
    device with no sync.  Nothing while the counters are off."""
    if not _counting:
        return
    with _lock:
        if COUNTERS[name] == "host":
            _host[name] = _host.get(name, 0) + int(value)
            return
        acc = _device.get(value.device)
        if acc is None:
            acc = _device[value.device] = torch.zeros(
                len(_DEVICE_INDEX), dtype=torch.int64, device=value.device)
        acc.narrow(0, _DEVICE_INDEX[name], 1).add_(value.reshape(1))


def read() -> dict:
    """Every counter's total since the counters were turned on, summed over
    devices (one sync a device)."""
    with _lock:
        out = {name: _host.get(name, 0) for name in COUNTERS}
        for acc in _device.values():
            for name, v in zip(_DEVICE_INDEX, acc.tolist()):
                out[name] += v
    return out
