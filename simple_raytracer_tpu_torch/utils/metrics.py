"""Timing and throughput instrumentation.

The port's copy of ``simple_raytracer_tpu.utils.metrics``: a ring buffer
of frame times with min, max, mean and FPS (the reference's frame-time
window, interface.cpp:486-510), the periodic console or JSONL log (its
60-frame average, main.cpp:339-344), the derived ray throughput (W * H *
samples * bounces / t), and ``profiler_trace``, which captures a
``torch.profiler`` trace of a block and exports it for Chrome's trace
viewer.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Optional


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


class StepLogger:
    """Periodic console/JSONL metrics log (the log_fps analog)."""

    def __init__(self, every: int = 60, path: Optional[str] = None,
                 quiet: bool = False):
        self.every = every
        self.path = path
        self.quiet = quiet
        self.timer = FrameTimer(window=every)
        self.step = 0

    def record(self, seconds: float, **extra) -> None:
        self.timer.record(seconds)
        self.step += 1
        if self.step % self.every == 0:
            entry = {"step": self.step, **self.timer.summary(), **extra}
            if not self.quiet:
                print(f"[metrics] step {self.step}: "
                      f"avg {entry['avg_ms']:.2f} ms, {entry['fps']:.1f} fps")
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(entry) + "\n")


# the file profiler_trace writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A ``torch.profiler`` capture of the block (the host and, where
    CUDA is available, the card), exported as a Chrome trace to
    ``logdir/trace.json``; nothing when ``logdir`` is None.  The trace is
    written only when the block ends without an exception."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
