"""The window's arithmetic: a rate over all the work and all the time, and
a tail over every frame."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value: the
    smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def window_rate(frames, work_per_frame: float) -> float:
    """Work per second over a window of (start, end) frames: every frame's
    work over the wall time from the first start to the last end."""
    if not frames:
        raise ValueError("no frames")
    wall = frames[-1][1] - frames[0][0]
    return len(frames) * work_per_frame / wall


def frame_ms(frames) -> list:
    return [(end - start) * 1e3 for start, end in frames]
