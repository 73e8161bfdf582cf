"""The traced frames: torch.profiler's device operations, each named by the
benchmark's span that issued it, their union over the window, the idle
gaps, and the guard against a profile that lost a kernel.

Each device operation (kernel, copy or fill) is matched to the runtime
call that launched it by its correlation id (else to the host operation
the profiler linked it to), and the call's host time to
the benchmark's span open at that moment (``bench.step`` around
``Renderer.step``, ``bench.image`` around ``Renderer.image``).  Host and
device times share the profiler's clock.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Optional

from .kernels import family, is_launched, short_name

SPANS = ("bench.step", "bench.image")
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float
    span: Optional[str]          # "step", "image" or None
    family: Optional[str]

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Profile:
    ops: list                    # DeviceOp, in start order
    spans: list                  # (start_us, end_us, name) host spans


def _is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith(("CUDA", "cuda"))


def parse(events) -> Profile:
    """A Profile from ``prof.events()``."""
    spans, runtime, frontend, device = [], {}, {}, []
    for e in events:
        r = e.time_range
        if _is_device(e):
            # the profiler also draws the host's annotations (the spans,
            # its step markers) on the device's timeline: they are no work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in SPANS or e.name.startswith("ProfilerStep")):
                device.append(e)
            continue
        if e.name in SPANS:
            spans.append((r.start, r.end, e.name.split(".")[1]))
        if _RUNTIME.match(e.name):
            runtime[e.id] = r.start
        elif not getattr(e, "linked_correlation_id", 0):
            frontend.setdefault(e.id, r.start)
    spans.sort()
    starts = [s[0] for s in spans]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            return spans[i][2]
        return None

    ops = []
    for e in device:
        # the launching runtime call, else the op or span it was linked to
        t_host = runtime.get(e.id)
        if t_host is None:
            t_host = frontend.get(getattr(e, "linked_correlation_id", 0))
        ops.append(DeviceOp(e.name, e.time_range.start, e.time_range.end,
                            None if t_host is None else span_at(t_host),
                            family(e.name)))
    ops.sort(key=lambda o: o.start_us)
    return Profile(ops, spans)


def union(ops) -> list:
    """The merged (start_us, end_us) intervals in which some device
    operation ran."""
    out = []
    for o in ops:
        if out and o.start_us <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end_us)
        else:
            out.append([o.start_us, o.end_us])
    return out


def busy_seconds(ops) -> float:
    return sum(b - a for a, b in union(ops)) / 1e6


def device_ops(ops, top: int = 10) -> list:
    """[name, seconds] of the device operations that took the most time."""
    total = {}
    for o in ops:
        k = short_name(o.name)
        total[k] = total.get(k, 0.0) + o.dur_us / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:top]


def idle_gaps(profile: Profile, top: int = 10) -> list:
    """[name, seconds] of the longest gaps between device intervals, each
    named by the benchmark's span open on the host as it began ("loop":
    none, the frame loop's own code)."""
    spans = profile.spans
    starts = [s[0] for s in spans]
    iv = union(profile.ops)
    gaps = []
    for (a0, a1), (b0, b1) in zip(iv, iv[1:]):
        i = bisect.bisect_right(starts, a1) - 1
        name = (spans[i][2] if i >= 0 and spans[i][0] <= a1 <= spans[i][1]
                else "loop")
        gaps.append([f"host in {name}", (b0 - a1) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return gaps[:top]


def guard(profile: Profile, launched: dict) -> list:
    """The reasons a profile cannot be read: no device operation at all,
    or, for a kernel family, device events of its launched kernel
    (``kernels.LAUNCHED``) that do not number the launches the program
    counted in the traced frames: a lost event would read as a gain."""
    if not profile.ops:
        return ["the profiler recorded no device operation"]
    reasons = []
    for fam, n in sorted(launched.items()):
        seen = sum(1 for o in profile.ops
                   if o.family == fam and is_launched(o.name, fam))
        if seen != n:
            reasons.append(
                f"the program counted {n} {fam} launch(es) in the traced "
                f"frames and the profile holds {seen} device event(s) of "
                f"their kernel")
    return reasons


@dataclasses.dataclass
class TraceRun:
    """What a per-layer metric's reader reads: the traced frames' profile
    and the benchmark's own spans of the run."""
    config: dict
    traffic: dict
    width: int
    height: int
    num_samples: int
    num_bounces: int
    frames: int                  # traced frames, one pass each
    profile: Profile
    window_s: float              # host seconds of the traced frames
    busy_s: float                # device seconds in the union of its ops
    dispatch_s: list             # host seconds inside each window step
    scene_build_s: float         # host seconds to build the scene
    launched: dict               # the program's launches by kernel family

    def device_ms(self, keep) -> Optional[float]:
        """Device ms a traced frame of the ops for which ``keep(op)`` holds;
        None where no op does."""
        ops = [o for o in self.profile.ops if keep(o)]
        if not ops:
            return None
        return sum(o.dur_us for o in ops) / 1e3 / self.frames
