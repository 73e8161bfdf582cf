"""The program's own spans and counters in traced frames: the arithmetic
of the per-layer metrics that read them (``shade_torch_ms``,
``nearest_prims_ms``, ``pass_prologue_ms``, ``bounce_live_share``,
``bvh_admit_share``) and of idle gaps named by the program's spans.

The program marks its layers with ``srt.*`` spans (``torch.profiler.
record_function``, while its ``utils.metrics.spans`` is on) and totals
rays in its counters (``utils.metrics.read``).  Here each device
operation is charged to the innermost ``srt.*`` span open on the host
when its runtime call launched it, matched as ``profiling.parse`` matches
it; ``parse`` itself is left as it is, so the readers that name an
operation by the benchmark's span read what they read.  A program
without spans gives operations charged to no span, and no prologue.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import statistics
from typing import Optional

from . import profiling
from .kernels import family

PREFIX = "srt."
# runtime calls that put work on the device: launches, copies, fills
_PUTS_WORK = re.compile(r"Launch|Memcpy|Memset")


@dataclasses.dataclass
class SpanOp:
    name: str
    start_us: float
    end_us: float
    family: Optional[str]
    stack: tuple                 # srt.* spans open at its launch, outermost first

    @property
    def inner(self) -> Optional[str]:
        return self.stack[-1] if self.stack else None

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


def host_spans(events) -> list:
    """(start_us, end_us, name) of every ``srt.*`` span on the host, by
    start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.name.startswith(PREFIX) and not profiling._is_device(e))


def open_stacks(spans, times) -> dict:
    """time -> the spans open at that time (start <= t <= end), outermost
    first; ``spans`` nest, as a host thread's spans do."""
    out, stack, i = {}, [], 0
    for t in sorted(set(times)):
        while i < len(spans) and spans[i][0] <= t:
            start, end, name = spans[i]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((end, name))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out[t] = tuple(name for _, name in stack)
    return out


def _is_work(e) -> bool:
    """A device event that is work: not a host annotation that the
    profiler also draws on the device's timeline."""
    return not (getattr(e, "is_user_annotation", False)
                or e.name in profiling.SPANS
                or e.name.startswith((PREFIX, "ProfilerStep")))


def attribute(events) -> list:
    """Every device operation as a SpanOp, in start order: its launching
    runtime call's host time (else the host operation it was linked to,
    as ``profiling.parse``) placed in the ``srt.*`` spans open then."""
    runtime, frontend, device = {}, {}, []
    for e in events:
        if profiling._is_device(e):
            if _is_work(e):
                device.append(e)
        elif profiling._RUNTIME.match(e.name):
            runtime[e.id] = e.time_range.start
        elif not getattr(e, "linked_correlation_id", 0):
            frontend.setdefault(e.id, e.time_range.start)
    t_host = {}
    for e in device:
        t = runtime.get(e.id)
        if t is None:
            t = frontend.get(getattr(e, "linked_correlation_id", 0))
        t_host[id(e)] = t
    stacks = open_stacks(host_spans(events),
                         [t for t in t_host.values() if t is not None])
    ops = [SpanOp(e.name, e.time_range.start, e.time_range.end,
                  family(e.name), stacks.get(t_host[id(e)], ()))
           for e in device]
    ops.sort(key=lambda o: o.start_us)
    return ops


def device_ms(ops, frames: int, keep) -> Optional[float]:
    """Device ms a frame of the ops for which ``keep(op)`` holds; None
    where no op does."""
    kept = [o for o in ops if keep(o)]
    if not kept:
        return None
    return sum(o.dur_us for o in kept) / 1e3 / frames


def shade_torch_ms(ops, frames: int) -> Optional[float]:
    """PyTorch operations (no kernel family) launched under ``srt.shade``:
    the split path's shade."""
    return device_ms(ops, frames,
                     lambda o: o.inner == "srt.shade" and o.family is None)


def nearest_prims_ms(ops, frames: int) -> Optional[float]:
    """Every operation launched under ``srt.nearest_prims``."""
    return device_ms(ops, frames, lambda o: o.inner == "srt.nearest_prims")


def by_span(ops, frames: int) -> dict:
    """"<innermost span>|<family>" -> device ms a frame, largest first."""
    total = {}
    for o in ops:
        k = f"{o.inner}|{o.family}"
        total[k] = total.get(k, 0.0) + o.dur_us / 1e3 / frames
    return dict(sorted(total.items(), key=lambda kv: -kv[1]))


def torch_by_bounce(ops, frames: int) -> dict:
    """"srt.bounce.<i>" -> device ms a frame of its PyTorch operations."""
    total = {}
    for o in ops:
        b = next((s for s in o.stack if s.startswith("srt.bounce.")), None)
        if b is not None and o.family is None:
            total[b] = total.get(b, 0.0) + o.dur_us / 1e3 / frames
    return dict(sorted(total.items(), key=lambda kv: int(kv[0][11:])))


def prologues_ms(events) -> list:
    """Host ms of each ``srt.step`` from its start to the first runtime
    call inside it that puts work on the device (a launch, copy or fill);
    a step that makes none is left out."""
    calls = sorted(e.time_range.start for e in events
                   if not profiling._is_device(e)
                   and profiling._RUNTIME.match(e.name)
                   and _PUTS_WORK.search(e.name))
    out = []
    for start, end, name in host_spans(events):
        if name != "srt.step":
            continue
        j = bisect.bisect_left(calls, start)
        if j < len(calls) and calls[j] <= end:
            out.append((calls[j] - start) / 1e3)
    return out


def pass_prologue_ms(events) -> Optional[float]:
    """The mean of ``prologues_ms``; None without a ``srt.step``."""
    p = prologues_ms(events)
    return statistics.mean(p) if p else None


def idle_gaps(profile: profiling.Profile, spans, top: int = 10) -> list:
    """``profiling.idle_gaps`` with each name followed by the innermost
    program span open as the gap began: "host in image: srt.fetch"; the
    benchmark's name alone where no program span is open."""
    return sorted(_gaps(profile, spans), key=lambda g: -g[1])[:top]


def idle_by_name(profile: profiling.Profile, spans, frames: int) -> dict:
    """Gap name (as ``idle_gaps``) -> idle ms a frame, largest first."""
    total = {}
    for name, s in _gaps(profile, spans):
        total[name] = total.get(name, 0.0) + s * 1e3 / frames
    return dict(sorted(total.items(), key=lambda kv: -kv[1]))


def _gaps(profile, spans) -> list:
    starts = [s[0] for s in profile.spans]
    iv = profiling.union(profile.ops)
    stacks = open_stacks(spans, [a1 for (_, a1) in iv[:-1]])
    gaps = []
    for (a0, a1), (b0, b1) in zip(iv, iv[1:]):
        i = bisect.bisect_right(starts, a1) - 1
        bench = (profile.spans[i][2] if i >= 0
                 and profile.spans[i][0] <= a1 <= profile.spans[i][1]
                 else "loop")
        inner = stacks[a1][-1] if stacks[a1] else None
        gaps.append([f"host in {bench}" + (f": {inner}" if inner else ""),
                     (b0 - a1) / 1e6])
    return gaps


def shares(counters: dict) -> dict:
    """``bounce_live_share``: 100 * trace.live / trace.rays, the share of
    the bounce bodies' rays that are alive; ``bvh_admit_share``: 100 *
    bvh.admitted / bvh.compacted_rays, the compaction's ratio.  None where
    the denominator is 0 (the whole-trace route counts nothing)."""
    def pct(num, den):
        den = counters.get(den, 0)
        return 100.0 * counters.get(num, 0) / den if den else None
    return {"bounce_live_share": pct("trace.live", "trace.rays"),
            "bvh_admit_share": pct("bvh.admitted", "bvh.compacted_rays")}
