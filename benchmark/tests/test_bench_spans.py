"""The program's spans in traced frames (srtbench/spans.py): each device
operation charged to the innermost ``srt.*`` span open at its launch,
idle gaps named by it, a pass's prologue, the counters' shares; and
``profiling.parse`` reading what it read before the program had spans."""
import pytest

from srtbench import profiling, spans
from test_bench_profiling import EVENTS, ev


def pass_events():
    """One pass and its image: the program's spans inside the benchmark's,
    runtime calls under them, their device operations, and annotations
    that the profiler draws on the device's timeline."""
    host = [
        ev("bench.step", 0, 100, id=1, annotation=True),
        ev("srt.step", 1, 99, id=2, annotation=True),
        ev("srt.rays", 2, 8, id=3, annotation=True),
        ev("cudaLaunchKernel", 5, 6, id=601, linked=3),
        ev("srt.bounce.0", 10, 60, id=4, annotation=True),
        ev("srt.nearest_prims", 11, 20, id=5, annotation=True),
        ev("cudaLaunchKernel", 12, 13, id=602, linked=5),
        ev("srt.bvh", 21, 30, id=6, annotation=True),
        ev("cuLaunchKernel", 22, 23, id=603, linked=6),
        ev("srt.shade", 31, 59, id=7, annotation=True),
        ev("cudaLaunchKernel", 32, 33, id=604, linked=7),
        ev("cudaLaunchKernel", 40, 41, id=605, linked=7),
        ev("srt.bounce.1", 61, 95, id=8, annotation=True),
        ev("srt.shade", 62, 94, id=9, annotation=True),
        ev("cudaLaunchKernel", 63, 64, id=606, linked=9),
        ev("bench.image", 110, 150, id=10, annotation=True),
        ev("srt.image", 111, 149, id=11, annotation=True),
        ev("srt.tonemap", 112, 115, id=12, annotation=True),
        ev("cudaLaunchKernel", 113, 114, id=607, linked=12),
        ev("srt.fetch", 116, 148, id=13, annotation=True),
        ev("cudaMemcpyAsync", 117, 118, id=608, linked=13),
    ]
    k = "void at::native::vectorized_elementwise_kernel<4, X>(int, X)"
    device = [
        ev(k, 6, 9, device=True, id=601),
        ev(k, 13, 19, device=True, id=602),
        ev("void bvh_kernel<2, false, false, false>(RayIn, BvhParams)", 23,
           29, device=True, id=603),
        ev(k, 33, 38, device=True, id=604),
        ev("void at::native::reduce_kernel<512, 1>(X)", 41, 50, device=True,
           id=605),
        ev(k, 64, 70, device=True, id=606),
        ev(k, 114, 116, device=True, id=607),
        ev("Memcpy DtoH (Device -> Pageable)", 118, 140, device=True,
           id=608),
        ev("srt.shade", 33, 50, device=True, annotation=True),
        ev("srt.step", 6, 70, device=True, annotation=True),
    ]
    return host + device


def test_ops_charged_to_the_innermost_span():
    ops = spans.attribute(pass_events())
    assert [o.inner for o in ops] == [
        "srt.rays", "srt.nearest_prims", "srt.bvh", "srt.shade", "srt.shade",
        "srt.shade", "srt.tonemap", "srt.fetch"]
    assert ops[3].stack == ("srt.step", "srt.bounce.0", "srt.shade")
    assert ops[7].stack == ("srt.image", "srt.fetch")
    assert [o.family for o in ops][:3] == [None, None, "bvh"]


def test_readers_arithmetic():
    events = pass_events()
    ops = spans.attribute(events)
    assert spans.shade_torch_ms(ops, 2) == pytest.approx((5 + 9 + 6) / 2e3)
    assert spans.nearest_prims_ms(ops, 1) == pytest.approx(6e-3)
    assert spans.torch_by_bounce(ops, 1) == {
        "srt.bounce.0": pytest.approx(20e-3),
        "srt.bounce.1": pytest.approx(6e-3)}
    top = spans.by_span(ops, 1)
    assert list(top)[0] == "srt.fetch|None"
    assert top["srt.bvh|bvh"] == pytest.approx(6e-3)
    assert spans.prologues_ms(events) == [pytest.approx(4e-3)]
    assert spans.pass_prologue_ms(events) == pytest.approx(4e-3)


def test_idle_gaps_named_by_the_program_span():
    events = pass_events()
    prof = profiling.parse(events)
    srt = spans.host_spans(events)
    gaps = spans.idle_gaps(prof, srt)
    assert gaps[0] == ["host in step: srt.shade", pytest.approx(44e-6)]
    names = {g[0] for g in gaps}
    assert names == {"host in step: srt.step",
                     "host in step: srt.nearest_prims",
                     "host in step: srt.bvh", "host in step: srt.shade",
                     "host in image: srt.fetch"}
    by = spans.idle_by_name(prof, srt, 1)
    assert by["host in step: srt.shade"] == pytest.approx((3 + 14 + 44) / 1e3)
    assert by["host in image: srt.fetch"] == pytest.approx(2e-3)
    # the same gaps as the benchmark's own names, in the same order
    plain = profiling.idle_gaps(prof)
    assert [g[1] for g in plain] == [g[1] for g in gaps]
    assert [g[0] for g in plain] == [g[0].split(":")[0] for g in gaps]


def test_parse_unmoved_by_program_spans():
    """The accepted readers' view: the existing events, and the same
    events with the program's spans around the launches and drawn on the
    device, give the same operations under the same benchmark spans."""
    want = [("step", None), ("step", "bvh"), ("image", None)]
    assert [(o.span, o.family) for o in profiling.parse(EVENTS).ops] == want
    with_spans = EVENTS + [
        ev("srt.step", 5, 95, id=21, annotation=True),
        ev("srt.bvh", 19, 30, id=22, annotation=True),
        ev("srt.fetch", 115, 145, id=23, annotation=True),
        ev("srt.step", 15, 90, device=True, annotation=True),
        ev("srt.fetch", 125, 140, device=True, annotation=True)]
    got = profiling.parse(with_spans)
    assert got.ops == profiling.parse(EVENTS).ops
    assert got.spans == profiling.parse(EVENTS).spans
    assert [o.inner for o in spans.attribute(with_spans)] == [
        "srt.step", "srt.bvh", "srt.fetch"]


def test_a_program_without_spans():
    """The parent's profile: no operation charged to a program span, no
    prologue, and the gaps under the benchmark's names alone."""
    ops = spans.attribute(EVENTS)
    assert [o.stack for o in ops] == [(), (), ()]
    assert spans.shade_torch_ms(ops, 1) is None
    assert spans.pass_prologue_ms(EVENTS) is None
    prof = profiling.parse(EVENTS)
    assert spans.idle_gaps(prof, spans.host_spans(EVENTS)) == \
        profiling.idle_gaps(prof)


@pytest.mark.parametrize("counters,want", [
    ({"trace.rays": 400, "trace.live": 103, "bvh.compacted_rays": 300,
      "bvh.admitted": 6}, (25.75, 2.0)),
    ({"trace.rays": 0, "trace.live": 0, "bvh.compacted_rays": 0,
      "bvh.admitted": 0}, (None, None)),
    ({}, (None, None)),
])
def test_shares(counters, want):
    got = spans.shares(counters)
    assert (got["bounce_live_share"], got["bvh_admit_share"]) == want


def test_open_stacks_on_a_profile_of_the_port():
    """The stack sweep over torch.profiler's own events: every operation a
    CPU pass runs under a bounce lies in ``srt.step``, in that bounce, in
    one of its three stages."""
    import torch

    from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
    from simple_raytracer_tpu_torch.models.presets import CONFIGS
    from simple_raytracer_tpu_torch.utils import metrics

    scene, camera, _ = CONFIGS[5](width=16, height=8)
    r = Renderer(RenderOptions(width=16, height=8, num_samples=1,
                               num_bounces=2, tri_backend="bvh"),
                 scene, device="cpu")
    r.step(camera, time=3)
    was = metrics.spans(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            r.step(camera, time=7)
    finally:
        metrics.spans(was)
    events = prof.events()
    srt = spans.host_spans(events)
    assert [s[2] for s in srt].count("srt.step") == 1
    ops = [e.time_range.start for e in events if e.name.startswith("aten::")]
    stacks = spans.open_stacks(srt, ops)
    in_bounce = [s for s in stacks.values() if len(s) > 1
                 and s[1].startswith("srt.bounce.")]
    assert in_bounce and all(s[0] == "srt.step" for s in stacks.values())
    assert {s[2] for s in in_bounce if len(s) > 2} <= {
        "srt.nearest_prims", "srt.bvh", "srt.shade"}
    assert {s[1] for s in in_bounce} == {"srt.bounce.0", "srt.bounce.1"}
