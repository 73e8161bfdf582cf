"""The traced frames' reading: device operations named by the span that
issued them, the host's annotations left out, their union, the idle
gaps, the guard against a lost kernel, and the readers' arithmetic."""
import types

import pytest

from srtbench import kernels, profiling, spec


def ev(name, start, end, device=False, id=0, linked=0, annotation=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        id=id, linked_correlation_id=linked, is_user_annotation=annotation)


EVENTS = [
    ev("bench.step", 0, 100, id=1, annotation=True),
    ev("cudaLaunchKernel", 10, 12, id=501, linked=1),
    ev("cuLaunchKernel", 20, 22, id=502, linked=1),
    ev("bench.image", 110, 150, id=2, annotation=True),
    ev("cudaMemcpyAsync", 120, 122, id=503, linked=2),
    ev("void at::native::vectorized_elementwise_kernel<4, X>(int, X)", 15,
       40, device=True, id=501),
    ev("void bvh_kernel<2, false, false, false>(RayIn, BvhParams)", 40, 90,
       device=True, id=502),
    ev("Memcpy DtoH (Device -> Pageable)", 125, 140, device=True, id=503),
    ev("bench.step", 10, 92, device=True, annotation=True),   # drawn on GPU
    ev("ProfilerStep#3", 0, 150, device=True),
]


def test_parse_names_ops_by_span():
    p = profiling.parse(EVENTS)
    assert [(o.span, o.family) for o in p.ops] == [
        ("step", None), ("step", "bvh"), ("image", None)]
    assert profiling.busy_seconds(p.ops) == pytest.approx(90e-6)
    gaps = profiling.idle_gaps(p)
    assert gaps == [["host in step", pytest.approx(35e-6)]]
    top = profiling.device_ops(p.ops)
    assert top[0][0] == "bvh_kernel<2, false, false, false>"


def launch_events(walks, with_order=True):
    """A BVH launch's device events: its order and compaction kernels,
    then its walk, ``walks`` times (the walk left out where False)."""
    out = []
    for k, walk in enumerate(walks):
        t = 1000 * k
        if with_order:
            out += [ev("ray_partials(RayIn, BvhParams, float4*)", t, t + 5,
                       device=True),
                    ev("scatter_rays(int const*, int, int*, int*)", t + 5,
                       t + 9, device=True)]
        if walk:
            out.append(ev("void (anonymous namespace)::bvh_kernel<2, false,"
                          " false, false>(RayIn, float4 const*)", t + 10,
                          t + 90, device=True))
    return out


def test_guard_refuses_a_lost_kernel():
    p = profiling.parse(EVENTS)
    assert profiling.guard(p, {"bvh": 1, "shade": 0}) == []
    assert "shade" in profiling.guard(p, {"bvh": 1, "shade": 6})[0]
    assert profiling.guard(profiling.Profile([], []), {}) != []


@pytest.mark.parametrize("walks, launched, ok", [
    ([True] * 6, 6, True),
    ([True, True, False, True, True, True], 6, False),   # one walk lost
    ([False] * 6, 6, False),       # every walk lost, the order kept
    ([True] * 6, 7, False),
])
def test_guard_counts_each_launch_of_the_walk(walks, launched, ok):
    """The walk's events lost with the order's kept would read as a
    faster BVH: the guard counts the walk's events against the launches."""
    p = profiling.parse(launch_events(walks))
    reasons = profiling.guard(p, {"bvh": launched, "shade": 0})
    assert (reasons == []) is ok, reasons
    if not ok:
        assert "bvh" in reasons[0]


def test_families_by_name():
    f = kernels.family
    assert f("void bvh_kernel<2, false, false, false>(RayIn const, ...)") \
        == "bvh"
    assert f("scan_buckets(int const*, int, int*, int*)") == "bvh"
    assert f("void trace_kernel<2, false>(TraceArgs, TraceParams)") == "trace"
    assert f("bounce_kernel(float const*, float*)") == "shade"
    assert f("void (anonymous namespace)::triangle_kernel<1>(float*)") == \
        "triangle"
    assert f("void at::native::reduce_kernel<512, 1>(X)") is None
    assert f("Memcpy DtoH (Device -> Pageable)") is None


def readers_run(ops, frames=2, window=1e-3):
    return profiling.TraceRun(
        config={}, traffic={}, width=1920, height=1080, num_samples=2,
        num_bounces=6, frames=frames, profile=profiling.Profile(ops, []),
        window_s=window, busy_s=profiling.busy_seconds(ops),
        dispatch_s=[0.002, 0.004], scene_build_s=1.5, launched={})


def test_readers():
    op = lambda fam, span, us: profiling.DeviceOp("k", 0, us, span, fam)
    ops = [op("shade", "step", 250.0), op(None, "step", 100.0),
           op(None, "image", 30.0)]
    run = readers_run(ops)
    read = lambda n: spec.reader(n)(run)
    cols = kernels.shade_columns(1920, 1080, 2)
    assert cols == 4147200
    least = cols * 168 / 3.35e12
    assert read("shade_kernel_roofline") == pytest.approx(
        100 * least / 250e-6)
    assert read("shade_kernel_ms") == pytest.approx(0.125)
    assert read("torch_ops_ms") == pytest.approx(0.05)
    assert read("image_ms") == pytest.approx(0.015)
    assert read("bvh_kernel_ms") is None and read("trace_kernel_ms") is None
    assert read("dispatch_ms") == pytest.approx(3.0)
    assert read("scene_build_s") == 1.5
    assert read("device_idle") == pytest.approx(75.0)
