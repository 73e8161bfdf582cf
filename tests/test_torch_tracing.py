"""The port's spans and counters (simple_raytracer_tpu_torch/utils/metrics.py).

On the CPU, over config 5 at 32x24 (4,096 triangles in 64 clusters) on
three routes: the split path ("bvh"), the fused path's plain version
("fused", pushed past the whole-trace envelope) and the whole-trace
kernel's plain version ("auto").  Off, the instrumentation adds no
operation and never enters ``record_function``; on, the canvas is bit for
bit the same, torch.profiler sees each pass's spans nested by layer, the
counters equal the sums of ``segments=`` for the same pass on the split
and fused paths and stay at zero on the whole-trace route, and the CLI's
``--metrics`` line carries them.
"""
import contextlib
import json
import sys
import threading
from collections import Counter

import pytest
import torch

from simple_raytracer_tpu_torch import cli, engine
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops import intersect, scene_types, trace
from simple_raytracer_tpu_torch.ops.camera import (camera_rotation,
                                                   generate_rays)
from simple_raytracer_tpu_torch.utils import metrics

W, H, SPP, BOUNCES = 32, 24, 1, 3
ROUTES = ("split", "fused", "whole")
BACKEND = {"split": "bvh", "fused": "fused", "whole": "auto"}


@pytest.fixture(autouse=True)
def instrumentation_off():
    """Each test starts and ends with spans and counters off."""
    metrics.spans(False)
    metrics.counters(False)
    yield
    metrics.spans(False)
    metrics.counters(False)


@pytest.fixture(scope="module")
def config5():
    scene, camera, _ = CONFIGS[5](width=W, height=H)
    return scene, camera


def _renderer(config5, monkeypatch, route: str) -> Renderer:
    """A renderer of config 5 on ``route``: "fused" with the whole-trace
    envelope closed, so the clustered mesh takes trace_rays_fused."""
    if route == "fused":
        monkeypatch.setattr(scene_types, "TABLE_MAX_SLOTS", 0)
        monkeypatch.setattr(scene_types, "MEGA_PACKED_MAX_CLUSTERS", 0)
    monkeypatch.setenv("SRT_BVH_COMPACT", "1")   # every BVH launch compacts
    options = RenderOptions(width=W, height=H, num_samples=SPP,
                            num_bounces=BOUNCES, tri_backend=BACKEND[route])
    r = Renderer(options, config5[0], device="cpu")
    ds = r.device_scene
    assert trace.takes_whole_trace(ds, options.tri_backend) == (
        route == "whole")
    assert trace.fused_ok(ds, options.tri_backend) == (route == "fused")
    return r


def _pass(r: Renderer, camera) -> torch.Tensor:
    r.clear_canvas()
    r.step(camera, time=7)
    return r.canvas.clone()


def test_span_off_is_one_shared_object():
    assert metrics.span("srt.step") is metrics.span("srt.bounce", 3)
    assert metrics.spans(True) is False
    assert metrics.span("srt.step") is not metrics.span("srt.step")
    assert metrics.spans(False) is True


@pytest.mark.parametrize("on", [False, True])
def test_span_enters_record_function_only_when_on(config5, monkeypatch, on):
    names = []

    def fake(name):
        names.append(name)
        return contextlib.nullcontext()

    r = _renderer(config5, monkeypatch, "split")
    monkeypatch.setattr(torch.profiler, "record_function", fake)
    metrics.spans(on)
    r.step(config5[1], time=7)
    r.image()
    if not on:
        assert names == []
    else:
        assert names.count("srt.step") == 1
        assert names.count("srt.image") == 1
        assert [n for n in names if n.startswith("srt.bounce.")] == [
            f"srt.bounce.{i}" for i in range(BOUNCES)]


def _aten_ops(fn) -> Counter:
    """The operations torch.profiler records on the CPU while ``fn`` runs,
    by name: kernels, allocations, copies and host syncs
    (``aten::_local_scalar_dense``), and the spans it enters."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return Counter(e.name for e in prof.events())


@pytest.mark.parametrize("route", ROUTES)
def test_off_adds_no_operation(config5, monkeypatch, route):
    """Spans and counters off: a pass and its image never enter
    ``record_function``, and run the operations of the same code with the
    instrumentation replaced by no-ops."""
    r = _renderer(config5, monkeypatch, route)
    cam = config5[1]
    r.step(cam, time=3)           # lazy tables built outside the count

    def frame():
        r.step(cam, time=7)
        r.image()

    def refuse(*args):
        raise AssertionError("called with the instrumentation off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = _aten_ops(frame)
    assert not any(n.startswith("srt.") for n in off)
    no_span = lambda *a: contextlib.nullcontext()
    for mod in (engine, trace, intersect):
        monkeypatch.setattr(mod, "span", no_span)
    monkeypatch.setattr(metrics, "count", lambda *a: None)
    monkeypatch.setattr(metrics, "counting", lambda: False)
    assert _aten_ops(frame) == off


@pytest.mark.parametrize("spans_on,counters_on",
                         [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("route", ROUTES)
def test_canvas_bit_identical(config5, monkeypatch, route, spans_on,
                              counters_on):
    r = _renderer(config5, monkeypatch, route)
    off = _pass(r, config5[1])
    metrics.spans(spans_on)
    metrics.counters(counters_on)
    before = metrics.read()
    on = _pass(r, config5[1])
    assert torch.equal(off, on)
    # the whole-trace route counts nothing, as its kernel on the card
    assert (metrics.read() != before) == (counters_on and route != "whole")


def _span_tree(events):
    """(name, parent name) of every srt.* span, the parent the shortest
    srt.* span whose interval holds it."""
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith("srt.")]
    out = []
    for k, (name, a, b) in enumerate(spans):
        holders = [s for j, s in enumerate(spans)
                   if j != k and s[1] <= a and b <= s[2]]
        parent = min(holders, key=lambda s: s[2] - s[1], default=None)
        out.append((name, parent[0] if parent else None))
    return out


@pytest.mark.parametrize("route", ["split", "fused"])
def test_profiler_sees_the_pass_nested(config5, monkeypatch, route):
    r = _renderer(config5, monkeypatch, route)
    cam = config5[1]
    metrics.spans(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.step(cam, time=7)
        r.image()
    tree = _span_tree(prof.events())
    names = Counter(n for n, _ in tree)
    assert names["srt.step"] == 1 and names["srt.image"] == 1
    assert ("srt.step", None) in tree and ("srt.image", None) in tree
    bounces = [f"srt.bounce.{i}" for i in range(BOUNCES)]
    assert [n for n, p in tree if n.startswith("srt.bounce.")] == bounces
    assert all(p == "srt.step" for n, p in tree if n in bounces)
    for b in bounces:
        inside = {n for n, p in tree if p == b}
        assert {"srt.nearest_prims", "srt.bvh", "srt.shade"} <= inside, b
    assert ("srt.rays", "srt.step") in tree
    assert ("srt.sky", "srt.step") in tree
    assert ("srt.accumulate", "srt.step") in tree
    assert ("srt.tonemap", "srt.image") in tree
    assert ("srt.fetch", "srt.image") in tree


def test_profiler_trace_turns_spans_on(config5, monkeypatch, tmp_path):
    r = _renderer(config5, monkeypatch, "whole")
    with metrics.profiler_trace(str(tmp_path)):
        assert metrics.span("x") is not metrics.span("x")
        r.step(config5[1], time=7)
    assert metrics.span("x") is metrics.span("x")
    text = (tmp_path / metrics.TRACE_FILE).read_text()
    assert '"srt.step"' in text and '"srt.whole_trace"' in text


def test_update_scene_span(config5, monkeypatch):
    r = _renderer(config5, monkeypatch, "split")
    metrics.spans(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.update_scene(config5[0])
    assert [e.name for e in prof.events()
            if e.name.startswith("srt.")] == ["srt.update_scene"]


def _rays(config5):
    scene, camera = config5
    cam = camera.state(W / H)
    return generate_rays(W, H, SPP, 7, cam.position,
                         camera_rotation(cam.yaw, cam.pitch),
                         cam.aspect_ratio, cam.fov_scale)


@pytest.mark.parametrize("compact", ["0", "1"])
def test_counters_equal_segments(config5, monkeypatch, compact):
    """The split path's live rays are the sums of its segments' first
    numbers, and the fused path counts the same live rays; each compacting
    BVH launch counts its rays and admits only live ones."""
    monkeypatch.setenv("SRT_BVH_COMPACT", compact)
    r = Renderer(RenderOptions(width=W, height=H, num_samples=SPP,
                               num_bounces=BOUNCES, tri_backend="bvh"),
                 config5[0], device="cpu")
    ds = r.device_scene
    o, d, seed = _rays(config5)
    n = o.x.shape[0]

    metrics.counters(True)
    segments = []
    trace.trace_rays(ds, o, d, seed, BOUNCES, segments, split=True,
                     tri_backend="bvh")
    split = metrics.read()
    metrics.counters(False)
    metrics.counters(True)
    trace.trace_rays_fused(ds, o, d, seed, BOUNCES)
    fused = metrics.read()
    metrics.counters(False)

    assert len(segments) == BOUNCES
    live = sum(s[0] for s in segments)
    assert split["trace.live"] == fused["trace.live"] == live
    assert split["trace.rays"] == n * BOUNCES
    rp = -(-n // 256) * 256                 # the state's padded columns
    assert fused["trace.rays"] == rp * BOUNCES
    if compact == "1":
        assert split["bvh.compacted_rays"] == n * BOUNCES
        assert fused["bvh.compacted_rays"] == rp * BOUNCES
        for c in (split, fused):
            assert 0 < c["bvh.admitted"] <= c["trace.live"]
        assert fused["bvh.admitted"] == split["bvh.admitted"]
    else:
        for c in (split, fused):
            assert c["bvh.compacted_rays"] == c["bvh.admitted"] == 0


def test_whole_trace_plain_version_counts_nothing(config5):
    """The whole-trace kernel's plain version keeps its segments and
    leaves the counters at zero, as the kernel does on the card."""
    scene, camera = config5
    r = Renderer(RenderOptions(width=W, height=H, num_samples=SPP,
                               num_bounces=BOUNCES), scene, device="cpu")
    o, d, seed = _rays(config5)
    metrics.counters(True)
    segments = []
    trace.trace_rays_rows(r.device_scene, o, d, seed, BOUNCES, segments)
    assert len(segments) == BOUNCES and segments[0][0] == o.x.shape[0]
    assert set(metrics.read().values()) == {0}


@pytest.mark.parametrize("backend", ["bvh", "fused", "auto"])
def test_cli_metrics_line_carries_the_counters(monkeypatch, capsys,
                                               tmp_path, backend):
    """``--metrics`` counts the run's passes and prints the counters in
    its JSON line, then turns them off: R rays a bounce and pass on the
    split path, Rp on the fused path, none on the whole-trace route."""
    if backend == "fused":                  # past the whole-trace envelope
        monkeypatch.setattr(scene_types, "TABLE_MAX_SLOTS", 0)
        monkeypatch.setattr(scene_types, "MEGA_PACKED_MAX_CLUSTERS", 0)
    steps, n = 2, W * H * SPP
    rc = cli.main(["--config", "5", "--width", str(W), "--height", str(H),
                   "--samples", str(SPP), "--bounces", str(BOUNCES),
                   "--steps", str(steps), "--tri-backend", backend,
                   "--device", "cpu", "--out", str(tmp_path / "a.png"),
                   "--metrics"])
    assert rc == 0
    c = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "counters"]
    assert set(c) == set(metrics.COUNTERS)
    assert not metrics.counting()
    if backend == "auto":
        assert set(c.values()) == {0}
        return
    per_bounce = n if backend == "bvh" else -(-n // 256) * 256
    assert c["trace.rays"] == per_bounce * BOUNCES * steps
    assert n <= c["trace.live"] < n * BOUNCES * steps


def test_counters_restart_from_zero_and_stay_off():
    before = metrics.read()
    metrics.count("trace.rays", 5)
    metrics.count("trace.live", torch.tensor(3))
    assert metrics.read() == before
    metrics.counters(True)
    metrics.count("trace.rays", 5)
    metrics.count("trace.live", torch.tensor(3))
    metrics.count("bvh.admitted", torch.tensor([4], dtype=torch.int32))
    assert metrics.read() == {"trace.rays": 5, "trace.live": 3,
                              "bvh.compacted_rays": 0, "bvh.admitted": 4}
    metrics.counters(True)          # already on: the counts stand
    assert metrics.read()["trace.rays"] == 5
    metrics.counters(False)
    metrics.counters(True)
    assert set(metrics.read().values()) == {0}
    with pytest.raises(KeyError):
        metrics.count("trace.nothing", 1)


def test_counters_from_many_threads():
    """No update lost: 16 threads on a short switch interval add to a host
    and a device counter at once."""
    threads_n, adds = 16, 300
    one = torch.ones((), dtype=torch.int64)
    metrics.counters(True)

    def work():
        for _ in range(adds):
            metrics.count("trace.rays", 1)
            metrics.count("trace.live", one)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = metrics.read()
    assert got["trace.rays"] == got["trace.live"] == threads_n * adds
