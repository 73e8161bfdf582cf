"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (its look for a card skipped) on the CPU at a tiny
size, once sound and once for each fault a cell can have.  It has no
exchange between chips: every cell takes one."""
import pytest

import run
from conftest import make_cell


@pytest.fixture
def split_route(monkeypatch):
    from simple_raytracer_tpu_torch.ops import scene_types
    monkeypatch.setattr(scene_types, "TABLE_MAX_SLOTS", 256)


def unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from simple_raytracer_tpu_torch.parallel import shard
    monkeypatch.setattr(shard, "render_pass",
                        lambda scene, cam, canvas, time, **kw: canvas)


def half_batch(monkeypatch):
    """Half of the batch (every pixel's second sample) left out, the mean
    taken over the rest."""
    from simple_raytracer_tpu_torch.ops import trace
    from simple_raytracer_tpu_torch.ops.vec import Vec3
    real = trace.trace_per_bounce

    def first_half(scene, o, d, seed, num_bounces, *a, **kw):
        pick = lambda v: Vec3(v.x[0::2], v.y[0::2], v.z[0::2])
        c = real(scene, pick(o), pick(d), seed[0::2], num_bounces, *a, **kw)
        return Vec3(*(x.repeat_interleave(2) for x in c))
    monkeypatch.setattr(trace, "trace_per_bounce", first_half)


def altered(monkeypatch):
    """Each pass's answer altered where it is produced: traced on another
    pass's RNG stream."""
    from simple_raytracer_tpu_torch.parallel import shard
    real = shard.render_pass
    monkeypatch.setattr(shard, "render_pass",
                        lambda scene, cam, canvas, time, **kw:
                        real(scene, cam, canvas, time + 1, **kw))


def stale_image(monkeypatch):
    """The image altered where it is produced: ``image()`` returns the
    first frame's image over and over, as a stale cache would."""
    from simple_raytracer_tpu_torch.engine import Renderer
    real = Renderer.image
    kept = {}

    def first(self):
        if self not in kept:
            kept[self] = real(self)
        return kept[self]
    monkeypatch.setattr(Renderer, "image", first)


@pytest.mark.parametrize("fault", [None, unchanged, half_batch, altered,
                                   stale_image])
def test_fault_is_not_correct(fault, tmp_path, split_route, monkeypatch):
    root, bd, name = make_cell(tmp_path, "large_mesh", subdivisions=3)
    if fault is not None:
        fault(monkeypatch)
    r = run.run_cell(name, 2 ** 31 + 77, 0.5, False, device="cpu",
                     root=root, bench_dir=bd)
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"mrays_per_s", "frame_ms_p95", "setup_s"}
