"""The JAX package's opt-in switches in the port, each held against the
JAX package on the CPU, on the same inputs made from a seed:

- the residency limits (``SRT_BVH_PACKED_VMEM_MAX``,
  ``SRT_MEGA_PACKED_MAX``), ``SRT_MEGA_MT_SLICES`` and
  ``SRT_NO_COMPILE_CACHE``, read once at import (a subprocess a set of
  values), and the routes they decide;
- the compaction policy (``SRT_BVH_COMPACT``, ``SRT_BVH_COMPACT_CAP``):
  whether each bounce of the split and fused paths compacts;
- the compaction's key (``SRT_BVH_COMPACT_KEY``): ``compact_order`` under
  "morton" against ``_compact_prefix(..., "morton")`` at 14, 10 and 6
  bucket bits, with origins far outside the mesh and dead and NaN rays,
  and the fallback to "super" below 6 bits;
- the reverse visiting order (``SRT_BVH_ORDER=rev``): ``front_to_back``
  against the order the JAX wrapper hands its kernel, the compaction's
  rank unchanged;
- ``sort_rays``: the permutation against ``_sort_rays_by_super``'s, and
  the (t, slot) against the unsorted call;
- the ring depth (``SRT_BVH_DMA_SLOTS``), the whole-trace kernel's
  ``SRT_MEGA_MT_SLICES`` rule, the host library's ``SRT_NATIVE_LIB``, and
  each bad value raising the JAX package's error.

The JAX wrapper's visiting order is its own ``front_to_back`` closure,
run on the same rays outside it.
"""
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.models import Scene as JScene
from simple_raytracer_tpu.models.meshgen import icosphere
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops import intersect as jintersect
from simple_raytracer_tpu.ops.pallas import bounce_kernel as jbk
from simple_raytracer_tpu.ops.pallas import bvh_kernel as jbvh
from simple_raytracer_tpu_torch import accel
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops import scene_types as tst
from simple_raytracer_tpu_torch.ops import trace as ttrace
from simple_raytracer_tpu_torch.ops.camera import camera_rotation
from simple_raytracer_tpu_torch.ops.cuda import build
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel as tk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import (jax_native_accel, jax_scene_arrays, jvec,
                                tvec, unit_vectors)

REPO = Path(__file__).resolve().parents[1]
KNOBS = ("SRT_BVH_PACKED_VMEM_MAX", "SRT_MEGA_PACKED_MAX",
         "SRT_MEGA_MT_SLICES", "SRT_NO_COMPILE_CACHE", "SRT_BVH_COMPACT",
         "SRT_BVH_COMPACT_CAP", "SRT_BVH_COMPACT_KEY", "SRT_BVH_ORDER",
         "SRT_BVH_DMA_SLOTS", "SRT_NATIVE_LIB")
H100_SHARED_OPTIN = 232448     # bytes of shared memory a block may opt in to
BASE_RAYS = 1 << 21            # rays made afresh; a larger batch repeats them


@pytest.fixture(autouse=True)
def no_knobs(monkeypatch):
    """Every test starts with every switch unset."""
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def scenes():
    """Configs 5 and 6 at 64x36 in both packages (the JAX scene, built by
    its default native builder, carried across), and a 320-triangle
    icosphere of 5 clusters: one admission box."""
    jax_native_accel()
    out = {}
    for n in (5, 6):
        ds = JCONFIGS[n](width=64, height=36)[0].build()
        _, camera, _ = CONFIGS[n](width=64, height=36)
        out[n] = (ds, from_numpy(jax_scene_arrays(ds), "cpu"), camera)
    pos, nrm = icosphere(subdivisions=2)
    sc = JScene()
    sc.cluster_threshold = 64
    sc.cluster_size = 64
    sc.add_model(sc.pool.append(pos, nrm))
    ds = sc.build()
    out["ico"] = (ds, from_numpy(jax_scene_arrays(ds), "cpu"), None)
    return out


def rays(ts, n: int, seed: int, wild: bool = True):
    """(o, d, alive, t_init) numpy rays at a scene's mesh: a third from
    inside its box, a third from up to 50 box sizes outside it and a third
    from 1e30 to 1e36 away (a quotient beyond int32 before the clip),
    headed at points of the box; t_init +inf or a few box sizes; about 15%
    dead and 3% with a NaN in the origin or the direction.  Without
    ``wild``, no far and no NaN ray (whose origins would make every box's
    distance from the mean live origin +inf or NaN, and so every visiting
    order the index order)."""
    if n > BASE_RAYS:           # the same rays again: ties go by index
        base = rays(ts, BASE_RAYS, seed, wild)
        reps = -(-n // BASE_RAYS)
        return tuple(np.ascontiguousarray(np.tile(a, (reps,) + (1,) * (
            a.ndim - 1))[:n]) for a in base)
    r = np.random.default_rng(seed)
    tr = ts.triangles
    v = tr.v0.numpy()[tr.active.numpy()]
    lo, hi = v.min(0), v.max(0)
    size = float((hi - lo).max())
    target = r.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    kind = r.integers(0, 3, n)
    o = np.where((kind == 0)[:, None], r.uniform(lo, hi, size=(n, 3)),
                 target + r.normal(size=(n, 3)) * size
                 * np.where(kind == 1, 50.0, 0.0)[:, None]).astype(np.float32)
    far = (kind == 2) & wild
    o[far] = (np.sign(r.normal(size=(int(far.sum()), 3)))
              * 10.0 ** r.uniform(30, 36, (int(far.sum()), 3)))
    d = target - o
    with np.errstate(over="ignore", invalid="ignore"):   # the far origins
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
    small = r.uniform(size=n) < 0.2
    d[small] = unit_vectors(r, int(small.sum()))
    t_init = np.where(r.uniform(size=n) < 0.6, np.inf,
                      r.uniform(0.1, 3.0, n) * size).astype(np.float32)
    alive = (r.uniform(size=n) > 0.15).astype(np.float32)
    bad = (r.uniform(size=n) < 0.03) & wild
    o[bad & (r.uniform(size=n) < 0.5), 2] = np.nan
    d[bad & (r.uniform(size=n) < 0.5), 0] = np.nan
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return f32(o), f32(d), alive, t_init


def port_args(o, d, alive, t_init):
    return (tvec(o), tvec(d), torch.from_numpy(alive),
            torch.from_numpy(t_init))


def jax_args(o, d, alive, t_init):
    return jvec(o), jvec(d), jnp.asarray(alive), jnp.asarray(t_init)


# -- read at import ----------------------------------------------------------

IMPORT_PROBE = r"""
import importlib, json
out = {}
for name, mod, attr in (
        ("jax_packed", "simple_raytracer_tpu.ops.pallas.bvh_kernel",
         "PACKED_VMEM_MAX_CLUSTERS"),
        ("port_packed", "simple_raytracer_tpu_torch.ops.bvh",
         "PACKED_VMEM_MAX_CLUSTERS"),
        ("jax_mega", "simple_raytracer_tpu.ops.pallas.bounce_kernel",
         "MEGA_PACKED_MAX_CLUSTERS"),
        ("port_mega", "simple_raytracer_tpu_torch.ops.scene_types",
         "MEGA_PACKED_MAX_CLUSTERS"),
        ("jax_slices", "simple_raytracer_tpu.ops.pallas.bounce_kernel",
         "MEGA_MT_SLICES"),
        ("port_slices", "simple_raytracer_tpu_torch.ops.cuda.trace_kernel",
         "MEGA_MT_SLICES"),
        ("port_cache", "simple_raytracer_tpu_torch.ops.cuda.build",
         "COMPILE_CACHE")):
    try:
        out[name] = getattr(importlib.import_module(mod), attr)
    except Exception as exc:
        out[name] = type(exc).__name__
import jax
out["jax_cache"] = bool(jax.config.jax_compilation_cache_dir)
print(json.dumps(out))
"""


def import_under(env: dict) -> subprocess.Popen:
    """The probe, started in a fresh process with ``env`` set (its JSON
    line on stdout)."""
    full = {k: v for k, v in os.environ.items()
            if k not in KNOBS and k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(env, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", IMPORT_PROBE], cwd=REPO,
                            env=full, stdout=subprocess.PIPE, text=True)


@pytest.fixture(scope="module", autouse=True)
def import_probes():
    """The import probe in two processes, started with the module's first
    test and read by the last: the switches set, and set to values int()
    refuses."""
    good = {"SRT_BVH_PACKED_VMEM_MAX": "700", "SRT_MEGA_PACKED_MAX": "760",
            "SRT_MEGA_MT_SLICES": "3", "SRT_NO_COMPILE_CACHE": "1"}
    bad = {"SRT_BVH_PACKED_VMEM_MAX": "7e2", "SRT_MEGA_PACKED_MAX": "x",
           "SRT_MEGA_MT_SLICES": "2.0"}
    procs = [import_under(env) for env in (good, bad)]
    yield procs
    for proc in procs:
        proc.kill()
        proc.wait()


def test_defaults_are_the_jax_packages():
    """With every variable unset (this process) the constants are the JAX
    modules' defaults; the ring depth is the port's own."""
    assert bvh.PACKED_VMEM_MAX_CLUSTERS == jbvh.PACKED_VMEM_MAX_CLUSTERS == 800
    assert (tst.MEGA_PACKED_MAX_CLUSTERS == jbk.MEGA_PACKED_MAX_CLUSTERS
            == 853)
    assert tk.MEGA_MT_SLICES == jbk.MEGA_MT_SLICES == 1
    assert build.COMPILE_CACHE
    assert bk.resolve_dma_slots() is None and jbvh._resolve_dma_slots() == 8


# -- the routes and the compaction policy -------------------------------------

def fake_clusters(c: int, k: int):
    """(JAX, port) stand-ins of a table of C clusters of K slots: the
    shapes the residency rules read (a packed table where the JAX scene
    builds one)."""
    packets = -(-k // 128) if bvh.packable(k) else None
    shape = types.SimpleNamespace
    jcl = shape(table_t=shape(shape=(c * k, 128)),
                table_tr=None if packets is None
                else shape(shape=(c, jbvh._TROWS * packets, 128)))
    tcl = shape(slots=torch.empty((c, k), dtype=torch.int32, device="meta"),
                k=k)
    return jcl, tcl


def jax_compacts(n: int, compact) -> bool:
    """closest_hit's route (ops/intersect.py:292): a cap, and room beside
    the ray index (intersect_triangles_bvh_compact's dense fallback)."""
    cap = jintersect.resolve_compact_cap(n, compact)
    return bool(cap) and cap < n and 31 - max((n - 1).bit_length(), 1) >= 4


def jax_variant(jcl) -> str:
    """intersect_triangles_bvh's residency as the port's variant names."""
    if jbvh.table_streams_hbm(jcl):
        return "streamed"
    return ("flat" if jcl.table_t.shape[0] <= jbvh.VMEM_TABLE_MAX_SLOTS
            else "two_level")


def jax_mega_fused(jcl) -> bool:
    """render_pass's whole-trace envelope under "fused" (ops/trace.py:
    277-292) for a clustered mesh."""
    return (jcl.table_t.shape[0] <= jbvh.VMEM_TABLE_MAX_SLOTS
            or (jcl.table_tr is not None
                and jcl.table_tr.shape[1] == jbvh._TROWS
                and jcl.table_tr.shape[0] <= jbk.MEGA_PACKED_MAX_CLUSTERS))


@pytest.mark.parametrize("packed,mega,compact,cap", [
    (800, 853, None, None), (700, 853, None, None), (800, 700, None, None),
    (800, 853, "0", None), (800, 853, "1", None), (700, 853, "auto", None),
    (800, 853, None, "300000"), (800, 853, "auto", "2000000"),
    (800, 853, "98304", None)])
def test_routes_and_compaction_per_bounce_as_jax(monkeypatch, packed, mega,
                                                 compact, cap):
    """Under each residency limit and SRT_BVH_COMPACT / _CAP value: the BVH
    variant, the whole-trace envelope under "fused", and for each bounce
    of the split path (bounce 0, the later ones) and of the fused path
    whether it compacts, on configs 4, 6 and 7's tables and K = 256, at
    4,608 to 2,073,600 rays, are the JAX package's.  The fused path's
    only difference: with both knobs unset the port compacts where "auto"
    allows, the JAX package never."""
    for mod in (jbvh, bvh):
        monkeypatch.setattr(mod, "PACKED_VMEM_MAX_CLUSTERS", packed)
    for mod in (jbk, tst):
        monkeypatch.setattr(mod, "MEGA_PACKED_MAX_CLUSTERS", mega)
    if compact is not None:
        monkeypatch.setenv("SRT_BVH_COMPACT", compact)
    if cap is not None:
        monkeypatch.setenv("SRT_BVH_COMPACT_CAP", cap)
    knob = compact is not None or cap is not None
    for c, k in ((32, 64), (768, 128), (11008, 128), (768, 256)):
        jcl, tcl = fake_clusters(c, k)
        assert bk.bvh_variant(tcl) == jax_variant(jcl)
        scene = types.SimpleNamespace(triangles=types.SimpleNamespace(
            material=torch.empty(c * k, device="meta"), clusters=tcl))
        assert ((tst.whole_trace_variant(scene, "fused") == "clustered")
                == jax_mega_fused(jcl))
        for n in (4608, 98305, 1036800, 2073600):
            b0 = "auto" if jbvh.table_streams_hbm(jcl) else None
            assert ttrace.split_compacts(n, tcl) == (
                jax_compacts(n, b0), jax_compacts(n, "auto"))
            fused = jax_compacts(n, None)
            assert ttrace.fused_compacts(n) == (
                fused if knob else jax_compacts(n, "auto"))
    if compact == "1":           # every bounce of every size compacts
        assert ttrace.split_compacts(4608, tcl) == (True, True)


def test_compaction_knobs_refuse_as_jax(monkeypatch):
    """A value int() refuses raises ValueError in both packages."""
    for name, value in (("SRT_BVH_COMPACT", "on"),
                        ("SRT_BVH_COMPACT_CAP", "1/20")):
        monkeypatch.setenv(name, value)
        for fn in (jintersect.resolve_compact_cap, bvh.resolve_compact_cap):
            with pytest.raises(ValueError):
                fn(1036800, "auto")
        monkeypatch.delenv(name)


# -- the compaction's key -----------------------------------------------------

@pytest.mark.parametrize("env,bits", [
    (None, 10), ("super", 10), ("morton", 10), ("morton", 6),
    ("morton", 5), ("auto", 14), ("morton", 4)])
def test_sort_key_resolves_as_jax(monkeypatch, env, bits):
    """SRT_BVH_COMPACT_KEY and the bucket bits give _resolve_sort_key's
    key: "morton" below 6 bits falls back to "super"."""
    if env is not None:
        monkeypatch.setenv("SRT_BVH_COMPACT_KEY", env)
    want = jbvh._resolve_sort_key(None, None, None, None, None, None, bits)
    assert bvh.resolve_sort_key(bits) == want
    n = 1 << (31 - bits)                 # the most rays of `bits` bits
    assert bvh.compact_key(n) == want


def test_sort_key_refuses_as_jax(monkeypatch):
    monkeypatch.setenv("SRT_BVH_COMPACT_KEY", "zorder")
    with pytest.raises(ValueError, match="super/morton/auto") as jerr:
        jbvh._resolve_sort_key(None, None, None, None, None, None, 10)
    with pytest.raises(ValueError) as terr:
        bvh.resolve_sort_key(10)
    assert str(terr.value) == str(jerr.value)


def index_bits_forced(monkeypatch, idx_bits: int) -> None:
    """Both packages' compaction keys with ``idx_bits`` bits of ray index,
    as a launch of 2^(idx_bits - 1) + 1 rays or more has, for a smaller
    batch: the port's ``bvh.index_bits``, and the builtin ``max`` of
    _compact_prefix's ``max((n - 1).bit_length(), 1)`` (its other call,
    ``max(nbits)``, keeps the builtin)."""
    import builtins
    monkeypatch.setattr(bvh, "index_bits", lambda n: idx_bits)

    def key_max(*args, **kw):
        if len(args) == 2 and args[1] == 1 and isinstance(args[0], int):
            return idx_bits
        return builtins.max(*args, **kw)
    monkeypatch.setattr(jbvh, "max", key_max, raising=False)


@pytest.mark.parametrize("n_rays,idx_bits,bits", [
    (70_000, None, 14), (1_100_000, None, 10), (5_000, 25, 6)])
def test_morton_order_matches_jax(scenes, monkeypatch, n_rays, idx_bits,
                                  bits):
    """compact_order under "morton" on config 5: the whole order and the
    count of _compact_prefix(..., "morton"), with origins inside, beside
    and 1e30 to 1e36 outside the mesh, dead rays and NaN rays, at 14 and
    10 bucket bits (70,000 and 1,100,000 rays) and at 6, a launch of 2^24
    + 1 rays or more, keyed so on 5,000 (``index_bits_forced``).  At 14
    bits the "super" order and count are _compact_prefix's too, and
    SRT_BVH_ORDER=rev changes neither order."""
    ds, ts, _ = scenes[5]
    if idx_bits is not None:
        index_bits_forced(monkeypatch, idx_bits)
    assert 31 - bvh.index_bits(n_rays) == bits
    data = rays(ts, n_rays, seed=bits)
    adm = ts.triangles.clusters.hierarchy.admission
    targs = port_args(*data)
    order, count = bvh.compact_order(*targs, adm, "morton")
    prefix, jcount = jbvh._compact_prefix(
        *jax_args(*data), ds.triangles.clusters.aabb, n_rays, "morton")
    assert int(count) == int(jcount)
    assert 0 < int(count) < n_rays
    assert np.array_equal(order.numpy(), np.asarray(prefix))
    if bits == 6:    # the admitted rays fill several of the 8 cells
        cells = bvh.morton_cells(targs[0], adm, bits)[order[:int(count)]]
        assert len(set(cells.tolist())) > 3
    if bits == 14:
        order_s, count_s = bvh.compact_order(*targs, adm, "super")
        prefix_s, _ = jbvh._compact_prefix(
            *jax_args(*data), ds.triangles.clusters.aabb, n_rays, "super")
        assert np.array_equal(order_s.numpy(), np.asarray(prefix_s))
        assert not torch.equal(order_s, order)
        monkeypatch.setenv("SRT_BVH_ORDER", "rev")
        for key, want in (("super", order_s), ("morton", order)):
            got, _ = bvh.compact_order(*targs, adm, key)
            assert torch.equal(got, want)


def test_morton_cells_quantise_as_xla(scenes):
    """An origin below, inside, past and far past the bounds and a NaN
    one: each axis truncated, saturated and clipped as XLA's f32 -> int32
    conversion and clip give (NaN to cell 0)."""
    _, ts, _ = scenes[5]
    adm = ts.triangles.clusters.hierarchy.admission
    real = adm[adm[:, 0] < 1e37]
    lo, hi = real[:, 0:3].amin(0), real[:, 3:6].amax(0)
    xs = torch.stack([lo - 1.0, lo, (lo + hi) * 0.5, hi, hi + 1.0,
                      torch.full((3,), 3e38), torch.full((3,), math.nan)])
    o = bvh.Vec3(xs[:, 0].contiguous(), xs[:, 1].contiguous(),
                 xs[:, 2].contiguous())
    cells = bvh.morton_cells(o, adm, 10).tolist()
    assert cells[0] == 0 and cells[-1] == 0
    assert cells[3] == cells[4] == cells[5] == 2 ** 7 - 1
    assert 0 < cells[2] < 2 ** 7 - 1


def test_cpu_route_compacts_with_the_resolved_key(scenes, monkeypatch):
    """The wrapper's CPU route under SRT_BVH_COMPACT_KEY=morton (the plain
    version over compact_order's Morton prefix) gives the dense plain
    version's (t, slot) on every live ray."""
    _, ts, _ = scenes[5]
    tr = ts.triangles
    o, d, alive, t_init = port_args(*rays(ts, 3000, seed=3, wild=False))
    dense = bk.intersect_triangles_bvh(o, d, alive, t_init, tr.clusters,
                                       tr.table)
    monkeypatch.setenv("SRT_BVH_COMPACT_KEY", "morton")
    assert bvh.compact_key(3000) == "morton"
    comp = bk.intersect_triangles_bvh(o, d, alive, t_init, tr.clusters,
                                      tr.table, compact=True)
    live = alive > 0
    assert torch.equal(comp[1][live], dense[1][live])
    assert torch.equal(comp[0][live], dense[0][live])
    assert int((dense[1][live] >= 0).sum()) > 50


# -- the reverse visiting order and sort_rays ---------------------------------

def jax_front_to_back(o, alive):
    """The JAX wrapper's own visiting order, ``front_to_back`` (a closure
    inside intersect_triangles_bvh over its rays' o and alive, which reads
    SRT_BVH_ORDER), as a function of the boxes: its code with those two
    cells, run eagerly."""
    code = next(c for c in jbvh.intersect_triangles_bvh.__wrapped__
                .__code__.co_consts
                if getattr(c, "co_name", None) == "front_to_back")
    cells = {"o": types.CellType(o), "alive": types.CellType(alive)}
    return types.FunctionType(code, vars(jbvh), "front_to_back", None,
                              tuple(cells[n] for n in code.co_freevars))


def jax_supers(aabb):
    """The JAX wrapper's super boxes of a two-level launch: the clusters
    padded with sentinels to whole groups, unioned 16 at a time."""
    n = aabb.shape[0]
    quantum = jbvh._SUPER * jbvh._GROUP
    c_pad = -(-n // quantum) * quantum
    sent = jnp.full((c_pad - n, 8), 3.0e38, jnp.float32).at[:, 6:].set(0.0)
    return jbvh._union_boxes8(jnp.concatenate([aabb, sent]).reshape(
        -1, jbvh._SUPER, 8))


@pytest.mark.parametrize("rev", [False, True], ids=["ftb", "rev"])
def test_visiting_order_matches_jax(scenes, monkeypatch, rev):
    """front_to_back (reversed under SRT_BVH_ORDER=rev, as the wrapper asks
    of it) is the JAX wrapper's front_to_back: on config 5's 64 cluster
    boxes (its flat _kernel's order) and config 6's 48 supers (the order
    sort_rays ranks by); the compaction's order never reverses."""
    if rev:
        monkeypatch.setenv("SRT_BVH_ORDER", "rev")
    assert bvh.reverse_order() is rev
    for n in (5, 6):
        ds, ts, _ = scenes[n]
        data = rays(ts, 1000, seed=n, wild=False)
        o, d, alive, t_init = port_args(*data)
        jo, _, jalive, _ = jax_args(*data)
        ftb = jax_front_to_back(jo, jalive)
        cl = ts.triangles.clusters
        jsup = jax_supers(ds.triangles.clusters.aabb)
        assert np.array_equal(np.asarray(jsup), cl.hierarchy.supers.numpy())
        # config 5's flat order, config 6's supers (sort_rays' order)
        boxes = ((cl.aabb, ds.triangles.clusters.aabb) if n == 5 else
                 (cl.hierarchy.supers, jsup),)
        for tb, jb in boxes:
            want = np.asarray(ftb(jb))
            got = bvh.front_to_back(tb, o, alive > 0, bvh.reverse_order())
            assert np.array_equal(got.numpy(), want)
            plain = bvh.front_to_back(tb, o, alive > 0)
            assert rev == (not torch.equal(got, plain))
        adm = cl.hierarchy.admission
        order, count = bvh.compact_order(o, d, alive, t_init, adm)
        with monkeypatch.context() as m:
            m.delenv("SRT_BVH_ORDER", raising=False)
            order0, count0 = bvh.compact_order(o, d, alive, t_init, adm)
        assert torch.equal(order, order0) and int(count) == int(count0)


@pytest.mark.parametrize("rev", [False, True], ids=["ftb", "rev"])
def test_sort_rays_matches_jax(scenes, monkeypatch, rev):
    """sort_rays' permutation is _sort_rays_by_super's over the JAX
    wrapper's supers in its front_to_back order (back to front under
    rev), in chunks of rays as in one; the sorted streamed call gives the
    unsorted call's (t, slot) on every ray; a compacted or non-streamed
    call never sorts."""
    if rev:
        monkeypatch.setenv("SRT_BVH_ORDER", "rev")
    ds, ts, _ = scenes[6]
    tr = ts.triangles
    data = rays(ts, 1000, seed=7, wild=False)
    args = port_args(*data)
    jargs = jax_args(*data)
    jsup = jax_supers(ds.triangles.clusters.aabb)
    want = jbvh._sort_rays_by_super(
        *jargs, jsup, jax_front_to_back(jargs[0], jargs[2])(jsup))
    perm = bk.sort_rays_order(*args, tr.clusters)
    assert np.array_equal(perm.numpy(), np.asarray(want))
    assert not torch.equal(perm, torch.arange(1000))
    with monkeypatch.context() as m:      # 7 rays a chunk
        m.setitem(bvh.PAIR_CHUNK_ELEMS, "cpu", 4 * 48 * 7)
        assert torch.equal(bk.sort_rays_order(*args, tr.clusters), perm)
    if not rev:
        return              # the results, once: no order changes them
    ref = bk.intersect_triangles_bvh(*args, tr.clusters, tr.table,
                                     force_streamed=True)
    calls = []
    real = bk.sort_rays_order
    monkeypatch.setattr(bk, "sort_rays_order",
                        lambda *a: calls.append(1) or real(*a))
    out = bk.intersect_triangles_bvh(*args, tr.clusters, tr.table,
                                     force_streamed=True, sort_rays=True)
    assert calls and torch.equal(out[0], ref[0])
    assert torch.equal(out[1], ref[1])
    assert int((ref[1] >= 0).sum()) > 30
    calls.clear()
    few = tuple(bvh.Vec3(*(c[:64] for c in a)) if isinstance(a, bvh.Vec3)
                else a[:64] for a in args)
    bk.intersect_triangles_bvh(*few, tr.clusters, tr.table, sort_rays=True)
    bk.intersect_triangles_bvh(*few, tr.clusters, tr.table, compact=True,
                               force_streamed=True, sort_rays=True)
    assert not calls        # two_level, and a compacted launch


# -- the ring depth -----------------------------------------------------------

@pytest.mark.parametrize("value", ["2", "4", "16", "1", "0", "-3", "eight"])
def test_dma_slots_resolve_as_jax(monkeypatch, value):
    """SRT_BVH_DMA_SLOTS: a depth of 2 or more is the JAX depth; below 2,
    or not an int, both raise ValueError, in the same words."""
    monkeypatch.setenv("SRT_BVH_DMA_SLOTS", value)
    try:
        want = jbvh._resolve_dma_slots()
    except ValueError as exc:
        with pytest.raises(ValueError) as err:
            bk.resolve_dma_slots()
        assert str(err.value) == str(exc)
        return
    assert bk.resolve_dma_slots() == want == int(value)


def test_ring_builds_and_limits():
    """A depth gets a build of its own (-DSRT_BVH_STAGES, named by the
    depth), the port's own depth the route's build; the source's ring,
    chunk and shared-memory layout are the wrapper's; a ring that does not
    fit an H100's 227 KB a block raises before any launch (16 fits in the
    MT and sub-box forms, not in the Plucker form)."""
    src = Path(bk.SOURCE).read_text()
    for name, value in (("STAGES", bk.STAGES), ("CHUNK", bk.CHUNK)):
        assert f"#define SRT_BVH_{name} {value}\n" in src
    assert "constexpr int kWarps = kBlock / 32;" in src
    assert "constexpr int kBlock = 128;" in src and bk.WALK_WARPS == 4
    assert bk.ring_kernel(bk.STAGES) is bk.KERNEL
    k4 = bk.ring_kernel(4)
    assert k4 is bk.ring_kernel(4) and k4.tag == "ring4"
    assert "-DSRT_BVH_STAGES=4" in k4.flags and k4.source == bk.SOURCE
    # the source's own note: 24 KB (40 KB) a block at 2 x 64, 44 KB with
    # the sub-box buffers, and one 8-byte barrier a buffer
    assert bk.walk_shared_bytes(2, False, 0) == 24 * 1024 + 4 * 2 * 8
    assert bk.walk_shared_bytes(2, True, 0) == 40 * 1024 + 4 * 2 * 8
    assert bk.walk_shared_bytes(2, False, 16) == 44 * 1024 + 4 * 3 * 8
    for stages, plucker, sub in ((16, False, 0), (16, False, 16),
                                 (11, True, 0)):
        bk.check_ring(stages, plucker, sub, H100_SHARED_OPTIN)
    with pytest.raises(ValueError, match="232448 B"):
        bk.check_ring(16, True, 0, H100_SHARED_OPTIN)
    with pytest.raises(ValueError, match="SRT_BVH_DMA_SLOTS=19"):
        bk.check_ring(19, False, 0, H100_SHARED_OPTIN)


def test_options_struct_matches_cuda_source():
    """BvhOptions, passed by value before BvhParams, has the CUDA struct's
    fields in order; srt_bvh_morton_keys takes the rays, the admission
    boxes, the keys and the count, then BvhParams and the stream; the C
    interface is 4."""
    import ctypes
    import re
    src = Path(bk.SOURCE).read_text()
    body = re.search(r"struct BvhOptions \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*int32_t (\w+);", body, re.M)
    assert [n for n, _ in bk.BvhOptions._fields_] == fields
    assert all(t is ctypes.c_int32 for _, t in bk.BvhOptions._fields_)
    for fn in ("srt_bvh_launch", "srt_bvh_count_launch"):
        sig = re.search(rf"int {fn}\((.*?)\)", src, re.S).group(1)
        assert re.search(r"BvhOptions opt, BvhParams p,\s+void\* stream$",
                         sig.strip()), fn
    sig = re.search(r"int srt_bvh_morton_keys\((.*?)\)", src, re.S).group(1)
    assert re.findall(r"\*\s*(\w+)", sig) == [
        "ox", "oy", "oz", "dx", "dy", "dz", "alive", "t_init", "admission",
        "keys", "count", "stream"]
    assert bk.MORTON_ARGTYPES == [ctypes.c_void_p] * 11 + [
        bk.BvhParams, ctypes.c_void_p]
    assert "srt_bvh_interface() { return 4; }" in src and bk.INTERFACE == 4


# -- the whole-trace kernel's MT slices ---------------------------------------

class _Reached(Exception):
    """The JAX whole trace got past its checks to its kernel."""


@pytest.fixture(scope="module")
def whole_trace_scenes():
    """The JAX scenes of configs 4 (clustered) and 2 (no triangles)."""
    jax_native_accel()
    return {n: JCONFIGS[n](width=16, height=8)[0].build() for n in (4, 2)}


@pytest.mark.parametrize("slices", [1, 2, 3, 12, 0, 5, -1, 24])
def test_mega_mt_slices_rule_as_jax(whole_trace_scenes, monkeypatch,
                                    slices):
    """SRT_MEGA_MT_SLICES on a clustered whole trace (config 4): the values
    trace_full_fused takes pass the port's check, the others raise its
    ValueError in its words; a scene without clusters (config 2) never
    reads it."""
    monkeypatch.setattr(jbk, "MEGA_MT_SLICES", slices)

    def pallas_call(*a, **kw):
        raise _Reached

    monkeypatch.setattr(jbk.pl, "pallas_call", pallas_call)
    eye = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    at = types.SimpleNamespace(x=0.0, y=1.0, z=4.0)
    for n, variant in ((4, "clustered"), (2, "none")):
        try:
            jbk.trace_full_fused(whole_trace_scenes[n], eye, at, 2.0, 0.5,
                                 1, width=16, height=8, num_samples=1,
                                 num_bounces=2)
        except _Reached:
            tk.check_mt_slices(variant, slices)
        except ValueError as exc:
            assert variant == "clustered"
            with pytest.raises(ValueError) as err:
                tk.check_mt_slices(variant, slices)
            assert str(err.value) == str(exc)
        else:
            raise AssertionError("the JAX whole trace ran no kernel")


def test_mega_mt_slices_change_no_image(monkeypatch):
    """The port's clustered whole trace gives the same rows under every
    valid SRT_MEGA_MT_SLICES and refuses an invalid one before tracing."""
    scene, camera, options = CONFIGS[4](width=16, height=8)
    from simple_raytracer_tpu_torch.engine import Renderer
    r = Renderer(options, scene, device="cpu")
    assert tst.whole_trace_variant(r.device_scene) == "clustered"
    cam = camera.state(2.0)
    args = (r.device_scene, camera_rotation(cam.yaw, cam.pitch),
            cam.position, cam.aspect_ratio, cam.fov_scale, 3)
    kw = dict(width=16, height=8, num_samples=1, num_bounces=3)
    ref = tk.trace_full(*args, **kw)
    monkeypatch.setattr(tk, "MEGA_MT_SLICES", 4)
    got = tk.trace_full(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    monkeypatch.setattr(tk, "MEGA_MT_SLICES", 5)
    with pytest.raises(ValueError, match="block_r/128 = 12"):
        tk.trace_full(*args, **kw)


# -- the host library and the build cache -------------------------------------

def _tiny_library(directory: Path) -> Path:
    src = directory / "tiny.cpp"
    src.write_text('extern "C" int srt_tiny() { return 7; }\n')
    return src


def test_native_lib_names_the_host_library(monkeypatch, tmp_path):
    """SRT_NATIVE_LIB naming the JAX package's native library: the port
    loads it instead of its own, and its BVH is the port's own library's,
    bit for bit; a missing file, or a library without the four entry
    points, raises."""
    jaccel = jax_native_accel()
    path = jaccel._LIB._name
    pos = np.random.default_rng(9).normal(size=(700, 3, 3)).astype(np.float32)
    own = accel.build_bvh(pos)
    monkeypatch.setenv("SRT_NATIVE_LIB", path)
    assert accel.host_library()._name == path
    named = accel.build_bvh(pos)
    for a, b in zip(own, named):
        assert np.array_equal(a, b)
    monkeypatch.setenv("SRT_NATIVE_LIB", str(tmp_path / "missing.so"))
    with pytest.raises(RuntimeError, match="no such file"):
        accel.host_library()
    lib = tmp_path / "libtiny.so"
    subprocess.run([os.environ.get("CXX") or "g++", "-shared", "-fPIC",
                    "-o", str(lib), str(_tiny_library(tmp_path))],
                   check=True, capture_output=True)
    monkeypatch.setenv("SRT_NATIVE_LIB", str(lib))
    with pytest.raises(RuntimeError, match="lacks srt_bvh_build"):
        accel.host_library()


def test_no_compile_cache_builds_anew(monkeypatch, tmp_path):
    """With the cache (the default) a source's build lands in BUILD_DIR
    and is reused; under SRT_NO_COMPILE_CACHE every build lands in a fresh
    temporary directory beside it."""
    src = _tiny_library(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b" / "kernels")
    bind = lambda lib: None
    lib = build.HostLibrary(src, bind).library()
    assert Path(lib._name).parent == build.BUILD_DIR
    assert build.HostLibrary(src, bind).library()._name == lib._name
    monkeypatch.setattr(build, "COMPILE_CACHE", False)
    dirs = {Path(build.HostLibrary(src, bind).library()._name).parent
            for _ in range(2)}
    assert len(dirs) == 2 and build.BUILD_DIR not in dirs
    assert all(p.parent == build.BUILD_DIR.parent for p in dirs)


def test_switches_read_at_import_as_jax(import_probes):
    """Each constant read at import equals the JAX module's under the same
    variables (``import_probes``: values set, values int() refuses, which
    fail both imports with ValueError); SRT_NO_COMPILE_CACHE turns off the
    port's build cache as it turns off JAX's persistent compile cache."""
    got, got_bad = (json.loads(p.communicate(timeout=120)[0].strip()
                               .splitlines()[-1]) for p in import_probes)
    for what in ("packed", "mega", "slices"):
        assert got[f"port_{what}"] == got[f"jax_{what}"], (what, got)
        assert got_bad[f"port_{what}"] == "ValueError", got_bad
        assert got_bad[f"jax_{what}"] == "ValueError", got_bad
    assert got["port_packed"] == 700 and got["port_mega"] == 760
    assert got["port_slices"] == 3
    assert got["port_cache"] is False and got["jax_cache"] is False
