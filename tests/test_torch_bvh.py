"""The per-bounce paths' BVH pieces (ops/bvh.py, ops/cuda/bvh_kernel.py,
intersect.closest_hit_split) against simple_raytracer_tpu's
ops/pallas/bvh_kernel.py.

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there).  Here the plain version is held to the TPU kernels
``_kernel``, ``_kernel_packed`` and ``_kernel_hbm`` (the streamed table,
row or packed), run in Pallas interpret mode with block_r=128 as
tests/test_bvh_kernel.py runs them, on a 320-triangle icosphere: the same
hit masks and winner indices, and t within rtol=1e-5, the JAX test's own
tolerance (interpret mode runs under jit, where XLA:CPU contracts
multiply-adds, so t may differ by an ulp).  The plain version's coarse
gates (groups, supers) give the results of testing every (ray, cluster)
pair, bit for bit, on configs 5 and 6.  The
TPU gates Moller-Trumbore for a 128-ray sub-block, the port for each ray
alone; on these sets no hit differs (a grazing hit that MT accepts just
outside a box its ray's own slab test rejects would show here).

The host steps (the slab test, the box unions, the admission boxes) are
bit-equal to JAX's; the compacted route gives the dense route's results
for every live ray; the routing follows the TPU's rules.
"""
import ctypes
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.models import Scene as JScene
from simple_raytracer_tpu.models.meshgen import icosphere
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops import intersect as jint
from simple_raytracer_tpu.ops.pallas import bvh_kernel as jbvh
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops import intersect as tint
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import (jax_native_accel, jax_scene_arrays, jvec,
                                to_np, tvec, unit_vectors)

RTOL = 1e-5   # tests/test_bvh_kernel.py's bound on t (see the docstring)


@pytest.fixture
def jax_native():
    """The JAX package on its default BVH builder, its native library (the
    port's host library builds the same tree)."""
    jax_native_accel()


def _ico_scene(k):
    pos, nrm = icosphere(subdivisions=2)          # 320 triangles
    sc = JScene()
    sc.cluster_threshold = 64
    sc.cluster_size = k
    sc.add_model(sc.pool.append(pos, nrm))
    ds = sc.build()
    return ds, from_numpy(jax_scene_arrays(ds), "cpu")


def _ray_set(n, seed, inside=False):
    """Random rays (origins in [-3, 3]^3 aimed at random points within 1.2
    of the unit icosphere's center, or origins inside it in random
    directions), t_init a mix of +inf and finite seeds, about 10% dead
    rays."""
    r = np.random.default_rng(seed)
    if inside:
        o = (unit_vectors(r, n) * r.uniform(0, 0.8, (n, 1))).astype(
            np.float32)
        d = unit_vectors(r, n)
    else:
        o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
        d = unit_vectors(r, n) * r.uniform(0, 1.2, (n, 1)) - o
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_init = np.where(r.uniform(size=n) < 0.5, np.inf,
                      r.uniform(0.2, 5.0, n)).astype(np.float32)
    alive = (r.uniform(size=n) > 0.1).astype(np.float32)
    return o, d, alive, t_init


def _jax_bvh(ds, o, d, alive, t_init, route):
    cl = ds.triangles.clusters
    kw = dict(block_r=128, interpret=True)
    if route == "packed_vmem":
        kw.update(table_tr=cl.table_tr, packed_vmem=True)
    elif route in ("hbm", "hbm_packed"):
        # _kernel_hbm, as tri_backend="clustered" forces it
        kw.update(hbm_table=True,
                  table_tr=cl.table_tr if route == "hbm_packed" else None)
    t, i = jbvh.intersect_triangles_bvh(
        jvec(o), jvec(d), jnp.asarray(alive), jnp.asarray(t_init), cl.aabb,
        cl.table_t, **kw)
    return np.asarray(t), np.asarray(i)


def _port_bvh(ts, o, d, alive, t_init):
    """The plain version's t and the winners' triangle indices; each
    winner's slot holds its triangle's table row."""
    tr = ts.triangles
    t, slot = bvh.intersect_triangles_bvh_plain(
        tvec(o), tvec(d), torch.from_numpy(alive), torch.from_numpy(t_init),
        tr.clusters, tr.table)
    assert slot.dtype == torch.int32
    i = bvh.triangle_index(tr.clusters, slot)
    won = slot >= 0
    np.testing.assert_array_equal(tr.table[slot[won].long(), 0:3].numpy(),
                                  tr.v0[i[won].long()].numpy())
    return t.numpy(), i.numpy()


def _assert_same_hits(jt, ji, pt, pi, live):
    assert pi.dtype == np.int32
    hit = ji[live] >= 0
    np.testing.assert_array_equal(pi[live] >= 0, hit)
    np.testing.assert_array_equal(pi[live][hit], ji[live][hit])
    np.testing.assert_allclose(pt[live][hit], jt[live][hit], rtol=RTOL)
    assert np.isinf(pt[live][~hit]).all() and (pi[live][~hit] == -1).all()
    return int(hit.sum())


@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("route", ["kernel", "packed_vmem", "hbm",
                                   "hbm_packed"])
def test_plain_matches_tpu_kernels(route, k):
    """The plain version against _kernel, _kernel_packed and _kernel_hbm
    (streaming the row table or the packed one) on random rays with
    t_init seeds and dead rays."""
    ds, ts = _ico_scene(k)
    assert ts.triangles.clusters.k == k
    offset = {"kernel": 1, "packed_vmem": 0, "hbm": 2, "hbm_packed": 3}
    o, d, alive, t_init = _ray_set(640, seed=k + offset[route])
    jt, ji = _jax_bvh(ds, o, d, alive, t_init, route)
    pt, pi = _port_bvh(ts, o, d, alive, t_init)
    live = alive > 0
    assert _assert_same_hits(jt, ji, pt, pi, live) > 50
    assert (pi[~live] == -1).all()    # a dead ray is a miss in the port
    # t_init is honoured: no reported hit at or beyond it
    assert (pt[pi >= 0] < t_init[pi >= 0]).all()


def test_rays_starting_inside_the_mesh():
    ds, ts = _ico_scene(64)
    o, d, alive, t_init = _ray_set(512, seed=7, inside=True)
    jt, ji = _jax_bvh(ds, o, d, alive, t_init, "kernel")
    pt, pi = _port_bvh(ts, o, d, alive, t_init)
    live = alive > 0
    # every ray from inside the closed sphere with t_init = inf hits it
    assert (pi[live & np.isinf(t_init)] >= 0).all()
    assert _assert_same_hits(jt, ji, pt, pi, live) > 200


def _tie_tables():
    """Two identical triangles in two clusters of 8 slots, global indices
    5 (slot 0, cluster 0) and 2 (slot 8, cluster 1), facing rays down -z."""
    c, k = 2, 8
    table = np.zeros((c * k, 128), np.float32)
    for slot, g in ((0, 5.0), (k, 2.0)):
        table[slot, 0:3] = [-1.0, -1.0, -2.0]
        table[slot, 3:6] = [2.0, 0.0, 0.0]
        table[slot, 6:9] = [0.0, 2.0, 0.0]
        table[slot, 9:18] = [0, 0, 1, 0, 0, 1, 0, 0, 1]
        table[slot, 19] = 1.0
        table[slot, 20] = g
    aabb = np.zeros((c, 8), np.float32)
    aabb[:, 0:3] = [-1.0, -1.0, -2.0]
    aabb[:, 3:6] = [1.0, 1.0, -2.0]
    slots = np.where(table[:, 19] > 0, table[:, 20], -1).astype(
        np.int64).reshape(c, k)
    return table, aabb, slots


def _clusters(aabb, slots):
    a, s = torch.from_numpy(aabb), torch.from_numpy(slots)
    return types.SimpleNamespace(aabb=a, slots=s, k=s.shape[1],
                                 hierarchy=bvh.build_hierarchy(a, s))


def test_equal_t_tie_across_clusters_picks_lowest_index():
    """An exact tie across clusters goes to the lowest global index, as in
    the TPU kernels (tests/test_bvh_kernel.py's tie), whatever the order;
    a tie with t_init keeps the seed (no triangle hit)."""
    table, aabb, slots = _tie_tables()
    n = 128
    o = np.zeros((n, 3), np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    alive = np.ones(n, np.float32)
    t_init = np.full(n, np.inf, np.float32)
    t_init[:8] = 2.0                      # exactly the triangles' t
    jt, ji = jbvh.intersect_triangles_bvh(
        jvec(o), jvec(d), jnp.asarray(alive), jnp.asarray(t_init),
        jnp.asarray(aabb), jnp.asarray(table), block_r=128, interpret=True)
    cl = _clusters(aabb, slots)
    tab = torch.from_numpy(np.ascontiguousarray(table[:, :20]))
    pt, ps = bvh.intersect_triangles_bvh_plain(
        tvec(o), tvec(d), torch.from_numpy(alive), torch.from_numpy(t_init),
        cl, tab)
    assert (ps.numpy()[8:] == 8).all()            # slot 8 holds index 2
    pi = bvh.triangle_index(cl, ps)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert (pi.numpy()[8:] == 2).all() and (pi.numpy()[:8] == -1).all()
    np.testing.assert_array_equal(pt.numpy()[8:], 2.0)
    assert np.isinf(pt.numpy()[:8]).all()


def test_slab_test_matches_visit_prepass():
    """slab_maybe per (box, ray) equals _visit_prepass's visit bits with
    one ray per block: closed intervals (flat boxes), the t_init cap,
    sentinel boxes, dead rays, and NaN slabs (a zero direction component
    with the origin on a box plane)."""
    r = np.random.default_rng(3)
    n, c = 256, 40
    lo = r.uniform(-2, 1, (c, 3)).astype(np.float32)
    hi = (lo + r.uniform(0, 1, (c, 3))).astype(np.float32)
    hi[:5, 1] = lo[:5, 1]                             # flat boxes
    aabb = np.concatenate([lo, hi, np.zeros((c, 2), np.float32)], 1)
    aabb[-4:, :6] = 3.0e38                            # sentinels
    o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = unit_vectors(r, n)
    d[:16, 0] = 0.0                                   # 1 / 0 = inf
    o[:8, 0] = aabb[:8, 0]                            # (lo - o) * inf = NaN
    d[16:24] = [0.0, 1.0, 0.0]
    t_init = np.where(r.uniform(size=n) < 0.5, np.inf,
                      r.uniform(0.1, 4, n)).astype(np.float32)
    alive = (r.uniform(size=n) > 0.2).astype(np.float32)
    packed, counts = jbvh._visit_prepass(
        jvec(o), jvec(d), jnp.asarray(alive), jnp.asarray(t_init),
        jnp.asarray(aabb), 1, 0)
    bits = np.asarray(packed).view(np.uint32)         # (R, words)
    want = np.stack([(bits[:, j // 32] >> (j % 32)) & 1 for j in range(c)]
                    ).astype(bool)                    # (C, R)
    got = bvh.slab_maybe(torch.from_numpy(aabb), tvec(o),
                         bvh.inverse(tvec(d)), torch.from_numpy(t_init),
                         torch.from_numpy(alive) > 0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(0), np.asarray(counts))
    assert got[:, :8].any() and not got[-4:].any()


def test_unions_and_admission_boxes_match(jax_native):
    """union_boxes8, the hierarchy's supers and groups, and the admission
    boxes are bit-equal to _union_boxes8, the super/group boxes
    intersect_triangles_bvh builds, and _admission_boxes: on config 6's
    768 boxes and on 5,000 random ones (two rounds of admission unions)."""
    r = np.random.default_rng(5)
    lo = r.uniform(-5, 5, (5000, 3)).astype(np.float32)
    rand = np.concatenate([lo, lo + r.uniform(0, 1, (5000, 3)).astype(
        np.float32), np.zeros((5000, 2), np.float32)], 1)
    rand[r.uniform(size=5000) < 0.1, :6] = 3.0e38
    scene, _, _ = JCONFIGS[6](width=64, height=36)
    cfg6 = np.array(scene.build().triangles.clusters.aabb)
    assert cfg6.shape == (768, 8)
    for aabb in (cfg6, rand):
        ta = torch.from_numpy(aabb)
        np.testing.assert_array_equal(
            bvh.union_boxes8(ta.reshape(-1, 8, 8)).numpy(),
            np.asarray(jbvh._union_boxes8(jnp.asarray(aabb).reshape(
                -1, 8, 8))))
        h = bvh.build_hierarchy(ta, torch.zeros(aabb.shape[0], 1,
                                                dtype=torch.int64))
        q = jbvh._SUPER * jbvh._GROUP
        c_pad = -(-aabb.shape[0] // q) * q
        sent = np.zeros((c_pad - aabb.shape[0], 8), np.float32)
        sent[:, :6] = 3.0e38
        pad = jnp.asarray(np.concatenate([aabb, sent]))
        sup = jbvh._union_boxes8(pad.reshape(-1, jbvh._SUPER, 8))
        top = jbvh._union_boxes8(sup.reshape(-1, jbvh._GROUP, 8))
        np.testing.assert_array_equal(h.boxes.numpy(), np.asarray(pad))
        np.testing.assert_array_equal(h.supers.numpy(), np.asarray(sup))
        np.testing.assert_array_equal(h.groups.numpy(), np.asarray(top))
        np.testing.assert_array_equal(
            h.admission.numpy(),
            np.asarray(jbvh._admission_boxes(jnp.asarray(aabb))))
    assert h.admission.shape[0] <= 256 < 5000 // 16


def _mesh_rays(ts, n, seed):
    """Rays from around the mesh toward random points of its box."""
    r = np.random.default_rng(seed)
    tr = ts.triangles
    v = tr.v0.numpy()[tr.active.numpy()]
    target = r.uniform(v.min(0), v.max(0), size=(n, 3)).astype(np.float32)
    o = (target + 3.0 * r.normal(size=(n, 3))).astype(np.float32)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("every_ray_admits", [False, True])
def test_compacted_route_equals_dense_route(every_ray_admits):
    """compact_order and the compacted route against the dense route, live
    rays compared: the same (t, idx).  The admitted rays come first, their
    count is the JAX prefix's count, and with every ray admitting (the
    TPU's overflow case, where it falls back to the dense kernel) the
    order holds every ray."""
    ds, ts = _ico_scene(64)
    n = 1500
    o, d, alive, t_init = _ray_set(n, seed=11, inside=every_ray_admits)
    if every_ray_admits:
        alive[:] = 1.0
        t_init[:] = np.inf
    cl = ts.triangles.clusters
    args = (tvec(o), tvec(d), torch.from_numpy(alive),
            torch.from_numpy(t_init))
    order, count = bvh.compact_order(*args, cl.hierarchy.admission)
    count = int(count)
    _, jcount = jbvh._compact_prefix(
        jvec(o), jvec(d), jnp.asarray(alive), jnp.asarray(t_init),
        ds.triangles.clusters.aabb, n, "super")
    assert count == int(jcount)
    assert sorted(order.tolist()) == list(range(n))
    admitted = bvh.slab_maybe(cl.hierarchy.admission, tvec(o),
                              bvh.inverse(tvec(d)), torch.from_numpy(t_init),
                              torch.from_numpy(alive) > 0).any(0).numpy()
    assert set(order[:count].tolist()) == set(np.nonzero(admitted)[0])
    if every_ray_admits:
        assert count == n
    else:
        assert 0 < count < n
    tc, sc = bk.intersect_triangles_bvh(*args, cl, ts.triangles.table,
                                        compact=True)
    td, sd = bk.intersect_triangles_bvh(*args, cl, ts.triangles.table)
    live = alive > 0
    np.testing.assert_array_equal(sc.numpy()[live], sd.numpy()[live])
    np.testing.assert_array_equal(tc.numpy()[live], td.numpy()[live])
    assert (sd.numpy()[live] >= 0).sum() > 100


def test_barycentric_weights_match_jax():
    """Bit-equal to the JAX functions, run eagerly."""
    r = np.random.default_rng(2)
    v0, v1, v2 = (r.normal(size=(4000, 3)).astype(np.float32)
                  for _ in range(3))
    w = r.uniform(0, 1, (4000, 3)).astype(np.float32)
    p = (v0 * w[:, :1] + v1 * w[:, 1:2] + v2 * w[:, 2:]).astype(np.float32)
    want = jint.barycentric_weights(jvec(v0), jvec(v1), jvec(v2), jvec(p))
    got = tint.barycentric_weights(tvec(v0), tvec(v1), tvec(v2), tvec(p))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = jint.barycentric_weights_from_edges(jvec(v1), jvec(v2), jvec(p))
    got = tint.barycentric_weights_from_edges(tvec(v1), tvec(v2), tvec(p))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.fixture
def interpret_bvh(monkeypatch):
    """JAX's BVH kernel in interpret mode with 128-ray blocks, as
    tests/test_bvh_kernel.py:441-452 runs it inside closest_hit."""
    orig = jbvh.intersect_triangles_bvh

    def interp(o, d, alive, t_init, aabb, table_t, block_r=1536,
               interpret=False, **kw):
        return orig(o, d, alive, t_init, aabb, table_t, block_r=128,
                    interpret=True, **kw)

    monkeypatch.setattr(jbvh, "intersect_triangles_bvh", interp)


@pytest.mark.parametrize("n_cfg", [4, 6])
def test_closest_hit_split_matches_jax_bvh(n_cfg, jax_native, interpret_bvh):
    """The split path's nearest hit against JAX's closest_hit with
    tri_backend="bvh" (the BVH kernel in interpret mode, its winner shaded
    at the hit position): the same hits and materials, t within RTOL and
    normals within 1e-5 (t's ulp moves the position)."""
    scene, _, _ = JCONFIGS[n_cfg](width=64, height=36)
    ds = scene.build()
    ts = from_numpy(jax_scene_arrays(ds), "cpu")
    o, d = _mesh_rays(ts, 512, 30 + n_cfg)
    alive = np.random.default_rng(n_cfg).uniform(size=512) > 0.1
    jh = jint.closest_hit(ds, jvec(o), jvec(d), tri_backend="bvh",
                          alive=jnp.asarray(alive))
    th = tint.closest_hit_split(ts, tvec(o), tvec(d), torch.from_numpy(alive))
    hit = np.asarray(jh.hit) & alive
    np.testing.assert_array_equal(th.hit.numpy() & alive, hit)
    assert th.triangle.numpy()[hit].mean() > 0.3
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit],
                               rtol=RTOL)
    np.testing.assert_array_equal(th.material.numpy()[hit],
                                  np.asarray(jh.material)[hit])
    np.testing.assert_allclose(to_np(th.normal)[hit], to_np(jh.normal)[hit],
                               rtol=0, atol=1e-5)


def test_closest_hit_split_dense_meshes_match_jax():
    """A mesh without clusters takes the dense loop on the split path, as
    the JAX "jnp" route: 16 triangles (config 3) and a mid-size 100 that
    the whole-trace kernel does not serve.  Both run eagerly, so t,
    materials and the position-barycentric normals are bit-equal."""
    from simple_raytracer_tpu_torch.models.meshgen import icosphere as tico
    pos, nrm = tico(subdivisions=2)
    sc = JScene()
    sc.add_model(sc.pool.append(pos[:100], nrm[:100]))
    kw = {"skybox": "gradient"}
    for ds in (JCONFIGS[3](width=64, height=36, **kw)[0].build(), sc.build()):
        ts = from_numpy(jax_scene_arrays(ds), "cpu")
        assert ts.triangles.clusters is None
        o, d = _mesh_rays(ts, 3000, 40)
        alive = torch.ones(3000, dtype=torch.bool)
        jh = jint.closest_hit(ds, jvec(o), jvec(d), tri_backend="jnp",
                              tri_chunk=4096)
        th = tint.closest_hit_split(ts, tvec(o), tvec(d), alive)
        hit = np.asarray(jh.hit)
        np.testing.assert_array_equal(th.hit.numpy(), hit)
        assert hit.mean() > 0.3
        np.testing.assert_array_equal(th.t.numpy(), np.asarray(jh.t))
        np.testing.assert_array_equal(th.material.numpy()[hit],
                                      np.asarray(jh.material)[hit])
        np.testing.assert_array_equal(to_np(th.normal)[hit],
                                      to_np(jh.normal)[hit])


def test_residency_and_compaction_rules_match_jax(jax_native):
    """table_streams_hbm, compact_cap_auto and the variant choice follow
    the TPU's rules: configs 4 and 5 fit the row table (flat), config 6
    the packed one (two_level, bounce 0 dense), config 7's 11,008
    clusters of 128 stream (the streamed variant), and "clustered" forces
    the streamed variant on any table, as hbm_table=True does."""
    for n in (4, 5, 6):
        ds = JCONFIGS[n](width=64, height=36)[0].build()
        ts = from_numpy(jax_scene_arrays(ds), "cpu")
        cl = ts.triangles.clusters
        assert bvh.table_streams_hbm(cl) == jbvh.table_streams_hbm(
            ds.triangles.clusters) is False
        assert bk.bvh_variant(cl) == ("two_level" if n == 6 else "flat")
        assert bk.bvh_variant(cl, force_streamed=True) == "streamed"
    assert cl.slots.shape == (768, 128)
    shape = lambda *s: types.SimpleNamespace(shape=s)
    for c, k in ((11008, 128), (801, 128), (800, 128), (400, 256)):
        jcl = types.SimpleNamespace(
            table_t=shape(c * k, 128),
            table_tr=shape(c, 24 * (-(-k // 128)), 128))
        tcl = types.SimpleNamespace(slots=torch.zeros(c, k), k=k)
        assert bvh.table_streams_hbm(tcl) == jbvh.table_streams_hbm(jcl)
    assert bk.bvh_variant(types.SimpleNamespace(
        slots=torch.zeros(11008, 128), k=128)) == "streamed"
    for n in (4608, 98303, 98304, 1036800, 2073600):
        assert bvh.compact_cap_auto(n) == jbvh.compact_cap_auto(n)
    assert not bvh.compacts(4608) and bvh.compacts(1036800)


def test_cuda_path_has_no_plain_fallback(monkeypatch):
    """Rays on a device other than the CPU go to the kernel's prepare,
    which raises off the card; the plain version is never called, with or
    without compaction."""
    _, ts = _ico_scene(64)
    calls = []
    monkeypatch.setattr(bvh, "intersect_triangles_bvh_plain",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(bvh, "intersect_compacted_plain",
                        lambda *a, **k: calls.append(a))
    meta = from_numpy(jax_scene_arrays(_ico_scene(64)[0]), "meta")
    o = tvec(np.zeros((8, 3), np.float32))
    o = type(o)(*(c.to("meta") for c in o))
    ones = torch.ones(8, device="meta")
    before = bk.KERNEL.launches
    for compact in (False, True):
        with pytest.raises(ValueError, match="unsupported device"):
            bk.intersect_triangles_bvh(o, o, ones, ones,
                                       meta.triangles.clusters,
                                       meta.triangles.table, compact=compact)
    assert not calls and bk.KERNEL.launches == before


def test_launch_struct_matches_cuda_source():
    """ctypes passes BvhParams by value: its fields must be the CUDA
    struct's, in order; the launch takes as many pointers as the wrapper
    passes."""
    src = Path(bk.SOURCE).read_text()
    body = re.search(r"struct BvhParams \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*int32_t (\w+);", body, re.M)
    assert [n for n, _ in bk.BvhParams._fields_] == fields
    assert all(t is ctypes.c_int32 for _, t in bk.BvhParams._fields_)
    sig = re.search(r"int srt_bvh_launch\((.*?)\)", src, re.S).group(1)
    assert sig.count("*") == bk.LAUNCH_ARGTYPES.count(ctypes.c_void_p)
    assert bk.LAUNCH_ARGTYPES[-2] is bk.BvhParams
    for name, value in bk.VARIANTS.items():
        camel = "k" + "".join(w.title() for w in name.split("_"))
        assert re.search(rf"{camel} = {value}\b", src), name
    # the counting instance takes the same arguments and its counters; the
    # ray arrays come in Prepared.rays' order (o, d, alive, t_init)
    sig_c = re.search(r"int srt_bvh_count_launch\((.*?)\)", src,
                      re.S).group(1)
    assert sig_c.count("*") == bk.COUNT_ARGTYPES.count(ctypes.c_void_p)
    assert sig_c.count("*") == sig.count("*") + 1
    assert bk.COUNT_ARGTYPES[-2] is bk.BvhParams
    for s in (sig, sig_c):
        names = re.findall(r"\*\s*(\w+)", s)
        assert names[:8] == ["ox", "oy", "oz", "dx", "dy", "dz", "alive",
                             "t_init"]
    assert re.search(r"long long srt_bvh_work_words\(BvhParams p\)", src)


def _every_pair_plain(o, d, alive, t_init, clusters, table):
    """The plain version without the coarse gates: the slab test of every
    (live ray, cluster) pair, then the same MT and commit."""
    n_rays = o.x.shape[0]
    n_cl, k = clusters.slots.shape
    live = alive > 0
    inv = bvh.inverse(d)
    cols = table.reshape(n_cl, k, table.shape[1])
    gidx = clusters.hierarchy.gidx.to(torch.int64)
    key = ((gidx << 32) | torch.arange(n_cl * k)).reshape(n_cl, k)
    best_t = t_init.clone()
    best_key = torch.full((n_rays,), -1, dtype=torch.int64)
    c_idx, r_idx = bvh.slab_maybe(clusters.aabb, o, inv, t_init,
                                  live).nonzero(as_tuple=True)
    ray = lambda v: v[r_idx][:, None]
    t, valid = bvh._mt(ray(o.x), ray(o.y), ray(o.z), ray(d.x), ray(d.y),
                       ray(d.z), lambda j: cols[:, :, j][c_idx])
    t = torch.where(valid, t, float("inf"))
    local_t = t.amin(dim=1)
    local_key = torch.where(valid & (t == local_t[:, None]), key[c_idx],
                            bvh._NO_KEY).amin(dim=1)
    new_t = best_t.scatter_reduce(0, r_idx, local_t, "amin")
    cand = torch.where(local_t == new_t[r_idx], local_key, bvh._NO_KEY)
    keep = torch.where(best_t == new_t, best_key, bvh._NO_KEY)
    best_key = keep.scatter_reduce(0, r_idx, cand, "amin")
    won = best_key >= 0
    return (torch.where(won, new_t, float("inf")),
            torch.where(won, best_key & 0xFFFFFFFF, -1).to(torch.int32))


@pytest.mark.parametrize("n_cfg", [5, 6])
def test_coarse_gates_equal_every_pair(n_cfg):
    """The plain version walks groups, then supers, then clusters; a union
    box contains its members, so it gives, bit for bit, the results of
    testing every (ray, cluster) pair: on config 5 (64 clusters, one
    group) and config 6 (768 clusters, three groups), for camera rays and
    rays at the mesh with t_init seeds and dead rays."""
    from simple_raytracer_tpu_torch.models.presets import CONFIGS
    from simple_raytracer_tpu_torch.ops.camera import (camera_rotation,
                                                       generate_rays)
    scene, camera, _ = CONFIGS[n_cfg](width=64, height=36)
    ts = scene.build("cpu")
    cl = ts.triangles.clusters
    cam = camera.state(64 / 36)
    o1, d1, _ = generate_rays(64, 36, 1, 3, cam.position,
                              camera_rotation(cam.yaw, cam.pitch),
                              cam.aspect_ratio, cam.fov_scale)
    o2, d2 = _mesh_rays(ts, 3000, 50 + n_cfg)
    o = type(o1)(*(torch.cat([a, torch.from_numpy(b)])
                   for a, b in zip(o1, o2.T)))
    d = type(d1)(*(torch.cat([a, torch.from_numpy(b)])
                   for a, b in zip(d1, d2.T)))
    n = o.x.shape[0]
    r = np.random.default_rng(n_cfg)
    t_init = torch.from_numpy(np.where(r.uniform(size=n) < 0.5, np.inf,
                                       r.uniform(0.5, 6.0, n)
                                       ).astype(np.float32))
    alive = torch.from_numpy((r.uniform(size=n) > 0.1).astype(np.float32))
    t_a, s_a = bvh.intersect_triangles_bvh_plain(o, d, alive, t_init, cl,
                                                 ts.triangles.table)
    t_b, s_b = _every_pair_plain(o, d, alive, t_init, cl,
                                 ts.triangles.table)
    assert torch.equal(s_a, s_b) and torch.equal(t_a, t_b)
    assert int((s_a >= 0).sum()) > 1000
