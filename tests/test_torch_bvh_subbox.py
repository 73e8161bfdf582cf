"""The BVH kernel's sub-box form (SRT_BVH_SUBBOX: ``_subbox_word`` and
``_mt_gated_sub``, the JAX package's fourth culling level) as the CPU can
check it, against simple_raytracer_tpu.

The CUDA kernel's form runs only on the card (chip_smoke.py holds its
launches to the gated plain version and to the ungated kernel there).
Here, with exact equality unless a test says otherwise:

- the port's ``Scene.build`` makes the JAX build's (C * 8, 8) sub-box
  table bit for bit, at K = 64 and 128 with empty ranges, on a refit too,
  and none without the knob;
- ``coarsen_sub_aabb`` is the JAX one at each division;
- the gated plain version gives every ray the (t, triangle) of the JAX
  ``_kernel_packed`` and ``_kernel_hbm`` with their sub-box gate (Pallas
  interpret mode, block_r=128; t within rtol=1e-5, the JAX test's own
  bound: interpret mode runs under jit, where XLA:CPU contracts
  multiply-adds) and the (t, slot) of the port's ungated
  plain version, in ``two_level`` and ``streamed``, dense and compacted,
  at div 2, 4 and 8 (and at K = 64 and K = 192, whose 24-slot ranges
  straddle the walk's 64-slot chunks);
- the warp walk's sub-box form, transcribed (``warp_walk_emulation``
  with ``sub``: when the walk takes a super, its sub-box block is copied
  and each lane's words of the clusters it admits made as one batch, the
  clusters and chunks no lane wants skipped, MT only over the lane's
  ranges), gives the gated plain version's (t, slot) on config 6's
  hierarchy, and on the icosphere's, whose cluster count is not a
  multiple of 16 (K = 64 and 192), with fewer lane-slot MT tests than the
  ungated walk;
- a whole pass under SRT_BVH_SUBBOX=8 keeps to the JAX package's within
  the golden bound (RMSE < 2e-3) and equals the port's ungated pass;
- a bad value raises the JAX package's error, and ``_sub_box_rows`` and
  ``resolve_plucker`` decide as the JAX rule does.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.engine import Renderer as JRenderer
from simple_raytracer_tpu.engine import RenderOptions as JOptions
from simple_raytracer_tpu.models import Scene as JScene
from simple_raytracer_tpu.models.meshgen import icosphere
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops.pallas import bvh_kernel as jbvh
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.meshgen import icosphere as ticosphere
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.models.scene import Scene as TScene
from simple_raytracer_tpu_torch.models.scene import sub_boxes
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import (jax_scene_arrays, jvec, tvec, unit_vectors,
                                use_builder, warp_walk_emulation)

BOUND = 2e-3      # tests/test_golden.py's bound on a whole pass
RTOL = 1e-5       # tests/test_bvh_kernel.py's bound on t against JAX


def _jax_scene(k, subbox="8"):
    """The 320-triangle icosphere clustered at K = k by the JAX package,
    built with SRT_BVH_SUBBOX=subbox (None: unset), and carried across."""
    pos, nrm = icosphere(subdivisions=2)
    sc = JScene()
    sc.cluster_threshold = 64
    sc.cluster_size = k
    sc.add_model(sc.pool.append(pos, nrm))
    with pytest.MonkeyPatch.context() as mp:
        if subbox is None:
            mp.delenv("SRT_BVH_SUBBOX", raising=False)
        else:
            mp.setenv("SRT_BVH_SUBBOX", subbox)
        ds = sc.build()
    return ds, from_numpy(jax_scene_arrays(ds), "cpu")


def _ray_set(n, seed):
    """Rays from [-3, 3]^3 at points within 1.2 of the center, t_init a
    mix of +inf and finite seeds, about 10% dead rays."""
    r = np.random.default_rng(seed)
    o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = unit_vectors(r, n) * r.uniform(0, 1.2, (n, 1)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_init = np.where(r.uniform(size=n) < 0.5, np.inf,
                      r.uniform(0.2, 5.0, n)).astype(np.float32)
    alive = (r.uniform(size=n) > 0.1).astype(np.float32)
    return o, d, alive, t_init


def _port_scene(k, subbox, move=None):
    """The port's own build of the same icosphere at K = k under
    SRT_BVH_SUBBOX=subbox (None: unset); with ``move`` (a 4x4 transform)
    the model is then moved and the scene refit.  Returns the built
    arrays and the device scene of the last build."""
    pos, nrm = ticosphere(subdivisions=2)
    sc = TScene()
    sc.cluster_threshold = 64
    sc.cluster_size = k
    model = sc.add_model(sc.pool.append(pos, nrm))
    with pytest.MonkeyPatch.context() as mp:
        if subbox is None:
            mp.delenv("SRT_BVH_SUBBOX", raising=False)
        else:
            mp.setenv("SRT_BVH_SUBBOX", subbox)
        ds = sc.build("cpu")
        arrays = sc.arrays()
        if move is not None:
            sc.set_model_transform(model, move)
            ds = sc.build("cpu", refit=True)
            arrays = sc.arrays(refit=True)
    return arrays, ds


MOVE = np.array([[0.8, 0.0, 0.6, 0.3], [0.0, 1.0, 0.0, -0.2],
                 [-0.6, 0.0, 0.8, 1.1], [0.0, 0.0, 0.0, 1.0]], np.float32)


@pytest.mark.parametrize("k", [64, 128])
def test_scene_sub_aabb_matches_jax(k, monkeypatch):
    """Scene.build under SRT_BVH_SUBBOX=8 makes the JAX build's table bit
    for bit (both packages' SAH builders give the same clusters), with
    ranges that hold no triangle as sentinel boxes beside filled ones;
    from_numpy carries the JAX table across unchanged; a refit after a
    move makes the JAX refit's table (the boxes of the moved triangles,
    not the stale ones); without the knob neither package builds one."""
    use_builder(monkeypatch, "sah")
    ds, carried = _jax_scene(k)
    want = np.asarray(ds.triangles.clusters.sub_aabb)
    arrays, own = _port_scene(k, "8")
    got = arrays["clusters.sub_aabb"]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        own.triangles.clusters.sub_aabb.numpy().view(np.int32),
        want.view(np.int32))
    np.testing.assert_array_equal(
        carried.triangles.clusters.sub_aabb.numpy().view(np.int32),
        want.view(np.int32))
    # empty ranges: the sentinel in both corners, zeros in columns 6:8,
    # and clusters that hold both kinds
    empty = want[:, 0] >= 1e38
    assert (want[empty, 0:6] == np.float32(3e38)).all()
    assert not want[:, 6:].any()
    per = empty.reshape(-1, 8)
    assert (per.any(1) & ~per.all(1)).any() and per.all(1).any()
    # the table bounds each range's vertices
    pos = np.stack([arrays[f"triangles.v{i}"] for i in range(3)], axis=1)
    np.testing.assert_array_equal(sub_boxes(pos, arrays["clusters.slots"]),
                                  got)
    # a refit: the JAX package's refit, and a table of the moved mesh
    jpos, jnrm = icosphere(subdivisions=2)
    sc = JScene()
    sc.cluster_threshold = 64
    sc.cluster_size = k
    m = sc.add_model(sc.pool.append(jpos, jnrm))
    monkeypatch.setenv("SRT_BVH_SUBBOX", "8")
    sc.build()
    m.transform = MOVE
    jrefit = np.asarray(sc.build(refit=True).triangles.clusters.sub_aabb)
    arrays, _ = _port_scene(k, "8", move=MOVE)
    np.testing.assert_array_equal(arrays["clusters.sub_aabb"].view(np.int32),
                                  jrefit.view(np.int32))
    assert not np.array_equal(jrefit, want)
    # no knob: no table in either package
    monkeypatch.delenv("SRT_BVH_SUBBOX")
    assert sc.build().triangles.clusters.sub_aabb is None
    arrays, own = _port_scene(k, None)
    assert "clusters.sub_aabb" not in arrays
    assert own.triangles.clusters.sub_aabb is None
    _, own = _port_scene(k, "0")
    assert own.triangles.clusters.sub_aabb is None


@pytest.mark.parametrize("div", [2, 4, 8])
def test_coarsen_sub_aabb_matches_jax(div):
    """coarsen_sub_aabb on the K = 64 table (with its sentinel ranges) and
    on random boxes: the JAX function's table bit for bit."""
    ds, _ = _jax_scene(64)
    r = np.random.default_rng(div)
    lo = r.uniform(-2, 1, (64, 3)).astype(np.float32)
    rand = np.zeros((64, 8), np.float32)
    rand[:, 0:3] = lo
    rand[:, 3:6] = lo + r.uniform(0, 1, (64, 3)).astype(np.float32)
    rand[r.uniform(size=64) < 0.3, 0:6] = np.float32(3e38)
    for table in (np.asarray(ds.triangles.clusters.sub_aabb), rand):
        want = np.asarray(jbvh.coarsen_sub_aabb(jnp.asarray(table), div))
        got = bvh.coarsen_sub_aabb(torch.from_numpy(table), div).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def _count_rows(monkeypatch):
    """Record what bvh._sub_box_rows decides for each plain call."""
    seen = []
    rule = bvh._sub_box_rows

    def spy(*args):
        seen.append(rule(*args))
        return seen[-1]

    monkeypatch.setattr(bvh, "_sub_box_rows", spy)
    return seen


# (K, TPU route, division): the packed table resident (two_level) or
# streamed (streamed), a K = 64 table, and K = 192 (no packed table: the
# TPU streams row tiles; its 24-slot ranges straddle the walk's chunks)
GATED = ([(128, r, div) for r in ("packed_vmem", "hbm_packed")
          for div in (2, 4, 8)]
         + [(64, "hbm_packed", 8), (192, "hbm_rows", 8)])


@pytest.mark.parametrize("k,route,div", GATED,
                         ids=[f"k{k}-{r}-div{d}" for k, r, d in GATED])
def test_gated_plain_matches_jax_and_ungated(k, route, div, monkeypatch):
    """The port's wrapper on CPU tensors under SRT_BVH_SUBBOX=div (its
    gated plain version, in the variant the TPU route maps to) against
    the JAX kernel with the same sub-box gate in interpret mode: the same
    hits and winners, t within RTOL; and against the port's ungated plain version on
    the same rays, dense and compacted: the same (t, slot)."""
    ds, ts = _jax_scene(k)
    cl = ds.triangles.clusters
    o, d, alive, t_init = _ray_set(640, seed=k + div)
    kw = (dict(packed_vmem=True) if route == "packed_vmem"
          else dict(hbm_table=True))
    jt, ji = jbvh.intersect_triangles_bvh(
        jvec(o), jvec(d), jnp.asarray(alive), jnp.asarray(t_init),
        cl.aabb, cl.table_t, block_r=128, interpret=True,
        table_tr=cl.table_tr, sub_aabb=cl.sub_aabb, sub_div=div, **kw)
    jt, ji = np.asarray(jt), np.asarray(ji)
    tr = ts.triangles
    if route == "packed_vmem":
        monkeypatch.setattr(bvh, "VMEM_TABLE_MAX_SLOTS", 128)
    streamed = route != "packed_vmem"
    variant = bk.bvh_variant(tr.clusters, force_streamed=streamed)
    assert variant == ("streamed" if streamed else "two_level")
    rays = (tvec(o), tvec(d), torch.from_numpy(alive),
            torch.from_numpy(t_init))
    monkeypatch.setenv("SRT_BVH_SUBBOX", str(div))
    seen = _count_rows(monkeypatch)
    gated = {c: bk.intersect_triangles_bvh(*rays, tr.clusters, tr.table,
                                           compact=c,
                                           force_streamed=streamed)
             for c in (False, True)}
    assert seen == [k // div] * 2
    monkeypatch.delenv("SRT_BVH_SUBBOX")
    t_u, s_u = bk.intersect_triangles_bvh(*rays, tr.clusters, tr.table,
                                          force_streamed=streamed)
    assert seen[-1] == 0
    live = alive > 0
    hits = 0
    for c, (t_g, s_g) in gated.items():
        assert torch.equal(s_g, s_u) and torch.equal(t_g, t_u), c
        idx = bvh.triangle_index(tr.clusters, s_g).numpy()
        np.testing.assert_array_equal(idx[live] >= 0, ji[live] >= 0)
        np.testing.assert_array_equal(idx[live], np.where(
            ji[live] >= 0, ji[live], -1))
        hit = idx[live] >= 0
        np.testing.assert_allclose(t_g.numpy()[live][hit], jt[live][hit],
                                   rtol=RTOL)
        assert np.isinf(jt[live][~hit]).all()
        hits = int((idx[live] >= 0).sum())
    assert hits > 100


def _gate_share(ts, rays, div):
    """The share of (admitted pair, slot range) tests the sub-box gate
    rejects on these rays: what makes the gated and ungated runs differ
    in work, not in result."""
    o, d, alive, t_init = rays
    cl = ts.triangles.clusters
    sub = bvh.coarsen_sub_aabb(cl.sub_aabb, div).reshape(-1, 8, 8)[:, :div]
    inv = bvh.inverse(d)
    total = met = 0
    for c, r in bvh.admitted_pairs(o, inv, alive > 0, t_init, cl, 2 ** 20):
        pick = lambda v: bvh.Vec3(v.x[r][:, None], v.y[r][:, None],
                                  v.z[r][:, None])
        meet = bvh._slab(lambda j: sub[c][:, :, j], pick(o), pick(inv),
                         t_init[r][:, None])
        total += meet.numel()
        met += int(meet.sum())
    return 1 - met / max(total, 1)


def test_gate_rejects_ranges():
    """The gate has work to skip on these scenes: a good share of the
    admitted pairs' ranges lie beyond the ray's slab."""
    _, ts = _jax_scene(128)
    o, d, alive, t_init = _ray_set(640, seed=3)
    rays = (tvec(o), tvec(d), torch.from_numpy(alive),
            torch.from_numpy(t_init))
    share = _gate_share(ts, rays, 8)
    assert 0.2 < share < 1.0


@pytest.fixture(scope="module")
def config6():
    """Config 6 at its preset size (768 clusters of 128) under
    SRT_BVH_SUBBOX=8, JAX's scene carried across (the port's own build of
    it is held to JAX's above), and one secondary-bounce-like ray set."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SRT_BVH_SUBBOX", "8")
        jscene, _, _ = JCONFIGS[6](width=64, height=36)
        ts = from_numpy(jax_scene_arrays(jscene.build()), "cpu")
    cl = ts.triangles.clusters
    assert cl.slots.shape == (768, 128) and cl.sub_aabb is not None
    box = cl.aabb[cl.aabb[:, 0] < 1e37]
    lo, hi = box[:, 0:3].amin(0).numpy(), box[:, 3:6].amax(0).numpy()
    r = np.random.default_rng(66)
    n = 512
    tgt = lo + r.uniform(0, 1, (n, 3)) * (hi - lo)
    o = (tgt + unit_vectors(r, n) * 3.0).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_init = np.where(r.uniform(size=n) < 0.7, np.inf,
                      r.uniform(1.0, 5.0, n)).astype(np.float32)
    alive = r.uniform(size=n) > 0.1
    return ts, (tvec(o), tvec(d), torch.from_numpy(alive),
                torch.from_numpy(t_init))


@pytest.mark.parametrize("div,split_max", [(8, 16), (8, 0), (8, 32),
                                           (2, 16)])
def test_warp_walk_sub_box_form_matches_plain(config6, div, split_max):
    """The warp walk's sub-box form transcribed (warp_walk_emulation with
    ``sub``) on config 6's hierarchy, MT split or per lane: the gated
    plain version's (t, slot) bit for bit, and that of the ungated
    walk; the gate skips chunks and whole clusters, and its lane-slot MT
    tests fall below the ungated walk's."""
    ts, rays = config6
    cl, table = ts.triangles.clusters, ts.triangles.table
    sub = (bvh.coarsen_sub_aabb(cl.sub_aabb, div), 128 // div)
    (t_g, s_g), cnt = warp_walk_emulation(*rays, cl, table, sub=sub,
                                          split_max=split_max)
    (t_u, s_u), cnt_u = warp_walk_emulation(*rays, cl, table,
                                            split_max=split_max)
    t_p, s_p = bvh.intersect_triangles_bvh_plain(*rays, cl, table, "mt",
                                                 cl.sub_aabb, div)
    assert torch.equal(s_g, s_p) and torch.equal(t_g, t_p)
    assert torch.equal(s_u, s_p) and torch.equal(t_u, t_p)
    assert int((s_p >= 0).sum()) > 100
    assert cnt["sub_tests"] > 0 and cnt["chunks_skipped"] > 0
    assert cnt["lane_slots"] < cnt_u["lane_slots"]


def _ico_walk(k, div, seed, nan_every=0):
    """The warp walk transcribed, gated at ``div`` and ungated, and the
    gated plain version, on the icosphere clustered at K = k (its cluster
    count not a multiple of 16: the last super's sub-box block is cut at
    the table's end) and 640 rays of ``_ray_set``; with ``nan_every``,
    every such ray live with a NaN direction, which admits every box, the
    sentinel ones of the supers past the table too (their block: the last
    cluster's rows)."""
    _, ts = _jax_scene(k)
    cl, table = ts.triangles.clusters, ts.triangles.table
    assert cl.slots.shape[0] % bvh.SUPER != 0
    o, d, alive, t_init = _ray_set(640, seed)
    if nan_every:
        d[::nan_every] = np.nan
        alive[::nan_every] = 1.0
    rays = (tvec(o), tvec(d), torch.from_numpy(alive),
            torch.from_numpy(t_init))
    sub = (bvh.coarsen_sub_aabb(cl.sub_aabb, div), k // div)
    gated = warp_walk_emulation(*rays, cl, table, sub=sub)
    ungated = warp_walk_emulation(*rays, cl, table)
    plain = bvh.intersect_triangles_bvh_plain(*rays, cl, table, "mt",
                                              cl.sub_aabb, div)
    return gated, ungated, plain


@pytest.mark.parametrize("k", [64, 192])
def test_warp_walk_sub_box_partial_super(k):
    """The super-at-a-time words on a hierarchy whose cluster count is not
    a multiple of 16 (the last super's block clamped to the table's end),
    at K = 64 and at K = 192 (24-slot ranges across the 64-slot chunks),
    with NaN rays that walk the supers past the table: the gated plain
    version's (t, slot) bit for bit, and the ungated walk's."""
    ((t_g, s_g), cnt), ((t_u, s_u), _), (t_p, s_p) = _ico_walk(k, 8, k, 160)
    assert torch.equal(s_g, s_p) and torch.equal(t_g, t_p)
    assert torch.equal(s_u, s_p) and torch.equal(t_u, t_p)
    assert int((s_p >= 0).sum()) > 100
    assert cnt["sub_tests"] > 0


@pytest.mark.parametrize("div", [2, 4, 8])
def test_warp_walk_sub_box_lane_slots_below_ungated(div):
    """The batch's words, though made with the t of the super's entry
    (at least the t when each cluster is found), still cut MT: on the K =
    64 icosphere at each division the gated walk slabs div sub-boxes for
    each admitting lane, issues fewer lane-slot MT tests than the ungated
    walk, and gives the gated plain version's (t, slot)."""
    ((t_g, s_g), cnt), ((_, _), cnt_u), (t_p, s_p) = _ico_walk(64, div, 7)
    assert torch.equal(s_g, s_p) and torch.equal(t_g, t_p)
    assert cnt["sub_tests"] > 0 and cnt["sub_tests"] % div == 0
    assert 0 < cnt["lane_slots"] < cnt_u["lane_slots"]


def test_whole_pass_matches_jax_and_ungated(monkeypatch):
    """Config 4 (K = 64) under tri_backend="clustered" (the streamed
    variant; JAX's _kernel_hbm in interpret mode) and SRT_BVH_SUBBOX=8:
    the port's pass keeps to the JAX package's gated pass within the
    golden bound (measured here: RMSE 2.6e-7) and equals, bit for bit, the
    port's pass on the same scene with the knob unset."""
    orig = jbvh.intersect_triangles_bvh
    calls = []

    def interp(o, d, alive, t_init, aabb, table_t, block_r=1536,
               interpret=False, **kw):
        calls.append(kw.get("sub_aabb") is not None and kw["sub_div"] == 8)
        return orig(o, d, alive, t_init, aabb, table_t, block_r=128,
                    interpret=True, **kw)

    monkeypatch.setattr(jbvh, "intersect_triangles_bvh", interp)
    monkeypatch.setenv("SRT_BVH_SUBBOX", "8")
    use_builder(monkeypatch, "sah")
    jscene, jcamera, _ = JCONFIGS[4](width=48, height=32)
    camera = CONFIGS[4](width=48, height=32)[1]
    kw = dict(width=48, height=32, num_samples=1, num_bounces=3,
              tri_backend="clustered")
    jr = JRenderer(JOptions(**kw), scene=jscene)
    jr.step(jcamera, time=9)
    assert calls and all(calls)
    carried = from_numpy(jax_scene_arrays(jscene.build()), "cpu")
    assert carried.triangles.clusters.k == 64
    seen = _count_rows(monkeypatch)
    canvases = []
    for knob in ("8", "0"):
        monkeypatch.setenv("SRT_BVH_SUBBOX", knob)
        r = Renderer(RenderOptions(**kw), device="cpu")
        r.set_device_scene(carried)
        r.step(camera, time=9)
        canvases.append(r.canvas.numpy())
    assert 8 in seen and seen[-1] == 0
    assert np.isfinite(canvases[0]).all()
    assert np.sqrt(np.mean((canvases[0] - np.asarray(jr.canvas)) ** 2)) \
        < BOUND
    np.testing.assert_array_equal(canvases[0], canvases[1])


@pytest.mark.parametrize("bad", ["3", "16", "on"])
def test_bad_value_raises_the_jax_error(bad, monkeypatch):
    """A value other than 0, 1, 2, 4 or 8 raises JAX's ValueError, from
    maybe_sub_aabb and from a BVH call; "1" is 8."""
    ds, ts = _jax_scene(128)
    monkeypatch.setenv("SRT_BVH_SUBBOX", bad)
    with pytest.raises(ValueError) as want:
        jbvh.maybe_sub_aabb(ds.triangles.clusters)
    with pytest.raises(ValueError) as got:
        bvh.maybe_sub_aabb(ts.triangles.clusters)
    assert str(got.value) == str(want.value)
    o, d, alive, t_init = _ray_set(32, seed=1)
    with pytest.raises(ValueError, match="SRT_BVH_SUBBOX must be"):
        bk.intersect_triangles_bvh(
            tvec(o), tvec(d), torch.from_numpy(alive),
            torch.from_numpy(t_init), ts.triangles.clusters, ts.triangles.table,
            force_streamed=True)
    monkeypatch.setenv("SRT_BVH_SUBBOX", "1")
    sub, div = bvh.maybe_sub_aabb(ts.triangles.clusters)
    assert div == 8 and sub is ts.triangles.clusters.sub_aabb
    assert jbvh.maybe_sub_aabb(ds.triangles.clusters)[1] == 8


def _record(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        decision = fn()
    return decision, [str(w.message) for w in caught]


@pytest.mark.parametrize("subbox", [None, "2", "4", "8"])
def test_sub_box_rows_and_plucker_match_jax(subbox, monkeypatch):
    """_sub_box_rows against the rule of JAX's intersect_triangles_bvh
    (bvh_kernel.py:1477-1479: a table, K % (8 * div) == 0, one packet) at
    K in {64, 128, 192, 256}, and resolve_plucker against _resolve_plucker
    with those rows, for each variant: the same rows, decisions and
    warnings; a launch gates exactly where the rows are nonzero, never in
    "flat"."""
    monkeypatch.setenv("SRT_BVH_MT", "plucker")
    if subbox is not None:
        monkeypatch.setenv("SRT_BVH_SUBBOX", subbox)
    seen = set()
    for k in (64, 128, 192, 256):
        ds, ts = _jax_scene(k, subbox)
        jcl, cl = ds.triangles.clusters, ts.triangles.clusters
        sub, div = jbvh.maybe_sub_aabb(jcl)
        packets = (jcl.table_tr.shape[1] // 24 if jcl.table_tr is not None
                   else 1)
        want_rows = (k // div if sub is not None and k % (8 * div) == 0
                     and packets == 1 else 0)
        rows = bvh._sub_box_rows(k, *bvh.maybe_sub_aabb(cl))
        assert rows == want_rows, (k, subbox)
        seen.add(rows > 0)
        for variant, packed in (("two_level", True),
                                ("streamed", jcl.table_tr is not None)):
            want = _record(lambda: jbvh._resolve_plucker(packed, want_rows))
            got = _record(lambda: bvh.resolve_plucker(cl, variant))
            assert got == want, (k, variant, subbox)
            _, _, _, launch_rows = bk.launch_tables(cl, ts.triangles.table,
                                                    variant, compact=False)
            assert launch_rows == rows
        _, _, _, flat_rows = bk.launch_tables(cl, ts.triangles.table,
                                              "flat", compact=False)
        assert flat_rows == 0
    assert seen == ({False} if subbox is None else {True, False})
