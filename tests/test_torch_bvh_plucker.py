"""The Plucker form of the BVH kernel's Moller-Trumbore (SRT_BVH_MT=plucker;
ops/bvh.py, ops/cuda/bvh_kernel.py), Scene.cluster_size and the lowering
probes, against simple_raytracer_tpu.

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there).  Here the plain Plucker version is held to JAX's
``_kernel_packed`` and ``_kernel_hbm`` under SRT_BVH_MT=plucker, run in
Pallas interpret mode with block_r=128 as tests/test_torch_bvh.py runs
them, at K = 128 (one packet) and K = 256 (two), on a 320-triangle
icosphere: the same hit masks and winners, and t within rtol=1e-4, the
JAX package's own bound for this form (tests/test_bvh_kernel.py:289-298).
The largest relative t differences observed on these sets: 3.25e-6
against JAX's Plucker form (JAX evaluates the dot products as one f32
matmul, the port in their index order) and 3.76e-6 against the port's own
MT form.
"""
import ctypes
import re
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.models import Scene as JScene
from simple_raytracer_tpu.models.meshgen import icosphere
from simple_raytracer_tpu.ops.pallas import bvh_kernel as jbvh
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.camera import Camera
from simple_raytracer_tpu_torch.models.materials import Material
from simple_raytracer_tpu_torch.models.scene import Scene as TScene
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.scripts import probe_kernel_ops as probe

from torch_port_helpers import (BUILDERS, jax_scene_arrays, jvec, tvec,
                                unit_vectors, use_builder)

RTOL = 1e-4   # tests/test_bvh_kernel.py's bound on the Plucker form's t


def _ico_scene(k, subbox=None):
    """The 320-triangle icosphere clustered at K = k (JAX's scene, carried
    across), built with SRT_BVH_SUBBOX set to ``subbox`` when given."""
    pos, nrm = icosphere(subdivisions=2)
    sc = JScene()
    sc.cluster_threshold = 64
    sc.cluster_size = k
    sc.add_model(sc.pool.append(pos, nrm))
    with pytest.MonkeyPatch.context() as mp:
        if subbox is not None:
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


@pytest.fixture(scope="module", params=[(r, k) for k in (128, 256)
                                        for r in ("packed_vmem",
                                                  "hbm_packed")],
                ids=lambda p: f"{p[0]}-k{p[1]}")
def plucker_case(request):
    """One JAX Plucker run per (route, K): the scene, the rays, JAX's
    (t, index) and whether its Plucker form traced."""
    route, k = request.param
    ds, ts = _ico_scene(k)
    cl = ds.triangles.clusters
    assert cl.table_tr is not None and cl.table_tr.shape[1] == 24 * (k // 128)
    o, d, alive, t_init = _ray_set(640, seed=k + (route == "hbm_packed"))
    kw = (dict(packed_vmem=True) if route == "packed_vmem"
          else dict(hbm_table=True))
    before = jbvh._PLUCKER_TRACES
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SRT_BVH_MT", "plucker")
        jbvh.intersect_triangles_bvh.clear_cache()
        try:
            t, i = jbvh.intersect_triangles_bvh(
                jvec(o), jvec(d), jnp.asarray(alive), jnp.asarray(t_init),
                cl.aabb, cl.table_t, block_r=128, interpret=True,
                table_tr=cl.table_tr, **kw)
        finally:
            jbvh.intersect_triangles_bvh.clear_cache()
    return dict(route=route, k=k, ts=ts, rays=(o, d, alive, t_init),
                jt=np.asarray(t), ji=np.asarray(i),
                traced=jbvh._PLUCKER_TRACES > before)


def _port(ts, rays, route, monkeypatch, form_env):
    """The port's wrapper on CPU tensors (its plain version) in the
    variant the route maps to: ``two_level`` for packed_vmem (the row
    table limit lowered, as the JAX test lowers it), ``streamed`` for
    hbm_packed.  Returns t, the winners' triangle indices, the variant."""
    o, d, alive, t_init = rays
    tr = ts.triangles
    if route == "packed_vmem":
        monkeypatch.setattr(bvh, "VMEM_TABLE_MAX_SLOTS", 128)
    streamed = route == "hbm_packed"
    variant = bk.bvh_variant(tr.clusters, force_streamed=streamed)
    if form_env:
        monkeypatch.setenv("SRT_BVH_MT", form_env)
    else:
        monkeypatch.delenv("SRT_BVH_MT", raising=False)
    t, slot = bk.intersect_triangles_bvh(
        tvec(o), tvec(d), torch.from_numpy(alive), torch.from_numpy(t_init),
        tr.clusters, tr.table, force_streamed=streamed)
    return t.numpy(), bvh.triangle_index(tr.clusters, slot).numpy(), variant


def test_plain_plucker_matches_jax_plucker(plucker_case, monkeypatch):
    """The plain Plucker version against _kernel_packed / _kernel_hbm
    under SRT_BVH_MT=plucker: the same hit masks and winners, t within
    RTOL; both packages' counters show the form ran."""
    c = plucker_case
    before = bvh.PLUCKER_CALLS
    pt, pi, variant = _port(c["ts"], c["rays"], c["route"], monkeypatch,
                            "plucker")
    assert variant == ("two_level" if c["route"] == "packed_vmem"
                       else "streamed")
    assert c["traced"] and bvh.PLUCKER_CALLS == before + 1
    live = c["rays"][2] > 0
    jt, ji = c["jt"][live], c["ji"][live]
    hit = ji >= 0
    np.testing.assert_array_equal(pi[live] >= 0, hit)
    np.testing.assert_array_equal(pi[live][hit], ji[hit])
    np.testing.assert_allclose(pt[live][hit], jt[hit], rtol=RTOL)
    assert np.isinf(pt[live][~hit]).all()
    assert hit.sum() > 50


def test_plucker_form_matches_mt_form(plucker_case, monkeypatch):
    """The port's Plucker form against its MT form on the same rays: the
    same hits and winners, t within RTOL (the two forms round
    differently)."""
    c = plucker_case
    pt, pi, _ = _port(c["ts"], c["rays"], c["route"], monkeypatch,
                      "plucker")
    before = bvh.PLUCKER_CALLS
    mt, mi, _ = _port(c["ts"], c["rays"], c["route"], monkeypatch, None)
    assert bvh.PLUCKER_CALLS == before
    live = c["rays"][2] > 0
    np.testing.assert_array_equal(pi[live], mi[live])
    hit = mi[live] >= 0
    np.testing.assert_allclose(pt[live][hit], mt[live][hit], rtol=RTOL)


def test_plucker_table_matches_plucker_lt():
    """plucker_table's rows are the nonzero entries of JAX's _plucker_lt
    (run eagerly on each packed tile), bit for bit, on every filled slot
    of K = 256's two packets (an empty slot is a zero row in the port, a
    copy of a real triangle's with active 0 in JAX); the table is built
    once per scene and cached."""
    ds, ts = _ico_scene(256)
    cl = ds.triangles.clusters
    tr = ts.triangles
    coeffs = bvh.plucker_coefficients(tr.clusters, tr.table)
    assert bvh.plucker_coefficients(tr.clusters, tr.table) is coeffs
    assert coeffs.shape == (tr.table.shape[0], bvh.PLUCKER_COLS)
    # LT's (plane, coefficient) entries in plucker_table's column order
    nonzero = ([(0, j) for j in range(6)] + [(1, j) for j in range(6)]
               + [(2, j) for j in range(3)] + [(3, j) for j in range(6, 10)]
               + [(4, 9)])
    got = coeffs.numpy().reshape(cl.aabb.shape[0], 256, bvh.PLUCKER_COLS)
    n_filled = 0
    for c in range(cl.aabb.shape[0]):
        for p in range(2):
            lt = np.asarray(jbvh._plucker_lt(cl.table_tr[c, 24 * p:24 * p
                                                         + 24]))
            lt = lt.reshape(10, 6, 128)
            want = np.stack([lt[j, plane] for plane, j in nonzero], axis=1)
            mine = got[c, 128 * p:128 * p + 128]
            filled = want[:, -1] > 0
            n_filled += int(filled.sum())
            np.testing.assert_array_equal(mine[filled], want[filled])
            assert not mine[~filled].any()
            # the planes plucker_table leaves out are zero in LT
            kept = np.zeros((6, 10), bool)
            for plane, j in nonzero:
                kept[plane, j] = True
            kept[5] = True     # gidx: the port's int32 index table
            assert not lt.transpose(1, 0, 2)[~kept].any()
    assert n_filled == 320


def _variants_and_jax(ds, k):
    """JAX's (packed, sub_rows) for a table of K-slot clusters, as
    intersect_triangles_bvh derives them (bvh_kernel.py:1333, 1477-1479,
    1503), and whether its route asks _resolve_plucker at all, per port
    variant."""
    cl = ds.triangles.clusters
    sub, div = jbvh.maybe_sub_aabb(cl)
    packets = cl.table_tr.shape[1] // 24 if cl.table_tr is not None else 1
    sub_rows = (k // div if sub is not None and k % (8 * div) == 0
                and packets == 1 else 0)
    return {"flat": None,                           # _kernel never asks
            "two_level": (True, sub_rows),          # _kernel_packed
            "streamed": (cl.table_tr is not None, sub_rows)}   # _kernel_hbm


def _record(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        decision = fn()
    return decision, [str(w.message) for w in caught]


@pytest.mark.parametrize("subbox", [None, "8"])
def test_resolve_plucker_matches_jax(subbox, monkeypatch):
    """resolve_plucker against _resolve_plucker for every variant, K in
    {64, 128, 192, 256} and SRT_BVH_SUBBOX unset or 8: the same decision
    and the same warnings; "flat" never asks and never warns.  Resolving
    counts nothing: only a call in the form is counted."""
    monkeypatch.setenv("SRT_BVH_MT", "plucker")
    before = bvh.PLUCKER_CALLS
    if subbox is not None:
        monkeypatch.setenv("SRT_BVH_SUBBOX", subbox)
    seen = set()
    for k in (64, 128, 192, 256):
        ds, ts = _ico_scene(k, subbox)
        for variant, args in _variants_and_jax(ds, k).items():
            want = ((False, []) if args is None
                    else _record(lambda: jbvh._resolve_plucker(*args)))
            got = _record(lambda: bvh.resolve_plucker(ts.triangles.clusters,
                                                      variant))
            assert got == want, (k, variant, subbox)
            seen.add((want[0], len(want[1])))
    # both outcomes, and refusals that warn, occur
    assert (True, 0) in seen and (False, 1) in seen
    assert bvh.PLUCKER_CALLS == before
    monkeypatch.setenv("SRT_BVH_MT", "mt")
    assert bvh.mt_form() == "mt" and not bvh.resolve_plucker(
        ts.triangles.clusters, "two_level")


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("k", [64, 128, 256])
def test_cluster_size_scene_matches_jax(k, builder, monkeypatch):
    """Scene.cluster_size forces K: the port's build equals the JAX
    package's cluster boxes, slots and triangles, both packages on either
    BVH builder (``use_builder``)."""
    use_builder(monkeypatch, builder)
    from simple_raytracer_tpu_torch.models.meshgen import icosphere as tico
    ds, _ = _ico_scene(k)
    want = jax_scene_arrays(ds)
    sc = TScene()
    sc.cluster_threshold = 64
    sc.cluster_size = k
    sc.add_model(sc.pool.append(*tico(subdivisions=2)))
    got = sc.build("cpu").triangles
    assert got.clusters.k == k
    np.testing.assert_array_equal(got.clusters.aabb.numpy(),
                                  want["clusters.aabb"])
    np.testing.assert_array_equal(got.clusters.slots.numpy(),
                                  want["clusters.slots"])
    np.testing.assert_array_equal(got.v0.numpy(), want["triangles.v0"])
    assert TScene.cluster_size is None


@pytest.mark.parametrize("k", [64, 256])
def test_plucker_render_matches_mt(k, monkeypatch):
    """A 64x36, 2 spp render of the icosphere (clustered at K = k) under
    tri_backend="clustered" (the streamed variant's plain version), the
    Plucker form against MT: canvas RMSE <= 1e-4, and every BVH call took
    the Plucker form."""
    from simple_raytracer_tpu_torch.models.meshgen import icosphere as tico
    sc = TScene()
    sc.cluster_threshold = 64
    sc.cluster_size = k
    lamp = sc.add_material(Material(emission=(1.0, 0.9, 0.7),
                                    emission_strength=3.0), "Lamp")
    sc.add_model(sc.pool.append(*tico(subdivisions=2)))
    sc.add_sphere((1.6, 0.8, 0.0), 0.5, material=lamp)
    sc.add_plane((0, -1.2, 0), (0, 1, 0))
    cam = Camera(position=(0.0, 0.5, 4.0))
    opts = RenderOptions(width=64, height=36, num_samples=2, num_bounces=4,
                         tri_backend="clustered")
    canvases = {}
    for form in ("mt", "plucker"):
        monkeypatch.setenv("SRT_BVH_MT", form)
        before = bvh.PLUCKER_CALLS
        r = Renderer(opts, sc, device="cpu")
        assert r.device_scene.triangles.clusters.k == k
        r.render(cam, num_steps=1)
        calls = bvh.PLUCKER_CALLS - before
        assert calls == (opts.num_bounces if form == "plucker" else 0)
        canvases[form] = r.canvas
    diff = canvases["plucker"] - canvases["mt"]
    assert float(diff.pow(2).mean().sqrt()) <= 1e-4
    assert float(canvases["mt"].std()) > 0


def test_cuda_sources_match_the_wrappers():
    """The coefficient count of the BVH kernel, and the probe kernel's
    launch struct and probe numbers, are the wrappers'."""
    src = Path(bk.SOURCE).read_text()
    assert re.search(rf"kPluckerCols = {bvh.PLUCKER_COLS};", src)
    assert "STREAMED_MAX_K" not in vars(bk) and "kMaxK" not in src
    # the streamed variant stages whole rows: five float4s a Plucker row,
    # three a staged MT row
    assert re.search(r"kPluckerRowF4 = kPluckerCols / 4;", src)
    assert bvh.PLUCKER_COLS % 4 == 0
    assert re.search(rf"kMtRowF4 = {bvh.STAGED_COLS // 4};", src)
    src = Path(probe.SOURCE).read_text()
    body = re.search(r"struct ProbeParams \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*int32_t (\w+);", body, re.M)
    assert [n for n, _ in probe.ProbeParams._fields_] == fields
    assert all(t is ctypes.c_int32 for _, t in probe.ProbeParams._fields_)
    sig = re.search(r"int srt_probe_launch\((.*?)\)", src, re.S).group(1)
    assert sig.count("*") == probe.LAUNCH_ARGTYPES.count(ctypes.c_void_p)
    names = {"A": "kColumnSum", "B": "kScalarSum", "C": "kGatedLoop"}
    for name, (value, _, _) in probe.PROBES.items():
        assert re.search(rf"{names[name]} = {value}\b", src), name


def test_probe_plain_versions_and_cpu_run(monkeypatch):
    """The probes' plain versions give the TPU probes' outputs (the sum
    65536 for A and B, zeros for C); run on the CPU times nothing; a
    CUDA-less tensor elsewhere goes to the kernel, which raises, and is
    not counted."""
    res = probe.run("cpu")
    assert {n: r["value"] for n, r in res.items()} == {
        "A": 65536.0, "B": 65536.0, "C": 0.0}
    assert all(r["equal"] and r["us_per_call"] is None
               for r in res.values())
    before = probe.KERNEL.launches
    with pytest.raises(ValueError, match="bad tensor"):
        probe.probe("A", torch.ones((probe.ROWS, probe.COLS),
                                    device="meta"))
    with pytest.raises(ValueError, match="unknown probe"):
        probe.probe("D", torch.ones((probe.ROWS, probe.COLS)))
    assert probe.KERNEL.launches == before
