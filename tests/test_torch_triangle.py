"""The brute-force triangle route (ops/triangle.py, ops/cuda/triangle_kernel.py)
and the "pallas" and "jnp" triangle backends against simple_raytracer_tpu.

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there).  Here: the packed table against the JAX
``pack_triangles`` bit for bit; the plain version against the TPU kernel
``_kernel`` (``intersect_triangles_pallas`` in Pallas interpret mode) as
tests/test_pallas_triangle.py holds that kernel to the dense loop (the
same hits, the same index on every hit, t at rtol 1e-5; measured here:
equal); the wrapper's dispatch and launch ABI; the split path's nearest
hit under "pallas" and "jnp" against the JAX ``closest_hit`` under "jnp"
(shaded by triangle index, never by cluster slot); and whole renders.

The JAX ``"pallas"`` route calls ``intersect_triangles_pallas`` without
``interpret`` (ops/intersect.py:311), so it cannot run on the CPU: the
function-level parity above stands in for it, and the renders are held to
the JAX ``render_pass`` under "jnp" (the same nearest hits, the same
shading) at the golden bound, RMSE < 2e-3 (the JAX render runs under jit,
where XLA:CPU fuses multiply-adds).
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.engine import Renderer as JRenderer
from simple_raytracer_tpu.engine import RenderOptions as JOptions
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops import intersect as jint
from simple_raytracer_tpu.ops.pallas import triangle_kernel as jtk
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops import intersect as tint
from simple_raytracer_tpu_torch.ops import triangle
from simple_raytracer_tpu_torch.ops.cuda import triangle_kernel as trk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy, tri_table
from simple_raytracer_tpu_torch.ops.vec import Vec3

from torch_port_helpers import (jax_native_accel, jax_scene_arrays, jvec,
                                to_np, tvec)

KWARGS = {3: {"skybox": "gradient"}}


@pytest.fixture
def jax_native():
    """The JAX package on its default BVH builder, its native library (the
    port's host library builds the same tree)."""
    jax_native_accel()


def _scenes(n):
    scene = JCONFIGS[n](width=32, height=16, **KWARGS.get(n, {}))[0]
    ds = scene.build()
    return ds, from_numpy(jax_scene_arrays(ds), "cpu")


def _mesh_rays(ts, n, seed):
    """Rays from around the mesh toward random points of its triangles
    (most hit), plus a few that miss."""
    r = np.random.default_rng(seed)
    tr = ts.triangles
    act = np.flatnonzero(tr.active.numpy())
    pick = r.choice(act, n)
    w = r.dirichlet([1, 1, 1], n).astype(np.float32)
    target = (tr.v0.numpy()[pick] * w[:, :1] + tr.v1.numpy()[pick] * w[:, 1:2]
              + tr.v2.numpy()[pick] * w[:, 2:])
    o = (target + r.normal(0, 3, (n, 3))).astype(np.float32)
    d = target - o
    d[: n // 10] *= -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("n", [3, 4, 6])
def test_packed_tables_match_jax(n, jax_native):
    """The packed (16, T) table is the JAX pack_triangles' bit for bit
    (config 6: 81,920 triangles padded to 131,072); the triangle-indexed
    rows are tri_table's, and for a clustered mesh each slot's row of the
    slot table is its triangle's row."""
    ds, ts = _scenes(n)
    tr = ts.triangles
    np.testing.assert_array_equal(tr.packed.numpy(),
                                  np.asarray(jtk.pack_triangles(ds.triangles)))
    assert tr.packed.shape == (16, tr.material.shape[0])
    arrays = {k: tr_k.numpy() for k, tr_k in (
        ("v0", tr.v0), ("v1", tr.v1), ("v2", tr.v2), ("n0", tr.n0),
        ("n1", tr.n1), ("n2", tr.n2), ("material", tr.material),
        ("active", tr.active))}
    np.testing.assert_array_equal(tr.rows.numpy(), tri_table(arrays))
    if tr.clusters is None:
        assert tr.rows is tr.table
    else:
        slots = tr.clusters.slots.reshape(-1)
        full = slots >= 0
        np.testing.assert_array_equal(tr.table[full].numpy(),
                                      tr.rows[slots[full]].numpy())
    if n == 6:
        assert tr.packed.shape[1] == 131072
        assert int(tr.active.sum()) == 81920


def _tie_table():
    """A (16, 1024) table of random small triangles, with one triangle
    copied to columns 700 and 300 (the earlier must win an exact tie) and
    the columns from 1000 on inactive; rays straight down onto the copy."""
    r = np.random.default_rng(9)
    v0 = r.uniform(-5, 5, (1024, 3)).astype(np.float32)
    v0[:, 1] = r.uniform(-3, -1, 1024)
    v1 = (v0 + r.normal(0, 0.3, (1024, 3))).astype(np.float32)
    v2 = (v0 + r.normal(0, 0.3, (1024, 3))).astype(np.float32)
    tri = np.float32([[0, 0, 0], [1, 0, 0], [0, 0, 1]])
    for c in (300, 700):
        v0[c], v1[c], v2[c] = tri
    packed = triangle.pack_triangles(v0, v1, v2, np.arange(1024) < 1000)
    o = np.zeros((100, 3), np.float32)
    o[:, 0] = r.uniform(0.05, 0.45, 100)
    o[:, 2] = r.uniform(0.05, 0.45, 100)
    o[:, 1] = 2.0
    d = np.tile(np.float32([0.0, -1.0, 0.0]), (100, 1))
    return torch.from_numpy(packed), o, d


def test_plain_version_matches_tpu_kernel(jax_native):
    """The plain version against _kernel in interpret mode over config 4's
    2,048-column table (grid 2 x 4 at the TPU's blocks), and over a table
    with exact ties (the first triangle wins in both)."""
    _, ts = _scenes(4)
    o, d = _mesh_rays(ts, 500, 1)
    tie, o2, d2 = _tie_table()
    hits = []
    for packed, o, d in ((ts.triangles.packed, o, d), (tie, o2, d2)):
        jt, ji = jtk.intersect_triangles_pallas(
            jvec(o), jvec(d), jnp.asarray(packed.numpy()), interpret=True)
        tt, ti = triangle.intersect_packed_plain(tvec(o), tvec(d), packed)
        jt, ji = np.asarray(jt), np.asarray(ji)
        assert ti.dtype == torch.int32
        hit = np.isfinite(jt)
        np.testing.assert_array_equal(np.isfinite(tt.numpy()), hit)
        np.testing.assert_array_equal(ti.numpy()[hit], ji[hit])
        np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=1e-5)
        hits.append(hit.mean())
    assert 0.5 < hits[0] < 1.0 and hits[1] == 1.0
    assert (ti.numpy() == 300).all() and (ji == 300).all()
    # the dense loop gives the same, chunked or not
    for chunk in (1, 7, 4096):
        with pytest.MonkeyPatch.context() as m:
            m.setitem(triangle.TRI_CHUNK_ELEMS, "cpu", 100 * chunk)
            t2, i2 = triangle.intersect_packed_plain(tvec(o), tvec(d), tie)
        np.testing.assert_array_equal(t2.numpy(), tt.numpy())
        np.testing.assert_array_equal(i2.numpy(), ti.numpy())


def test_wrapper_takes_the_plain_version_only_on_the_cpu(monkeypatch):
    """CPU rays take the plain version and count no launch; rays on
    another device go to the kernel's prepare, which raises off the card,
    and the plain version is never called."""
    _, ts = _scenes(3)
    o, d = _mesh_rays(ts, 64, 2)
    before = trk.KERNEL.launches
    t, i = trk.intersect_triangles_packed(tvec(o), tvec(d),
                                          ts.triangles.packed)
    assert trk.KERNEL.launches == before and i.dtype == torch.int32
    calls = []
    monkeypatch.setattr(trk, "intersect_packed_plain",
                        lambda *a: calls.append(a))
    meta = lambda a: Vec3(*(c.to("meta") for c in tvec(a)))
    with pytest.raises(ValueError, match="triangle kernel: unsupported"):
        trk.intersect_triangles_packed(meta(o), meta(d),
                                       ts.triangles.packed.to("meta"))
    assert not calls and trk.KERNEL.launches == before


def test_launch_struct_matches_cuda_source():
    """ctypes passes TriParams by value: its fields must be the CUDA
    struct's, in order; the launch takes as many pointers as the wrapper
    declares, then the struct and the stream."""
    src = Path(trk.SOURCE).read_text()
    body = re.search(r"struct TriParams \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)\s+(\w+);", body)
    assert [(n, t) for t, n in fields] == [
        (name, "int32_t") for name, _ in trk.TriParams._fields_]
    assert all(ct is ctypes.c_int32 for _, ct in trk.TriParams._fields_)
    sig = re.search(r"int srt_triangle_launch\((.*?)\)", src, re.S).group(1)
    n_ptr = sig.count("*")
    assert trk.LAUNCH_ARGTYPES == [ctypes.c_void_p] * (n_ptr - 1) + [
        trk.TriParams, ctypes.c_void_p]


@pytest.mark.parametrize("n", [3, 4])
def test_closest_hit_matches_jax_dense_route(n, jax_native):
    """closest_hit_split under "pallas" and "jnp" (the same hits: equal
    Hit fields) against the JAX closest_hit under "jnp" (one chunk, so it
    runs eagerly): hits, t, materials and normals equal.  For config 4's
    clustered mesh the winner is a triangle index and its row comes from
    Triangles.rows; its slot table would give another triangle's row."""
    ds, ts = _scenes(n)
    o, d = _mesh_rays(ts, 2000, 3 + n)
    alive = torch.ones(2000, dtype=torch.bool)
    hits = [tint.closest_hit_split(ts, tvec(o), tvec(d), alive,
                                   tri_backend=b) for b in ("pallas", "jnp")]
    for a, b in zip(*hits):
        np.testing.assert_array_equal(np.asarray(torch.stack(list(a))
                                                 if isinstance(a, tuple)
                                                 else a),
                                      np.asarray(torch.stack(list(b))
                                                 if isinstance(b, tuple)
                                                 else b))
    jh = jint.closest_hit(ds, jvec(o), jvec(d), tri_backend="jnp",
                          tri_chunk=4096)
    th = hits[0]
    hit = np.asarray(jh.hit)
    assert hit.mean() > 0.5 and th.triangle.numpy().any()
    np.testing.assert_array_equal(th.hit.numpy(), hit)
    np.testing.assert_array_equal(th.t.numpy(), np.asarray(jh.t))
    np.testing.assert_array_equal(th.material.numpy()[hit],
                                  np.asarray(jh.material)[hit])
    np.testing.assert_array_equal(to_np(th.normal)[hit],
                                  to_np(jh.normal)[hit])
    if ts.triangles.clusters is not None:
        assert not torch.equal(ts.triangles.table[:ts.triangles.rows.shape[0]],
                               ts.triangles.rows)


@pytest.mark.parametrize("n", [3, 4])
def test_pallas_and_jnp_renders_match_jax(n, jax_native):
    """A whole small render under "pallas" and under "jnp" (the port's
    split path: the plain triangle version and the dense loop, equal on
    the CPU) against the JAX Renderer under "jnp", for config 3's small
    mesh and config 4's clustered one."""
    w, h = 48, 32
    kw = dict(width=w, height=h, num_samples=1, num_bounces=3)
    jscene, jcamera, _ = JCONFIGS[n](width=w, height=h, **KWARGS.get(n, {}))
    jr = JRenderer(JOptions(tri_backend="jnp", **kw), scene=jscene)
    jr.step(jcamera, time=9)
    carried = from_numpy(jax_scene_arrays(jscene.build()), "cpu")
    camera = CONFIGS[n](width=w, height=h, **KWARGS.get(n, {}))[1]
    canvases = []
    for backend in ("pallas", "jnp"):
        r = Renderer(RenderOptions(tri_backend=backend, **kw), device="cpu")
        r.set_device_scene(carried)
        r.step(camera, time=9)
        canvases.append(r.canvas.numpy())
    np.testing.assert_array_equal(canvases[0], canvases[1])
    assert np.isfinite(canvases[0]).all() and canvases[0].std() > 0
    rmse = float(np.sqrt(np.mean((canvases[0] - np.asarray(jr.canvas)) ** 2)))
    assert rmse < 2e-3, rmse
