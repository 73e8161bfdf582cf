"""The triangle kernel's live-ray contract, its staged table and its exact
early-out (ops/triangle.py, ops/cuda/triangle_kernel.py), on the CPU.

The CUDA kernel (csrc/triangle_kernel.cu) runs only on the card, where
chip_smoke.py holds every launch's (t, index) to the plain version on
every ray, dead rays included.  Here:

- the plain version with an ``alive`` mask against the TPU kernel
  ``_kernel`` (``intersect_triangles_pallas`` in Pallas interpret mode):
  live rays give its (t, index) (index equal, t at rtol 1e-5, as
  tests/test_torch_triangle.py holds the dense route), dead rays
  (+inf, 0); ``alive=None`` gives exactly the maskless result;
- the staged table: the active columns in order, bit for bit, and a
  nearest-hit loop over it that equals the plain version; built on the
  kernel's first use only (``staged_table``), never by the CPU route;
- the kernel's block shape and early-out margins: the CUDA source's
  constants are the wrapper's and the plain predicate's;
- the kernel's division-free early-out (``pretest_rejects``, repeated in
  the kernel's order): no pair it rejects passes Moller-Trumbore, on
  adversarial floats (hypothesis: zeros of either sign, subnormals,
  overflowing reciprocals, the margins' neighbours) and on adversarial
  geometry (u and v exactly at 0 and 1, rays grazing an edge or lying in
  the triangle's plane, tiny and huge triangles); on a scene it rejects
  most pairs;
- the split path's nearest hit under "pallas" with dead rays against the
  dense "jnp" route and the JAX ``closest_hit`` on the live rays.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from simple_raytracer_tpu.ops import intersect as jint
from simple_raytracer_tpu.ops.pallas import triangle_kernel as jtk
from simple_raytracer_tpu_torch.ops import intersect as tint
from simple_raytracer_tpu_torch.ops import triangle
from simple_raytracer_tpu_torch.ops.cuda import triangle_kernel as trk
from simple_raytracer_tpu_torch.ops.vec import Vec3

from test_torch_triangle import (_mesh_rays, _scenes, _tie_table,  # noqa: F401
                                 jax_native)
from torch_port_helpers import jvec, to_np, tvec

# hypothesis: fixed examples, no database written beside the tests
SETTINGS = dict(deadline=None, database=None, derandomize=True)


def _alive(n, seed, share=0.3):
    return torch.from_numpy(np.random.default_rng(seed).random(n) < share)


def test_live_rays_match_tpu_kernel(jax_native):
    """Live rays: the JAX kernel's (t, index) in interpret mode (config
    4's 2,048-column table, and the table with exact ties); dead rays:
    (+inf, 0); the wrapper on CPU rays is the plain version."""
    _, ts = _scenes(4)
    o, d = _mesh_rays(ts, 600, 11)
    tie, o2, d2 = _tie_table()
    for packed, o, d, seed in ((ts.triangles.packed, o, d, 1),
                               (tie, o2, d2, 2)):
        alive = _alive(o.shape[0], seed)
        jt, ji = jtk.intersect_triangles_pallas(
            jvec(o), jvec(d), jnp.asarray(packed.numpy()), interpret=True)
        jt, ji = np.asarray(jt), np.asarray(ji)
        tt, ti = triangle.intersect_packed_plain(tvec(o), tvec(d), packed,
                                                 alive)
        wt, wi = trk.intersect_triangles_packed(tvec(o), tvec(d), packed,
                                                alive)
        assert torch.equal(wt, tt) and torch.equal(wi, ti)
        assert ti.dtype == torch.int32
        live = alive.numpy()
        tt, ti = tt.numpy(), ti.numpy()
        hit = np.isfinite(jt) & live
        np.testing.assert_array_equal(np.isfinite(tt), hit)
        np.testing.assert_array_equal(ti[hit], ji[hit])
        np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-5)
        assert np.isinf(tt[~live]).all() and (ti[~live] == 0).all()
        assert hit.sum() > 20 and (~live).sum() > 50
    assert (ti[hit] == 300).all()    # the first of two equal triangles


def test_alive_none_is_every_ray(jax_native):
    """alive=None and an all-True mask give the maskless result exactly;
    an all-False mask gives (+inf, 0) everywhere."""
    _, ts = _scenes(3)
    o, d = _mesh_rays(ts, 300, 4)
    packed = ts.triangles.packed
    t0, i0 = triangle.intersect_packed_plain(tvec(o), tvec(d), packed)
    for alive in (None, torch.ones(300, dtype=torch.bool)):
        t1, i1 = trk.intersect_triangles_packed(tvec(o), tvec(d), packed,
                                                alive)
        assert torch.equal(t1, t0) and torch.equal(i1, i0)
    t2, i2 = triangle.intersect_packed_plain(
        tvec(o), tvec(d), packed, torch.zeros(300, dtype=torch.bool))
    assert torch.isinf(t2).all() and not i2.any()
    assert torch.isfinite(t0).float().mean() > 0.5


def test_key_orders_as_t_then_index():
    """The kernel's (R,) int64 key, (t bits << 32) | index: split_key
    gives (t, index) back as views; the miss key is (+inf, 0); for t > 0
    (subnormal to +inf) the least key is the least t, then the least
    index, the first-minimum rule the atomicMin merge keeps."""
    g = np.random.default_rng(5)
    t = np.concatenate([np.float32([1e-45, 1e-38, 0.5, 1.0, 3e38, np.inf]),
                        g.uniform(0, 10, 200).astype(np.float32)])
    t = np.repeat(t, 3)
    idx = g.integers(0, 2 ** 31 - 1, t.size).astype(np.int32)
    key = torch.from_numpy((t.view(np.int32).astype(np.int64) << 32)
                           | idx.astype(np.int64))
    kt, ki = trk.split_key(key)
    assert kt.dtype == torch.float32 and ki.dtype == torch.int32
    np.testing.assert_array_equal(kt.numpy(), t)
    np.testing.assert_array_equal(ki.numpy(), idx)
    by_key = np.argsort(key.numpy(), kind="stable")
    by_pair = np.lexsort((idx, t))
    np.testing.assert_array_equal(by_key, by_pair)
    mt, mi = trk.split_key(torch.tensor([trk.MISS_KEY]))
    assert float(mt) == np.inf and int(mi) == 0


@pytest.mark.parametrize("n", [3, 4, 6])
def test_staged_table(n, jax_native):
    """The staged table holds the active columns of the packed table in
    order, bit for bit, with each column's index as int32 bits; a nearest
    hit over its rows (the kernel's reading) equals the plain version's."""
    _, ts = _scenes(n)
    tr = ts.triangles
    packed, staged = tr.packed, triangle.staged_table(tr)
    act = torch.nonzero(packed[9] > 0)[:, 0]
    assert staged.shape == (act.numel(), triangle.STAGED_COLS)
    assert staged.dtype == torch.float32 and staged.is_contiguous()
    bits = lambda t: t.contiguous().view(torch.int32)
    for cols, rows in ((slice(0, 3), slice(0, 3)), (slice(4, 7), slice(3, 6)),
                       (slice(8, 11), slice(6, 9))):
        assert torch.equal(bits(staged[:, cols]), bits(packed[rows, act].T))
    assert torch.equal(bits(staged[:, 3]), act.to(torch.int32))
    assert not staged[:, [7, 11]].any()
    if n == 6:
        assert staged.shape[0] == 81920 < packed.shape[1]
    o, d = _mesh_rays(ts, 200, n)
    col = lambda j: Vec3(staged[:, j], staged[:, j + 1], staged[:, j + 2])
    t_s, i_s, _, _ = triangle.nearest_triangle(
        tvec(o), tvec(d), col(0), col(4), col(8),
        torch.ones(staged.shape[0], dtype=torch.bool))
    index = bits(staged[:, 3])[i_s]
    t_p, i_p = triangle.intersect_packed_plain(tvec(o), tvec(d), packed)
    hit = torch.isfinite(t_p)
    assert torch.equal(t_s, t_p) and torch.equal(index[hit], i_p[hit])
    assert hit.float().mean() > 0.5


@pytest.mark.parametrize("n", [3, 4, 5])
def test_staged_table_built_on_first_use(n, jax_native):
    """from_numpy builds no staged table; the CPU route under "pallas"
    (the plain version over the packed table) builds none either;
    staged_table builds it once and keeps it on the scene's Triangles."""
    _, ts = _scenes(n)
    tr = ts.triangles
    assert tr.staged is None
    o, d = _mesh_rays(ts, 100, n)
    tint.closest_hit_split(ts, tvec(o), tvec(d),
                           torch.ones(100, dtype=torch.bool),
                           tri_backend="pallas")
    assert tr.staged is None
    staged = triangle.staged_table(tr)
    assert tr.staged is staged and triangle.staged_table(tr) is staged
    assert torch.equal(staged, triangle.stage_triangles(tr.packed))
    assert staged.shape == (int(tr.active.sum()), triangle.STAGED_COLS)


def test_kernel_constants_match_the_wrapper():
    """The CUDA source's block shape is the wrapper's SHAPE (chip_smoke.py
    models the kernel's warps by it), its early-out margins are the plain
    predicate's, and a staged row is STAGED_COLS floats."""
    src = Path(trk.SOURCE).read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    assert (int(const("kThreads")), int(const("kRays"))) == trk.SHAPE
    assert const("kUpper") == "1.0f + 0x1p-20f"
    assert triangle.PRETEST_UPPER == 1.0 + float.fromhex("0x1p-20")
    assert float.fromhex(const("kXMin").rstrip("f")) == \
        triangle.PRETEST_X_MIN
    assert float.fromhex(const("kAMax").rstrip("f")) == \
        triangle.PRETEST_A_MAX
    assert 4 * int(const("kRowFloat4")) == triangle.STAGED_COLS


# ---- the early-out ----

def _u_test_passes(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """MT's a and u tests on f32 (numpy rounds each operation): a != 0
    and u = RN(RN(1 / a) * x) in [0, 1]."""
    with np.errstate(all="ignore"):
        u = (np.float32(1.0) / a) * x
        return (a != 0) & (u >= 0) & (u <= 1)


def _check_ax(a, x):
    a = np.asarray(a, np.float32)
    x = np.asarray(x, np.float32)
    rejects = triangle.pretest_rejects(torch.from_numpy(a),
                                       torch.from_numpy(x)).numpy()
    bad = rejects & _u_test_passes(a, x)
    assert not bad.any(), list(zip(a[bad], x[bad]))
    return rejects


def _near(v: np.ndarray, k: int) -> np.ndarray:
    """v moved by k ulps (f32), toward +inf for k > 0."""
    v = np.asarray(v, np.float32)
    step = np.float32(np.inf) if k > 0 else np.float32(-np.inf)
    with np.errstate(over="ignore"):
        for _ in range(abs(k)):
            v = np.nextafter(v, step)
    return v


def test_pretest_margins_exhaustively():
    """Every power of two and its neighbours, subnormals to the largest
    float and inf, as a, against x at each margin and its neighbours:
    |a|, RN(|a| (1 + 2^-20)), +-2^-64, +-0, the smallest subnormal, of
    both signs.  No rejected pair passes the u test, and the test rejects
    where its rule says it must."""
    exps = np.arange(-149, 128)
    mags = np.concatenate([np.ldexp(np.float32(1), exps).astype(np.float32),
                           [np.float32(np.inf), np.float32(3.4028235e38)]])
    mags = np.unique(np.concatenate([_near(mags, k) for k in (-2, -1, 0, 1)]))
    mags = mags[mags > 0]
    a = np.concatenate([mags, -mags])
    c = np.float32(triangle.PRETEST_UPPER)
    with np.errstate(over="ignore"):
        marks = [np.abs(a), np.abs(a) * c]
    base = [np.full_like(a, v) for v in (0.0, 2.0 ** -64, 2.0 ** -149, 1.0)]
    xs = []
    for m in marks + base:
        for k in range(-3, 4):
            v = _near(m, k)
            xs += [v, -v, v * np.sign(a), -v * np.sign(a)]
    rejected = 0
    for x in xs:
        rejected += int(_check_ax(a, x).sum())
    assert rejected > len(xs) * a.size // 4
    # the rule's own cases
    one = np.float32([1.0, 1.0, -1.0, 2.0 ** 64, 2.0 ** 65])
    got = _check_ax(one, np.float32([1.5, -1e-3, 1e-3, -2.0 ** -64,
                                     -1.0]))
    assert got.tolist() == [True, True, True, True, False]
    got = _check_ax(np.float32([0.0, -0.0, 0.0]),
                    np.float32([1.0, 0.0, -1.0]))
    assert got.tolist() == [True, False, True]
    assert not _check_ax(np.float32([1.0, 1.0, np.nan, 1.0]),
                         np.float32([0.0, -0.0, 1.0, np.nan])).any()


F32 = st.floats(width=32, allow_nan=True, allow_infinity=True,
                allow_subnormal=True)


@settings(max_examples=400, **SETTINGS)
@given(st.lists(st.tuples(F32, F32), min_size=1, max_size=64))
def test_pretest_never_rejects_a_u_pass(pairs):
    """Arbitrary f32 (a, x), special values included."""
    a, x = zip(*pairs)
    _check_ax(a, x)


@settings(max_examples=400, **SETTINGS)
@given(st.lists(st.tuples(F32, st.sampled_from(["a", "ac", "0", "xmin"]),
                          st.integers(-4, 4), st.booleans()),
                min_size=1, max_size=64))
def test_pretest_never_rejects_near_its_margins(cases):
    """x a few ulps from each margin of an arbitrary a: |a| (u = 1),
    RN(|a| (1 + 2^-20)), 0 and -2^-64 (u = 0), of either sign."""
    a = np.float32([c[0] for c in cases])
    with np.errstate(over="ignore"):
        marks = {"a": np.abs(a),
                 "ac": np.abs(a) * np.float32(triangle.PRETEST_UPPER),
                 "0": np.zeros_like(a),
                 "xmin": np.full_like(a, -triangle.PRETEST_X_MIN)}
    x = np.float32([_near(marks[m][i], k) * (-1 if neg else 1)
                    for i, (_, m, k, neg) in enumerate(cases)])
    _check_ax(a, x * np.where(np.signbit(a), np.float32(-1), np.float32(1)))


def _mt_pairs(o, d, v0, e1, e2):
    """(P, 3) f32 arrays, pair by pair -> (rejects, MT valid)."""
    vec = lambda v: Vec3(*(torch.from_numpy(np.ascontiguousarray(v[:, i]))
                           for i in range(3)))
    a, x, u, v, t = triangle.moller_trumbore(vec(o), vec(d), vec(v0),
                                             vec(e1), vec(e2))
    valid = ((a != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
             & (t > 0))
    return triangle.pretest_rejects(a, x), valid


COORD = st.integers(-4, 4)
POINT = st.tuples(COORD, COORD, COORD)
SCALES = [2.0 ** -100, 2.0 ** -70, 2.0 ** -40, 2.0 ** -3, 1.0, 2.0 ** 20,
          2.0 ** 40, 2.0 ** 60]


@settings(max_examples=300, **SETTINGS)
@given(st.lists(st.tuples(POINT, POINT, POINT, POINT,
                          st.integers(0, 4), st.integers(0, 4),
                          st.sampled_from(["aim", "graze", "plane", "free"]),
                          POINT, st.integers(-2, 2),
                          st.sampled_from(SCALES), st.sampled_from(SCALES)),
                min_size=1, max_size=32))
def test_pretest_never_rejects_a_hit(cases):
    """Triangles on an integer grid, rays aimed at a vertex, an edge or an
    interior point (u and v exactly 0, 1 or quarters), grazing an edge
    from the triangle's plane, lying in the plane, or free; the aim moved
    by a few ulps; the scene scaled by powers of two (tiny triangles with
    subnormal a, huge ones whose products overflow), the direction
    separately.  No pair the early-out rejects passes MT."""
    rows = []
    for v0, e1, e2, o, wu, wv, kind, free, ulps, scale, dscale in cases:
        v0, e1, e2, o = (np.float64(p) for p in (v0, e1, e2, o))
        wu, wv = wu / 4.0, wv / 4.0
        if wu + wv > 1.0:
            wu, wv = 1.0 - wv, wv
        target = v0 + wu * e1 + wv * e2
        if kind == "graze":      # from the plane, toward an edge point
            o = v0 + 2.0 * e1 - e2
            target = v0 + 0.5 * e1
        elif kind == "plane":    # a ray in the triangle's plane
            o = v0 - e1 - e2
        d = np.float64(free) if kind == "free" else target - o
        d = _near(np.float32(d * dscale), ulps)
        rows.append((np.float32(o * scale), d, np.float32(v0 * scale),
                     np.float32(e1 * scale), np.float32(e2 * scale)))
    o, d, v0, e1, e2 = (np.stack(c) for c in zip(*rows))
    rejects, valid = _mt_pairs(o, d, v0, e1, e2)
    assert not (rejects & valid).any()


def test_pretest_rejects_most_pairs_of_a_scene(jax_native):
    """Config 4's mesh against rays aimed at its triangles: every pair
    that MT accepts survives the early-out, and it rejects more than 90%
    of the pairs before the division."""
    _, ts = _scenes(4)
    o, d = _mesh_rays(ts, 400, 7)
    packed = ts.triangles.packed
    act = packed[9] > 0
    col = lambda i: Vec3(packed[i, act][None, :], packed[i + 1, act][None, :],
                         packed[i + 2, act][None, :])
    ray = lambda v: Vec3(*(torch.from_numpy(v[:, i].copy())[:, None]
                           for i in range(3)))
    a, x, u, v, t = triangle.moller_trumbore(ray(o), ray(d), col(0), col(3),
                                             col(6))
    valid = ((a != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
             & (t > 0))
    rejects = triangle.pretest_rejects(a, x)
    assert valid.sum() > 300 and not (rejects & valid).any()
    assert rejects.float().mean() > 0.9


@pytest.mark.parametrize("n", [3, 4])
def test_closest_hit_with_dead_rays(n, jax_native):
    """closest_hit_split under "pallas" with a partial alive mask: on the
    live rays, the "jnp" route's Hit and the JAX closest_hit's t, hits,
    materials and normals."""
    ds, ts = _scenes(n)
    o, d = _mesh_rays(ts, 1500, 20 + n)
    alive = _alive(1500, n, share=0.4)
    live = alive.numpy()
    hp = tint.closest_hit_split(ts, tvec(o), tvec(d), alive,
                                tri_backend="pallas")
    hj = tint.closest_hit_split(ts, tvec(o), tvec(d), alive,
                                tri_backend="jnp")
    for a, b in zip(hp, hj):
        a = torch.stack(list(a)) if isinstance(a, tuple) else a
        b = torch.stack(list(b)) if isinstance(b, tuple) else b
        np.testing.assert_array_equal(a.numpy()[..., live],
                                      b.numpy()[..., live])
    jh = jint.closest_hit(ds, jvec(o), jvec(d), tri_backend="jnp",
                          tri_chunk=4096)
    hit = np.asarray(jh.hit) & live
    assert hit.sum() > 200 and hp.triangle.numpy()[live].any()
    np.testing.assert_array_equal(hp.hit.numpy()[live], hit[live])
    np.testing.assert_array_equal(hp.t.numpy()[live], np.asarray(jh.t)[live])
    np.testing.assert_array_equal(hp.material.numpy()[hit],
                                  np.asarray(jh.material)[hit])
    np.testing.assert_array_equal(to_np(hp.normal)[hit],
                                  to_np(jh.normal)[hit])
