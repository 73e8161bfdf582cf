"""The port's host library (csrc/host_accel.cpp) against the JAX package's
native library (native/srt_native.cpp).

The port builds its own copy of the library with the host compiler; its
binned-SAH BVH must equal the JAX package's native build bit for bit
(nodes, meta, order) on seeded random meshes, on a mesh that reaches the
median fallback, on a deep unbalanced one and on the presets' meshes, and so
must the clusters cut from it, its triangle transform and its STL parse.
The NumPy median split, asked for with force_python=True, stays equal to
the JAX package's NumPy builder.  A build that fails raises: no path
falls back to the median split.  A truncated binary STL loads its whole
records in both packages.
"""
import re

import numpy as np
import pytest

from simple_raytracer_tpu.io.stl import load_stl_model as jload_stl
from simple_raytracer_tpu.models.shapes import TrianglePool as JPool
from simple_raytracer_tpu_torch import accel
from simple_raytracer_tpu_torch.io.stl import load_stl_model, save_stl
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.models.shapes import TrianglePool
from simple_raytracer_tpu_torch.ops.cuda import build

from torch_port_helpers import jax_native_accel


def _random_mesh(t: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(t, 1, 3)) * 4.0
    return (centers + rng.normal(size=(t, 3, 3))
            * rng.uniform(0.01, 1.0, (t, 1, 1))).astype(np.float32)


def _coincident_mesh() -> np.ndarray:
    """300 triangles about one centroid: no SAH split exists, so every
    node of more than 4 * leaf_size triangles takes the median split."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(300, 1, 3)).astype(np.float32)
    return np.concatenate([d, -d, np.zeros_like(d)], axis=1) + np.float32(0.5)


def _geometric_mesh() -> np.ndarray:
    """300 small triangles whose centroids grow by 1.1 a step along x:
    SAH splits cut off the farthest few, so the tree is far deeper than a
    balanced one.  (No float32 mesh of a test's size reaches the stop at
    depth 60: a chain of 61 splits that each keep most of a node needs
    either very many triangles or box areas that grow past float32.)"""
    x = (1.1 ** np.arange(300)).astype(np.float32)
    tri = np.zeros((300, 3, 3), np.float32)
    tri[:, :, 0] = x[:, None]
    tri[:, 1, 1] = tri[:, 2, 2] = 1e-3 * x
    return tri


def _config_mesh(n: int) -> np.ndarray:
    scene, _, _ = CONFIGS[n]()
    return np.concatenate([m.world_triangles(scene.pool)[0]
                           for m in scene.models]).astype(np.float32)


MESHES = {
    "random1": lambda: _random_mesh(1, 0),
    "random7": lambda: _random_mesh(7, 1),
    "random100": lambda: _random_mesh(100, 2),
    "random5000": lambda: _random_mesh(5000, 3),
    "coincident": _coincident_mesh,
    "geometric": _geometric_mesh,
    "config4": lambda: _config_mesh(4),
    "config5": lambda: _config_mesh(5),
    "config6": lambda: _config_mesh(6),
}


def _depths(bvh) -> np.ndarray:
    """Each node's depth, from the DFS preorder and the skip links (an
    inner node's children are i + 1 and the skip of i + 1)."""
    depth = np.zeros(bvh.num_nodes, np.int64)
    for i in range(bvh.num_nodes):
        if not bvh.meta[i, 3]:
            depth[i + 1] = depth[i] + 1
            depth[bvh.meta[i + 1, 0]] = depth[i] + 1
    return depth


def _assert_same_bvh(got, want):
    for name in ("nodes", "meta", "order"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("leaf_size", [4, 8])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_build_bvh_matches_jax_native(mesh, leaf_size):
    jaccel = jax_native_accel()
    pos = MESHES[mesh]()
    got = accel.build_bvh(pos, leaf_size=leaf_size)
    _assert_same_bvh(got, jaccel.build_bvh(pos, leaf_size=leaf_size))
    leaves = got.meta[:, 3] == 1
    if mesh == "coincident":    # median splits down to leaves of <= 4 * L
        assert got.num_nodes > 1
        assert (got.meta[leaves, 2] <= 4 * leaf_size).all()
        assert got.meta[leaves, 2].max() > leaf_size
    if mesh == "geometric":     # a deep, unbalanced tree
        assert _depths(got).max() > 2 * np.log2(pos.shape[0])


@pytest.mark.parametrize("mesh", ["random5000", "coincident", "geometric",
                                  "config5"])
def test_validate_bvh(mesh):
    pos = MESHES[mesh]()
    bvh = accel.build_bvh(pos)
    accel.validate_bvh(bvh, pos)
    broken = bvh.meta.copy()
    broken[0, 0] = 0
    with pytest.raises(ValueError, match="bad skip"):
        accel.validate_bvh(accel.BVH(bvh.nodes, broken, bvh.order), pos)


@pytest.mark.parametrize("k", [64, 128, 256])
def test_build_clusters_matches_jax_native(k):
    jaccel = jax_native_accel()
    pos = MESHES["config6"]()
    got = accel.build_clusters(pos, k=k)
    want = jaccel.build_clusters(pos, k=k)
    assert got.k == want.k == k
    for name in ("aabb", "slots", "order"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


@pytest.mark.parametrize("mesh", ["random100", "random5000", "coincident",
                                  "config4"])
def test_median_split_matches_jax_python(mesh):
    """force_python=True: the port's NumPy median split, equal to the JAX
    package's NumPy builder; the host library's SAH tree differs."""
    jaccel = jax_native_accel()
    pos = MESHES[mesh]()
    got = accel.build_bvh(pos, force_python=True)
    _assert_same_bvh(got, jaccel.build_bvh(pos, force_python=True))
    accel.validate_bvh(got, pos)
    if mesh == "random5000":
        assert not np.array_equal(got.order, accel.build_bvh(pos).order)


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_transform_matches_jax_native(n):
    jaccel = jax_native_accel()
    rng = np.random.default_rng(n)
    pos = rng.normal(size=(n, 3, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3, 3)).astype(np.float32)
    mat = rng.normal(size=(4, 4)).astype(np.float32)
    for force in (False, True):
        got = accel.transform_triangles(pos, nrm, mat, force_python=force)
        want = jaccel.transform_triangles(pos, nrm, mat, force_python=force)
        for g, w in zip((got[0], got[1], *got[2]), (want[0], want[1],
                                                     *want[2])):
            np.testing.assert_array_equal(g, w)


def test_stl_parse_matches_jax_native(tmp_path):
    jaccel = jax_native_accel()
    pos = _random_mesh(257, 7)
    path = tmp_path / "m.stl"
    save_stl(path, pos)
    raw = path.read_bytes()
    got, want = accel.parse_stl(raw), jaccel.parse_stl_native(raw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], pos)
    assert accel.parse_stl(raw[:83]) is None
    # both routes of the loader append the same triangles
    pools = [TrianglePool(), TrianglePool()]
    for pool, force in zip(pools, (False, True)):
        pool.append(pos[:5], pos[:5])
        assert load_stl_model(path, pool, force_python=force) == (5, 257)
    np.testing.assert_array_equal(pools[0].positions, pools[1].positions)
    np.testing.assert_array_equal(pools[0].normals, pools[1].normals)


@pytest.mark.parametrize("force_python", [False, True])
def test_truncated_stl_loads_whole_records_as_jax(force_python, tmp_path):
    """A binary STL cut 20 bytes into its fourth record (the header still
    counts 4): the JAX package (its native parser) and both routes of the
    port load its three whole records, at the same span.  A file shorter
    than its header loads nothing."""
    jax_native_accel()
    pos = _random_mesh(4, 11)
    full = tmp_path / "full.stl"
    save_stl(full, pos)
    raw = full.read_bytes()
    assert len(raw) == 84 + 4 * 50
    cut = tmp_path / "cut.stl"
    cut.write_bytes(raw[:84 + 3 * 50 + 20])
    jpool, tpool = JPool(), TrianglePool()
    assert jload_stl(cut, jpool) == (0, 3)
    assert load_stl_model(cut, tpool, force_python=force_python) == (0, 3)
    np.testing.assert_array_equal(tpool.positions, jpool.positions)
    np.testing.assert_array_equal(tpool.normals, jpool.normals)
    np.testing.assert_array_equal(tpool.positions, pos[:3])
    short = tmp_path / "short.stl"
    short.write_bytes(raw[:83])
    assert jload_stl(short, JPool()) is None
    assert load_stl_model(short, TrianglePool(),
                          force_python=force_python) is None


@pytest.mark.parametrize("compiler", ["missing", "fails"])
def test_failed_host_build_raises(compiler, monkeypatch, tmp_path):
    """No compiler, or one that fails, in a fresh build directory: the
    BVH build and the STL parse raise with the compiler's word; only
    force_python=True gives the median split."""
    cxx = (str(tmp_path / "no-such-compiler") if compiler == "missing"
           else "false")
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(accel, "HOST", build.HostLibrary(
        accel.HOST.source, accel._bind))
    pos = _random_mesh(100, 5)
    with pytest.raises(RuntimeError, match=re.escape(cxx)):
        accel.build_bvh(pos)
    with pytest.raises(RuntimeError):
        accel.build_clusters(pos, k=64)
    with pytest.raises(RuntimeError):
        accel.parse_stl(b"\0" * 84)
    assert not list((tmp_path / "build").glob("*.so"))
    median = accel.build_bvh(pos, force_python=True)
    accel.validate_bvh(median, pos)


def test_host_library_is_the_ports_build():
    """The loaded library is the port's own build under
    build/srt_torch_kernels/, named by its source's hash, never the JAX
    package's native/libsrt_native.so."""
    accel.host_library()
    path = accel.HOST._lib._name
    assert path.startswith(str(build.BUILD_DIR)), path
    assert "host_accel-" in path and "native" not in path, path
    assert accel.HOST.flags == build.HOST_FLAGS
    assert "-ffp-contract=off" in build.HOST_FLAGS
    assert not any(f.startswith("-march") for f in build.HOST_FLAGS)
