"""Host acceleration structures: the BVH build and its cut into clusters.

The port's own copy of ``simple_raytracer_tpu.accel``.  ``build_bvh``
runs the binned-SAH builder of the port's host library
(``csrc/host_accel.cpp``, the C interface and the algorithm of the JAX
package's native library), which the host compiler builds at first use
into ``build/srt_torch_kernels/`` (``ops/cuda/build.HostLibrary``); a
failed build raises.  ``SRT_NATIVE_LIB`` names another library of the
same C interface to load instead (``host_library``).  ``force_python=True`` asks for the NumPy
median-split builder instead, the JAX package's fallback.  The library
also transforms triangles (``transform_triangles``) and parses binary STL
(``parse_stl``, for ``io/stl.py``).  ``build_clusters`` cuts the tree into
clusters of K slots and ``refit_clusters`` recomputes the boxes of a
cached topology for moved geometry.  The build runs on the host at scene
build; the traversal runs in the whole-trace kernel
(``csrc/trace_kernel.cu``) or, on the split per-bounce path, in the BVH
kernel (``csrc/bvh_kernel.cu``).

BVH layout:
  nodes:  (N, 8) f32 -- [min.xyz, max.xyz, pad, pad], DFS preorder
  meta:   (N, 4) i32 -- [skip, first, count, is_leaf]; ``skip`` is the
          DFS index to jump to when the node's box is missed (N ends),
          ``first``/``count`` index the REORDERED triangles of a leaf
  order:  (T,) i32 -- the permutation that makes each leaf contiguous
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np

from .ops.cuda import build

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _bind(lib: ctypes.CDLL) -> None:
    lib.srt_bvh_build.restype = ctypes.c_int32
    lib.srt_bvh_build.argtypes = [_F32P, ctypes.c_int32, ctypes.c_int32,
                                  _F32P, _I32P, _I32P]
    lib.srt_transform_triangles.restype = None
    lib.srt_transform_triangles.argtypes = [_F32P, _F32P, _F32P,
                                            ctypes.c_int32, _F32P, _F32P,
                                            _F32P]
    lib.srt_stl_count.restype = ctypes.c_int32
    lib.srt_stl_count.argtypes = [_U8P, ctypes.c_int64]
    lib.srt_stl_parse.restype = ctypes.c_int32
    lib.srt_stl_parse.argtypes = [_U8P, ctypes.c_int64, _F32P, _F32P]


HOST = build.HostLibrary(build.PACKAGE_DIR / "csrc" / "host_accel.cpp", _bind)
# the entry points a library named by SRT_NATIVE_LIB must export (the JAX
# package's native library and csrc/host_accel.cpp alike)
HOST_SYMBOLS = ("srt_bvh_build", "srt_transform_triangles", "srt_stl_count",
                "srt_stl_parse")
_NAMED = {}      # path -> the library SRT_NATIVE_LIB named, loaded once


def host_library() -> ctypes.CDLL:
    """The host library: the one SRT_NATIVE_LIB names, or else
    ``csrc/host_accel.cpp`` built on first use (RuntimeError with the
    compiler's output if it cannot be built).  SRT_NATIVE_LIB (the JAX
    package's accel.py:41) is read at each call; its library is loaded
    once.  A named file that is missing, cannot be loaded or lacks one of
    ``HOST_SYMBOLS`` raises RuntimeError: stricter than the JAX package,
    which then tries its other candidates and at last its NumPy
    builder."""
    path = os.environ.get("SRT_NATIVE_LIB")
    if not path:
        return HOST.library()
    if path not in _NAMED:
        if not os.path.isfile(path):
            raise RuntimeError(f"SRT_NATIVE_LIB={path!r}: no such file")
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            raise RuntimeError(f"SRT_NATIVE_LIB={path!r} cannot be loaded: "
                               f"{exc}") from exc
        missing = [n for n in HOST_SYMBOLS if not hasattr(lib, n)]
        if missing:
            raise RuntimeError(f"SRT_NATIVE_LIB={path!r} lacks "
                               f"{', '.join(missing)}")
        _bind(lib)
        _NAMED[path] = lib
    return _NAMED[path]


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


class BVH(NamedTuple):
    nodes: np.ndarray   # (N, 8) f32
    meta: np.ndarray    # (N, 4) i32: [skip, first, count, is_leaf]
    order: np.ndarray   # (T,) i32

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]


def build_bvh(positions: np.ndarray, leaf_size: int = 4,
              force_python: bool = False) -> BVH:
    """A BVH over (T, 3, 3) world-space triangle positions: the host
    library's binned SAH, or with ``force_python`` the NumPy median
    split."""
    positions = np.ascontiguousarray(positions, np.float32)
    t = positions.shape[0]
    if t == 0:
        return BVH(nodes=np.zeros((0, 8), np.float32),
                   meta=np.zeros((0, 4), np.int32),
                   order=np.zeros((0,), np.int32))
    if force_python:
        return _build_bvh_python(positions, leaf_size)
    cap = 2 * t + 1
    nodes = np.zeros((cap, 8), np.float32)
    meta = np.zeros((cap, 4), np.int32)
    order = np.zeros((t,), np.int32)
    n = host_library().srt_bvh_build(_f32p(positions), t, leaf_size,
                                     _f32p(nodes), meta.ctypes.data_as(_I32P),
                                     order.ctypes.data_as(_I32P))
    if not 0 < n <= cap:
        raise RuntimeError(f"srt_bvh_build returned {n} nodes for {t} "
                           "triangles")
    return BVH(nodes=nodes[:n].copy(), meta=meta[:n].copy(), order=order)


def _build_bvh_python(positions: np.ndarray, leaf_size: int) -> BVH:
    """Median split on the longest axis of each node's box."""
    t = positions.shape[0]
    lo = positions.min(axis=1)
    hi = positions.max(axis=1)
    centroid = (lo + hi) * 0.5

    nodes, meta = [], []
    order = np.arange(t, dtype=np.int32)

    def rec(idx: np.ndarray, depth: int) -> int:
        node_id = len(nodes)
        nodes.append(None)
        meta.append(None)
        box_lo = lo[idx].min(axis=0)
        box_hi = hi[idx].max(axis=0)
        if len(idx) <= leaf_size or depth > 60:
            nodes[node_id] = (box_lo, box_hi)
            meta[node_id] = [-1, idx, len(idx), 1]
            return node_id
        axis = int(np.argmax(box_hi - box_lo))
        med = np.argsort(centroid[idx, axis], kind="stable")
        half = len(idx) // 2
        left_idx, right_idx = idx[med[:half]], idx[med[half:]]
        nodes[node_id] = (box_lo, box_hi)
        meta[node_id] = [rec(left_idx, depth + 1), None, 0, 0]
        meta[node_id][1] = rec(right_idx, depth + 1)
        return node_id

    rec(order, 0)
    n = len(nodes)

    # flatten: leaf ranges in DFS order, and the skip links
    node_arr = np.zeros((n, 8), np.float32)
    meta_arr = np.zeros((n, 4), np.int32)
    new_order = []
    skip = np.full(n, n, np.int32)
    for i in range(n):
        m = meta[i]
        if not m[3]:
            left, right = m[0], m[1]
            skip[left] = right
            skip[right] = skip[i]
    for i in range(n):
        box_lo, box_hi = nodes[i]
        node_arr[i, :3] = box_lo
        node_arr[i, 3:6] = box_hi
        m = meta[i]
        if m[3]:
            first = len(new_order)
            new_order.extend(m[1].tolist())
            meta_arr[i] = [skip[i], first, m[2], 1]
        else:
            meta_arr[i] = [skip[i], -1, 0, 0]
    return BVH(nodes=node_arr, meta=meta_arr,
               order=np.asarray(new_order, np.int32))


def validate_bvh(bvh: BVH, positions: np.ndarray) -> None:
    """Raise ValueError unless every triangle lies in exactly one leaf,
    every leaf box contains its triangles (to 1e-4) and every skip link
    points forward, at most one past the last node."""
    t = positions.shape[0]
    seen = np.zeros(t, bool)
    n = bvh.num_nodes
    for i in range(n):
        skip, first, count, is_leaf = bvh.meta[i]
        if not i < skip <= n:
            raise ValueError(f"node {i}: bad skip {skip}")
        if is_leaf:
            idx = bvh.order[first:first + count]
            if seen[idx].any():
                raise ValueError(f"node {i}: a triangle in two leaves")
            seen[idx] = True
            tri = positions[idx].reshape(-1, 3)
            if ((tri < bvh.nodes[i, :3] - 1e-4).any()
                    or (tri > bvh.nodes[i, 3:6] + 1e-4).any()):
                raise ValueError(f"leaf {i}: a triangle outside its box")
    if not seen.all():
        raise ValueError("a triangle in no leaf")


def transform_triangles(positions: np.ndarray, normals: np.ndarray,
                        matrix: np.ndarray, force_python: bool = False):
    """(T, 3, 3) positions and normals by a 4x4 matrix (positions affine,
    normals by its linear part) and the positions' world box (lo, hi):
    the host library's, or with ``force_python`` NumPy's matmul, which
    ``Model.world_triangles`` uses and which may differ in the last bit."""
    positions = np.ascontiguousarray(positions, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    matrix = np.ascontiguousarray(matrix, np.float32)
    n = positions.shape[0]
    if not force_python and n > 0:
        pos_out = np.empty_like(positions)
        nrm_out = np.empty_like(normals)
        aabb = np.empty(6, np.float32)
        host_library().srt_transform_triangles(
            _f32p(positions), _f32p(normals), _f32p(matrix), n,
            _f32p(pos_out), _f32p(nrm_out), _f32p(aabb))
        return pos_out, nrm_out, (aabb[:3], aabb[3:])
    wpos = positions @ matrix[:3, :3].T + matrix[:3, 3]
    wnrm = normals @ matrix[:3, :3].T
    flat = wpos.reshape(-1, 3)
    if flat.shape[0]:
        box = (flat.min(axis=0), flat.max(axis=0))
    else:
        box = (np.full(3, np.inf, np.float32), np.full(3, -np.inf, np.float32))
    return wpos, wnrm, box


def parse_stl(data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The (M, 3, 3) positions and flat normals of a binary STL buffer's
    whole records (a truncated file gives fewer than its header counts),
    by the host library; None if the buffer is shorter than its header."""
    lib = host_library()
    buf = np.frombuffer(data, np.uint8)
    count = lib.srt_stl_count(buf.ctypes.data_as(_U8P), len(data))
    if count < 0:
        return None
    pos = np.empty((count, 3, 3), np.float32)
    nrm = np.empty((count, 3, 3), np.float32)
    lib.srt_stl_parse(buf.ctypes.data_as(_U8P), len(data), _f32p(pos),
                      _f32p(nrm))
    return pos, nrm


class Clusters(NamedTuple):
    """Fixed-size triangle clusters cut from a BVH: a box per cluster and
    exactly K triangle slots (-1 pads).  ``order`` is the BVH permutation:
    the caller reorders its triangle arrays by it, so slot (c, s) refers
    to reordered triangle ``slots[c, s]``."""
    aabb: np.ndarray    # (C, 8) f32: [min.xyz, max.xyz, pad, pad]
    slots: np.ndarray   # (C, K) i32: reordered triangle index, -1 = pad
    order: np.ndarray   # (T,) i32: the BVH permutation
    k: int


def build_clusters(positions: np.ndarray, k: int = 256,
                   leaf_size: int = 8) -> Clusters:
    """Cut a BVH (``build_bvh``'s) into spatial clusters of at most ``k``
    triangles.

    First the tree is cut into granules, whole subtrees of at most k/4
    triangles (contiguous ranges of the reordered array); then
    DFS-consecutive granules are packed greedily into clusters of at most
    k, each box the union of its granules' boxes."""
    t = positions.shape[0]
    if t == 0:
        return Clusters(aabb=np.zeros((0, 8), np.float32),
                        slots=np.zeros((0, k), np.int32),
                        order=np.zeros((0,), np.int32), k=k)
    bvh = build_bvh(positions, leaf_size=min(leaf_size, k))
    n = bvh.num_nodes
    skip = bvh.meta[:, 0]
    is_leaf = bvh.meta[:, 3] == 1
    leaf_counts = np.where(is_leaf, bvh.meta[:, 2], 0)
    pref = np.concatenate([[0], np.cumsum(leaf_counts)])
    # first reordered index of the subtree rooted at i: the ``first`` of
    # the next leaf at or after i (leaf firsts are in DFS order)
    next_leaf_first = np.full(n + 1, t, np.int64)
    for i in range(n - 1, -1, -1):
        next_leaf_first[i] = (bvh.meta[i, 1] if is_leaf[i]
                              else next_leaf_first[i + 1])

    granule = max(min(leaf_size, k), k // 4)
    g_boxes, g_firsts, g_counts = [], [], []
    i = 0
    while i < n:
        count = pref[skip[i]] - pref[i]
        if count <= granule or is_leaf[i]:
            first = int(next_leaf_first[i])
            # an oversized leaf (the depth cutoff) is split across
            # granules that share its box
            for off in range(0, max(int(count), 1), k):
                g_boxes.append(np.asarray(bvh.nodes[i, :6], np.float32))
                g_firsts.append(first + off)
                g_counts.append(min(int(count) - off, k))
            i = int(skip[i])
        else:
            i += 1

    boxes, firsts, counts = [], [], []
    for box, first, count in zip(g_boxes, g_firsts, g_counts):
        if counts and counts[-1] + count <= k \
                and firsts[-1] + counts[-1] == first:
            counts[-1] += count
            boxes[-1] = np.concatenate(
                [np.minimum(boxes[-1][:3], box[:3]),
                 np.maximum(boxes[-1][3:6], box[3:6])])
        else:
            boxes.append(box.copy())
            firsts.append(first)
            counts.append(count)

    c = len(boxes)
    aabb = np.zeros((c, 8), np.float32)
    aabb[:, :6] = np.asarray(boxes, np.float32)
    slots = np.full((c, k), -1, np.int32)
    for ci, (first, count) in enumerate(zip(firsts, counts)):
        if not 0 <= count <= k:
            raise ValueError(f"cluster {ci}: count {count} > k {k}")
        slots[ci, :count] = np.arange(first, first + count, dtype=np.int32)
    return Clusters(aabb=aabb, slots=slots, order=bvh.order, k=k)


def refit_clusters(cl: Clusters, positions: np.ndarray) -> Clusters:
    """The cluster boxes recomputed for moved geometry, the topology kept.

    The permutation and the slots built for the old positions stay valid
    for any new positions (every triangle is still in exactly one cluster
    and each new box bounds its triangles, so culling stays
    conservative); only the boxes' tightness degrades as models move far
    from where the tree was built.  A transform edit refits in O(T) and a
    later full build restores the quality.

    ``positions`` are the unreordered (T, 3, 3) world vertices, the array
    ``build_clusters`` was given."""
    t = positions.shape[0]
    if t == 0 or cl.slots.shape[0] == 0:
        return cl
    rp = positions[cl.order]                      # (T, 3, 3) reordered
    si = np.clip(cl.slots, 0, t - 1)              # (C, K)
    v = rp[si]                                    # (C, K, 3, 3)
    invalid = (cl.slots < 0)[:, :, None, None]
    lo = np.where(invalid, np.inf, v).min(axis=(1, 2))
    hi = np.where(invalid, -np.inf, v).max(axis=(1, 2))
    aabb = np.zeros_like(cl.aabb)
    aabb[:, 0:3] = lo
    aabb[:, 3:6] = hi
    return Clusters(aabb=aabb.astype(np.float32), slots=cl.slots,
                    order=cl.order, k=cl.k)
