"""The BVH kernel's warp walk (csrc/bvh_kernel.cu: ``warp_walk``, the
``two_level`` variant's walk, row 4, and its Plucker form, row 5a) as the
CPU can check it, against the plain version and simple_raytracer_tpu.

The CUDA kernel runs only on the card (chip_smoke.py holds every
``two_level`` launch, and its counting instance, to the plain version
there).  Here ``warp_walk_emulation`` (tests/torch_port_helpers.py, which
tests/test_torch_bvh_flat.py shares) transcribes the walk in PyTorch:

- the rays in warps of 32, in the launch's order (dense, or a compacted
  launch's ray order with its count);
- ``next_item``'s batched gates: BATCH groups of the front-to-back order
  tested together against each lane's t at that moment, a group's 16
  supers when the warp enters it, a super's 16 clusters when it enters
  that; a gate passes when any lane admits the box, and each lane keeps
  its own gates;
- the ring of STAGES chunk buffers: each chunk (CHUNK slots) is found,
  and its gates tested, before the MT of the chunks ahead of it, right
  after the turn of the chunk whose buffer it takes (with the lanes' t of
  that moment);
- each lane's test of the cluster's box again, with its t then, at each
  chunk's turn;
- MT split pair by pair when at most SPLIT_MAX lanes admit the chunk (lane
  l tests slots l, l + 32, ... of each admitting ray in turn, keeps its
  least (t bits << 32 | global index) key, the warp takes the least key
  and the lowest lane holding it, the ray's lane commits), else every
  admitting lane tests every slot itself (one commit of its least key:
  the commit rule is a lexicographic minimum, so slot-by-slot commits in
  order end in the same (t, index, first slot)).

It gives ``intersect_triangles_bvh_plain``'s (t, slot) bit for bit on
config 6's K = 128 hierarchy (768 clusters, 3 groups) in both MT forms,
dense and compacted, with dead rays, NaN rays and finite t_init, with the
route's constants and with a batch of 2 groups, the split point at 0 and
32 and rings of 1 and 4 chunks (so that a batch boundary and both MT
paths run, and chunks are found with older and newer t), and on exact ties
across lanes and clusters; the JAX ``_kernel_packed`` (Pallas interpret
mode) gives the same winners on an icosphere at K = 128.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.models import Scene as JScene
from simple_raytracer_tpu.models.meshgen import icosphere
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops.pallas import bvh_kernel as jbvh
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.ops.vec import Vec3

from test_torch_bvh_streamed import _tie_clusters
from torch_port_helpers import (BATCH, CHUNK, LANES, SPLIT_MAX, STAGES,
                               jax_native_accel, jax_scene_arrays, jvec, tvec,
                               unit_vectors, warp_walk_emulation)

@pytest.fixture(scope="module")
def config6():
    """Config 6 at 64x36 (768 clusters of 128, 3 groups of the hierarchy),
    the JAX scene (its default, native BVH builder) carried across."""
    jax_native_accel()
    ds = JCONFIGS[6](width=64, height=36)[0].build()
    tr = from_numpy(jax_scene_arrays(ds), "cpu").triangles
    assert tr.clusters.k == 128 and tr.clusters.hierarchy.groups.shape[0] > 1
    return tr.clusters, tr.table


def _mesh_rays(clusters, table, n_warps, seed):
    """Warps of rays at config 6's mesh: each warp's rays leave points
    near one origin in a cone about the direction to a point of the mesh's
    box, as a bounce's rays from one surface patch do (many lanes admit a
    cluster); in every third warp only 3 lanes live (few lanes admit: the
    split MT).  t_init a mix of +inf and finite seeds, about 15% of the
    other warps' rays dead, and two rays of the second warp with a NaN
    origin or direction (which a NaN slab admits)."""
    r = np.random.default_rng(seed)
    v = table[:, 0:3].numpy()[clusters.hierarchy.gidx.numpy() >= 0]
    lo, hi = v.min(0), v.max(0)
    n = n_warps * LANES
    origin = (r.uniform(lo, hi, (n_warps, 3))
              + 0.5 * (hi - lo).max() * unit_vectors(r, n_warps))
    axis = r.uniform(lo, hi, (n_warps, 3)) - origin
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    o = origin.repeat(LANES, 0) + 0.02 * r.normal(size=(n, 3))
    d = axis.repeat(LANES, 0) + 0.03 * r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_init = np.where(r.uniform(size=n) < 0.6, np.inf,
                      r.uniform(0.3, 3.0, n))
    alive = (r.uniform(size=n) > 0.15).astype(np.float32)
    few = (np.arange(n) // LANES) % 3 == 2
    alive[few] = (np.arange(n) % LANES < 3)[few]
    # a NaN ray admits every box: two, in the second warp
    o[LANES + 5, 0] = np.nan
    d[LANES + 9, 2] = np.nan
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return (tvec(f32(o)), tvec(f32(d)), torch.from_numpy(alive),
            torch.from_numpy(f32(t_init)))


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation runs many small tensor operations: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("form", ["mt", "plucker"])
def test_warp_walk_matches_plain(config6, form, compact):
    """The warp walk with the route's constants gives the plain version's
    (t, slot) on every ray of config 6's mesh rays, dense or compacted (in
    compact_order's order, the rays past its count misses), in either MT
    form; both MT paths run."""
    cl, table = config6
    rays = _mesh_rays(cl, table, 12, seed=3 + 2 * compact
                      + (form == "plucker"))
    if compact:
        order, count = bvh.compact_order(*rays, cl.hierarchy.admission)
        (t_e, s_e), cnt = warp_walk_emulation(*rays, cl, table, form, order,
                                              count)
        t_p, s_p = bvh.intersect_compacted_plain(*rays, cl, table, order,
                                                 int(count), form)
        assert 0 < int(count) < 12 * LANES
    else:
        (t_e, s_e), cnt = warp_walk_emulation(*rays, cl, table, form)
        t_p, s_p = bvh.intersect_triangles_bvh_plain(*rays, cl, table, form)
    assert torch.equal(s_e, s_p) and torch.equal(t_e, t_p)
    assert int((s_p >= 0).sum()) > 100
    assert 0 < cnt["split"] < cnt["chunks"]    # both MT paths


@pytest.mark.parametrize("split_max,stages", [(0, 1), (LANES, 4)])
@pytest.mark.parametrize("form", ["mt", "plucker"])
def test_warp_walk_batches_and_split_points(config6, form, split_max,
                                            stages):
    """A batch of 2 of the 3 groups (a batch boundary), never splitting
    MT (split point 0) or always (32), each chunk found just before its
    turn or 3 chunks ahead: the same (t, slot) as the plain version."""
    cl, table = config6
    rays = _mesh_rays(cl, table, 6, seed=11 + (form == "plucker"))
    (t_e, s_e), cnt = warp_walk_emulation(*rays, cl, table, form, batch=2,
                                          split_max=split_max, stages=stages)
    t_p, s_p = bvh.intersect_triangles_bvh_plain(*rays, cl, table, form)
    assert torch.equal(s_e, s_p) and torch.equal(t_e, t_p)
    assert cnt["split"] == (cnt["chunks"] if split_max else 0)
    assert cnt["group_tests"] == 6 * 3      # 6 warps, 2 + 1 groups each


@pytest.mark.parametrize("form", ["mt", "plucker"])
@pytest.mark.parametrize("second", [False, True])
def test_warp_walk_ties_pick_lowest_index(second, form):
    """An exact tie across the lanes of a chunk (slots 3 and 40, indices 9
    and 4) and across clusters (index 2) goes to the lowest global index,
    through the split path (a warp of one live ray) and the per-lane path
    (a full warp); a tie with t_init keeps the seed (a miss)."""
    cl, table = _tie_clusters(second)
    n = 64
    o = Vec3(*(torch.zeros(n) for _ in range(3)))
    d = Vec3(torch.zeros(n), torch.zeros(n), -torch.ones(n))
    t_init = torch.full((n,), math.inf)
    t_init[:8] = 2.0
    alive = torch.ones(n)
    alive[33:] = 0.0                  # the second warp: one live ray
    (t_e, s_e), cnt = warp_walk_emulation(o, d, alive, t_init, cl, table,
                                          form)
    t_p, s_p = bvh.intersect_triangles_bvh_plain(o, d, alive, t_init, cl,
                                                 table, form)
    assert torch.equal(s_e, s_p) and torch.equal(t_e, t_p)
    assert (s_e[8:33] == (69 if second else 40)).all()
    assert (s_e[:8] == -1).all() and (s_e[33:] == -1).all()
    assert 0 < cnt["split"] < cnt["chunks"]


def test_warp_walk_matches_jax_packed_kernel():
    """The JAX _kernel_packed (Pallas interpret mode, block_r=128, as
    tests/test_torch_bvh.py runs it) and the warp walk on the same rays of
    a 320-triangle icosphere at K = 128: the same hit masks and winners,
    t within tests/test_bvh_kernel.py's rtol=1e-5 (interpret mode runs
    under jit, where XLA:CPU contracts multiply-adds)."""
    pos, nrm = icosphere(subdivisions=2)
    sc = JScene()
    sc.cluster_threshold = 64
    sc.cluster_size = 128
    sc.add_model(sc.pool.append(pos, nrm))
    ds = sc.build()
    tr = from_numpy(jax_scene_arrays(ds), "cpu").triangles
    r = np.random.default_rng(5)
    n = 512
    o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = unit_vectors(r, n) * r.uniform(0, 1.2, (n, 1)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_init = np.where(r.uniform(size=n) < 0.5, np.inf,
                      r.uniform(0.2, 5.0, n)).astype(np.float32)
    alive = (r.uniform(size=n) > 0.1).astype(np.float32)
    cl = ds.triangles.clusters
    jt, ji = jbvh.intersect_triangles_bvh(
        jvec(o), jvec(d), jnp.asarray(alive), jnp.asarray(t_init), cl.aabb,
        cl.table_t, block_r=128, interpret=True, table_tr=cl.table_tr,
        packed_vmem=True)
    jt, ji = np.asarray(jt), np.asarray(ji)
    (t_e, s_e), _ = warp_walk_emulation(
        tvec(o), tvec(d), torch.from_numpy(alive), torch.from_numpy(t_init),
        tr.clusters, tr.table)
    i_e = bvh.triangle_index(tr.clusters, s_e).numpy()
    live = alive > 0
    hit = ji[live] >= 0
    np.testing.assert_array_equal(i_e[live] >= 0, hit)
    np.testing.assert_array_equal(i_e[live][hit], ji[live][hit])
    np.testing.assert_allclose(t_e.numpy()[live][hit], jt[live][hit],
                               rtol=1e-5)
    assert int(hit.sum()) > 50 and (i_e[~live] == -1).all()


def test_constants_match_the_cuda_source():
    """The emulation's warp, chunk, ring, split point and gate batch are
    the kernel's (a constant the sweep sets: its default), the
    hierarchy's widths are ops/bvh's, and two_level launches the warp
    walk, which the counting instance counts."""
    src = Path(bk.SOURCE).read_text()

    def const(name):
        value = re.search(rf"constexpr int {name} = (\w+);",
                          src).group(1)
        if not value.isdigit():
            value = re.search(rf"#define {value} (\d+)\n", src).group(1)
        return int(value)

    assert const("kChunk") == CHUNK and const("kStages") == STAGES
    assert const("kSplitMax") == SPLIT_MAX
    assert const("kBatch") == BATCH
    assert const("kSuper") == bvh.SUPER and const("kGroup") == bvh.GROUP
    assert re.search(r"case kTwoLevel:[^\n]*\n\s+case kStreamed:\s+"
                     r"SRT_BVH_WALK\(kStreamed\);", src)
    assert re.search(r"#define SRT_BVH_WALK\(VARIANT\)\s*\\\n\s*"
                     r"if \(counters != nullptr\)", src)
