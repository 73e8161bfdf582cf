"""The BVH kernel's warp walk (csrc/bvh_kernel.cu: ``warp_walk``, the
``two_level`` variant's walk, row 4, and its Plucker form, row 5a) as the
CPU can check it, against the plain version and simple_raytracer_tpu.

The CUDA kernel runs only on the card (chip_smoke.py holds every
``two_level`` launch, and its counting instance, to the plain version
there).  Here ``warp_walk_emulation`` transcribes the walk in PyTorch:

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
import collections
import itertools
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simple_raytracer_tpu.accel
from simple_raytracer_tpu.models import Scene as JScene
from simple_raytracer_tpu.models.meshgen import icosphere
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops.pallas import bvh_kernel as jbvh
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.ops.vec import Vec3

from test_torch_bvh_streamed import _tie_clusters
from torch_port_helpers import jax_scene_arrays, jvec, tvec, unit_vectors

# the kernel's constants (test_constants_match_the_cuda_source): a warp,
# the slots of a chunk, the warp's ring of chunk buffers, the most
# admitting lanes that split a chunk's MT, the groups of a gate batch
LANES, CHUNK, STAGES, SPLIT_MAX, BATCH = 32, 64, 2, 16, 16
NO_KEY = torch.iinfo(torch.int64).max


def _feed(clusters, table, form):
    """The rows the walk reads, as ``col(rows)(j)`` of the plain version's
    arithmetic (``bvh._mt``'s slot-table columns from the staged MT table,
    or the Plucker coefficients), and each slot's global index."""
    if form == "plucker":
        coeffs = bvh.plucker_table(table)
        return (lambda s: lambda j: coeffs[s, j]), clusters.hierarchy.gidx
    st = bvh.stage_slots(table, clusters.hierarchy.gidx)
    where = {0: 0, 1: 1, 2: 2, 3: 4, 4: 5, 5: 6, 6: 8, 7: 9, 8: 10, 19: 7}
    return ((lambda s: lambda j: st[s, where[j]]),
            st[:, 3].contiguous().view(torch.int32))


def warp_walk_emulation(o: Vec3, d: Vec3, alive, t_init, clusters, table,
                        form="mt", perm=None, count=None, batch=BATCH,
                        split_max=SPLIT_MAX, stages=STAGES):
    """The warp walk of one launch in PyTorch (see the module docstring):
    rays ``perm`` (a compacted launch's order, the first ``count`` listed)
    or every ray in index order, in warps of LANES, with a ring of
    ``stages`` chunk buffers (1: each chunk found just before its turn) ->
    ((t, slot) as the kernel writes them, counts of what the walk did)."""
    n_rays = o.x.shape[0]
    n_cl, k = clusters.slots.shape
    hier = clusters.hierarchy
    cols, gidx = _feed(clusters, table, form)
    mt = bvh._mt_plucker if form == "plucker" else bvh._mt
    live = alive > 0
    inv = bvh.inverse(d)
    order = bvh.front_to_back(hier.groups, o, live).long()
    ray_list = torch.arange(n_rays) if perm is None else perm.long()
    n_listed = n_rays if perm is None else int(count)
    t_out = torch.full((n_rays,), math.inf)
    slot_out = torch.full((n_rays,), -1, dtype=torch.int32)
    cnt = collections.Counter()
    for w0 in range(0, n_rays, LANES):
        ray = ray_list[w0:w0 + LANES]
        lanes = torch.arange(ray.numel())
        listed = (w0 + lanes < n_listed) & live[ray]
        if not listed.any():
            continue       # the warp skips the walk: every lane a miss
        pick = lambda v: Vec3(v.x[ray], v.y[ray], v.z[ray])
        ro, rd, ri = pick(o), pick(d), pick(inv)
        best_t = t_init[ray].clone()
        best_i = torch.full_like(ray, -1)
        best_s = torch.full_like(ray, -1)
        cnt["walked"] += int(listed.sum())

        def gates(boxes, parent):
            """(N, lanes): each lane's slab tests of N boxes against its
            best t now, where its parent gate passed."""
            return bvh.slab_maybe(boxes, ro, ri, best_t, listed) & parent

        def commit(lane, key, slot):
            """The commit rule at ``lane`` of a candidate key (t bits << 32
            | index; NO_KEY: none): the least (t, index) wins."""
            has = key != NO_KEY
            lane, key, slot = lane[has], key[has], slot[has]
            t = (key >> 32).to(torch.int32).view(torch.float32)
            g = key & 0xFFFFFFFF
            bt, bi = best_t[lane], best_i[lane]
            win = (t <= bt) & ((t < bt) | (g < bi))
            best_t[lane] = torch.where(win, t, bt)
            best_i[lane] = torch.where(win, g, bi)
            best_s[lane] = torch.where(win, slot, best_s[lane])

        def chunk_turn(c, base, found):
            ok = found & gates(hier.boxes[c:c + 1], True)[0]
            if not ok.any():
                cnt["wasted"] += 1
                return
            if base == 0:
                cnt["visits"] += 1
                cnt["pairs"] += int(ok.sum())
            cnt["chunks"] += 1
            first = min(c, n_cl - 1) * k + base
            n = min(CHUNK, k - base)
            slots = torch.arange(first, first + n)
            admit = ok.nonzero()[:, 0]
            q = lambda v: v[admit][:, None]
            t, valid = mt(q(ro.x), q(ro.y), q(ro.z), q(rd.x), q(rd.y),
                          q(rd.z), cols(slots[None, :]))          # (A, n)
            key = torch.where(valid, (t.view(torch.int32).long() << 32)
                              | gidx[slots].long()[None, :], NO_KEY)
            if admit.numel() > split_max:
                # each admitting lane alone, every slot in order
                least, at = key.min(dim=1)
                commit(admit, least, slots[at])
                return
            # split: lane l holds slots l, l + 32, ...; its least key (its
            # first slot on a tie), then the warp's least key and the
            # lowest lane holding it
            cnt["split"] += 1
            pad = -n % LANES
            keys = torch.cat([key, torch.full((key.shape[0], pad), NO_KEY)],
                             1).view(key.shape[0], -1, LANES)  # (A, j, l)
            lane_key, lane_j = keys.min(dim=1)                  # (A, l)
            least = lane_key.min(dim=1).values                  # (A,)
            src = (lane_key == least[:, None]).long().argmax(dim=1)
            j = lane_j.gather(1, src[:, None])[:, 0]
            slot = first + j * LANES + src
            commit(admit, least, torch.where(least != NO_KEY, slot, -1))

        def next_item():
            """The warp's chunks in order, each found (its gates tested)
            only when the walk asks for it: (cluster, first slot, each
            lane's gate of the cluster when it was tested)."""
            for j0 in range(0, order.numel(), batch):
                groups = order[j0:j0 + batch]
                g_mask = gates(hier.groups[groups], True)
                cnt["group_tests"] += groups.numel()
                for gi in g_mask.any(dim=1).nonzero()[:, 0].tolist():
                    g = int(groups[gi])
                    s_mask = gates(
                        hier.supers[g * bvh.GROUP:(g + 1) * bvh.GROUP],
                        g_mask[gi])
                    for si in s_mask.any(dim=1).nonzero()[:, 0].tolist():
                        s = g * bvh.GROUP + si
                        c_mask = gates(
                            hier.boxes[s * bvh.SUPER:(s + 1) * bvh.SUPER],
                            s_mask[si])
                        for ci in c_mask.any(dim=1).nonzero()[:, 0].tolist():
                            for base in range(0, k, CHUNK):
                                yield s * bvh.SUPER + ci, base, c_mask[ci]

        # the ring: the next chunks are found before the MT of the chunks
        # ahead of them, each after the turn of the chunk whose buffer it
        # takes
        items = next_item()
        ring = collections.deque(itertools.islice(items, stages))
        while ring:
            chunk_turn(*ring.popleft())
            ring.extend(itertools.islice(items, 1))
        won = best_i >= 0
        t_out[ray] = torch.where(won, best_t, math.inf)
        slot_out[ray] = torch.where(won, best_s, -1).to(torch.int32)
    return (t_out, slot_out), cnt


@pytest.fixture(scope="module")
def config6():
    """Config 6 at 64x36 (768 clusters of 128, 3 groups of the hierarchy),
    the JAX scene (NumPy builder) carried across."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(simple_raytracer_tpu.accel, "_load_library",
                   lambda: None)
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
    assert re.search(r"\(counters != nullptr && !warp\)", src)
