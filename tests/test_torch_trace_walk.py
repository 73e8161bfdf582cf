"""The whole-trace kernel's clustered traversal (csrc/trace_kernel.cu: the
warp walk of ``kClusteredTris``, rows 1b and 1b') as the CPU can check it,
against the dense plain version and simple_raytracer_tpu.

The CUDA kernel runs only on the card (chip_smoke.py holds its canvas, and
its counting instance, to the plain version there).  Here
``trace_walk_emulation`` transcribes one bounce's walk in PyTorch:

- the rays in warps of 32 in launch order; a dead lane (a ray that died,
  or past the rays) gates nothing but stays in its warp;
- each lane's ray with its slab margin (``walk_ray``: kSlabMargin times the
  larger of the origin's and the boxes' largest coordinate magnitude, in t
  times the largest |1 / d|), every gate the margin-padded slab test
  (``slab_pad``) in the kernel's operation order;
- the gates down the hierarchy in index order: BATCH groups tested
  together, a group's 16 supers when the warp enters it, a super's 16
  clusters when it enters that (or, with ``flat``, every cluster box 16
  at a time), each against the lane's t of that moment; a gate passes when
  any lane admits the box;
- the ring of STAGES chunk buffers: each chunk (CHUNK slots) is found
  before the MT of the chunks ahead of it, and at its turn each lane tests
  the cluster's box again with its t then;
- MT from the staged table (ops/bvh.stage_slots), split slot by slot over
  the 32 lanes when at most SPLIT_MAX lanes admit a chunk (the route's 32:
  always; the warp's least (t bits << 32 | global index) key, the lowest
  lane holding it), else each admitting lane over every slot; the least
  (t, global index) wins, seeded with (the sphere or plane t, -1);
- the winner's (u, v), from MT run again on its 80-byte slot row.

It gives the dense plain version's triangle (t, index, u, v) bit for bit
on the bounces of a config 4 pass and on rays at a reduced config 6 mesh
and the full one, with the route's constants and with a batch of one
group, the split point at 0 and 16, rings of 1 and 4 chunks, chunks of
half a cluster and the flat gate; exact ties go to the lowest index, on either MT path; a
parent box built as the min and max of its children's planes admits
whatever they admit, and the gate's NaN-dropping min and max admit what
NaN-propagating ones would for every ray without a NaN (hypothesis); and
a whole trace through the walk is the plain version's, bit for bit, and
within test_torch_trace_kernel.py's bounds of JAX's ``_tris_clustered``
(``trace_full_fused`` in Pallas interpret mode).
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
from hypothesis import given, settings, strategies as st

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops.camera import camera_rotation as jrotation
from simple_raytracer_tpu.ops.pallas import bounce_kernel
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops import intersect
from simple_raytracer_tpu_torch.ops import trace as trace_mod
from simple_raytracer_tpu_torch.ops.camera import camera_rotation
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel as tk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.ops.triangle import nearest_triangle
from simple_raytracer_tpu_torch.ops.vec import Vec3, normalize

from test_torch_bvh_streamed import _tie_clusters
from torch_port_helpers import jax_scene_arrays, to_np, tvec, unit_vectors

# the kernel's constants (test_constants_match_the_cuda_source): a warp,
# the slots of a chunk, the warp's ring of chunk buffers, the most
# admitting lanes that split a chunk's MT, the groups of a gate batch, the
# slab margin
LANES, CHUNK, STAGES, SPLIT_MAX, BATCH = 32, 128, 2, 32, 16
MARGIN = 2.0 ** -16
NO_KEY = torch.iinfo(torch.int64).max
# the staged table's columns of each slot-table column MT reads
STAGED_OF = {0: 0, 1: 1, 2: 2, 3: 4, 4: 5, 5: 6, 6: 8, 7: 9, 8: 10, 19: 7}


def walk_ray(o: Vec3, d: Vec3, extent: float):
    """The kernel's walk_ray: (1 / d, the slab margin in t)."""
    inv = bvh.inverse(d)
    a = torch.abs
    mag = torch.fmax(torch.fmax(a(o.x), a(o.y)),
                     torch.fmax(a(o.z), torch.tensor(extent)))
    pad = (MARGIN * mag) * torch.fmax(torch.fmax(a(inv.x), a(inv.y)),
                                      a(inv.z))
    return inv, pad


def slab_pad(boxes, o: Vec3, inv: Vec3, pad, t_far, live):
    """(N, 8) boxes x (L,) rays -> (N, L) bool: the kernel's slab_pad in
    its operation order (min and max that drop a NaN operand, as fminf and
    fmaxf do), for the live lanes."""
    col = lambda j: boxes[:, j, None]
    row = lambda v: v[None]
    t1x = (col(0) - row(o.x)) * row(inv.x)
    t2x = (col(3) - row(o.x)) * row(inv.x)
    t1y = (col(1) - row(o.y)) * row(inv.y)
    t2y = (col(4) - row(o.y)) * row(inv.y)
    t1z = (col(2) - row(o.z)) * row(inv.z)
    t2z = (col(5) - row(o.z)) * row(inv.z)
    mn, mx = torch.fmin, torch.fmax
    near = mx(mx(mn(t1x, t2x), mn(t1y, t2y)),
              mx(mn(t1z, t2z), torch.zeros_like(t1z)))
    far = mn(mn(mx(t1x, t2x), mx(t1y, t2y)), mn(mx(t1z, t2z), row(t_far)))
    keep = ~((near - row(pad) > far + row(pad)) | (col(0) >= 1.0e38))
    return keep & row(live)


def mt_rows(o: Vec3, d: Vec3, col):
    """Moller-Trumbore in the kernel's order on slot-table columns
    ``col(j)`` -> (t, u, v, valid)."""
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    hx = d.y * e2z - d.z * e2y
    hy = d.z * e2x - d.x * e2z
    hz = d.x * e2y - d.y * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / a
    sx = o.x - col(0)
    sy = o.y - col(1)
    sz = o.z - col(2)
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (d.x * qx + d.y * qy + d.z * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    valid = ((a != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > 0.0) & (col(19) > 0.0))
    return t, u, v, valid


def trace_walk_emulation(o: Vec3, d: Vec3, alive, t_seed, clusters, table,
                         batch=BATCH, split_max=SPLIT_MAX, stages=STAGES,
                         flat=False, chunk=CHUNK):
    """One bounce's warp walk of the whole-trace kernel in PyTorch (see the
    module docstring): (R,) rays, their alive mask and sphere or plane t
    -> ((t, global index, slot, u, v): the nearest triangle strictly
    nearer than the seed, (+inf, -1, -1, 0, 0) when none is; counts)."""
    n_rays = o.x.shape[0]
    n_cl, k = clusters.slots.shape
    hier = clusters.hierarchy
    staged = bvh.stage_slots(table, hier.gidx)
    gidx = staged[:, 3].contiguous().view(torch.int32)
    live_all = alive > 0
    inv_all, pad_all = walk_ray(o, d, clusters.extent)
    out_t = torch.full((n_rays,), math.inf)
    out_i = torch.full((n_rays,), -1, dtype=torch.int64)
    out_s = torch.full((n_rays,), -1, dtype=torch.int64)
    cnt = collections.Counter()
    n_groups = hier.groups.shape[0]
    for w0 in range(0, n_rays, LANES):
        ray = torch.arange(w0, min(w0 + LANES, n_rays))
        live = live_all[ray]
        if not live.any():
            continue          # no lane alive: the warp has left the loop
        pick = lambda v: Vec3(v.x[ray], v.y[ray], v.z[ray])
        ro, rd, ri = pick(o), pick(d), pick(inv_all)
        pad = pad_all[ray]
        best_t = t_seed[ray].clone()
        best_i = torch.full_like(ray, -1)
        best_s = torch.full_like(ray, -1)

        def gates(boxes, parent):
            return slab_pad(boxes, ro, ri, pad, best_t, live) & parent

        def commit(lane, key, slot):
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
            cnt["chunks"] += 1
            if base == 0:
                cnt["union"] += 1
                cnt["admitted"] += int(ok.sum())
            first = min(c, n_cl - 1) * k + base
            n = min(chunk, k - base)
            slots = torch.arange(first, first + n)
            admit = ok.nonzero()[:, 0]
            q = lambda v: v[admit][:, None]
            t, _, _, valid = mt_rows(
                Vec3(q(ro.x), q(ro.y), q(ro.z)),
                Vec3(q(rd.x), q(rd.y), q(rd.z)),
                lambda j: staged[slots[None, :], STAGED_OF[j]])  # (A, n)
            key = torch.where(valid, (t.view(torch.int32).long() << 32)
                              | gidx[slots].long()[None, :], NO_KEY)
            if admit.numel() > split_max:
                least, at = key.min(dim=1)
                commit(admit, least, slots[at])
                return
            cnt["split"] += 1
            pad_n = -n % LANES
            keys = torch.cat([key, torch.full((key.shape[0], pad_n),
                                              NO_KEY)], 1)
            keys = keys.view(key.shape[0], -1, LANES)          # (A, j, l)
            lane_key, lane_j = keys.min(dim=1)                 # (A, l)
            least = lane_key.min(dim=1).values
            src = (lane_key == least[:, None]).long().argmax(dim=1)
            j = lane_j.gather(1, src[:, None])[:, 0]
            commit(admit, least, torch.where(least != NO_KEY,
                                             first + j * LANES + src, -1))

        def clusters_of(s, parent):
            c_mask = gates(hier.boxes[s * bvh.SUPER:(s + 1) * bvh.SUPER],
                           parent)
            for ci in c_mask.any(dim=1).nonzero()[:, 0].tolist():
                for base in range(0, k, chunk):
                    yield s * bvh.SUPER + ci, base, c_mask[ci]

        def next_item():
            if flat:
                for s in range(n_groups * bvh.GROUP):
                    yield from clusters_of(s, True)
                return
            for j0 in range(0, n_groups, batch):
                g_mask = gates(hier.groups[j0:j0 + batch], True)
                for gi in g_mask.any(dim=1).nonzero()[:, 0].tolist():
                    g = j0 + gi
                    s_mask = gates(
                        hier.supers[g * bvh.GROUP:(g + 1) * bvh.GROUP],
                        g_mask[gi])
                    for si in s_mask.any(dim=1).nonzero()[:, 0].tolist():
                        yield from clusters_of(g * bvh.GROUP + si,
                                               s_mask[si])

        items = next_item()
        ring = collections.deque(itertools.islice(items, stages))
        while ring:
            chunk_turn(*ring.popleft())
            ring.extend(itertools.islice(items, 1))
        won = best_i >= 0
        out_t[ray] = torch.where(won, best_t, math.inf)
        out_i[ray] = best_i
        out_s[ray] = best_s
    # the winner's (u, v): MT once more on its slot row
    won = out_i >= 0
    row = table[out_s.clamp_min(0)]
    t_w, u, v, valid = mt_rows(o, d, lambda j: row[:, j])
    assert bool((valid | ~won).all())
    assert torch.equal(t_w[won], out_t[won])
    zero = torch.zeros_like(u)
    return ((out_t, out_i, out_s, torch.where(won, u, zero),
             torch.where(won, v, zero)), cnt)


def dense_triangles(o: Vec3, d: Vec3, t_seed, tris):
    """The dense plain version's triangle hit under the seed: (t, index,
    u, v), (+inf, -1, 0, 0) where no triangle is strictly nearer than the
    sphere or plane (as closest_hit resolves the tie to them)."""
    cols = lambda t: Vec3(t[:, 0], t[:, 1], t[:, 2])
    t, i, u, v = nearest_triangle(o, d, cols(tris.v0),
                                  cols(tris.v1 - tris.v0),
                                  cols(tris.v2 - tris.v0), tris.active)
    won = t < t_seed
    zero = torch.zeros_like(u)
    return (torch.where(won, t, math.inf), torch.where(won, i, -1),
            torch.where(won, u, zero), torch.where(won, v, zero))


def assert_same_hits(walked, dense):
    t_w, i_w, _, u_w, v_w = walked
    t_d, i_d, u_d, v_d = dense
    assert torch.equal(i_w, i_d)
    assert torch.equal(t_w, t_d)
    assert torch.equal(u_w, u_d) and torch.equal(v_w, v_d)


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation runs many small tensor operations: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def record_bounces(scene, camera, opt, w, h, samples=1, time_seed=4242):
    """A plain whole-trace pass of the scene at w x h: each bounce's rays,
    alive mask (live at bounce 0 and after each hit) and sphere or plane
    t, as the kernel's walk sees them."""
    cam = camera.state(w / h)
    rec = []
    saved = trace_mod.closest_hit

    def hit_of(sc, o, d):
        hit = saved(sc, o, d)
        t_s, _, t_p, _ = intersect._spheres_planes(sc, o, d)
        rec.append((o, d, hit.hit, torch.minimum(t_s, t_p)))
        return hit

    trace_mod.closest_hit = hit_of
    try:
        tk.trace_full_plain(scene, camera_rotation(cam.yaw, cam.pitch),
                            cam.position, cam.aspect_ratio, cam.fov_scale,
                            time_seed, width=w, height=h,
                            num_samples=samples, num_bounces=opt.num_bounces)
    finally:
        trace_mod.closest_hit = saved
    out, alive = [], None
    for o, d, hit, seed in rec:
        alive = torch.ones_like(hit) if alive is None else alive
        out.append((o, d, alive, seed))
        alive = alive & hit
    return out


@pytest.fixture(scope="module")
def config4():
    scene, camera, opt = CONFIGS[4](width=32, height=16)
    ds = scene.build("cpu")
    return ds, record_bounces(ds, camera, opt, 32, 16, samples=2)


@pytest.mark.parametrize("bounce", [0, 1, 2, 3])
def test_walk_matches_dense_on_config4_bounces(config4, bounce):
    """Each of the first bounces of a config 4 pass (32 clusters of 64):
    the walk's (t, index, u, v) are the dense plain version's on every
    ray, dead lanes (rays that missed) among live ones; both MT paths
    run."""
    ds, bounces = config4
    o, d, alive, seed = bounces[bounce]
    tris = ds.triangles
    walked, cnt = trace_walk_emulation(o, d, alive, seed, tris.clusters,
                                       tris.table)
    live = alive > 0
    dense = dense_triangles(o, d, seed, tris)
    dense = tuple(torch.where(live, x, y) for x, y in zip(
        dense, (math.inf, -1, 0.0, 0.0)))
    assert_same_hits(walked, dense)
    assert int((walked[1] >= 0).sum()) > 10
    if bounce:
        assert 0 < int((~live).sum()) and cnt["split"] > 0


def mesh_rays(tris, n_warps, seed):
    """Warps of rays at a mesh, as a bounce off one surface patch gives
    (many lanes admit a cluster): each warp's rays leave points near one
    origin outside the mesh in a cone about the direction to one of its
    vertices; every third warp with 3 live lanes (the split MT), about 15%
    of the others' rays dead, seeds a mix of +inf and finite sphere or
    plane t."""
    r = np.random.default_rng(seed)
    v = tris.v0.numpy()
    lo, hi = v.min(0), v.max(0)
    n = n_warps * LANES
    target = v[r.integers(0, v.shape[0], n_warps)]
    origin = target + (hi - lo).max() * unit_vectors(r, n_warps)
    axis = target - origin
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    o = origin.repeat(LANES, 0) + 0.02 * r.normal(size=(n, 3))
    d = axis.repeat(LANES, 0) + 0.03 * r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seed_t = np.where(r.uniform(size=n) < 0.6, np.inf,
                      r.uniform(0.3, 3.0, n))
    alive = r.uniform(size=n) > 0.15
    few = (np.arange(n) // LANES) % 3 == 2
    alive[few] = (np.arange(n) % LANES < 3)[few]
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return (tvec(f32(o)), tvec(f32(d)), torch.from_numpy(alive),
            torch.from_numpy(f32(seed_t)))


@pytest.fixture(scope="module")
def mesh6():
    """Config 6's mesh cut to subdivision 5 (20,480 triangles, one group)
    and at full size (81,920 triangles, 768 clusters of 128, 3 groups)."""
    out = {}
    for sub in (5, 6):
        ds = CONFIGS[6](width=64, height=36, subdivisions=sub)[0].build("cpu")
        out[sub] = ds.triangles
    assert out[6].clusters.hierarchy.groups.shape[0] == 3
    return out


# the walk's constants of each case (the route's, then one changed)
CASES = {"route": {}, "batch1": dict(batch=1), "split0": dict(split_max=0),
         "split16": dict(split_max=16), "ring1": dict(stages=1),
         "ring4": dict(stages=4), "chunk64": dict(chunk=64),
         "flat": dict(flat=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_walk_matches_dense_on_config6_mesh(mesh6, case):
    """Rays at the reduced config 6 mesh with the route's constants (MT
    always split), and at the full mesh with a batch of one group, the
    split point at 0 (never split) and 16 (both paths), rings of 1 and 4
    chunks, chunks of 64 slots (two a cluster) and the flat gate: the
    dense plain version's (t, index, u, v) on every ray."""
    kw = CASES[case]
    tris = mesh6[5 if case == "route" else 6]
    o, d, alive, seed = mesh_rays(tris, 8, seed=list(CASES).index(case))
    walked, cnt = trace_walk_emulation(o, d, alive, seed, tris.clusters,
                                       tris.table, **kw)
    dense = dense_triangles(o, d, seed, tris)
    dense = tuple(torch.where(alive, x, y) for x, y in zip(
        dense, (math.inf, -1, 0.0, 0.0)))
    assert_same_hits(walked, dense)
    assert int((walked[1] >= 0).sum()) > 20
    if case == "split0":
        assert cnt["split"] == 0
    elif case == "split16":
        assert 0 < cnt["split"] < cnt["chunks"]       # both MT paths
    else:
        assert cnt["split"] == cnt["chunks"]          # always split


@pytest.mark.parametrize("split_max", [SPLIT_MAX, 16])
@pytest.mark.parametrize("second", [False, True])
def test_walk_ties_pick_lowest_index(second, split_max):
    """An exact tie across the lanes of a chunk (slots 3 and 40, indices 9
    and 4) and across clusters (index 2) goes to the lowest global index,
    as the dense loop's first index: split across the warp (the route's
    MT; at split point 16, a warp of one live ray) and tested by each
    admitting lane (a full warp, at split point 16); a tie with the sphere
    or plane seed keeps the seed."""
    cl, table = _tie_clusters(second)
    cl.extent = 2.0
    n = 64
    o = Vec3(*(torch.zeros(n) for _ in range(3)))
    d = Vec3(torch.zeros(n), torch.zeros(n), -torch.ones(n))
    seed = torch.full((n,), math.inf)
    seed[:8] = 2.0
    alive = torch.ones(n, dtype=torch.bool)
    alive[33:] = False                # the second warp: one live ray
    (t, idx, slot, u, v), cnt = trace_walk_emulation(
        o, d, alive, seed, cl, table, split_max=split_max)
    assert (idx[8:33] == (2 if second else 4)).all()
    assert (slot[8:33] == (69 if second else 40)).all()
    assert (t[8:33] == 2.0).all() and (u[8:33] == 0.5).all()
    assert (idx[:8] == -1).all() and (idx[33:] == -1).all()
    if split_max == LANES:
        assert cnt["split"] == cnt["chunks"] > 0
    else:
        assert cnt["union"] > cnt["split"] > 0
    # the dense loop over the triangles by index: the same winner
    rows = torch.zeros(10, 20)
    gidx = cl.slots.reshape(-1)
    rows[gidx[gidx >= 0]] = table[gidx >= 0]
    active = rows[:, 19] > 0
    v0 = Vec3(rows[:, 0], rows[:, 1], rows[:, 2])
    e1 = Vec3(rows[:, 3], rows[:, 4], rows[:, 5])
    e2 = Vec3(rows[:, 6], rows[:, 7], rows[:, 8])
    t_d, i_d, _, _ = nearest_triangle(o, d, v0, e1, e2, active)
    assert (i_d[8:33] == idx[8:33]).all() and torch.equal(t_d[8:33],
                                                          t[8:33])


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), scale=st.sampled_from([1.0, 1e3]),
       axis_rays=st.booleans())
def test_parent_box_admits_what_its_children_admit(seed, scale, axis_rays):
    """A parent box built as the min and max of its children's planes
    (ops/bvh.union_boxes8, as build_hierarchy builds supers and groups)
    admits every ray that one of its children admits under the margin-
    padded slab test, whatever the ray's bound: (b - o) * inv rounds
    monotonically in b, and so do near - pad and far + pad."""
    r = np.random.default_rng(seed)
    n_par, n_ray = 8, 96
    lo = r.normal(0, scale, (n_par, 16, 3))
    size = np.abs(r.normal(0, scale / 4, (n_par, 16, 3)))
    if r.uniform() < 0.5:
        size[:, ::5] = 0.0            # flat boxes
    boxes = np.zeros((n_par, 16, 8), np.float32)
    boxes[..., 0:3] = lo
    boxes[..., 3:6] = lo + size
    boxes[:, 13:] = bvh.SENTINEL      # padding children
    boxes[:, 13:, 6:] = 0.0
    boxes = torch.from_numpy(boxes)
    parents = bvh.union_boxes8(boxes)
    o = r.normal(0, 2 * scale, (n_ray, 3)).astype(np.float32)
    d = unit_vectors(r, n_ray)
    # half the rays aim at the centre of a real child
    aim = boxes[r.integers(0, n_par, n_ray // 2), r.integers(0, 13,
                                                              n_ray // 2)]
    d[::2] = ((aim[:, 0:3] + aim[:, 3:6]).numpy() * 0.5 - o[::2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if axis_rays:
        d[::3, r.integers(0, 3)] = 0.0     # pad = inf: every real box
    t_far = np.where(np.arange(n_ray) % 4 < 2, np.inf,
                     r.uniform(0, 3 * scale, n_ray)).astype(np.float32)
    o_, d_ = tvec(o), tvec(d)
    extent = float(boxes[boxes[..., 0] < 1e37][:, :6].abs().max())
    inv, pad = walk_ray(o_, d_, extent)
    live = torch.ones(n_ray, dtype=torch.bool)
    t_far = torch.from_numpy(t_far)
    child = slab_pad(boxes.reshape(-1, 8), o_, inv, pad, t_far, live)
    parent = slab_pad(parents, o_, inv, pad, t_far, live)
    child = child.view(n_par, 16, n_ray).any(dim=1)
    assert not bool((child & ~parent).any())
    assert bool(child.any())


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), zeros=st.booleans(),
       on_planes=st.booleans())
def test_gate_admits_what_a_nan_propagating_gate_admits(seed, zeros,
                                                        on_planes):
    """The gate's min and max drop a NaN operand (fminf, fmaxf); the
    NaN-propagating ones (torch.minimum, torch.maximum: the parent
    kernel's gate) admit exactly the same boxes for every ray without a
    NaN: with zero and denormal direction components (1 / d infinite, so
    the margin is infinite), origins on box planes (0 * inf), padding
    boxes, finite and infinite bounds."""
    r = np.random.default_rng(seed)
    n_box, n_ray = 64, 128
    boxes = np.zeros((n_box, 8), np.float32)
    boxes[:, 0:3] = r.normal(0, 2, (n_box, 3))
    boxes[:, 3:6] = boxes[:, 0:3] + np.abs(r.normal(0, 1, (n_box, 3)))
    boxes[::7, 0:6] = bvh.SENTINEL
    o = r.normal(0, 4, (n_ray, 3)).astype(np.float32)
    if on_planes:                      # origins on box planes
        pick = r.integers(0, n_box, n_ray)
        axis = r.integers(0, 3, n_ray)
        o[np.arange(n_ray), axis] = boxes[pick, axis + 3 * (pick % 2)]
    d = unit_vectors(r, n_ray).astype(np.float32)
    if zeros:
        d[::3, r.integers(0, 3)] = 0.0
        d[1::5, r.integers(0, 3)] = np.float32(1e-40)     # denormal
    t_far = np.where(np.arange(n_ray) % 3 == 0, np.inf,
                     r.uniform(0, 8, n_ray)).astype(np.float32)
    boxes, t_far = torch.from_numpy(boxes), torch.from_numpy(t_far)
    o_, d_ = tvec(o), tvec(d)
    inv, pad = walk_ray(o_, d_, 10.0)
    live = torch.ones(n_ray, dtype=torch.bool)
    got = slab_pad(boxes, o_, inv, pad, t_far, live)
    col = lambda j: boxes[:, j, None]
    t = [(col(j) - v[None]) * w[None] for j, v, w in
         ((0, o_.x, inv.x), (3, o_.x, inv.x), (1, o_.y, inv.y),
          (4, o_.y, inv.y), (2, o_.z, inv.z), (5, o_.z, inv.z))]
    mn, mx = torch.minimum, torch.maximum
    near = mx(mx(mn(t[0], t[1]), mn(t[2], t[3])),
              mx(mn(t[4], t[5]), torch.zeros_like(t[4])))
    far = mn(mn(mx(t[0], t[1]), mx(t[2], t[3])),
             mn(mx(t[4], t[5]), t_far[None]))
    want = ~((near - pad[None] > far + pad[None]) | (col(0) >= 1.0e38))
    assert torch.equal(got, want)
    assert bool(want.any()) and not bool(want.all())


def walk_closest_hit(scene, o, d, alive):
    """closest_hit with its triangles from the warp walk: the sphere and
    plane t seed the walk, and a triangle winner is shaded at the (u, v)
    of MT run again on its row."""
    t_s, i_s, t_p, i_p = intersect._spheres_planes(scene, o, d)
    tr = scene.triangles
    (t_t, idx, _, u, v), _ = trace_walk_emulation(
        o, d, alive, torch.minimum(t_s, t_p), tr.clusters, tr.table)
    i_t = idx.clamp_min(0)
    return intersect._resolve(
        scene, o, d, t_s, i_s, t_p, i_p, t_t,
        lambda position: (normalize(intersect.triangle_normal(tr, i_t, u, v)),
                          tr.material[i_t]))


def test_whole_trace_through_the_walk_matches_plain_and_tpu_kernel(
        monkeypatch):
    """Config 4 at 64x16, 1 sample: the whole trace with each bounce's
    triangles from the walk (dead rays as dead lanes) equals the plain
    version bit for bit, and JAX's _tris_clustered (trace_full_fused in
    Pallas interpret mode) at test_torch_trace_kernel.py's bounds (RMSE
    under 2e-3, 99% of rays within 1e-3)."""
    w, h = 64, 16
    scene, camera, opt = JCONFIGS[4](width=w, height=h)
    ds = scene.build()
    ts = from_numpy(jax_scene_arrays(ds), "cpu")
    cam = camera.state(w / h)
    jcol = bounce_kernel.trace_full_fused(
        ds, jrotation(cam.yaw, cam.pitch), cam.position, cam.aspect_ratio,
        cam.fov_scale, jnp.uint32(1000), width=w, height=h, num_samples=1,
        num_bounces=opt.num_bounces, interpret=True)
    args = (ts, camera_rotation(float(cam.yaw), float(cam.pitch)),
            tuple(float(c) for c in cam.position), float(cam.aspect_ratio),
            float(cam.fov_scale), 1000)
    kw = dict(width=w, height=h, num_samples=1, num_bounces=opt.num_bounces)
    plain = tk.trace_full_plain(*args, **kw)
    alive = [None]

    def hit_of(sc, o, d):
        live = (torch.ones_like(o.x, dtype=torch.bool) if alive[0] is None
                else alive[0])
        hit = walk_closest_hit(sc, o, d, live)
        alive[0] = live & hit.hit
        return hit

    monkeypatch.setattr(trace_mod, "closest_hit", hit_of)
    walked = tk.trace_full_plain(*args, **kw)
    a, b, p = to_np(jcol), to_np(walked), to_np(plain)
    np.testing.assert_array_equal(b, p)
    assert np.isfinite(b).all()
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    agree = float(np.mean(np.all(np.abs(a - b) < 1e-3, axis=-1)))
    assert rmse < 2e-3, rmse
    assert agree > 0.99, agree


def test_constants_match_the_cuda_source():
    """The emulation's warp, chunk, ring, split point, gate batch and slab
    margin are the kernel's (a constant the sweep sets: its default), the
    wrapper's constants are the source's, the hierarchy's widths are
    ops/bvh's, and a staged row is three float4s."""
    src = Path(tk.SOURCE).read_text()

    def const(name):
        value = re.search(rf"constexpr (?:int|bool) {name} = (\w+)",
                          src).group(1)
        if not value.isdigit():
            value = re.search(rf"#define {value} (\d+)\n", src).group(1)
        return int(value)

    assert const("kChunk") == CHUNK == tk.CHUNK
    assert const("kStages") == STAGES == tk.STAGES
    assert const("kSplitMax") == SPLIT_MAX == tk.SPLIT_MAX
    assert const("kBatch") == BATCH
    assert const("kWalkBlock") == tk.WALK_BLOCK
    assert const("kSuper") == bvh.SUPER and const("kGroup") == bvh.GROUP
    assert const("kRowF4") * 4 == bvh.STAGED_COLS
    assert const("kRayBlock") == tk.RAY_BLOCK
    assert const("kPathBlock") == tk.PATH_BLOCK
    assert "constexpr float kSlabMargin = 0x1p-16f;" in src
    assert MARGIN == float.fromhex("0x1p-16")
    assert tk.WALK_SHARED_BYTES == (tk.WALK_BLOCK // 32) * STAGES * (
        CHUNK * 48 + 8)
