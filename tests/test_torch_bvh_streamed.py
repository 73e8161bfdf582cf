"""The streamed BVH variant's pieces that the CPU can check
(ops/bvh.py, ops/cuda/bvh_kernel.py, csrc/bvh_kernel.cu), against
simple_raytracer_tpu where it has the function.

The CUDA kernel runs only on the card (chip_smoke.py holds every streamed
launch, and the card's compaction, to the plain versions there).  Here:

- the ray compaction the launch runs on the card, transcribed in PyTorch
  (``compact_buckets``), admits exactly the rays of the plain version
  ``bvh.compact_order`` and counts them as the JAX ``_compact_prefix``
  does, on configs 5 and 6 at 64x36: camera and mesh rays, every ray
  admitting, none admitting, dead rays and NaN rays;
- the staged MT table (``bvh.stage_slots``) holds the slot table's
  columns and global indices at every slot, at K = 128 and 256, and is
  built once per scene;
- a PyTorch emulation of the kernel's split MT (``mt_chunk`` with few
  lanes admitting: each chunk of staged slots split over 32 lanes, each
  lane's least (t bits << 32 | index) key, the warp's least key, the
  commit by the ray's own lane) gives ``intersect_triangles_bvh_plain``'s
  (t, slot) bit for bit, in both MT forms, on random rays and on exact
  ties across lanes and across clusters.
"""
import math
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
from simple_raytracer_tpu.ops.pallas import bvh_kernel as jbvh
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops.camera import (camera_rotation,
                                                   generate_rays)
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.ops.vec import Vec3

from torch_port_helpers import (jax_native_accel, jax_scene_arrays, jvec,
                                tvec, unit_vectors)

CHUNK, LANES = 64, 32      # the kernel's kChunk and a warp


@pytest.fixture(scope="module")
def config_scenes():
    """Configs 5 and 6 at 64x36: the JAX scene (its default, native BVH
    builder) carried across, and the port's camera."""
    jax_native_accel()
    out = {}
    for n in (5, 6):
        ds = JCONFIGS[n](width=64, height=36)[0].build()
        _, camera, _ = CONFIGS[n](width=64, height=36)
        out[n] = (ds, from_numpy(jax_scene_arrays(ds), "cpu"), camera)
    return out


def _compaction_rays(ts, camera, case, seed):
    """Camera rays of the 64x36 view and rays from around the mesh at its
    box; t_init a mix of +inf and finite seeds.  ``case``: "mixed" (about
    20% dead), "every" (origins at admission box centers, every ray live
    with t_init = inf: every ray admits), "none" (rays far away, heading
    away), "dead" (every ray dead), "nan" (about 10% NaN origins or
    directions, which a NaN slab admits)."""
    r = np.random.default_rng(seed)
    cam = camera.state(64 / 36)
    o1, d1, _ = generate_rays(64, 36, 1, 3, cam.position,
                              camera_rotation(cam.yaw, cam.pitch),
                              cam.aspect_ratio, cam.fov_scale)
    tr = ts.triangles
    v = tr.v0.numpy()[tr.active.numpy()]
    target = r.uniform(v.min(0), v.max(0), size=(1500, 3))
    o2 = target + 3.0 * r.normal(size=(1500, 3))
    d2 = target - o2
    o = np.concatenate([np.stack([c.numpy() for c in o1], 1), o2])
    d = np.concatenate([np.stack([c.numpy() for c in d1], 1),
                        d2 / np.linalg.norm(d2, axis=1, keepdims=True)])
    n = o.shape[0]
    t_init = np.where(r.uniform(size=n) < 0.5, np.inf,
                      r.uniform(0.5, 6.0, n))
    alive = (r.uniform(size=n) > 0.2).astype(np.float32)
    if case == "every":
        adm = tr.clusters.hierarchy.admission.numpy()
        adm = adm[adm[:, 0] < 1.0e37]
        o = ((adm[:, 0:3] + adm[:, 3:6]) * 0.5)[r.integers(0, len(adm), n)]
        d = unit_vectors(r, n)
        t_init[:] = np.inf
        alive[:] = 1.0
    elif case == "none":
        o = 1.0e4 + r.uniform(0, 1, (n, 3))
        d = np.abs(unit_vectors(r, n)) + 0.1
        alive[:] = 1.0
    elif case == "dead":
        alive[:] = 0.0
    elif case == "nan":
        bad = r.uniform(size=n) < 0.1
        o[bad & (r.uniform(size=n) < 0.5), 0] = np.nan
        d[bad, 1] = np.nan
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return f32(o), f32(d), alive, f32(t_init)


def compact_buckets(o: Vec3, d: Vec3, alive: torch.Tensor,
                    t_init: torch.Tensor, admission: torch.Tensor):
    """The card's ray compaction (``csrc/bvh_kernel.cu``: ``rank_boxes``,
    ``bucket_rays``, ``scan_buckets``, ``scatter_rays``) in PyTorch ->
    (order (R,) int64, count 0-d int64, bucket (R,) int64).  A ray's
    bucket is 8 x the rank of the first admission box, in front-to-back
    order, that the live ray may meet before ``t_init``, plus its direction
    octant, or ``8 * N`` (the last) when it meets none or is dead; the
    order holds the buckets in turn from each bucket's first place (the
    exclusive sum of the sizes before it), and ``count`` is the last
    bucket's first place.  Within a bucket the kernel places rays in any
    order, this version in index order.  The admitted rays and their count
    are ``bvh.compact_order``'s."""
    n_box = admission.shape[0]
    live = alive > 0
    by_rank = bvh.front_to_back(admission, o, live).long()
    maybe = bvh.slab_maybe(admission[by_rank], o, bvh.inverse(d), t_init,
                           live)
    first = torch.where(maybe.any(dim=0), maybe.to(torch.int8).argmax(dim=0),
                        n_box)
    octant = ((d.x < 0).long() * 4 + (d.y < 0).long() * 2
              + (d.z < 0).long())
    bucket = torch.where(first < n_box, first * 8 + octant, 8 * n_box)
    sizes = torch.bincount(bucket, minlength=8 * n_box + 1)
    cursor = torch.cumsum(sizes, 0) - sizes
    order = torch.argsort(bucket, stable=True)
    return order, cursor[8 * n_box], bucket


@pytest.mark.parametrize("case", ["mixed", "every", "none", "dead", "nan"])
@pytest.mark.parametrize("n_cfg", [5, 6])
def test_card_compaction_admits_compact_orders_rays(config_scenes, n_cfg,
                                                    case):
    """compact_buckets (the launch's compaction, transcribed) admits the
    rays compact_order admits, first, with the same count; the JAX
    _compact_prefix counts the same; its buckets hold the admitted rays in
    front-to-back rank order of their first admission box, octant by
    octant, and the rest last."""
    ds, ts, camera = config_scenes[n_cfg]
    o, d, alive, t_init = _compaction_rays(ts, camera, case, 17 + n_cfg)
    n = o.shape[0]
    adm = ts.triangles.clusters.hierarchy.admission
    args = (tvec(o), tvec(d), torch.from_numpy(alive),
            torch.from_numpy(t_init))
    order_p, count_p = bvh.compact_order(*args, adm)
    order, count, bucket = compact_buckets(*args, adm)
    count = int(count)
    assert count == int(count_p)
    assert set(order[:count].tolist()) == set(order_p[:count].tolist())
    assert sorted(order.tolist()) == list(range(n))
    _, jcount = jbvh._compact_prefix(
        jvec(o), jvec(d), jnp.asarray(alive), jnp.asarray(t_init),
        ds.triangles.clusters.aabb, n, "super")
    assert count == int(jcount)
    want = {"every": n, "none": 0, "dead": 0}
    if case in want:
        assert count == want[case]
    else:
        assert 0 < count < n
    # the buckets: ascending along the order, the admitted ones first
    none = 8 * adm.shape[0]
    b = bucket[order]
    assert bool((b[1:] >= b[:-1]).all())
    assert bool((b[:count] < none).all()) and bool((b[count:] == none).all())
    octant = ((args[1].x < 0).long() * 4 + (args[1].y < 0).long() * 2
              + (args[1].z < 0).long())
    adm_ok = bucket < none
    assert torch.equal((bucket % 8)[adm_ok], octant[adm_ok])
    if case == "nan":
        nan_live = (np.isnan(o).any(1) | np.isnan(d).any(1)) & (alive > 0)
        assert adm_ok.numpy()[nan_live].all() and nan_live.sum() > 20


def _ico_clusters(k):
    pos, nrm = icosphere(subdivisions=2)          # 320 triangles
    sc = JScene()
    sc.cluster_threshold = 64
    sc.cluster_size = k
    sc.add_model(sc.pool.append(pos, nrm))
    ts = from_numpy(jax_scene_arrays(sc.build()), "cpu")
    return ts.triangles.clusters, ts.triangles.table


@pytest.mark.parametrize("k", [128, 256])
def test_staged_slots_hold_the_slot_table(k, monkeypatch):
    """stage_slots' rows: v0, the global index's int32 bits, e1, active,
    e2 and a zero, at every slot of a K = 128 or 256 table (the empty
    ones too); staged_slots builds them once per scene and keeps them on
    the clusters."""
    cl, table = _ico_clusters(k)
    assert cl.k == k and cl.staged is None
    built = []
    stage = bvh.stage_slots
    monkeypatch.setattr(bvh, "stage_slots",
                        lambda *a: built.append(1) or stage(*a))
    st = bvh.staged_slots(cl, table)
    assert bvh.staged_slots(cl, table) is st is cl.staged
    assert built == [1]
    assert st.shape == (cl.slots.numel(), bvh.STAGED_COLS)
    assert st.dtype == torch.float32 and st.is_contiguous()
    gidx = cl.hierarchy.gidx
    assert torch.equal(st[:, 0:3], table[:, 0:3])
    assert torch.equal(st[:, 3].contiguous().view(torch.int32), gidx)
    assert torch.equal(st[:, 4:7], table[:, 3:6])
    assert torch.equal(st[:, 7], table[:, 19])
    assert torch.equal(st[:, 8:11], table[:, 6:9])
    assert not st[:, 11].any()
    real = gidx >= 0
    assert bool(real.any()) and bool((~real).any())
    assert bool((st[real, 7] > 0).all()) and not st[~real, 7].any()


def _staged_cols(clusters, table, form):
    """The staged rows the kernel stages, as ``col(j)`` of the plain
    version's arithmetic (``bvh._mt``'s slot-table columns, or the Plucker
    coefficients), and each slot's global index."""
    gidx = clusters.hierarchy.gidx
    if form == "plucker":
        coeffs = bvh.plucker_table(table)
        return (lambda s: lambda j: coeffs[s, j]), gidx
    st = bvh.stage_slots(table, gidx)
    where = {0: 0, 1: 1, 2: 2, 3: 4, 4: 5, 5: 6, 6: 8, 7: 9, 8: 10, 19: 7}
    return ((lambda s: lambda j: st[s, where[j]]),
            st[:, 3].contiguous().view(torch.int32))


def split_emulation(o, d, alive, t_init, clusters, table, form):
    """The kernel's split MT in PyTorch, over the (ray, cluster) pairs the
    plain version's gates admit: each chunk of CHUNK slots is split over
    LANES lanes (lane l tests slots l, l + LANES, ...), each lane keeps
    its least key (t bits << 32 | global index; t > 0, so the bits order
    as the floats do), the warp takes the least key of its lanes and the
    slot that holds it, and the ray's lane commits it by ``commit``'s rule
    (the least (t, index) wins, seeded with (t_init, -1)), one candidate a
    ray at a time."""
    n_rays = o.x.shape[0]
    n_cl, k = clusters.slots.shape
    cols, gidx = _staged_cols(clusters, table, form)
    mt = bvh._mt_plucker if form == "plucker" else bvh._mt
    live = alive > 0
    inv = bvh.inverse(d)
    pairs = [torch.stack(p) for p in bvh.admitted_pairs(
        o, inv, live, t_init, clusters, 2 ** 20)]
    c, r = torch.cat(pairs, 1) if pairs else torch.zeros(2, 0).long()
    no_key = torch.iinfo(torch.int64).max
    cand = []
    for base in range(0, k, CHUNK):
        n = min(CHUNK, k - base)
        slots = c[:, None] * k + base + torch.arange(n)          # (P, n)
        ray = lambda v: v[r][:, None]
        t, valid = mt(ray(o.x), ray(o.y), ray(o.z), ray(d.x), ray(d.y),
                      ray(d.z), cols(slots))
        key = torch.where(valid, (t.view(torch.int32).long() << 32)
                          | gidx[slots].long(), no_key)
        pad = -n % LANES
        lanes = torch.cat([key, torch.full((key.shape[0], pad), no_key)],
                          1).view(key.shape[0], -1, LANES).amin(1)
        least = lanes.amin(1)                                    # (P,)
        at = (key == least[:, None]).long().argmax(1)
        got = least != no_key
        cand.append((r[got], least[got], slots[got, at[got]]))
    rays = torch.cat([x[0] for x in cand])
    keys = torch.cat([x[1] for x in cand])
    slots = torch.cat([x[2] for x in cand])
    best_t, best_i = t_init.clone(), torch.full((n_rays,), -1)
    best_s = torch.full((n_rays,), -1)
    by_ray = torch.argsort(rays, stable=True)
    rays, keys, slots = rays[by_ray], keys[by_ray], slots[by_ray]
    first = torch.searchsorted(rays, rays, right=False)
    turn = torch.arange(rays.numel()) - first
    for i in range(int(turn.max()) + 1 if turn.numel() else 0):
        sel = turn == i
        rr = rays[sel]
        t = (keys[sel] >> 32).to(torch.int32).view(torch.float32)
        g = keys[sel] & 0xFFFFFFFF
        bt, bi = best_t[rr], best_i[rr]
        win = (t <= bt) & ((t < bt) | (g < bi))
        best_t[rr] = torch.where(win, t, bt)
        best_i[rr] = torch.where(win, g, bi)
        best_s[rr] = torch.where(win, slots[sel], best_s[rr])
    won = best_i >= 0
    return (torch.where(won, best_t, math.inf),
            torch.where(won, best_s, -1).to(torch.int32))


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
    return (tvec(o), tvec(d), torch.from_numpy(alive),
            torch.from_numpy(t_init))


@pytest.mark.parametrize("form", ["mt", "plucker"])
@pytest.mark.parametrize("k", [64, 128, 256])
def test_split_mt_matches_plain(k, form):
    """The split MT with its warp-minimum merge gives the plain version's
    (t, slot) on every ray, in either MT form."""
    cl, table = _ico_clusters(k)
    rays = _ray_set(800, seed=k + (form == "plucker"))
    t_e, s_e = split_emulation(*rays, cl, table, form)
    t_p, s_p = bvh.intersect_triangles_bvh_plain(*rays, cl, table, form)
    assert torch.equal(s_e, s_p) and torch.equal(t_e, t_p)
    assert int((s_p >= 0).sum()) > 200


def _tie_clusters(second: bool):
    """Clusters of 64 slots facing rays down -z: cluster 0 holds one
    triangle twice, at slot 3 (global index 9) and slot 40 (index 4), two
    lanes apart; with ``second``, cluster 1 holds it once more at slot 69
    (index 2)."""
    c, k = (2 if second else 1), 64
    table = torch.zeros(c * k, 20)
    slots = torch.full((c, k), -1, dtype=torch.int64)
    for slot, g in ((3, 9), (40, 4)) + (((69, 2),) if second else ()):
        table[slot, 0:9] = torch.tensor([-1.0, -1.0, -2.0, 2.0, 0.0, 0.0,
                                         0.0, 2.0, 0.0])
        table[slot, 9:18] = torch.tensor([0, 0, 1.0] * 3)
        table[slot, 19] = 1.0
        slots.view(-1)[slot] = g
    aabb = torch.zeros(c, 8)
    aabb[:, 0:3] = torch.tensor([-1.0, -1.0, -2.0])
    aabb[:, 3:6] = torch.tensor([1.0, 1.0, -2.0])
    return types.SimpleNamespace(
        aabb=aabb, slots=slots, k=k, plucker=None,
        hierarchy=bvh.build_hierarchy(aabb, slots)), table


@pytest.mark.parametrize("form", ["mt", "plucker"])
@pytest.mark.parametrize("second", [False, True])
def test_split_mt_ties_pick_lowest_index(second, form):
    """An exact tie across the lanes of a chunk, and across clusters, goes
    to the lowest global index, as in the plain version; a tie with
    t_init keeps the seed (a miss)."""
    cl, table = _tie_clusters(second)
    n = 64
    o = Vec3(*(torch.zeros(n) for _ in range(3)))
    d = Vec3(torch.zeros(n), torch.zeros(n), -torch.ones(n))
    t_init = torch.full((n,), math.inf)
    t_init[:8] = 2.0
    alive = torch.ones(n)
    t_e, s_e = split_emulation(o, d, alive, t_init, cl, table, form)
    t_p, s_p = bvh.intersect_triangles_bvh_plain(o, d, alive, t_init, cl,
                                                 table, form)
    assert torch.equal(s_e, s_p) and torch.equal(t_e, t_p)
    assert (s_e[8:] == (69 if second else 40)).all()
    assert (s_e[:8] == -1).all() and torch.isinf(t_e[:8]).all()
    assert (t_e[8:] == 2.0).all()


def test_card_route_leaves_the_compaction_to_the_launch(monkeypatch):
    """On a device other than the CPU the compacted route never calls the
    PyTorch compaction (compact_order, front_to_back): the launch does it
    on the card, and prepare refuses any device but CUDA."""
    calls = []
    for name in ("compact_order", "front_to_back",
                 "intersect_compacted_plain"):
        monkeypatch.setattr(bvh, name, lambda *a, _n=name, **k:
                            calls.append(_n))
    cl, table = _ico_clusters(128)
    meta = lambda t: t.to("meta")
    o = Vec3(*(meta(torch.zeros(8)) for _ in range(3)))
    ones = meta(torch.ones(8))
    with pytest.raises(ValueError, match="unsupported device"):
        bk.intersect_triangles_bvh(o, o, ones, ones, cl, table,
                                   compact=True, force_streamed=True)
    assert not calls


def test_streamed_constants_match_the_cuda_source():
    """The staged row, the chunk, the split point, the compaction's and
    the visiting order's limits and the counting instance's counters are
    the wrapper's and the plain version's."""
    src = Path(bk.SOURCE).read_text()

    def const(name):
        value = re.search(rf"constexpr int {name} = (\w+);", src).group(1)
        if not value.isdigit():    # a constant the sweep sets: its default
            value = re.search(rf"#define {value} (\d+)\n", src).group(1)
        return int(value)

    assert const("kMtRowF4") * 4 == bvh.STAGED_COLS
    assert const("kChunk") == CHUNK
    assert const("kStages") >= 2 and 0 < const("kSplitMax") <= LANES
    assert const("kAdmissionMax") == bvh.ADMISSION_MAX
    assert const("kRankMax") == bk.RANK_MAX
    body = re.search(r"enum Count \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"^\s*kCount([A-Z]\w*)", body, re.M)
    camel = lambda s: "".join(w.title() for w in s.split("_"))
    assert names == [camel(c) for c in bk.COUNTERS] + ["Hist"]
    assert re.search(rf"kCounters = kCountHist \+ {len(bk.HIST_BINS)}\b",
                     src)
