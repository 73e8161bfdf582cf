"""The BVH kernel's ``flat`` variant (csrc/bvh_kernel.cu, row 3: the TPU's
``_kernel`` over a table of at most 8192 slots, configs 4 and 5 under
tri_backend="bvh") as the CPU can check it, against the plain version and
simple_raytracer_tpu.

The CUDA kernel runs only on the card (chip_smoke.py holds every ``flat``
launch, and its counting instance, to the plain version there).  ``flat``
launches the warp walk that ``two_level`` and ``streamed`` launch, down
the hierarchy, which on these tables is one group of 16 supers, 2 or 4 of
them real, over 32 or 64 clusters of 64 slots: one chunk a cluster.  Here
``warp_walk_emulation`` (tests/torch_port_helpers.py) transcribes that
walk in PyTorch, and:

- on configs 4 and 5 at 64x36 (the JAX scene, NumPy builder, carried
  across), on camera rays and on warps of rays from surface patches, with
  dead, NaN and few-lane warps and finite t_init, dense and compacted (in
  ``compact_order``'s order), the walk gives the plain version's (t, slot)
  bit for bit, both MT paths run, and the JAX ``_kernel`` (Pallas
  interpret mode, block_r=128, as tests/test_torch_bvh.py runs it) gives
  the same winners, t within RTOL;
- exact ties across clusters of different supers go to the lowest global
  index, through the split MT and the per-lane MT;
- ``prepare``'s tables hand ``flat`` the padded hierarchy and the staged
  MT table, and keep the MT form under SRT_BVH_MT=plucker;
- the CUDA source sends ``flat`` to the walk and refuses its Plucker form;
- each kernel source exports its C interface's version, the wrapper's, and
  the BVH launch takes no slot table (chip_smoke.py --parent binds the
  version before, which did, with one pointer more).
"""
import ctypes
import importlib.util
import math
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops.pallas import bvh_kernel as jbvh
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops.camera import (camera_rotation,
                                                   generate_rays)
from simple_raytracer_tpu_torch.ops.cuda import build
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel as tk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.ops.vec import Vec3

from torch_port_helpers import (LANES, jax_native_accel, jax_scene_arrays,
                                jvec, tvec, unit_vectors,
                                warp_walk_emulation)

RTOL = 1e-5   # tests/test_bvh_kernel.py's bound on t (interpret mode runs
              # under jit, where XLA:CPU contracts multiply-adds)


@pytest.fixture(scope="module")
def flat_configs():
    """Configs 4 and 5 at 64x36: the JAX scene (its default, native BVH
    builder, whose tree the port's host library builds too), the port's
    clusters and slot table, and the port's camera."""
    jax_native_accel()
    out = {}
    for n in (4, 5):
        ds = JCONFIGS[n](width=64, height=36)[0].build()
        tr = from_numpy(jax_scene_arrays(ds), "cpu").triangles
        _, camera, _ = CONFIGS[n](width=64, height=36)
        out[n] = (ds, tr.clusters, tr.table, camera)
    return out


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation runs many small tensor operations: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_rays(clusters, table, camera, n_warps, seed):
    """Two warps of the 64x36 view's camera rays (every 36th), then
    ``n_warps`` warps of rays from surface patches: each warp's rays leave
    points near one origin in a cone about the direction to a point of the
    mesh's box (many lanes admit a cluster); in every third of those warps
    only 3 lanes live (few lanes admit: the split MT).  t_init a mix of
    +inf and finite seeds, about 15% of the other rays dead, and two rays
    of the third warp with a NaN origin or direction (which a NaN slab
    admits)."""
    r = np.random.default_rng(seed)
    cam = camera.state(64 / 36)
    o1, d1, _ = generate_rays(64, 36, 1, 3, cam.position,
                              camera_rotation(cam.yaw, cam.pitch),
                              cam.aspect_ratio, cam.fov_scale)
    pick = np.arange(2 * LANES) * 36
    o_cam = np.stack([c.numpy()[pick] for c in o1], 1)
    d_cam = np.stack([c.numpy()[pick] for c in d1], 1)
    v = table[:, 0:3].numpy()[clusters.hierarchy.gidx.numpy() >= 0]
    lo, hi = v.min(0), v.max(0)
    m = n_warps * LANES
    origin = (r.uniform(lo, hi, (n_warps, 3))
              + 0.5 * (hi - lo).max() * unit_vectors(r, n_warps))
    axis = r.uniform(lo, hi, (n_warps, 3)) - origin
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    o_m = origin.repeat(LANES, 0) + 0.02 * r.normal(size=(m, 3))
    d_m = axis.repeat(LANES, 0) + 0.03 * r.normal(size=(m, 3))
    d_m /= np.linalg.norm(d_m, axis=1, keepdims=True)
    o = np.concatenate([o_cam, o_m])
    d = np.concatenate([d_cam, d_m])
    n = o.shape[0]
    t_init = np.where(r.uniform(size=n) < 0.6, np.inf,
                      r.uniform(0.3, 6.0, n))
    alive = (r.uniform(size=n) > 0.15).astype(np.float32)
    warp = np.arange(n) // LANES
    few = (warp >= 2) & (warp % 3 == 1)
    alive[few] = (np.arange(n) % LANES < 3)[few]
    o[2 * LANES + 5, 0] = np.nan
    d[2 * LANES + 9, 2] = np.nan
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return f32(o), f32(d), alive, f32(t_init)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("n_cfg", [4, 5])
def test_flat_walk_matches_plain_and_jax_kernel(flat_configs, n_cfg,
                                                compact):
    """The walk over config 4's or 5's hierarchy (one group) gives the
    plain version's (t, slot) bit for bit, dense or compacted (the rays
    past compact_order's count misses), with both MT paths; the JAX
    _kernel (dense; a ray the compaction leaves out meets no admission box,
    so it has no hit there either) gives the same winners, t within
    RTOL."""
    ds, cl, table, camera = flat_configs[n_cfg]
    assert bk.bvh_variant(cl) == "flat"
    hier = cl.hierarchy
    assert hier.groups.shape[0] == 1 and cl.k == 64
    real = (cl.aabb[:, 0] < 1.0e37).nonzero()[:, 0]
    assert int((hier.supers[:, 0] < 1.0e37).sum()) == int(
        torch.unique(real // bvh.SUPER).numel()) > 1
    o, d, alive, t_init = _flat_rays(cl, table, camera, 9,
                                     seed=2 * n_cfg + compact)
    rays = (tvec(o), tvec(d), torch.from_numpy(alive),
            torch.from_numpy(t_init))
    n = o.shape[0]
    if compact:
        order, count = bvh.compact_order(*rays, hier.admission)
        (t_e, s_e), cnt = warp_walk_emulation(*rays, cl, table, "mt", order,
                                              count)
        t_p, s_p = bvh.intersect_compacted_plain(*rays, cl, table, order,
                                                 int(count))
        assert 0 < int(count) < n
        listed = rays[2][order] > 0
        listed[int(count):] = False
    else:
        (t_e, s_e), cnt = warp_walk_emulation(*rays, cl, table)
        t_p, s_p = bvh.intersect_triangles_bvh_plain(*rays, cl, table)
        listed = rays[2] > 0
    assert torch.equal(s_e, s_p) and torch.equal(t_e, t_p)
    assert 0 < cnt["split"] < cnt["chunks"]          # both MT paths
    # one group: each warp with a listed lane tests it once, and no more
    assert n % LANES == 0
    assert cnt["group_tests"] == int(listed.view(-1, LANES).any(1).sum())
    jcl = ds.triangles.clusters
    jt, ji = jbvh.intersect_triangles_bvh(
        jvec(o), jvec(d), jnp.asarray(alive), jnp.asarray(t_init),
        jcl.aabb, jcl.table_t, block_r=128, interpret=True)
    jt, ji = np.asarray(jt), np.asarray(ji)
    live = alive > 0
    i_e = bvh.triangle_index(cl, s_e).numpy()
    hit = ji[live] >= 0
    np.testing.assert_array_equal(i_e[live] >= 0, hit)
    np.testing.assert_array_equal(i_e[live][hit], ji[live][hit])
    np.testing.assert_allclose(t_e.numpy()[live][hit], jt[live][hit],
                               rtol=RTOL)
    assert int(hit.sum()) > 50 and (i_e[~live] == -1).all()


def _tie_supers(second: bool):
    """A flat table of 32 clusters of 64 slots (two supers) facing rays
    down -z, every cluster empty but three: cluster 1 holds one triangle
    at slot 5 (global index 9), cluster 20 (the second super) the same
    triangle at slot 40 (index 4), and with ``second`` cluster 31 once
    more at slot 7 (index 2)."""
    c, k = 32, 64
    table = torch.zeros(c * k, 20)
    slots = torch.full((c, k), -1, dtype=torch.int64)
    aabb = torch.full((c, 8), bvh.SENTINEL)
    aabb[:, 6:] = 0.0
    placed = ((1, 5, 9), (20, 40, 4)) + (((31, 7, 2),) if second else ())
    for cluster, slot, g in placed:
        row = cluster * k + slot
        table[row, 0:9] = torch.tensor([-1.0, -1.0, -2.0, 2.0, 0.0, 0.0,
                                        0.0, 2.0, 0.0])
        table[row, 9:18] = torch.tensor([0, 0, 1.0] * 3)
        table[row, 19] = 1.0
        slots[cluster, slot] = g
        aabb[cluster, 0:3] = torch.tensor([-1.0, -1.0, -2.0])
        aabb[cluster, 3:6] = torch.tensor([1.0, 1.0, -2.0])
    return types.SimpleNamespace(
        aabb=aabb, slots=slots, k=k, plucker=None, staged=None,
        hierarchy=bvh.build_hierarchy(aabb, slots)), table


@pytest.mark.parametrize("second", [False, True])
def test_flat_ties_across_supers_pick_lowest_index(second):
    """An exact tie across clusters of two supers (and with ``second`` a
    third cluster) goes to the lowest global index, through the per-lane
    MT (a full warp) and the split MT (a warp of one live ray), as in the
    plain version; a tie with t_init keeps the seed (a miss)."""
    cl, table = _tie_supers(second)
    assert bk.bvh_variant(cl) == "flat"
    n = 64
    o = Vec3(*(torch.zeros(n) for _ in range(3)))
    d = Vec3(torch.zeros(n), torch.zeros(n), -torch.ones(n))
    t_init = torch.full((n,), math.inf)
    t_init[:8] = 2.0
    alive = torch.ones(n)
    alive[33:] = 0.0                  # the second warp: one live ray
    (t_e, s_e), cnt = warp_walk_emulation(o, d, alive, t_init, cl, table)
    t_p, s_p = bvh.intersect_triangles_bvh_plain(o, d, alive, t_init, cl,
                                                 table)
    assert torch.equal(s_e, s_p) and torch.equal(t_e, t_p)
    won = 31 * 64 + 7 if second else 20 * 64 + 40
    assert (s_e[8:33] == won).all() and (t_e[8:33] == 2.0).all()
    assert (s_e[:8] == -1).all() and (s_e[33:] == -1).all()
    assert 0 < cnt["split"] < cnt["chunks"]


@pytest.mark.parametrize("n_cfg", [4, 5])
@pytest.mark.parametrize("form", ["mt", "plucker"])
def test_prepare_hands_flat_the_hierarchy_and_staged_table(
        flat_configs, n_cfg, form, monkeypatch):
    """The tables a flat launch gets (``bk.launch_tables``, which
    ``prepare`` packs): the hierarchy's boxes padded with sentinels to a
    whole group, its supers and groups, the groups as the visiting order,
    and the staged MT table, built once per scene; under SRT_BVH_MT=plucker
    still the MT form (the TPU's _kernel never asks for Plucker), with no
    coefficient table."""
    _, cl, table, _ = flat_configs[n_cfg]
    cl = types.SimpleNamespace(**{f: getattr(cl, f) for f in (
        "aabb", "slots", "k", "hierarchy")}, plucker=None, staged=None)
    monkeypatch.setenv("SRT_BVH_MT", form)
    variant = bk.bvh_variant(cl)
    tensors, n_order, plucker, sub_rows = bk.launch_tables(
        cl, table, variant, compact=True)
    staged, coeffs, gidx, boxes, supers, groups, adm, subboxes = tensors
    hier = cl.hierarchy
    n_cl = cl.slots.shape[0]
    assert variant == "flat" and not plucker and coeffs is None
    assert sub_rows == 0 and subboxes is None      # flat never gates
    assert cl.plucker is None
    assert staged is cl.staged and staged is bvh.staged_slots(cl, table)
    assert torch.equal(staged.view(torch.int32),           # NaN bits too
                       bvh.stage_slots(table, hier.gidx).view(torch.int32))
    assert all(t is not table for t in tensors)     # no variant reads it
    assert gidx is hier.gidx and adm is hier.admission
    assert boxes is hier.boxes and supers is hier.supers
    assert groups is hier.groups and n_order == 1
    assert boxes.shape == (bvh.SUPER * bvh.GROUP, 8)
    assert torch.equal(boxes[:n_cl], cl.aabb)
    assert (boxes[n_cl:, :6] == bvh.SENTINEL).all()
    assert not boxes[:, 6:].any()
    adm = bk.launch_tables(cl, table, variant, compact=False)[0][6]
    assert adm is None


def test_cuda_source_sends_flat_to_the_walk():
    """In the CUDA source every variant launches the one warp walk (kFlat
    falls through to kTwoLevel and kStreamed, down the hierarchy), the
    one-thread loop is gone, and flat's Plucker form is refused."""
    src = Path(bk.SOURCE).read_text()
    assert re.search(r"case kFlat:[^\n]*\n\s+case kTwoLevel:\n\s+"
                     r"case kStreamed:\n\s+SRT_BVH_WALK\(kStreamed\);",
                     src)
    assert "mt_cluster" not in src
    assert re.search(r"\(p\.plucker && p\.variant == kFlat\)", src)


@pytest.mark.parametrize("split_max,stages", [(0, 1), (LANES, 4)])
def test_flat_walk_constants_change_no_result(flat_configs, split_max,
                                              stages):
    """Config 5's walk never splitting MT (split point 0) or always (32),
    each chunk found just before its turn or 3 chunks ahead, as the sweep
    builds it: the plain version's (t, slot) bit for bit."""
    _, cl, table, camera = flat_configs[5]
    o, d, alive, t_init = _flat_rays(cl, table, camera, 6, seed=21)
    rays = (tvec(o), tvec(d), torch.from_numpy(alive),
            torch.from_numpy(t_init))
    (t_e, s_e), cnt = warp_walk_emulation(*rays, cl, table,
                                          split_max=split_max, stages=stages)
    t_p, s_p = bvh.intersect_triangles_bvh_plain(*rays, cl, table)
    assert torch.equal(s_e, s_p) and torch.equal(t_e, t_p)
    assert int((s_p >= 0).sum()) > 50
    assert cnt["split"] == (cnt["chunks"] if split_max else 0)


@pytest.mark.parametrize("kernel,name", [(bk, "srt_bvh_interface"),
                                         (tk, "srt_trace_interface")])
def test_c_interface_version_matches_the_wrapper(kernel, name):
    """Each kernel source exports its C interface's version as ``name``,
    the wrapper's INTERFACE (its binding refuses a build of another)."""
    src = Path(kernel.SOURCE).read_text()
    m = re.search(rf'extern "C" int {name}\(\) \{{ return (\d+); \}}',
                  src)
    assert m and int(m.group(1)) == kernel.INTERFACE


def test_interface_of_a_build_without_the_export_is_1():
    """``build.interface``: a build of a source from before the export has
    version 1; one with it, what its function returns."""
    lib = types.SimpleNamespace()
    assert build.interface(lib, "srt_bvh_interface") == 1
    lib.srt_bvh_interface = lambda: 7
    assert build.interface(lib, "srt_bvh_interface") == 7


def test_bvh_launch_takes_no_slot_table():
    """srt_bvh_launch's pointers after the rays are ``Prepared.tensors``
    (staged, coeffs, gidx, boxes, supers, groups, admission, subboxes),
    then the work scratch, the compaction's order and count and the
    outputs: no variant reads the slot table, so it is not passed.
    chip_smoke.py binds a parent's build to this interface (bk._bind,
    binding every entry point) or to interface 3, the one without
    BvhOptions, whose launches it passes without the options (refusing a
    switch it lacks), and refuses any other version: 1, the one that took
    the slot table, and 2, the one without the sub-box table."""
    src = Path(bk.SOURCE).read_text()
    sig = re.search(r"int srt_bvh_launch\((.*?)\)", src, re.S).group(1)
    assert re.findall(r"\*\s*(\w+)", sig)[8:] == [
        "staged", "coeffs", "gidx", "boxes", "supers", "groups",
        "admission", "subboxes", "work", "perm", "count", "t_out",
        "slot_out", "stream"]
    assert bk.LAUNCH_POINTERS == 8 + 8 + 5
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    parent = smoke.parent_bvh_kernel(Path("parent"))
    for old in (1, 2):
        with pytest.raises(RuntimeError, match=f"interface {old}, want 4"):
            parent.bind(types.SimpleNamespace(
                srt_bvh_interface=lambda: old))
    fn = lambda: types.SimpleNamespace()
    lib = types.SimpleNamespace(srt_bvh_interface=lambda: bk.INTERFACE,
                                srt_bvh_launch=fn(),
                                srt_bvh_count_launch=fn(),
                                srt_bvh_work_words=fn(),
                                srt_bvh_morton_keys=fn())
    parent.bind(lib)
    assert lib.srt_bvh_launch.argtypes == bk.LAUNCH_ARGTYPES
    assert lib.srt_bvh_count_launch.argtypes == bk.COUNT_ARGTYPES
    # interface 3: the same arguments without the options
    lib3 = types.SimpleNamespace(srt_bvh_interface=lambda: 3,
                                 srt_bvh_launch=fn(),
                                 srt_bvh_count_launch=fn(),
                                 srt_bvh_work_words=fn())
    parent.bind(lib3)
    assert parent.version == 3
    assert lib3.srt_bvh_launch.argtypes == (
        [ctypes.c_void_p] * bk.LAUNCH_POINTERS
        + [bk.BvhParams, ctypes.c_void_p])
    assert lib3.srt_bvh_count_launch.argtypes == (
        [ctypes.c_void_p] * (bk.LAUNCH_POINTERS + 1)
        + [bk.BvhParams, ctypes.c_void_p])
    calls = []
    lib3 = types.SimpleNamespace(
        srt_bvh_launch=lambda *a: calls.append(a) or 0, tag="parent")
    wrapped = smoke.ParentBvhLibrary(lib3)
    params, opt = bk.BvhParams(), bk.BvhOptions()
    assert wrapped.srt_bvh_launch(1, 2, opt, params, 3) == 0
    assert calls == [(1, 2, params, 3)] and wrapped.tag == "parent"
    for name in ("reverse", "morton"):
        on = bk.BvhOptions()
        setattr(on, name, 1)
        with pytest.raises(ValueError, match="interface 3"):
            wrapped.srt_bvh_launch(1, 2, on, params, 3)
    assert not hasattr(smoke, "BvhParamsV2")
