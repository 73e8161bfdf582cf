"""The reference agrees with the program on the CPU at a tiny size, for
each configuration with its mesh cut, on the route its cells take there
(the envelopes lowered so that a cut mesh takes the full-size route); its
own tree finds exactly the dense loop's nearest triangle."""
import math

import pytest
import torch

import calibrate
import run
from conftest import make_cell
from reference import lbvh

# the route of each cell at full size, and the envelope constants that
# send a cut mesh down the same route on the CPU
CELLS = {
    "large_mesh.view1080_auto": ("split", "two_level"),
    "mega_mesh.view1080_fused": ("fused", "streamed"),
    "large_mesh.view1080_fused": ("whole", None),
    "mega_mesh.view1080_auto": ("split", "streamed"),
}


@pytest.fixture
def full_size_routes(monkeypatch):
    from simple_raytracer_tpu_torch.ops import bvh, scene_types
    monkeypatch.setattr(scene_types, "TABLE_MAX_SLOTS", 256)
    monkeypatch.setattr(bvh, "VMEM_TABLE_MAX_SLOTS", 256)
    return bvh, scene_types


def route_of(cfg, mix, md, bvh, scene_types, mega):
    from simple_raytracer_tpu_torch.ops import trace
    from srtbench import scenes
    ds = scenes.port_scene(cfg, md).build("cpu")
    # the large mesh's clusters inside the whole-trace kernel's "fused"
    # envelope, the mega mesh's past it and past the BVH kernel's
    # residency limit
    scene_types.MEGA_PACKED_MAX_CLUSTERS = 8 if mega else 40
    if mega:
        bvh.PACKED_VMEM_MAX_CLUSTERS = 8
    if trace.takes_whole_trace(ds, mix["tri_backend"]):
        return "whole", None
    kind = "fused" if trace.fused_ok(ds, mix["tri_backend"]) else "split"
    from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel
    return kind, bvh_kernel.bvh_variant(ds.triangles.clusters, False)


@pytest.mark.parametrize("cell", list(CELLS))
def test_reference_agrees_with_program(cell, tmp_path, full_size_routes,
                                       monkeypatch):
    bvh, scene_types = full_size_routes
    config, mix_name = cell.split(".")
    mega = config == "mega_mesh"
    monkeypatch.setattr(bvh, "PACKED_VMEM_MAX_CLUSTERS",
                        bvh.PACKED_VMEM_MAX_CLUSTERS)
    monkeypatch.setattr(scene_types, "MEGA_PACKED_MAX_CLUSTERS",
                        scene_types.MEGA_PACKED_MAX_CLUSTERS)
    root, bd, name = make_cell(tmp_path, config, subdivisions=3,
                               mix=mix_name)
    cfg, mix, md = calibrate._pieces(name, root, bd)
    assert route_of(cfg, mix, md, bvh, scene_types, mega) == CELLS[cell]
    # the harness's own run, the comparison that decides ``correct``
    for seed in (2 ** 31 + 3, 17):
        r = run.run_cell(name, seed, 0.3, False, device="cpu", root=root,
                         bench_dir=bd)
        assert r["correct"], r["checks"]
        assert set(r["checks"]) == {"gap", "nonfinite", "image_levels"}


def dense_nearest(o, d, v):
    t = lbvh._moller_trumbore(o[:, None], d[:, None], v[None, :, 0],
                              (v[:, 1] - v[:, 0])[None],
                              (v[:, 2] - v[:, 0])[None])
    tmin = t.min(1).values
    idx = torch.where(t == tmin[:, None], torch.arange(v.shape[0]),
                      v.shape[0]).min(1).values
    return torch.where(torch.isfinite(tmin), tmin, math.inf), \
        torch.where(torch.isfinite(tmin), idx, -1)


@pytest.mark.parametrize("n_tris", [5, 8, 300])
def test_tree_finds_the_dense_nearest(n_tris):
    from meshes.organic_blob import generate
    g = torch.Generator().manual_seed(n_tris)
    pos = torch.tensor(generate(2)[0])[:n_tris]         # up to 320
    pos = torch.cat([pos, pos[:3] + 0.0])               # exact duplicates
    tree = lbvh.LBVH(pos[:, 0], pos[:, 1], pos[:, 2])
    n = 4000
    o = torch.randn(n, 3, generator=g) * 2.0
    o[: n // 4] *= 0.2                                   # inside the mesh
    d = torch.randn(n, 3, generator=g)
    d[:50, 1] = 0.0                                      # axis-parallel
    d = d / d.norm(dim=1, keepdim=True)
    d[60] = math.nan                                     # the ln(0) hazard
    limit = torch.full((n,), math.inf)
    limit[100:200] = 0.5
    t, i = tree.nearest(o, d, limit)
    td, idd = dense_nearest(o, d, pos)
    keep = td < limit
    td = torch.where(keep, td, math.inf)
    idd = torch.where(keep, idd, -1)
    assert torch.equal(t, td)
    assert torch.equal(i, idd)
    assert i[60] == -1
