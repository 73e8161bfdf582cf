"""The whole-trace kernel module (ops/cuda/trace_kernel.py) on the CPU.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it
against its plain version there).  Here: the wrapper's dispatch (the
plain version for a CPU scene, an error for any other non-CUDA device,
no launch counted), its envelope (which meshes the kernel serves, and an
error, not the plain version, for any other), the launch ABI against the
CUDA source, the kernel's tables and cluster hierarchy against the TPU
kernel's, and the plain version against the TPU kernel ``_trace_kernel``
itself, run in Pallas interpret mode at 64x16 with 1 sample, for every
triangle variant (configs 1 and 2 without triangles, 3 small, 4 and 5
clustered).  Interpret mode runs under jit, where XLA:CPU fuses
multiply-adds, so per-ray radiance may drift by float rounding and a
path may flip at a Bernoulli threshold: that comparison bounds the RMSE
at 2e-3 (the golden bound) and needs 99% of rays within 1e-3, as
tests/test_fused_kernel.py does for the kernel against the scan path.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops.camera import camera_rotation as jrotation
from simple_raytracer_tpu.ops.pallas import bounce_kernel
from simple_raytracer_tpu_torch.ops.camera import camera_rotation
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel as tk
from simple_raytracer_tpu_torch.ops.scene_types import (from_numpy,
                                                       whole_trace_variant)

from torch_port_helpers import jax_scene_arrays, to_np


def _scene(n, w=64, h=16):
    kw = {"skybox": "gradient"} if n == 3 else {}
    scene, camera, opt = JCONFIGS[n](width=w, height=h, **kw)
    ds = scene.build()
    return ds, from_numpy(jax_scene_arrays(ds), "cpu"), camera, opt


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_plain_version_matches_tpu_kernel(n):
    w, h = 64, 16
    ds, ts, camera, opt = _scene(n, w, h)
    cam = camera.state(w / h)
    jcol = bounce_kernel.trace_full_fused(
        ds, jrotation(cam.yaw, cam.pitch), cam.position, cam.aspect_ratio,
        cam.fov_scale, jnp.uint32(1000), width=w, height=h, num_samples=1,
        num_bounces=opt.num_bounces, interpret=True)
    tcol = tk.trace_full(ts, camera_rotation(float(cam.yaw), float(cam.pitch)),
                         tuple(float(c) for c in cam.position),
                         float(cam.aspect_ratio), float(cam.fov_scale), 1000,
                         width=w, height=h, num_samples=1,
                         num_bounces=opt.num_bounces)
    a, b = to_np(jcol), to_np(tcol)
    assert np.isfinite(b).all()
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    agree = float(np.mean(np.all(np.abs(a - b) < 1e-3, axis=-1)))
    assert rmse < 2e-3, rmse
    assert agree > 0.99, agree


def test_wrapper_dispatch():
    """A CPU scene takes the plain version and counts no launch; a device
    that is neither CPU nor CUDA raises instead of falling back."""
    from simple_raytracer_tpu_torch.models.presets import CONFIGS
    scene, camera, _ = CONFIGS[2](width=64, height=16)
    ts = scene.build("cpu")
    cam = camera.state(4.0)
    args = (ts, camera_rotation(cam.yaw, cam.pitch), cam.position,
            cam.aspect_ratio, cam.fov_scale, 9)
    kw = dict(width=64, height=16, num_samples=2, num_bounces=4)
    before = tk.KERNEL.launches
    a = tk.trace_full(*args, **kw)
    segments = []
    b = tk.trace_full_plain(*args, **kw, segments=segments)
    assert tk.KERNEL.launches == before
    np.testing.assert_array_equal(to_np(a), to_np(b))
    live = [s[0] for s in segments]
    assert live[0] == 64 * 16 * 2 and live == sorted(live, reverse=True)
    assert all(tri == 0 and hit <= l for l, hit, tri in segments)
    meta = from_numpy(scene.arrays(), "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.trace_full(meta, *args[1:], **kw)


def test_tables_match_tpu_kernel_tables():
    ds, ts, _, _ = _scene(2)
    for jt, tt in zip(bounce_kernel.prim_tables(ds), tk.prim_tables(ts)):
        jt, tt = np.asarray(jt), tt.numpy()
        np.testing.assert_array_equal(jt[:tt.shape[0]], tt)
        assert not jt[tt.shape[0]:].any()   # the TPU table's row padding
    # the small triangle table: the TPU table's first 20 columns
    ds, ts, _, _ = _scene(3)
    np.testing.assert_array_equal(
        np.asarray(bounce_kernel.small_tris_table(ds))[:, :20],
        ts.triangles.table.numpy())


@pytest.mark.parametrize("n", [4, 5])
def test_cluster_tables_and_order_match_tpu_kernel(n):
    """The slot table equals the TPU row table's first 20 columns on every
    filled slot (an empty slot is all zero, inactive); the kernel's boxes
    are the TPU boxes, and its slab margin scales with their largest real
    coordinate.  (The kernel visits the clusters in the hierarchy's index
    order and breaks exact ties by the global triangle index, so no
    visiting order reaches the launch: tests/test_torch_trace_walk.py
    holds the walk to the dense plain version.)"""
    ds, ts, camera, _ = _scene(n)
    cl, tcl = ds.triangles.clusters, ts.triangles.clusters
    jt, tt = np.asarray(cl.table_t)[:, :20], ts.triangles.table.numpy()
    filled = jt[:, 19] > 0
    np.testing.assert_array_equal(tt[filled], jt[filled])
    assert not tt[~filled].any()
    aabb = np.asarray(cl.aabb)
    np.testing.assert_array_equal(tcl.aabb.numpy(), aabb)
    real = aabb[:, 0] < 1e38
    assert tcl.extent == np.abs(aabb[real, :6]).max() > 0
    # the hierarchy the walk reads: the boxes padded to whole groups of
    # 256, and every real box inside its super's and group's boxes
    hier = tcl.hierarchy
    assert hier.boxes.shape[0] == hier.groups.shape[0] * 256
    np.testing.assert_array_equal(hier.boxes[:aabb.shape[0]].numpy(), aabb)
    for parents, width in ((hier.supers, 16), (hier.groups, 256)):
        up = parents.numpy()[np.arange(hier.boxes.shape[0]) // width]
        box = hier.boxes.numpy()
        inside = ((up[:, 0:3] <= box[:, 0:3]) & (box[:, 3:6] <= up[:, 3:6]))
        assert inside.all(axis=1)[box[:, 0] < 1e37].all()


def test_envelope(monkeypatch):
    """The kernel's variants follow the TPU's whole-trace rule; a mesh
    outside it (here 100 triangles without clusters) raises for a device
    scene and never reaches the plain version.  Under "fused" the envelope
    takes tables of up to MEGA_PACKED_MAX_CLUSTERS single-packet clusters
    (config 6, and config 7 cut to 20,480 triangles), not config 7's
    11,008 clusters."""
    import types
    from simple_raytracer_tpu_torch.models.meshgen import icosphere
    from simple_raytracer_tpu_torch.models.presets import CONFIGS
    from simple_raytracer_tpu_torch.models.scene import Scene
    kwargs = {7: {"subdivisions": 5}}
    scenes = {n: CONFIGS[n](width=64, height=16,
                            **kwargs.get(n, {}))[0].build("cpu")
              for n in CONFIGS}
    variants = {n: whole_trace_variant(scenes[n]) for n in CONFIGS}
    # configs 6 and 7 (98,304 and 32,768 slots) take a per-bounce path
    assert variants == {1: "none", 2: "none", 3: "small", 4: "clustered",
                        5: "clustered", 6: None, 7: None}
    fused = {n: whole_trace_variant(scenes[n], "fused") for n in CONFIGS}
    assert fused == {**variants, 6: "clustered", 7: "clustered"}
    full7 = types.SimpleNamespace(triangles=types.SimpleNamespace(
        material=torch.zeros(2 ** 21), clusters=types.SimpleNamespace(
            slots=torch.zeros(11008, 128), k=128)))
    assert whole_trace_variant(full7, "fused") is None
    s = Scene()
    pos, nrm = icosphere(subdivisions=2)                 # 320 triangles
    s.add_model(s.pool.append(pos[:100], nrm[:100]))
    arrays = s.arrays()
    assert arrays["triangles.material"].shape == (128,)
    assert "clusters.slots" not in arrays
    meta = from_numpy(arrays, "meta")
    args = (meta, camera_rotation(0.0, 0.0), (0.0, 0.0, 5.0), 2.0, 1.0, 9)
    kw = dict(width=8, height=4, num_samples=1, num_bounces=2)
    calls, before = [], tk.KERNEL.launches
    with monkeypatch.context() as m:
        m.setattr(tk, "trace_full_plain", lambda *a, **k: calls.append(a))
        with pytest.raises(NotImplementedError, match="split per-bounce"):
            tk.trace_full(*args, **kw)
    assert not calls and tk.KERNEL.launches == before
    # the CPU renders it with the plain version
    cpu = from_numpy(arrays, "cpu")
    col = tk.trace_full(cpu, *args[1:], **kw)
    assert np.isfinite(to_np(col)).all()


def test_launch_struct_matches_cuda_source():
    """ctypes passes TraceParams by value: its fields must be the CUDA
    struct's, in order, with the same types and sizes; the launch takes
    as many pointers as the wrapper passes."""
    src = Path(tk.SOURCE).read_text()
    body = re.search(r"struct TraceParams \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(
        r"^\s*(float|int32_t|uint32_t|uint16_t) (\w+)(?:\[(\w+)\])?;",
        body, re.M)
    ctypes_of = {"float": "c_float", "int32_t": "c_int", "uint32_t": "c_uint",
                 "uint16_t": "c_ushort"}
    size_of = {"float": 4, "int32_t": 4, "uint32_t": 4, "uint16_t": 2}
    got = []
    for name, ct in tk.TraceParams._fields_:
        length = getattr(ct, "_length_", None)
        base = ct._type_ if length else ct
        got.append((base.__name__, name, str(length) if length else ""))
    want = [(ctypes_of[t], n, k) for t, n, k in fields]
    assert got == want
    n_bytes = sum(size_of[t] * int(k or 1) for t, _, k in fields)
    assert ctypes.sizeof(tk.TraceParams) == -(-n_bytes // 4) * 4
    sig = re.search(r"int srt_trace_launch\((.*?)\)", src, re.S).group(1)
    assert sig.count("*") == tk.LAUNCH_ARGTYPES.count(ctypes.c_void_p)
    assert tk.LAUNCH_ARGTYPES[-2] is tk.TraceParams
    # the kernel's table pointers, in the launch's order
    args = re.search(r"struct TraceArgs \{(.*?)\};", src, re.S).group(1)
    assert len(re.findall(r"\*\s*\w+;", args)) == tk.LAUNCH_POINTERS
    # the counting instance: the same pointers, then the counters
    sig = re.search(r"int srt_trace_count_launch\((.*?)\)", src,
                    re.S).group(1)
    assert sig.count("*") == tk.COUNT_ARGTYPES.count(ctypes.c_void_p)
    assert re.search(r"kCountLive = 0,", src)
    count = re.search(r"enum Count \{(.*?)kCounters", src, re.S).group(1)
    assert len(re.findall(r"kCount\w+", count)) == len(tk.COUNTERS)


def test_shared_memory_rule_at_the_boundary():
    """Tables above the default 48 KB of shared memory launch (the kernel
    opts in) up to the device's opt-in limit, and raise one 4-byte word
    above it.  A 1,025-sphere scene (2,048 slots of 32 B) is such a scene
    on an H100 (232,448 B per block); the clustered variant's rule counts
    the warp walk's rings and barriers beside the tables."""
    from simple_raytracer_tpu_torch.models.scene import Scene
    h100 = 232448
    tk.check_shared_bytes(h100, h100)
    with pytest.raises(ValueError, match="shared memory"):
        tk.check_shared_bytes(h100 + 4, h100)
    s = Scene()
    for i in range(1025):
        s.add_sphere((i * 0.1, 0.0, -5.0), 0.05)
    ts = s.build("cpu")
    words = sum(t.numel() for t in tk.prim_tables(ts))
    assert tk.DEFAULT_SHARED_BYTES < 4 * words <= h100
    tk.check_shared_bytes(4 * words, h100)
    assert (ctypes.sizeof(tk.TraceParams) + 8 * tk.LAUNCH_POINTERS
            <= tk.PARAM_LIMIT_BYTES)
    # the rings of the route's block: 4 warps x 2 x 128 slots x 48 B, and
    # a barrier a buffer; with the 1,025 spheres' tables still under the
    # limit
    assert tk.WALK_SHARED_BYTES == 4 * 2 * (128 * 48 + 8)
    assert 4 * words + tk.WALK_SHARED_BYTES <= h100
