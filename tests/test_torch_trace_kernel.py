"""The whole-trace kernel module (ops/cuda/trace_kernel.py) on the CPU.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it
against its plain version there).  Here: the wrapper's dispatch (the
plain version for a CPU scene, an error for any other non-CUDA device,
no launch counted), the launch ABI against the CUDA source, the kernel's
tables against the TPU kernel's, and the plain version against the TPU
kernel ``_trace_kernel`` itself, run in Pallas interpret mode at 64x16
with 1 sample.  Interpret mode runs under jit, where XLA:CPU fuses
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

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops.camera import camera_rotation as jrotation
from simple_raytracer_tpu.ops.pallas import bounce_kernel
from simple_raytracer_tpu_torch.ops.camera import camera_rotation
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel as tk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import jax_scene_arrays, to_np


def _scene(n, w=64, h=16):
    scene, camera, opt = JCONFIGS[n](width=w, height=h)
    ds = scene.build()
    return ds, from_numpy(jax_scene_arrays(ds), "cpu"), camera, opt


@pytest.mark.parametrize("n", [1, 2])
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
    assert all(hit <= l for l, hit in segments)
    meta = from_numpy(scene.arrays(), "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.trace_full(meta, *args[1:], **kw)


def test_tables_match_tpu_kernel_tables():
    ds, ts, _, _ = _scene(2)
    for jt, tt in zip(bounce_kernel.prim_tables(ds), tk.prim_tables(ts)):
        jt, tt = np.asarray(jt), tt.numpy()
        np.testing.assert_array_equal(jt[:tt.shape[0]], tt)
        assert not jt[tt.shape[0]:].any()   # the TPU table's row padding


def test_launch_struct_matches_cuda_source():
    """ctypes passes TraceParams by value: its fields must be the CUDA
    struct's, in order, with the same types and sizes."""
    src = Path(tk.SOURCE).read_text()
    body = re.search(r"struct TraceParams \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(float|int32_t|uint32_t) (\w+)(?:\[(\d+)\])?;",
                        body, re.M)
    ctypes_of = {"float": "c_float", "int32_t": "c_int", "uint32_t": "c_uint"}
    got = []
    for name, ct in tk.TraceParams._fields_:
        length = getattr(ct, "_length_", None)
        base = ct._type_ if length else ct
        got.append((base.__name__, name, str(length) if length else ""))
    want = [(ctypes_of[t], n, k) for t, n, k in fields]
    assert got == want
    n_words = sum(int(k or 1) for _, _, k in fields)
    assert ctypes.sizeof(tk.TraceParams) == 4 * n_words
