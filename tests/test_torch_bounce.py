"""The fused per-bounce path (ops/bounce.py, ops/cuda/bounce_kernel.py,
ops/trace.trace_rays_fused) against simple_raytracer_tpu's
ops/pallas/bounce_kernel.py and ops/trace.trace_rays_fused.

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there).  Here the plain version ``bounce_step_plain`` is
held to the TPU's ``_bounce_kernel`` (``bounce_step``) in Pallas interpret
mode at block_r=128 and 512, as tests/test_fused_kernel.py runs it, one
bounce at a time from the same state and the same BVH winners: the seed
and alive rows exact, the others within 1e-5 (interpret mode runs under
jit, where XLA:CPU contracts multiply-adds).  The whole fused trace is
held to the JAX ``trace_rays_fused`` within test_fused_kernel.py's
``_assert_close`` bounds (RMSE < 5e-3, > 99% of pixels within 1e-3), on
config 5 and on config 7 built with subdivisions=4.  The JAX scenes are
built with the JAX package's NumPy BVH builder, the one the port has.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops import trace as jtrace
from simple_raytracer_tpu.ops.camera import camera_rotation as jrotation
from simple_raytracer_tpu.ops.camera import generate_rays as jgenerate
from simple_raytracer_tpu.ops.pallas import bounce_kernel as jbk
from simple_raytracer_tpu_torch.ops import bounce, bvh
from simple_raytracer_tpu_torch.ops.cuda import bounce_kernel as sk
from simple_raytracer_tpu_torch.ops.intersect import _spheres_planes
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.ops.trace import trace_rays, trace_rays_fused
from simple_raytracer_tpu_torch.ops.vec import Vec3

from torch_port_helpers import (jax_native_accel, jax_scene_arrays, jvec,
                                seeds, to_np, tvec)

# config 7 at a test's size: 5,120 triangles
SCENES = {5: {}, 7: {"subdivisions": 4}}
W, H, BOUNCES = 96, 54, 3        # tests/test_fused_kernel.py's pass


@pytest.fixture
def jax_native():
    """The JAX package on its default BVH builder, its native library (the
    port's host library builds the same tree)."""
    jax_native_accel()


def _scenes(n):
    scene, camera, _ = JCONFIGS[n](width=W, height=H, **SCENES[n])
    ds = scene.build()
    return ds, from_numpy(jax_scene_arrays(ds), "cpu"), camera


def _primary(camera, spp=1, time=5):
    """The JAX camera rays of a W x H pass, as numpy arrays."""
    cam = camera.state(W / H)
    o, d, seed = jgenerate(W, H, spp, jnp.uint32(time), cam.position,
                           jrotation(cam.yaw, cam.pitch), cam.aspect_ratio,
                           cam.fov_scale)
    return to_np(o), to_np(d), np.asarray(seed)


def _assert_close(a, b):
    """tests/test_fused_kernel.py's bounds."""
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    agree = float(np.mean(np.all(np.abs(a - b) < 1e-3, axis=-1)))
    assert rmse < 5e-3, f"rmse {rmse}"
    assert agree > 0.99, f"only {agree:.3f} of pixels agree"


def _tseed(s: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(s.astype(np.int64))


@pytest.mark.parametrize("n", [5, 7])
def test_trace_rays_fused_matches_jax(n, jax_native):
    """The port's fused path (the BVH plain version and bounce_step_plain)
    against the JAX trace_rays_fused (_bounce_kernel in interpret mode,
    block_r=512): per-ray radiance within the fused tests' bounds."""
    ds, ts, camera = _scenes(n)
    assert ts.triangles.clusters is not None
    o, d, s = _primary(camera)
    want = jtrace.trace_rays_fused(ds, jvec(o), jvec(d), jnp.asarray(s),
                                   BOUNCES, block_r=512, interpret=True)
    got = trace_rays_fused(ts, tvec(o), tvec(d), _tseed(s), BOUNCES)
    a, b = to_np(want), to_np(got)
    assert np.isfinite(b).all() and b.std() > 0
    _assert_close(a, b)


def _jax_tri_rows(ts, t, slot):
    """The TPU bounce kernel's (20, Rp) tri_rows from the BVH winners:
    [t, the winner's 19 attributes]."""
    rows = ts.triangles.table[slot.clamp_min(0).long(), :19]
    rows = torch.where((slot >= 0)[:, None], rows, 0.0)
    return jnp.asarray(torch.cat([t[None], rows.T]).numpy())


@pytest.mark.parametrize("block_r", [128, 512])
@pytest.mark.parametrize("n", [5, 7])
def test_bounce_step_matches_jax_bounce_kernel(n, block_r, jax_native):
    """One bounce at a time from the same state and winners:
    bounce_step_plain against _bounce_kernel in interpret mode.  The seed
    row (as uint32 bits) and the alive row are equal; every other row is
    within 1e-5; the last bounce kills every ray."""
    ds, ts, camera = _scenes(n)
    o, d, s = _primary(camera)
    state = bounce.make_state(tvec(o), tvec(d), _tseed(s), block_r)
    jtabs = jbk.prim_tables(ds)
    cl = ts.triangles.clusters
    for i in range(BOUNCES):
        last = i == BOUNCES - 1
        ro = Vec3(state[0], state[1], state[2])
        rd = Vec3(state[3], state[4], state[5])
        t_s, _, t_p, _ = _spheres_planes(ts, ro, rd)
        t, slot = bvh.intersect_triangles_bvh_plain(
            ro, rd, state[7], torch.minimum(t_s, t_p), cl,
            ts.triangles.table)
        got = bounce.bounce_step_plain(state, last, ts, (t, slot))
        want = np.asarray(jbk.bounce_step(
            jnp.asarray(state.numpy()), jnp.int32(last), *jtabs,
            tri_rows=_jax_tri_rows(ts, t, slot), block_r=block_r,
            interpret=True))
        g = got.numpy()
        np.testing.assert_array_equal(g[6].view(np.uint32),
                                      want[6].view(np.uint32))
        np.testing.assert_array_equal(g[7], want[7])
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-5)
        live = state[7] > 0
        assert int(live.sum()) > 100 or i > 0
        state = got
    assert not (state[7] > 0).any()


def test_state_matches_jax_and_keeps_every_seed_pattern():
    """make_state and unpack_state are bit-equal to the JAX functions,
    seeds at and above 2^31 and NaN bit patterns included, the padding
    rays dead; a dead ray's 20 rows pass a bounce as they were, bit for
    bit."""
    r = np.random.default_rng(4)
    n = 300
    o = r.normal(size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    s = seeds(r, n)
    s[:4] = [0x7FC00001, 0xFFFFFFFF, 0x7F800001, 0x80000000]
    for block_r in (128, 256):
        want = np.asarray(jbk.make_state(jvec(o), jvec(d), jnp.asarray(s),
                                         block_r))
        got = bounce.make_state(tvec(o), tvec(d), _tseed(s), block_r)
        assert got.shape == want.shape == (20, -(-n // block_r) * block_r)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
        for a, b in zip(bounce.unpack_state(got, n),
                        jbk.unpack_state(jnp.asarray(want), n)):
            np.testing.assert_array_equal(to_np(a), to_np(b))
    np.testing.assert_array_equal(bounce.seed_of(got[6])[:n].numpy(), s)
    # every ray dead: the next state is the same bits
    ds = JCONFIGS[2](width=32, height=16)[0].build()
    ts = from_numpy(jax_scene_arrays(ds), "cpu")
    dead = got.clone()
    dead[7] = 0.0
    out = bounce.bounce_step_plain(dead, False, ts)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  dead.numpy().view(np.uint32))


@pytest.mark.parametrize("backend", ["auto", "clustered"])
@pytest.mark.parametrize("n", [5, 7])
def test_fused_path_equals_split_path(n, backend):
    """On the CPU the fused path (bounce_step_plain over the state) and
    the split trace_rays make the same float operations: bit-identical
    radiance, with the split path's BVH kernel in either variant."""
    from simple_raytracer_tpu_torch.models.presets import CONFIGS
    from simple_raytracer_tpu_torch.ops.camera import (camera_rotation,
                                                       generate_rays)
    scene, camera, opt = CONFIGS[n](width=48, height=32, **SCENES[n])
    ts = scene.build("cpu")
    cam = camera.state(48 / 32)
    o, d, s = generate_rays(48, 32, 2, 11, cam.position,
                            camera_rotation(cam.yaw, cam.pitch),
                            cam.aspect_ratio, cam.fov_scale)
    a = trace_rays(ts, o, d, s, opt.num_bounces, split=True,
                   tri_backend=backend)
    b = trace_rays_fused(ts, o, d, s, opt.num_bounces)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(torch.stack(list(a)).std()) > 0


def test_cuda_bounce_step_has_no_plain_fallback(monkeypatch):
    """A state on a device other than the CPU goes to the kernel's prepare,
    which raises off the card; the plain version is never called, and
    nothing is counted."""
    ds = JCONFIGS[5](width=32, height=16)[0].build()
    meta = from_numpy(jax_scene_arrays(ds), "meta")
    calls = []
    monkeypatch.setattr(bounce, "bounce_step_plain",
                        lambda *a, **k: calls.append(a))
    state = torch.zeros((20, 256), device="meta")
    tri = (torch.zeros(256, device="meta"),
           torch.zeros(256, dtype=torch.int32, device="meta"))
    before = sk.KERNEL.launches
    with pytest.raises(ValueError, match="bounce kernel: unsupported device"):
        bounce.bounce_step(state, False, meta, tri)
    assert not calls and sk.KERNEL.launches == before


def test_launch_struct_matches_cuda_source():
    """ctypes passes BounceParams by value: its fields must be the CUDA
    struct's, in order; the launch takes as many pointers as the wrapper
    passes, and the state has the rows the kernel reads."""
    src = Path(sk.SOURCE).read_text()
    body = re.search(r"struct BounceParams \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*int32_t (\w+);", body, re.M)
    assert [n for n, _ in sk.BounceParams._fields_] == fields
    assert all(t is ctypes.c_int32 for _, t in sk.BounceParams._fields_)
    sig = re.search(r"int srt_bounce_launch\((.*?)\)", src, re.S).group(1)
    assert sig.count("*") == sk.LAUNCH_ARGTYPES.count(ctypes.c_void_p)
    assert sk.LAUNCH_ARGTYPES[-2] is sk.BounceParams
    assert re.search(rf"kStRows = {sk.ST_ROWS};", src)
    assert sk.ST_ROWS == bounce.ST_ROWS == jbk.ST_ROWS
