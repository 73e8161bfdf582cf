"""The port's texture skybox against simple_raytracer_tpu: the equirect
coordinates, the bilinear sample, ``sky_color`` in every form the JAX
package samples a texture in, the image files, and the scene's texture
cache.

XLA:CPU's atan2 is the C library's atan2f (glibc: fdlibm's float form);
PyTorch's differs from it in the last bit on about 16% of unit vectors,
which moves a tap weight of a noisy 2048-wide texture by about 1e-4, so
the port carries its own (``ops/vec.atan2``) and the coordinates (u, v)
are held to JAX's bit for bit.  The sample on the same (u, v) is held to
``sample_equirect_gather`` at 1e-6 relative (measured here: bit-equal,
both run eagerly in the same operation order).  ``sky_color`` is held to
the JAX ``sky_color`` with each of its texture forms (the gather sampler,
the two-hot matmul sampler for at most 32,768 texels, and the quad-packed
rgb8 and rgbe layouts) at 1e-5 times max(texture scale, 1), the bound of
tests/test_sky_quad.py: the matmul sampler mixes in y first, the quad
forms decode with XLA's pow and ldexp, and the sun's pow is XLA's
(measured here: 4.8e-7 at most).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.io import image as jimage
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.models.scene import Scene as JScene
from simple_raytracer_tpu.ops import sky as jsky
from simple_raytracer_tpu.ops.scene_types import SkyboxTex
from simple_raytracer_tpu_torch.io import image as timage
from simple_raytracer_tpu_torch.models.presets import CONFIGS as TCONFIGS
from simple_raytracer_tpu_torch.models.scene import Scene
from simple_raytracer_tpu_torch.ops import sky as tsky
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.ops.vec import atan2

from torch_port_helpers import (jax_scene_arrays, jax_skybox_image, jvec,
                                to_np, tvec, unit_vectors)

_INV_PI = np.float32(1.0 / 3.14159274101257324)


def _ldr(h, w, seed=0):
    """An 8-bit image linearized as stbi_loadf does: (u8 / 255)^2.2."""
    u8 = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return np.power(u8.astype(np.float32) / 255.0, np.float32(2.2),
                    dtype=np.float32)


def _hdr(h, w, seed=1):
    """Radiance values above 1, exactly representable in RGBE."""
    r = np.random.default_rng(seed)
    img = np.exp(r.normal(0.0, 1.5, (h, w, 3))).astype(np.float32)
    return jimage._rgbe_to_float(jimage.float_to_rgbe(img))


def _f32(h, w, seed=2):
    """Arbitrary floats, which no packing recovers."""
    return (np.random.default_rng(seed).random((h, w, 3)) * 3.0
            + 0.1).astype(np.float32)


def _directions(n, seed):
    """Unit directions: random, the texture's seam (z = 0, x < 0), the
    poles and the edges of u and v, and the sun."""
    r = np.random.default_rng(seed)
    d = unit_vectors(r, n)
    k = n // 8
    d[:k, 2] = r.choice([0.0, -0.0, 1e-7, -1e-7], k)     # the seam
    d[:k, 0] = -np.abs(d[:k, 0])
    d[k:2 * k, 0] = r.choice([0.0, -0.0], k)
    d[k:2 * k, 2] = r.choice([0.0, -0.0], k)             # the poles
    d[:2 * k] /= np.linalg.norm(d[:2 * k], axis=1, keepdims=True)
    d[2 * k:2 * k + 16] = [0.70710677, 0.70710677, 0.0]  # at the sun
    return d.astype(np.float32)


def test_atan2_is_xla_cpus():
    """Bit for bit over unit vectors, a wide range of magnitudes, the
    zeros, x == 1 and NaN (the port's atan2 takes finite inputs or NaN: a
    direction is never infinite).  XLA:CPU flushes subnormals, which the
    port does not, so the magnitudes keep y / x out of the subnormal range
    (there the two differ by less than 1.2e-38, nothing to an equirect
    u)."""
    r = np.random.default_rng(3)
    y = np.concatenate([
        unit_vectors(r, 1 << 16)[:, 2],
        r.normal(size=4096).astype(np.float32)
        * np.float32(10.0) ** r.integers(-15, 15, 4096).astype(np.float32),
        np.array([0.0, -0.0, 1.0, -1.0, 1e-30, -0.7, np.nan] * 7,
                 np.float32)])
    x = np.concatenate([
        unit_vectors(r, 1 << 16)[:, 0],
        r.normal(size=4096).astype(np.float32)
        * np.float32(10.0) ** r.integers(-15, 15, 4096).astype(np.float32),
        np.repeat(np.array([0.0, -0.0, 1.0, -1.0, 1e-30, -0.7, np.nan],
                           np.float32), 7)])
    want = np.asarray(jnp.arctan2(jnp.asarray(y), jnp.asarray(x)))
    got = atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # PyTorch's own differs, which is why the port carries this one
    assert (torch.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
            != want).any()


def test_uv_and_sample_match_gather():
    d = _directions(1 << 15, 4)
    want_u = np.asarray(jnp.arctan2(jnp.asarray(d[:, 2]), jnp.asarray(d[:, 0]))
                        * _INV_PI * 0.5 + 0.5)
    want_v = np.asarray(jnp.asarray(d[:, 1]) * 0.5 + 0.5)
    u, v = tsky.equirect_uv(tvec(d))
    np.testing.assert_array_equal(u.numpy(), want_u)
    np.testing.assert_array_equal(v.numpy(), want_v)
    assert want_u.min() <= 0.0 + 1e-6 and want_u.max() >= 1.0 - 1e-6
    img = _ldr(1024, 2048)
    jimg = jsky.Vec3(*(jnp.asarray(img[..., c]) for c in range(3)))
    # the same (u, v), edges and corners included
    r = np.random.default_rng(5)
    uu = np.concatenate([want_u, r.choice([0.0, 1.0, 1e-9, 1 - 1e-7], 512)])
    vv = np.concatenate([want_v, r.choice([0.0, 1.0, 1e-9, 1 - 1e-7], 512)])
    uu, vv = uu.astype(np.float32), vv.astype(np.float32)
    want = to_np(jsky.sample_equirect_gather(jimg, jnp.asarray(uu),
                                             jnp.asarray(vv)))
    got = to_np(tsky.sample_equirect(torch.from_numpy(img),
                                     torch.from_numpy(uu),
                                     torch.from_numpy(vv)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("form", ["gather", "matmul", "rgb8", "rgbe"])
def test_sky_color_matches_every_jax_form(form):
    img = {"gather": lambda: _f32(256, 256), "matmul": lambda: _f32(64, 128),
           "rgb8": lambda: _ldr(128, 256), "rgbe": lambda: _hdr(128, 256)
           }[form]()
    scene, _, _ = JCONFIGS[3](width=32, height=16, skybox=img)
    ds = scene.build()
    packed = isinstance(ds.skybox, SkyboxTex)
    assert packed == (form in ("rgb8", "rgbe"))
    if packed:
        assert ds.skybox.mode == form
    else:
        n = img.shape[0] * img.shape[1]
        assert (n <= jsky.MATMUL_TEXEL_LIMIT) == (form == "matmul")
    arrays = jax_scene_arrays(ds)
    np.testing.assert_array_equal(arrays["skybox"], img)
    ts = from_numpy(arrays, "cpu")
    d = _directions(1 << 14, 6)
    want = to_np(jsky.sky_color(jvec(d), ds.sky, ds.skybox))
    got = to_np(tsky.sky_color(tvec(d), ts.sky, ts.skybox))
    scale = max(float(np.abs(img).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    # the gradient sky when there is no texture
    np.testing.assert_array_equal(
        to_np(tsky.sky_color(tvec(d), ts.sky, None)),
        to_np(tsky.sky_gradient(tvec(d), ts.sky)))


def test_image_files_match_jax(tmp_path):
    hdr = np.exp(np.random.default_rng(7).normal(0.0, 2.0, (24, 40, 3))
                 ).astype(np.float32)
    hdr[0, :5] = 0.0
    np.testing.assert_array_equal(timage.float_to_rgbe(hdr),
                                  jimage.float_to_rgbe(hdr))
    for w in (40, 6):   # run-length scanlines, and flat RGBE below 8 wide
        img = np.ascontiguousarray(hdr[:, :w])
        timage.save_hdr(tmp_path / f"t{w}.hdr", img)
        jimage.save_hdr(tmp_path / f"j{w}.hdr", img)
        assert ((tmp_path / f"t{w}.hdr").read_bytes()
                == (tmp_path / f"j{w}.hdr").read_bytes())
        got = timage.load_hdr(tmp_path / f"t{w}.hdr")
        np.testing.assert_array_equal(got, jimage.load_hdr(tmp_path
                                                           / f"t{w}.hdr"))
        np.testing.assert_array_equal(
            got, jimage._rgbe_to_float(jimage.float_to_rgbe(img)))
        sky = timage.load_skybox(tmp_path / f"t{w}.hdr")
        np.testing.assert_array_equal(
            sky, jimage.load_skybox(tmp_path / f"t{w}.hdr"))
        np.testing.assert_array_equal(sky, got[::-1])
    u8 = np.random.default_rng(8).integers(0, 256, (9, 13, 3), np.uint8)
    timage.save_ppm(tmp_path / "a.ppm", u8)
    np.testing.assert_array_equal(timage.load_ppm(tmp_path / "a.ppm"), u8)
    np.testing.assert_array_equal(jimage.load_ppm(tmp_path / "a.ppm"), u8)
    # an 8-bit image through PIL, where it is installed
    pil = pytest.importorskip("PIL.Image")
    pil.fromarray(u8, "RGB").save(tmp_path / "a.png")
    np.testing.assert_array_equal(timage.load_skybox(tmp_path / "a.png"),
                                  jimage.load_skybox(tmp_path / "a.png"))


def test_png_without_pil_says_so(tmp_path, monkeypatch):
    """PIL is imported only for an 8-bit image, and its absence is a clear
    ImportError; an .hdr skybox loads without it."""
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real(name, *a, **k)

    timage.save_hdr(tmp_path / "s.hdr", np.ones((2, 8, 3), np.float32))
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="needs PIL"):
        timage.load_skybox(tmp_path / "s.png")
    assert timage.load_skybox(tmp_path / "s.hdr").shape == (2, 8, 3)


def test_scene_skybox_cache():
    """The texture is uploaded once per image object and device: the same
    object (even changed in place) gives the cached tensor, a new object
    a new upload, and clearing the skybox drops the cache; the JAX
    Scene's cache behaves the same."""
    img = _ldr(8, 16)
    s, j = Scene(), JScene()
    s.skybox = j.skybox = img
    a, b = s.build("cpu").skybox, s.build("cpu").skybox
    assert a is b and s._skybox_dev[0] is img
    np.testing.assert_array_equal(a.numpy(), img)
    img[0, 0] = 5.0                       # in place: the cache stands
    assert s.build("cpu").skybox is a
    ja = j.build().skybox
    assert j.build().skybox is ja
    s.skybox = j.skybox = img.copy()      # replaced: a new texture
    c = s.build("cpu").skybox
    assert c is not a and float(c[0, 0, 0]) == 5.0
    assert j.build().skybox is not ja
    s.skybox = j.skybox = None
    assert s.build("cpu").skybox is None and s._skybox_dev is None
    assert j.build().skybox is None and j._skybox_dev is None
    with pytest.raises(ValueError, match="skybox"):
        from_numpy({**s.arrays(), "skybox": np.zeros((4, 3))}, "cpu")


def test_config3_auto_loads_the_reference_texture(monkeypatch, tmp_path):
    """Config 3's "auto" loads SRT_REFERENCE_SKYBOX through the port's
    load_skybox, as the JAX package loads it, and renders with it."""
    img = _hdr(16, 32)
    timage.save_hdr(tmp_path / "sky.hdr", img)
    monkeypatch.setenv("SRT_REFERENCE_SKYBOX", str(tmp_path / "sky.hdr"))
    scene = TCONFIGS[3](width=32, height=16)[0]
    jscene = JCONFIGS[3](width=32, height=16)[0]
    np.testing.assert_array_equal(scene.skybox, img[::-1])
    np.testing.assert_array_equal(scene.skybox, jscene.skybox)
    ts = scene.build("cpu")
    assert ts.skybox.shape == (16, 32, 3)
    np.testing.assert_array_equal(
        ts.skybox.numpy(), jax_skybox_image(jscene.build().skybox))
