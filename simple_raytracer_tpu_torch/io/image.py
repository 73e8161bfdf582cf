"""Image files: PPM and PNG output and the skybox loaders (Radiance .hdr,
and 8-bit images through PIL).

The counterpart of the pure-numpy parts of
``simple_raytracer_tpu.io.image``, copied so that the port imports
nothing of the JAX package.  PPM mirrors ``save_ppm`` (src/parser.cpp:
4-15): binary P6, RGB.  The skybox loader reproduces the reference's stb
usage (tracer.cpp:42-55): decode to float RGB, vertically flipped
(stbi_set_flip_vertically_on_load) so image row 0 is the BOTTOM of the
environment, matching the v = y*0.5+0.5 mapping in render.cl:391.  LDR
images are converted like stbi_loadf: (x/255)^2.2 per channel.  Only they
and ``save_png`` need PIL, which each imports when called.
"""
from __future__ import annotations

import os

import numpy as np


def save_ppm(path: os.PathLike, image: np.ndarray) -> None:
    """Write an (H, W, 3) u8 RGB image as binary P6."""
    image = np.asarray(image, np.uint8)
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6 {w} {h} 255\n".encode())
        f.write(image[..., :3].tobytes())


def load_ppm(path: os.PathLike) -> np.ndarray:
    """Read a binary P6 PPM back to (H, W, 3) u8.

    The header is parsed positionally — "P6", width, height, maxval, then
    EXACTLY ONE whitespace byte before the pixel data (the P6 contract).
    Splitting the whole file on whitespace would swallow leading pixel
    bytes that happen to be ASCII whitespace (0x09/0x0A/0x20...)."""
    import re

    with open(path, "rb") as f:
        data = f.read()
    m = re.match(rb"P6\s+(\d+)\s+(\d+)\s+(\d+)\s", data)
    if m is None:
        raise ValueError(f"{path}: not a binary P6 PPM")
    w, h, maxval = int(m.group(1)), int(m.group(2)), int(m.group(3))
    if maxval != 255:
        raise ValueError(f"{path}: unsupported maxval {maxval}")
    pixels = data[m.end():m.end() + w * h * 3]
    if len(pixels) < w * h * 3:
        raise ValueError(f"{path}: truncated pixel data")
    return np.frombuffer(pixels, np.uint8).reshape(h, w, 3).copy()


def save_png(path: os.PathLike, image: np.ndarray) -> None:
    """Write an (H, W, 3) u8 RGB image as PNG (PIL)."""
    from PIL import Image

    Image.fromarray(np.asarray(image, np.uint8), "RGB").save(path)


def load_skybox(path: os.PathLike, gamma: float = 2.2) -> np.ndarray:
    """Decode an environment image to (H, W, 3) f32, bottom-up.

    Matches stbi_loadf semantics: Radiance .hdr files decode to linear
    radiance natively (stb__hdr_convert), LDR sources linearize with the
    given gamma; the vertical flip matches tracer.cpp:44."""
    if str(path).lower().endswith(".hdr"):
        arr = load_hdr(path)
    else:
        try:
            from PIL import Image
        except ImportError as exc:
            raise ImportError(
                f"{path}: decoding an 8-bit image needs PIL (Pillow), which "
                "is not installed; a Radiance .hdr skybox needs nothing"
            ) from exc

        img = Image.open(path).convert("RGB")
        arr = np.asarray(img, np.float32) / 255.0
        arr = np.power(arr, np.float32(gamma))
    return arr[::-1].copy()  # flip vertically: row 0 = bottom


def float_to_rgbe(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) f32 linear -> (H, W, 4) u8 RGBE, the canonical Radiance
    shared-exponent encoding (exponent from the max channel's frexp)."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    m, e = np.frexp(maxc)                       # maxc = m * 2^e, m in [0.5,1)
    scale = m * 256.0 / np.where(maxc > 0, maxc, 1.0)
    valid = maxc >= 1e-32
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.where(valid[..., None],
                             np.clip(img * scale[..., None] + 0.5, 0, 255), 0)
    rgbe[..., 3] = np.where(valid, e + 128, 0)
    return rgbe


def save_hdr(path: os.PathLike, image: np.ndarray) -> None:
    """Write (H, W, 3) f32 linear radiance as a Radiance .hdr — the inverse
    of load_hdr.  Uses new-style scanlines (literal-only chunks) when the
    width allows so decoding is unambiguous, flat RGBE otherwise."""
    rgbe = float_to_rgbe(image)
    h, w = rgbe.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if not 8 <= w < 32768:
            f.write(rgbe.tobytes())
            return
        for y in range(h):
            f.write(bytes([2, 2, w >> 8, w & 0xFF]))
            for c in range(4):
                col = rgbe[y, :, c].tobytes()
                for x in range(0, w, 128):
                    chunk = col[x:x + 128]
                    f.write(bytes([len(chunk)]) + chunk)


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) u8 RGBE -> (..., 3) f32, stbi_loadf semantics:
    f = ldexp(1, E - (128 + 8)); rgb = mantissa * f; E == 0 -> black."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.ldexp(np.float32(1.0), e - (128 + 8)).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[e == 0] = 0.0
    return out


def load_hdr(path: os.PathLike) -> np.ndarray:
    """Decode a Radiance RGBE (.hdr) file to (H, W, 3) f32 linear radiance,
    top-down (caller flips).  Supports the common subset stb_image does:
    '-Y H +X W' orientation, new-style per-component RLE scanlines, and
    flat (unencoded) RGBE streams with old-style (1,1,1,count) runs."""
    with open(path, "rb") as f:
        data = f.read()

    # -- header: text lines until a blank line, then the resolution line
    pos = 0
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    fmt_ok = False
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"FORMAT="):
            fmt_ok = line[7:].strip() in (b"32-bit_rle_rgbe", b"32-bit_rle_xyze")
        if line == b"":
            break
    if not fmt_ok:
        raise ValueError(f"{path}: missing FORMAT=32-bit_rle_rgbe header")
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {b' '.join(res)!r}")
    h, w = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.empty((h, w, 4), np.uint8)

    # new-style RLE applies when 8 <= w < 32768 and the scanline starts
    # with the 2,2,hi,lo magic (stb checks per image, we check per file)
    new_rle = (8 <= w < 32768 and len(buf) >= 4 and buf[0] == 2
               and buf[1] == 2 and (int(buf[2]) << 8 | int(buf[3])) == w)
    if not new_rle:
        # flat RGBE stream: when it contains no old-style run marker
        # (r=g=b=1 is ALWAYS a marker in old-style decode, stb treats it
        # unconditionally as a repeat), the image is a straight
        # h*w*4-byte block — decode it in one reshape instead of the
        # per-pixel expansion loop (minutes vs milliseconds on panoramas)
        if len(buf) >= h * w * 4:
            cand = buf[:h * w * 4].reshape(h * w, 4)
            if not ((cand[:, 0] == 1) & (cand[:, 1] == 1)
                    & (cand[:, 2] == 1)).any():
                return _rgbe_to_float(cand.reshape(h, w, 4))
        # expand old-style runs (r=g=b=1: repeat previous pixel
        # count<<(8*shift) times)
        flat = []
        i = 0
        n_px = 0
        shift = 0
        while n_px < h * w:
            if i + 4 > len(buf):
                raise ValueError(f"{path}: truncated pixel data")
            px = buf[i:i + 4]
            if px[0] == 1 and px[1] == 1 and px[2] == 1:
                if not flat:
                    raise ValueError(f"{path}: run with no previous pixel")
                count = int(px[3]) << (8 * shift)
                flat.append(np.tile(flat[-1][-1:], (count, 1)))
                n_px += count
                shift += 1
            else:
                flat.append(px.reshape(1, 4))
                n_px += 1
                shift = 0
            i += 4
        rgbe = np.concatenate(flat)[:h * w].reshape(h, w, 4)
        return _rgbe_to_float(rgbe)

    i = 0
    for y in range(h):
        if i + 4 > len(buf):
            raise ValueError(f"{path}: truncated pixel data at row {y}")
        if buf[i] != 2 or buf[i + 1] != 2:
            raise ValueError(f"{path}: bad scanline magic at row {y}")
        if (int(buf[i + 2]) << 8 | int(buf[i + 3])) != w:
            raise ValueError(f"{path}: scanline width mismatch at row {y}")
        i += 4
        for c in range(4):
            x = 0
            while x < w:
                if i >= len(buf):
                    raise ValueError(
                        f"{path}: truncated pixel data at row {y}")
                count = int(buf[i])
                if count == 0:
                    # a zero count never advances x: corrupt stream
                    raise ValueError(f"{path}: bad RLE count 0 at row {y}")
                if count > 128:          # run: repeat one byte
                    if i + 2 > len(buf) or x + count - 128 > w:
                        raise ValueError(
                            f"{path}: truncated pixel data at row {y}")
                    rgbe[y, x:x + count - 128, c] = buf[i + 1]
                    x += count - 128
                    i += 2
                else:                    # literal: copy `count` bytes
                    if i + 1 + count > len(buf) or x + count > w:
                        raise ValueError(
                            f"{path}: truncated pixel data at row {y}")
                    rgbe[y, x:x + count, c] = buf[i + 1:i + 1 + count]
                    x += count
                    i += 1 + count
    return _rgbe_to_float(rgbe)
