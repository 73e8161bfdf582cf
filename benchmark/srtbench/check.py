"""What decides ``correct``: the seeds of the passes, the pixels checked,
and the comparison of the program's canvas and image with the
reference's.

Every pass of a run is seeded by its own RNG ``time``, drawn from
``--seed``.  After the window, a sample of pixels drawn from the seed is
read from the program's canvas (the sum over every pass of the window)
and from the u8 image that its last ``image()`` returned, and the
reference traces the same pixels through the same passes.  Three numbers
are compared:

  gap        sqrt(N) * RMSE(program mean - reference mean) / mean |ref|,
             over the pixels finite on both sides (N passes).  A path that
             takes another turn on one side moves a pixel's mean by about
             its radiance / (S N), so the RMSE falls as 1 / sqrt(N) where
             the two sides differ only on rare paths, and sqrt(N) makes the
             number steady across window lengths; a bias stays and grows.
  nonfinite  pixels finite on one side only.  A NaN pixel comes from the
             RNG's ln(0) draw, at the same draw on both sides.
  image_levels  the widest gap, in 8-bit levels, between the program's
             image and the plain tonemap of the reference's mean
             (``reference/tonemap.py``), over the pixels finite in the
             reference: the image's mapping and its division by the pass
             count, which the canvas alone does not show.
"""
from __future__ import annotations

import math

import numpy as np

from reference.tonemap import tonemap_u8

MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def pass_time(seed: int, index: int, stream: int = 0) -> int:
    """The RNG ``time`` of pass ``index`` of a run seeded ``seed``: a value
    in [1, 2^32); stream 1 seeds the warm-up passes."""
    t = (_splitmix((seed * 2 + stream) & 0xFFFFFFFFFFFFFFFF)
         + index * _GOLDEN) & MASK
    return t or 1


def pass_times(seed: int, count: int) -> np.ndarray:
    return np.array([pass_time(seed, i) for i in range(count)], np.int64)


def pixel_count(traffic: dict, passes: int, num_samples: int,
                n_pixels: int) -> int:
    """How many pixels are checked: the mix's path budget over the paths
    a pixel takes in the run, within the mix's bounds."""
    c = traffic["check"]
    p = c["paths"] // max(1, passes * num_samples)
    return int(min(n_pixels, max(c["min_pixels"], min(c["max_pixels"], p))))


def sample_pixels(seed: int, n_pixels: int, count: int) -> np.ndarray:
    """``count`` distinct row-major pixel ids drawn from the seed."""
    s = seed & 0xFFFFFFFFFFFFFFFF
    rng = np.random.default_rng([s & MASK, s >> 32, 0x5EED])
    return rng.choice(n_pixels, size=count, replace=False).astype(np.int64)


def compare(program: np.ndarray, reference: np.ndarray, passes: int,
            image: np.ndarray) -> dict:
    """The numbers compared, from (P, 3) canvases summed over ``passes``
    and the program's (P, 3) u8 image at the same pixels."""
    pm = np.asarray(program, np.float64) / passes
    rm = np.asarray(reference, np.float64) / passes
    fp, fr = np.isfinite(pm).all(1), np.isfinite(rm).all(1)
    ok = fp & fr
    diff = (pm - rm)[ok]
    scale = float(np.abs(rm[ok]).mean()) if ok.any() else 0.0
    rmse = float(np.sqrt((diff * diff).mean())) if ok.any() else math.inf
    gap = math.sqrt(passes) * rmse / scale if scale > 0 else math.inf
    levels, finite = tonemap_u8(reference, passes)
    seen = np.asarray(image, np.int64)[finite]
    widest = int(np.abs(seen - levels[finite]).max()) if finite.any() else 0
    return {"gap": gap, "nonfinite": int((fp != fr).sum()),
            "image_levels": widest}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN never is)."""
    return all(numbers[k] <= limits[k]["limit"] for k in limits)
