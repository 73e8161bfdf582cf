"""The plain tonemap of a progressive canvas: the mean over the passes,
the ACES filmic curve clamped to [0, 1], gamma 2.0, and 8 bits by
truncation, as the reference application's viewer maps its image."""
from __future__ import annotations

import numpy as np


def aces(x: np.ndarray) -> np.ndarray:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return np.clip((x * (x * a + b)) / (x * (x * c + d) + e), 0.0, 1.0)


def tonemap_u8(canvas: np.ndarray, passes: int):
    """(u8 levels as int64, finite mask) of a (P, 3) radiance sum over
    ``passes``; a pixel with a non-finite channel has no level."""
    mean = np.asarray(canvas, np.float64) / max(passes, 1)
    finite = np.isfinite(mean).all(-1)
    safe = np.where(finite[:, None], mean, 0.0)
    levels = np.floor(np.sqrt(aces(safe)) * 255.0).astype(np.int64)
    return np.clip(levels, 0, 255), finite
