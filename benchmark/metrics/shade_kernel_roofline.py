"""The shade kernel's share of its roofline, in %: the least time its
launches could take, each launch's state columns (one pass's rays padded
to whole blocks, from the frame's shapes) times 168 bytes over the card's
3.35 TB/s, over the time they took."""
from srtbench.kernels import (HBM_BYTES_PER_S, SHADE_BYTES_PER_COLUMN,
                              shade_columns)


def read(run):
    ops = [o for o in run.profile.ops if o.family == "shade"]
    if not ops:
        return None
    cols = shade_columns(run.width, run.height, run.num_samples)
    least_s = len(ops) * cols * SHADE_BYTES_PER_COLUMN / HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(o.dur_us for o in ops) / 1e6)
