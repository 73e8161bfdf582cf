"""The yardstick's constants: the card's published bandwidth, the bytes a
kernel must move, and which of the program's own kernels a device
operation belongs to, by its name."""
from __future__ import annotations

import re

# one NVIDIA H100 SXM's memory bandwidth, NVIDIA's data sheet, at its
# 700 W limit
HBM_BYTES_PER_S = 3.35e12

# the shade kernel reads a ray's 20 state rows and its nearest triangle's
# (t, slot) and writes the 20 rows: 168 bytes a state column
SHADE_BYTES_PER_COLUMN = (20 + 20 + 2) * 4
# the fused path pads its state to whole blocks of this many columns
STATE_BLOCK = 256

# the program's own CUDA kernels (csrc/*.cu), by their function names
FAMILIES = {
    "bvh": ("ray_partials", "rank_boxes", "bucket_rays", "scan_buckets",
            "scatter_rays", "morton_keys", "bvh_kernel"),
    "trace": ("trace_kernel",),
    "shade": ("bounce_kernel",),
    "triangle": ("compact_live", "triangle_kernel"),
}
# the one kernel that each counted launch of a family runs once (its
# other kernels run for some launches only: the compaction's, the Morton
# key's)
LAUNCHED = {"bvh": "bvh_kernel", "trace": "trace_kernel",
            "shade": "bounce_kernel", "triangle": "triangle_kernel"}
_WORD = {w: fam for fam, words in FAMILIES.items() for w in words}
_TOKEN = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def short_name(name: str) -> str:
    """A device operation's name without ``void``, its parameter list and
    an anonymous namespace, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut][:120]


def _word(name: str):
    base = short_name(name).split("<")[0]
    for token in reversed(_TOKEN.findall(base)):
        if token in _WORD:
            return token
    return None


def family(name: str):
    """The family of the program's kernels a device operation belongs to
    ("bvh", "trace", "shade", "triangle"), or None: PyTorch's kernels,
    copies and fills."""
    word = _word(name)
    return None if word is None else _WORD[word]


def is_launched(name: str, fam: str) -> bool:
    """Whether a device operation is the kernel that a counted launch of
    ``fam`` runs once (``LAUNCHED``)."""
    return _word(name) == LAUNCHED[fam]


def shade_columns(width: int, height: int, num_samples: int) -> int:
    """The state columns of a shade launch over one pass's rays."""
    n = width * height * num_samples
    return n + (-n) % STATE_BLOCK
