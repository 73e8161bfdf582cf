"""The devices of a render spread over horizontal pixel bands.

The counterpart of ``simple_raytracer_tpu.parallel.mesh``: where the JAX
package lays a 1-D ``jax.sharding.Mesh`` over its devices, the port keeps
the ordered list of ``torch.device``s that the bands run on.  Band ``i``
of ``n`` holds rows ``[i * H / n, (i + 1) * H / n)``.  A device may appear
more than once, so one card can hold several bands (the CPU tests use
``["cpu"] * n`` in place of JAX's virtual CPU devices).  Rendering is
communication-free: every pixel's RNG stream depends on its global pixel
id only, so the bands together give the single-device image.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def resolve_device(device=None) -> torch.device:
    """None means the card; without CUDA that raises (no silent CPU).  A
    bare "cuda" names the current card, as a tensor built there reports
    it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' to "
                               "render with the plain PyTorch version")
        device = "cuda"
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None \
            and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices() -> List[torch.device]:
    """The cards this process renders on: every local CUDA device, or in
    a multi-process render this process's own card
    (``distributed.process_device``).  Raises without CUDA."""
    from . import distributed
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: name the band devices, "
                           "e.g. ['cpu'] * n")
    if distributed.is_multiprocess():
        return [distributed.process_device()]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None,
              n: Optional[int] = None) -> List[torch.device]:
    """The ordered band devices: ``devices`` (default ``local_devices()``),
    optionally truncated to ``n``.  Entries may repeat."""
    if devices is None:
        devices = local_devices()
    mesh = [resolve_device(d) for d in devices]
    if n is not None:
        mesh = mesh[:n]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def band_rows(height: int, num_bands: int) -> List[Tuple[int, int]]:
    """``(row0, rows)`` of each of ``num_bands`` equal horizontal bands of
    the image, in order.  The height must divide by the band count."""
    if num_bands < 1 or height % num_bands:
        raise ValueError(f"height {height} not divisible by the {num_bands} "
                         "bands")
    rows = height // num_bands
    return [(i * rows, rows) for i in range(num_bands)]
