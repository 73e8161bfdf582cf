"""The banded render step: data parallelism over horizontal pixel bands.

The counterpart of ``simple_raytracer_tpu.parallel.shard``.  Each band
traces the rays of its own rows through the port's ``render_pass`` with
``row0`` at the band's first global row, on its own device and canvas;
the scene is replicated, one device scene per distinct device.  Pixel ids
and RNG streams are global, so the bands give the single-device canvas
bit for bit.  The bands are launched in order from the calling thread:
a pass queues its work without waiting for the device (``chip_smoke.py``
phase 9 counts a banded step's host synchronisations), so bands on
distinct cards can run at once; the host's own work a band is not
overlapped, which is what several processes (``distributed.py``) add.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops.trace import render_pass
from .mesh import band_rows, make_mesh


def replicate_scene(scene, mesh: Sequence[torch.device],
                    refit: bool = False) -> Dict[torch.device, object]:
    """One device scene per distinct device of ``mesh``, built from one
    flattening of the host ``scene`` (``Scene.build_replicas``)."""
    devices = list(dict.fromkeys(mesh))
    return dict(zip(devices, scene.build_replicas(devices, refit)))


def make_sharded_render_step(width: int, height: int, num_samples: int,
                             num_bounces: int, mesh=None,
                             aov: Optional[str] = None,
                             tri_backend: str = "auto", ray_tile=None,
                             canvas_tiled: bool = False, first_band: int = 0,
                             num_bands: Optional[int] = None) -> Callable:
    """The banded progressive step ``(scenes, camera_state, band_canvases,
    time) -> band_canvases``: ``scenes`` maps each device of ``mesh``
    (default ``make_mesh()``) to its device scene, and band ``i`` of the
    mesh, a ``(H / num_bands, W, 3)`` canvas on ``mesh[i]``, is the image's
    band ``first_band + i`` of ``num_bands`` (default: the mesh's length;
    more where other processes hold the other bands).

    ``ray_tile`` orders each band's rays in screen tiles and must divide
    the band, not the whole image; ``canvas_tiled`` keeps each band's
    canvas in that order.  The height must divide by ``num_bands``."""
    mesh = make_mesh() if mesh is None else list(mesh)
    if num_bands is None:
        num_bands = len(mesh)
    bands = band_rows(height, num_bands)[first_band:first_band + len(mesh)]
    if first_band < 0 or len(bands) != len(mesh):
        raise ValueError(f"bands {first_band}..{first_band + len(mesh) - 1} "
                         f"outside the image's 0..{num_bands - 1}")
    tile_h = height // num_bands
    if ray_tile is not None and (tile_h % ray_tile[0] or
                                 width % ray_tile[1]):
        raise ValueError(f"ray tile {ray_tile} must divide the per-device "
                         f"band {tile_h}x{width}")

    def step(scenes, camera_state, band_canvases: List[torch.Tensor],
             time) -> List[torch.Tensor]:
        if len(band_canvases) != len(mesh):
            raise ValueError(f"{len(band_canvases)} canvases for "
                             f"{len(mesh)} bands")
        return [render_pass(scenes[dev], camera_state, canvas, time,
                            width=width, height=height,
                            num_samples=num_samples, num_bounces=num_bounces,
                            ray_tile=ray_tile, row0=row0, tile_height=rows,
                            canvas_tiled=canvas_tiled,
                            tri_backend=tri_backend, aov=aov)
                for dev, canvas, (row0, rows)
                in zip(mesh, band_canvases, bands)]

    return step


def make_sharded_canvas(mesh: Sequence[torch.device], height: int, width: int,
                        num_bands: Optional[int] = None
                        ) -> List[torch.Tensor]:
    """Zero band canvases, ``(H / num_bands, W, 3)`` f32 on each device of
    ``mesh`` in turn (``num_bands`` as in ``make_sharded_render_step``)."""
    _, rows = band_rows(height, num_bands or len(mesh))[0]
    return [torch.zeros((rows, width, 3), dtype=torch.float32, device=d)
            for d in mesh]
