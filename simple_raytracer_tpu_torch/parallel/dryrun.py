"""The multi-device dry run: one banded step of config 2 at a tiny size.

The counterpart of ``__graft_entry__.dryrun_multichip``:

    python -c "from simple_raytracer_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4, device='cpu')"
"""
from __future__ import annotations

import itertools

import torch

from ..models.presets import config2_four_spheres
from .mesh import make_mesh
from .shard import (make_sharded_canvas, make_sharded_render_step,
                    replicate_scene)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run one step of config 2 at 64 x (8 n), 1 spp, 2 bounces over ``n``
    bands and check the canvas's shape.  The bands run on ``device``
    (every band), else on the local cards in turn, repeated where there
    are fewer cards than bands."""
    if device is not None:
        mesh = make_mesh([device] * n_devices)
    else:
        mesh = list(itertools.islice(itertools.cycle(make_mesh()),
                                     n_devices))
    width, height = 64, 8 * n_devices
    scene, camera, _ = config2_four_spheres(width=width, height=height)
    step = make_sharded_render_step(width, height, 1, 2, mesh=mesh)
    bands = step(replicate_scene(scene, mesh), camera.state(width / height),
                 make_sharded_canvas(mesh, height, width), 1)
    canvas = torch.cat([b.cpu() for b in bands])
    if canvas.shape != (height, width, 3):
        raise RuntimeError(f"dry run over {n_devices} bands: canvas "
                           f"{tuple(canvas.shape)}")
