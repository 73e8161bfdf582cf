"""Multi-device rendering: data parallelism over horizontal pixel bands."""

from .mesh import band_rows, make_mesh
from .shard import (make_sharded_canvas, make_sharded_render_step,
                    replicate_scene)
