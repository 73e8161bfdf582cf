"""The render engine: progressive accumulation on a torch device.

The counterpart of ``simple_raytracer_tpu.engine``: a ``Renderer`` owns
the device scene and the ``(canvas, num_steps)`` accumulation state.  Every
``step`` traces one more sample pass into the canvas; the image is the
tonemapped mean of all passes since the last ``clear_canvas``.  The
canvas is kept in ray-tile pixel order and untiled only when read.
``state_dict``/``load_state_dict`` checkpoint the accumulation state in
the JAX package's form (a row-major f32 canvas and the step count).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .models.camera import Camera
from .models.scene import Scene
from .ops.camera import tile_image, untile_image
from .ops.scene_types import DeviceScene
from .ops.tonemap import tonemap_u8
from .ops.trace import check_aov, check_tri_backend, render_pass


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Static render configuration.  Defaults mirror the reference
    application: 960x540, 2 samples, 10 bounces."""
    width: int = 960
    height: int = 540
    num_samples: int = 2
    num_bounces: int = 10
    # the reference's normals view: the same as aov="normals"
    show_normals: bool = False
    # a first-hit AOV instead of the path-traced image: None, "normals"
    # (n * 0.5 + 0.5), "depth" (1 / (1 + t) in grey, a miss 0) or "albedo"
    # (the material's colour); one segment, accumulated and tonemapped
    # as the image is
    aov: object = None
    # the JAX option's VMEM chunk, accepted so that the same options build
    # in either package; the port's loops size their own chunks
    tri_chunk: int = 256
    # screen-tile ray order (th, tw); None = row-major; "auto" tiles 8x64
    # when the image divides evenly.  A permutation: results are the same.
    ray_tile: object = "auto"
    # "auto": the whole-trace kernel for the scenes it serves, the split
    # per-bounce path for the others; "bvh": the split path for every
    # scene; "clustered": the split path with the BVH kernel's streamed
    # variant; "fused": the whole-trace kernel up to config 6's table,
    # the fused per-bounce path (the per-bounce shade kernel) beyond;
    # "pallas": the split path with the brute-force triangle kernel for
    # every mesh; "jnp": the split path with the dense PyTorch loop.
    tri_backend: str = "auto"

    def __post_init__(self):
        check_tri_backend(self.tri_backend)
        check_aov(self.aov)

    @property
    def aov_mode(self) -> Optional[str]:
        """The AOV traced: ``aov``, else "normals" under ``show_normals``,
        else None (the path-traced image)."""
        return self.aov or ("normals" if self.show_normals else None)


def _resolve_ray_tile(ray_tile, rows: int, width: int):
    """'auto' -> (8, 64) when rows and width divide evenly, else None."""
    if ray_tile == "auto":
        return (8, 64) if rows % 8 == 0 and width % 64 == 0 else None
    return ray_tile


def _resolve_device(device=None) -> torch.device:
    """None means the card; without CUDA that raises (no silent CPU)."""
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
        # "cuda" names the current card, as a tensor built there reports it
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Renderer:
    """Progressive path tracer with its state on one torch device."""

    def __init__(self, options: RenderOptions = RenderOptions(),
                 scene: Optional[Scene] = None, device=None):
        self.options = options
        self.device = _resolve_device(device)
        self._tile = _resolve_ray_tile(options.ray_tile, options.height,
                                       options.width)
        self._device_scene = None
        self._canvas = None
        self.num_steps = 0
        self._time_base = 1   # deterministic unless the caller passes time
        if scene is not None:
            self.update_scene(scene)
        self.clear_canvas()

    # -- scene / state ----------------------------------------------------
    def update_scene(self, scene: Scene, refit: bool = False) -> None:
        """Build the whole scene onto the device again.  ``refit=True``
        keeps the scene's cached cluster topology and recomputes only the
        cluster boxes, for an edit that moves models (``Scene.build``)."""
        self._device_scene = scene.build(self.device, refit=refit)

    def set_device_scene(self, device_scene: DeviceScene) -> None:
        if device_scene.device != self.device:
            raise ValueError(f"scene on {device_scene.device}, renderer on "
                             f"{self.device}")
        self._device_scene = device_scene

    @property
    def device_scene(self) -> Optional[DeviceScene]:
        return self._device_scene

    @property
    def ray_tile(self):
        """The resolved ray-tile order, (th, tw) or None."""
        return self._tile

    def clear_canvas(self) -> None:
        o = self.options
        self._canvas = torch.zeros((o.height, o.width, 3), dtype=torch.float32,
                                   device=self.device)
        self.num_steps = 0

    @property
    def canvas(self) -> torch.Tensor:
        """Row-major (H, W, 3) radiance sum."""
        if self._tile is not None:
            return untile_image(self._canvas, self._tile)
        return self._canvas

    # -- rendering --------------------------------------------------------
    def step(self, camera: Camera, time: Optional[int] = None) -> None:
        """One progressive sample pass accumulated into the canvas.  ``time``
        seeds the pass's RNG streams (nonzero); by default a counter."""
        if self._device_scene is None:
            raise RuntimeError("no scene: call update_scene() first")
        if time is None:
            time = self._time_base + self.num_steps
        o = self.options
        self._canvas = render_pass(
            self._device_scene, camera.state(o.width / o.height),
            self._canvas, time, width=o.width, height=o.height,
            num_samples=o.num_samples, num_bounces=o.num_bounces,
            ray_tile=self._tile, canvas_tiled=self._tile is not None,
            tri_backend=o.tri_backend, aov=o.aov_mode)
        self.num_steps += 1

    def render(self, camera: Camera, num_steps: int = 1,
               reset: bool = False) -> np.ndarray:
        """Accumulate ``num_steps`` passes; return the u8 image."""
        if reset:
            self.clear_canvas()
        for _ in range(num_steps):
            self.step(camera)
        return self.image()

    def image(self) -> np.ndarray:
        """Tonemapped (H, W, 3) u8 RGB of the accumulation state."""
        img = tonemap_u8(self._canvas, max(self.num_steps, 1))
        if self._tile is not None:
            img = untile_image(img, self._tile)
        return img.cpu().numpy()

    # -- checkpoint / resume ---------------------------------------------
    def state_dict(self) -> dict:
        """The accumulation state: the row-major (H, W, 3) f32 canvas as
        a numpy array and the step count.  With a scene file it is a
        whole checkpoint, in the JAX package's form."""
        return {"canvas": self.canvas.cpu().numpy(),
                "num_steps": self.num_steps}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict``'s canvas (re-tiled when a ray tile is in
        use) and step count; the canvas must be (height, width, 3)."""
        canvas = np.asarray(state["canvas"], np.float32)
        o = self.options
        if canvas.shape != (o.height, o.width, 3):
            raise ValueError(
                f"canvas shape {canvas.shape} != {(o.height, o.width, 3)}")
        canvas = torch.tensor(canvas, device=self.device)
        if self._tile is not None:
            canvas = tile_image(canvas, self._tile)
        self._canvas = canvas
        self.num_steps = int(state["num_steps"])

    # -- instrumentation --------------------------------------------------
    def benchmark_step(self, camera: Camera, iters: int = 10,
                       warmup: int = 2) -> dict:
        """Steady-state time of one progressive pass on the card, from CUDA
        events around ``iters`` passes after ``warmup`` passes.  The passes
        run on a scratch canvas: the accumulation state (canvas and step
        count) is left as it was, as in the JAX Renderer."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark_step times the card; this "
                               f"renderer is on {self.device}")

        def cuda_seconds(run):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(self.device):
                start.record()
                run()
                end.record()
                end.synchronize()
            return start.elapsed_time(end) / 1e3

        dt = self._time_passes(camera, iters, warmup, cuda_seconds) / iters
        o = self.options
        segments = o.width * o.height * o.num_samples * o.num_bounces
        return {
            "device": torch.cuda.get_device_name(self.device),
            "seconds_per_step": dt,
            "steps_per_second": 1.0 / dt,
            "mrays_per_second": segments / dt / 1e6,
            "spp_per_second": o.num_samples / dt,
        }

    def _time_passes(self, camera: Camera, iters: int, warmup: int,
                     seconds) -> float:
        """``seconds(run)`` of ``iters`` passes after ``warmup`` passes, on
        a scratch canvas; the canvas and the step count are restored."""
        canvas, num_steps = self._canvas, self.num_steps
        self._canvas = torch.zeros_like(canvas)
        try:
            for _ in range(warmup):
                self.step(camera)

            def run():
                for _ in range(iters):
                    self.step(camera)
            return seconds(run)
        finally:
            self._canvas, self.num_steps = canvas, num_steps
