"""The render engine: progressive accumulation on torch devices.

The counterpart of ``simple_raytracer_tpu.engine``: a ``Renderer`` owns
the device scene and the ``(canvas, num_steps)`` accumulation state.  Every
``step`` traces one more sample pass into the canvas; the image is the
tonemapped mean of all passes since the last ``clear_canvas``.  The
canvas is kept in ray-tile pixel order and untiled only when read.
``state_dict``/``load_state_dict`` checkpoint the accumulation state in
the JAX package's form (a row-major f32 canvas and the step count).

Under ``RenderOptions.all_devices`` the image is split into horizontal
bands, one a device (``parallel/``): the renderer keeps a canvas a band
and a device scene a distinct device, and in a multi-process render
(``parallel/distributed.py``) the bands of every process make one image,
gathered when it is read.  The bands give the single-device canvas bit
for bit.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import List, Optional

import numpy as np
import torch

from .models.camera import Camera
from .models.scene import Scene
from .ops.camera import tile_image, untile_image
from .ops.scene_types import DeviceScene
from .ops.tonemap import tonemap_u8
from .ops.trace import check_aov, check_tri_backend
from .parallel import distributed
from .parallel.mesh import band_rows, make_mesh, resolve_device
from .parallel.shard import (make_sharded_canvas, make_sharded_render_step,
                             replicate_scene)
from .utils.metrics import span


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
    # "auto": the whole-trace kernel for the scenes it serves, the split
    # per-bounce path for the others; "bvh": the split path for every
    # scene; "clustered": the split path with the BVH kernel's streamed
    # variant; "fused": the whole-trace kernel up to config 6's table,
    # the fused per-bounce path (the per-bounce shade kernel) beyond;
    # "pallas": the split path with the brute-force triangle kernel for
    # every mesh; "jnp": the split path with the dense PyTorch loop.
    tri_backend: str = "auto"
    # screen-tile ray order (th, tw); None = row-major; "auto" tiles 8x64
    # when the image divides evenly.  A permutation: results are the same.
    ray_tile: object = "auto"
    # render in horizontal pixel bands over every local device (or the
    # devices the Renderer is given), and across processes in a
    # multi-process render; the height must divide by the band count.
    # The bands give the single-device canvas bit for bit.
    all_devices: bool = False

    def __post_init__(self):
        check_tri_backend(self.tri_backend)
        check_aov(self.aov)

    @property
    def aov_mode(self) -> Optional[str]:
        """The AOV traced: ``aov``, else "normals" under ``show_normals``,
        else None (the path-traced image)."""
        return self.aov or ("normals" if self.show_normals else None)


def _resolve_ray_tile(ray_tile, rows: int, width: int):
    """'auto' -> (8, 64) when rows (the height, or a band's under
    all_devices) and width divide evenly, else None."""
    if ray_tile == "auto":
        return (8, 64) if rows % 8 == 0 and width % 64 == 0 else None
    return ray_tile


class Renderer:
    """Progressive path tracer with its state on one torch device, or in
    bands over several under ``all_devices``."""

    def __init__(self, options: RenderOptions = RenderOptions(),
                 scene: Optional[Scene] = None, device=None):
        """``device``: the torch device (default the card).  Under
        ``all_devices`` it may be a list, the devices of this process's
        bands in order (a device may repeat); the default is every local
        card (``parallel.mesh.local_devices``).  In a multi-process render
        every process builds its renderer at once: the band layout is
        agreed by a collective (``distributed.all_counts``)."""
        self.options = options
        several = isinstance(device, (list, tuple))
        if options.all_devices:
            mesh = make_mesh(device if device is None or several
                             else [device])
            # a multi-process render: every process's bands, in order
            counts = distributed.all_counts(len(mesh))
            first = sum(counts[:distributed.process_index()])
        else:
            if several:
                raise ValueError("several devices need all_devices=True")
            mesh = [resolve_device(device)]
            counts, first = [1], 0
        total = sum(counts)
        if options.height % total:
            raise ValueError(
                f"--all-devices: height {options.height} must divide by the "
                f"{total} devices (pick a multiple of {total})")
        self._mesh = mesh
        self._spans_processes = len(counts) > 1
        self._num_bands = total
        self._rows = band_rows(options.height, total)[first:first + len(mesh)]
        self.device = mesh[0]
        # the per-band tile order composes into the image's at read time
        self._tile = _resolve_ray_tile(options.ray_tile,
                                       options.height // total, options.width)
        self._step_fn = make_sharded_render_step(
            options.width, options.height, options.num_samples,
            options.num_bounces, mesh=mesh, aov=options.aov_mode,
            tri_backend=options.tri_backend, ray_tile=self._tile,
            canvas_tiled=self._tile is not None, first_band=first,
            num_bands=total)
        self._scenes = None          # device -> DeviceScene
        self._canvases = None        # one canvas a band of this process
        self.num_steps = 0
        self._time_base = 1   # deterministic unless the caller passes time
        if scene is not None:
            self.update_scene(scene)
        self.clear_canvas()

    @property
    def num_devices(self) -> int:
        """The bands each step is spread over, in every process."""
        return self._num_bands

    @property
    def devices(self) -> List[torch.device]:
        """The devices of this process's bands, in order."""
        return list(self._mesh)

    # -- scene / state ----------------------------------------------------
    def update_scene(self, scene: Scene, refit: bool = False) -> None:
        """Build the whole scene onto each device again.  ``refit=True``
        keeps the scene's cached cluster topology and recomputes only the
        cluster boxes, for an edit that moves models (``Scene.build``)."""
        with span("srt.update_scene"):
            self._scenes = replicate_scene(scene, self._mesh, refit)

    def set_device_scene(self, device_scene: DeviceScene) -> None:
        """Render ``device_scene``; every band must be on its device."""
        if set(self._mesh) != {device_scene.device}:
            raise ValueError(
                f"scene on {device_scene.device}, renderer on "
                + ", ".join(str(d) for d in dict.fromkeys(self._mesh)))
        self._scenes = {device_scene.device: device_scene}

    @property
    def device_scene(self) -> Optional[DeviceScene]:
        """The device scene of the first band's device."""
        return None if self._scenes is None else self._scenes[self.device]

    @property
    def ray_tile(self):
        """The resolved ray-tile order of a band, (th, tw) or None."""
        return self._tile

    def clear_canvas(self) -> None:
        o = self.options
        self._canvases = make_sharded_canvas(self._mesh, o.height, o.width,
                                             self._num_bands)
        self.num_steps = 0

    def _row_major(self, bands: List[torch.Tensor]) -> List[torch.Tensor]:
        if self._tile is None:
            return bands
        return [untile_image(b, self._tile) for b in bands]

    def _gather(self, bands: List[torch.Tensor]) -> torch.Tensor:
        """This process's row-major bands as one tensor on the first band's
        device, or where the render spans processes the whole image on
        the host (``distributed.fetch_canvas``, a collective)."""
        local = (bands[0] if len(bands) == 1
                 else torch.cat([b.to(self.device) for b in bands]))
        if self._spans_processes:
            return torch.from_numpy(distributed.fetch_canvas(local))
        return local

    @property
    def canvas(self) -> torch.Tensor:
        """Row-major (H, W, 3) radiance sum."""
        return self._gather(self._row_major(self._canvases))

    # -- rendering --------------------------------------------------------
    def step(self, camera: Camera, time: Optional[int] = None) -> None:
        """One progressive sample pass accumulated into the canvas.  ``time``
        seeds the pass's RNG streams (nonzero); by default a counter."""
        with span("srt.step"):
            # the scenes are read once: update_scene on another thread (the
            # viewer's edits) swaps them whole, so a pass never mixes two
            scenes = self._scenes
            if scenes is None:
                raise RuntimeError("no scene: call update_scene() first")
            if time is None:
                time = self._time_base + self.num_steps
            o = self.options
            self._canvases = self._step_fn(scenes,
                                           camera.state(o.width / o.height),
                                           self._canvases, time)
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
        """Tonemapped (H, W, 3) u8 RGB of the accumulation state (on every
        process of a multi-process render)."""
        with span("srt.image"):
            steps = max(self.num_steps, 1)
            with span("srt.tonemap"):
                bands = self._row_major(
                    [tonemap_u8(c, steps) for c in self._canvases])
            image = self._gather(bands)
            with span("srt.fetch"):
                return image.cpu().numpy()

    # -- checkpoint / resume ---------------------------------------------
    def state_dict(self) -> dict:
        """The accumulation state: the row-major (H, W, 3) f32 canvas as
        a numpy array and the step count.  With a scene file it is a
        whole checkpoint, in the JAX package's form, whatever the band
        count.  A collective in a multi-process render."""
        return {"canvas": self.canvas.cpu().numpy(),
                "num_steps": self.num_steps}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict``'s canvas (split into this process's
        bands, re-tiled when a ray tile is in use) and step count; the
        canvas must be (height, width, 3)."""
        canvas = np.asarray(state["canvas"], np.float32)
        o = self.options
        if canvas.shape != (o.height, o.width, 3):
            raise ValueError(
                f"canvas shape {canvas.shape} != {(o.height, o.width, 3)}")
        bands = [torch.tensor(canvas[row0:row0 + rows], device=dev)
                 for dev, (row0, rows) in zip(self._mesh, self._rows)]
        if self._tile is not None:
            bands = [tile_image(b, self._tile) for b in bands]
        self._canvases = bands
        self.num_steps = int(state["num_steps"])

    # -- instrumentation --------------------------------------------------
    def benchmark_step(self, camera: Camera, iters: int = 10,
                       warmup: int = 2) -> dict:
        """Steady-state time of one progressive pass on the card, from CUDA
        events around ``iters`` passes after ``warmup`` passes; in bands,
        from the host clock around the passes with every band's device
        synchronised before and after (the JAX ``_benchmark_host_loop``).
        The passes run on scratch canvases: the accumulation state
        (canvas and step count) is left as it was, as in the JAX
        Renderer."""
        if any(d.type != "cuda" for d in self._mesh):
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

        def host_seconds(run):
            devices = set(self._mesh)
            for d in devices:
                torch.cuda.synchronize(d)
            t0 = _time.perf_counter()
            run()
            for d in devices:
                torch.cuda.synchronize(d)
            return _time.perf_counter() - t0

        seconds = cuda_seconds if self._num_bands == 1 else host_seconds
        dt = self._time_passes(camera, iters, warmup, seconds) / iters
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
        scratch canvases; the canvases and the step count are restored."""
        canvases, num_steps = self._canvases, self.num_steps
        self._canvases = [torch.zeros_like(c) for c in canvases]
        try:
            for _ in range(warmup):
                self.step(camera)

            def run():
                for _ in range(iters):
                    self.step(camera)
            return seconds(run)
        finally:
            self._canvases, self.num_steps = canvases, num_steps
