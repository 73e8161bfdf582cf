"""simple_raytracer_tpu_torch: the progressive path tracer on PyTorch and
CUDA, for an NVIDIA H100.

A port of ``simple_raytracer_tpu`` (JAX on a TPU), which stays beside it
as the reference.  This package imports neither JAX nor the JAX package:
it keeps its own copies of the host models.  On a CUDA device a pass runs
as one hand-written whole-trace kernel (``csrc/trace_kernel.cu``) for the
scenes it serves, and otherwise as a per-bounce path, whose triangle hits
come from the hand-written BVH kernel (``csrc/bvh_kernel.cu``) or, under
``tri_backend="pallas"``, the brute-force triangle kernel
(``csrc/triangle_kernel.cu``); on the CPU each kernel's plain PyTorch
version runs instead.  A scene's environment is the gradient sky or an
equirect texture (``Scene.skybox``, e.g. from ``io.image.load_skybox``).
"""

from .engine import Renderer, RenderOptions
from .io.image import load_skybox
from .models.camera import Camera
from .models.materials import Material, MaterialSet, from_hex, from_rgb
from .models.scene import Scene, SkySettings

__all__ = [
    "Camera", "Material", "MaterialSet", "Scene", "SkySettings",
    "Renderer", "RenderOptions", "from_hex", "from_rgb", "load_skybox",
]
