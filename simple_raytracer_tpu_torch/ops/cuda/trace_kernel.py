"""The whole-trace kernel: ray generation, every bounce and the gradient
sky in one CUDA launch (``csrc/trace_kernel.cu``).

It replaces the TPU megakernel ``_trace_kernel`` of
``simple_raytracer_tpu/ops/pallas/bounce_kernel.py`` with the sky
evaluated in the kernel, including its two triangle forms: ``_tris_small``
(a dense loop over at most ``SMALL_TRIS_MAX`` triangles) and
``_tris_clustered`` (a BVH-clustered mesh of at most ``TABLE_MAX_SLOTS``
slots).  Its plain PyTorch version, ``trace_full_plain``, is
``generate_rays`` followed by ``trace_rays``.

``trace_full`` takes the plain version only for a scene on the CPU.  For
a scene on a CUDA device it launches the kernel or raises: there is no
fallback, and a mesh outside the kernel's envelope (see ``tri_variant``)
raises too.  The kernel is built on first use with ``nvcc`` into a shared
library with a C interface under ``build/srt_torch_kernels/`` (keyed on a
hash of the source) and bound with ``ctypes``.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..camera import generate_rays
from ..scene_types import TABLE_MAX_SLOTS, Clusters, DeviceScene
from ..vec import Vec3

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE = PACKAGE_DIR / "csrc" / "trace_kernel.cu"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "srt_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
BLOCK = 256
MAX_SHARED_BYTES = 48 * 1024
# meshes of at most this many triangles (padded) and no clusters take the
# dense in-kernel loop (bounce_kernel.SMALL_TRIS_MAX)
SMALL_TRIS_MAX = 64
# the kernel's triangle variants, as the CUDA source's TriMode
TRI_MODES = {"none": 0, "small": 1, "clustered": 2}
# room for the group order in TraceParams: groups of 8 clusters whose
# boxes (8 f32 each) fill MAX_SHARED_BYTES
MAX_GROUPS = MAX_SHARED_BYTES // (8 * 8 * 4)


class TraceParams(ctypes.Structure):
    """By-value launch parameters; the layout of ``TraceParams`` in the
    CUDA source."""
    _fields_ = [
        ("rot", ctypes.c_float * 9),
        ("cam_pos", ctypes.c_float * 3),
        ("aspect_ratio", ctypes.c_float),
        ("fov_scale", ctypes.c_float),
        ("height", ctypes.c_float),
        ("horizon", ctypes.c_float * 3),
        ("zenith", ctypes.c_float * 3),
        ("ground", ctypes.c_float * 3),
        ("sun_color", ctypes.c_float * 3),
        ("sun_direction", ctypes.c_float * 3),
        ("sun_focus", ctypes.c_float),
        ("sun_intensity", ctypes.c_float),
        ("width", ctypes.c_int32),
        ("num_samples", ctypes.c_int32),
        ("num_bounces", ctypes.c_int32),
        ("n_rays", ctypes.c_int32),
        ("tile_h", ctypes.c_int32),
        ("tile_w", ctypes.c_int32),
        ("row0", ctypes.c_int32),
        ("time", ctypes.c_uint32),
        ("n_spheres", ctypes.c_int32),
        ("n_planes", ctypes.c_int32),
        ("n_materials", ctypes.c_int32),
        ("tri_mode", ctypes.c_int32),
        ("n_tris", ctypes.c_int32),
        ("n_clusters", ctypes.c_int32),
        ("cluster_k", ctypes.c_int32),
        ("cluster_extent", ctypes.c_float),
        ("group_order", ctypes.c_uint8 * MAX_GROUPS),
    ]


# srt_trace_launch(sph, pln, mat, tri, box, out, params, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 6 + [TraceParams, ctypes.c_void_p]


class TraceKernel:
    """The built library, nvcc's output, and counts of launches: in all,
    and for each triangle variant (``variant_launches``)."""

    def __init__(self):
        self.launches = 0
        self.variant_launches = collections.Counter()
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def reset_counts(self) -> None:
        self.launches = 0
        self.variant_launches.clear()

    def library(self):
        """Build (once per source hash) and load the shared library."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build()
            return self._lib

    def _build(self):
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        out = BUILD_DIR / f"trace_kernel-{digest}.so"
        if not out.exists():
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the CUDA toolkit is "
                                   "needed to build the trace kernel")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{self.build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        fn = lib.srt_trace_launch
        fn.argtypes = LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
        lib.srt_error_string.argtypes = [ctypes.c_int]
        lib.srt_error_string.restype = ctypes.c_char_p
        return lib


KERNEL = TraceKernel()


def prim_tables(scene: DeviceScene):
    """The kernel's f32 tables: spheres (Ns, 8) [center, radius, material,
    active, 0, 0], planes (Np, 8) [position, normal, material, active],
    materials (M, 16) [smoothness, metallic, specular, emission_strength,
    transmittance, ior, color, emission, 0 x4]."""
    sp, pl, m = scene.spheres, scene.planes, scene.materials
    f = lambda t: t.to(torch.float32)
    sph = torch.cat([sp.center, sp.radius[:, None], f(sp.material)[:, None],
                     f(sp.active)[:, None],
                     torch.zeros_like(sp.center[:, :2])], dim=1)
    pln = torch.cat([pl.position, pl.normal, f(pl.material)[:, None],
                     f(pl.active)[:, None]], dim=1)
    mat = torch.cat([torch.stack([m.smoothness, m.metallic, m.specular,
                                  m.emission_strength, m.transmittance,
                                  m.refraction_index], dim=1),
                     m.color, m.emission,
                     torch.zeros_like(m.color[:, :1]).expand(-1, 4)], dim=1)
    return sph.contiguous(), pln.contiguous(), mat.contiguous()


def tri_variant(scene: DeviceScene) -> str:
    """The kernel's triangle variant for a scene: "none", "small" (at most
    SMALL_TRIS_MAX triangles, no clusters) or "clustered" (at most
    TABLE_MAX_SLOTS cluster slots), as the TPU's whole-trace rule
    (ops/trace.py ``mega_tris``).  Any other mesh raises."""
    tris = scene.triangles
    n = tris.material.shape[0]
    cl = tris.clusters
    if cl is None and n == 0:
        return "none"
    if cl is None and n <= SMALL_TRIS_MAX:
        return "small"
    if cl is not None and cl.slots.numel() <= TABLE_MAX_SLOTS:
        return "clustered"
    raise NotImplementedError(
        f"trace kernel: a mesh of {n} triangles "
        + ("with %d cluster slots" % cl.slots.numel() if cl is not None
           else "without clusters")
        + " is outside the whole-trace kernel; mid-size unclustered meshes "
        "and large clustered ones (configs 6 and 7) take the split "
        "per-bounce path, a later slice")


def group_order(clusters: Clusters, position) -> np.ndarray:
    """Front-to-back order of the groups of 8 clusters from the camera
    position: by the squared distance of each group's nearest box center,
    stably (bounce_kernel.trace_full_fused).  Padding groups sort last."""
    cam = np.asarray(position, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        diff = clusters.centers - cam[None, :]
        d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
              + diff[:, 2] * diff[:, 2])
    return np.argsort(d2.reshape(-1, 8).min(axis=1),
                      kind="stable").astype(np.int32)


def trace_full_plain(scene: DeviceScene, rot, position, aspect_ratio,
                     fov_scale, time, *, width, height, num_samples,
                     num_bounces, row0=0, tile_height=None, ray_tile=None,
                     segments=None) -> Vec3:
    """The plain PyTorch version: generate_rays, then trace_rays."""
    from ..trace import trace_rays
    o, d, seed = generate_rays(width, height, num_samples, time, position,
                               rot, aspect_ratio, fov_scale, row0=row0,
                               tile_height=tile_height, tile=ray_tile,
                               device=scene.device)
    return trace_rays(scene, o, d, seed, num_bounces, segments)


def trace_full(scene: DeviceScene, rot, position, aspect_ratio, fov_scale,
               time, *, width, height, num_samples, num_bounces, row0=0,
               tile_height=None, ray_tile=None) -> Vec3:
    """Per-ray radiance of the (tile_height * W * S,) rays of one pass
    (ray i is local_pixel * S + sample, pixels in ray-tile order when
    ``ray_tile`` is set)."""
    kw = dict(width=width, height=height, num_samples=num_samples,
              num_bounces=num_bounces, row0=row0, tile_height=tile_height,
              ray_tile=ray_tile)
    if scene.device.type == "cpu":
        return trace_full_plain(scene, rot, position, aspect_ratio,
                                fov_scale, time, **kw)
    return launch(prepare(scene, rot, position, aspect_ratio, fov_scale,
                          time, **kw))


@dataclasses.dataclass
class Prepared:
    """One pass's launch, checked and packed: tables and parameters."""
    tables: tuple            # spheres, planes, materials (device f32)
    tri_tables: tuple        # triangle rows, cluster boxes
    variant: str             # tri_variant
    params: TraceParams
    n_rays: int
    device: torch.device


def prepare(scene: DeviceScene, rot, position, aspect_ratio, fov_scale,
            time, *, width, height, num_samples, num_bounces, row0=0,
            tile_height=None, ray_tile=None) -> Prepared:
    """Check a CUDA pass's arguments and pack its launch."""
    if tile_height is None:
        tile_height = height
    variant = tri_variant(scene)
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"trace kernel: unsupported device {device}")
    if ray_tile is not None and (tile_height % ray_tile[0]
                                 or width % ray_tile[1]):
        raise ValueError(f"tile {ray_tile} must divide band "
                         f"{tile_height}x{width}")
    if num_bounces < 1:
        raise ValueError("num_bounces must be >= 1")

    sph, pln, mat = prim_tables(scene)
    tris = scene.triangles
    tri, box = tris.table, None
    shared = sph.numel() + pln.numel() + mat.numel()
    if variant == "small":
        shared += tri.numel()
    elif variant == "clustered":
        cl = tris.clusters
        if cl.slots.shape[0] % 8:
            raise ValueError("trace kernel: the cluster count must be a "
                             "multiple of 8")
        box = cl.aabb
        shared += box.numel()
    for name, t in (("spheres", sph), ("planes", pln), ("materials", mat),
                    ("triangles", tri), ("cluster boxes", box)):
        if t is not None and (t.device != device or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"trace kernel: bad {name} table {t.dtype} "
                             f"on {t.device}")
    if 4 * shared > MAX_SHARED_BYTES:
        raise ValueError("trace kernel: scene tables exceed 48 KB of "
                         "shared memory")
    n_rays = width * tile_height * num_samples
    if n_rays >= 2 ** 31 - BLOCK:
        raise ValueError(f"trace kernel: {n_rays} rays overflow int32")

    sky = scene.sky
    p = TraceParams()
    p.rot[:] = rot
    p.cam_pos[:] = position
    p.aspect_ratio, p.fov_scale, p.height = aspect_ratio, fov_scale, height
    p.horizon[:] = sky.horizon_color
    p.zenith[:] = sky.zenith_color
    p.ground[:] = sky.ground_color
    p.sun_color[:] = sky.sun_color
    p.sun_direction[:] = sky.sun_direction
    p.sun_focus, p.sun_intensity = sky.sun_focus, sky.sun_intensity
    p.width, p.num_samples, p.num_bounces = width, num_samples, num_bounces
    p.n_rays = n_rays
    p.tile_h, p.tile_w = ray_tile if ray_tile is not None else (0, 0)
    p.row0 = row0
    p.time = int(time) & 0xFFFFFFFF
    p.n_spheres, p.n_planes, p.n_materials = (sph.shape[0], pln.shape[0],
                                              mat.shape[0])
    p.tri_mode = TRI_MODES[variant]
    if variant == "small":
        p.n_tris = tri.shape[0]
    elif variant == "clustered":
        cl = tris.clusters
        p.n_clusters, p.cluster_k = cl.slots.shape
        p.cluster_extent = cl.extent
        order = group_order(cl, position)
        p.group_order[:order.shape[0]] = order.tolist()
    return Prepared((sph, pln, mat), (tri, box), variant, p, n_rays, device)


def launch(prep: Prepared, out: torch.Tensor = None) -> Vec3:
    """Launch the kernel on the current stream into ``out`` ((3, n_rays)
    f32, allocated when not given) and count the launch."""
    if out is None:
        out = torch.empty((3, prep.n_rays), dtype=torch.float32,
                          device=prep.device)
    elif (out.shape != (3, prep.n_rays) or out.dtype != torch.float32
          or out.device != prep.device or not out.is_contiguous()):
        raise ValueError("trace kernel: bad output tensor")
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = KERNEL.library()
    with torch.cuda.device(prep.device):
        stream = torch.cuda.current_stream(prep.device).cuda_stream
        err = lib.srt_trace_launch(*map(ptr, prep.tables + prep.tri_tables),
                                   out.data_ptr(), prep.params, stream)
    if err != 0:
        raise RuntimeError("trace kernel launch failed: "
                           + lib.srt_error_string(err).decode())
    KERNEL.launches += 1
    KERNEL.variant_launches[prep.variant] += 1
    return Vec3(out[0], out[1], out[2])
