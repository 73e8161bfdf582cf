"""The whole-trace kernel: ray generation, every bounce and the gradient
sky in one CUDA launch (``csrc/trace_kernel.cu``).

It replaces the TPU megakernel ``_trace_kernel`` of
``simple_raytracer_tpu/ops/pallas/bounce_kernel.py`` in both its forms:
with the gradient sky evaluated in the kernel (3 rows per ray), and, for
a scene with a texture skybox, without it (``fold_sky=False``): the
kernel writes 9 rows per ray (the emission gathered, the throughput and
direction at the miss) and the wrapper samples the texture on them once
(``ops/trace.add_sky``), as ``trace_full_fused`` does.  Its triangle
forms: ``_tris_small`` (a dense loop over at most
``scene_types.SMALL_TRIS_MAX`` triangles) and ``_tris_clustered`` (a
BVH-clustered mesh of at most ``TABLE_MAX_SLOTS`` slots, or under
``tri_backend="fused"`` the TPU's packed form of it, at most
``MEGA_PACKED_MAX_CLUSTERS`` clusters of at most 128 slots: config 6's
98,304 slots).  The kernel walks a clustered mesh warp by warp down the
scene's hierarchy (``ops/bvh.build_hierarchy``), feeding Moller-Trumbore
from the staged MT table (``ops/bvh.staged_slots``, built on the first
launch, once per scene) through a ring of bulk copies in shared memory;
the least (t, global triangle index) wins, so the visiting order changes
no result, and the winner's (u, v) are recomputed on its row.  The
``small`` variant runs persistent warps: each lane traces one path at a
time and, when it ends, takes the next path index from the launch's own
counter (``next_path``), so no lane idles while its warp's longest path
runs; each path keeps its seed and its rows, so no result depends on
which lane takes it.  ``none`` traces one thread a ray.  Both loop over
the active rows of their tables only.  Its plain PyTorch version,
``trace_full_plain``, is ``generate_rays`` followed by ``trace_rays_rows``
in its whole-trace form (every triangle tested densely, the lowest index
winning an exact tie, triangles shaded at MT's (u, v)), then the same
``add_sky``.

``trace_full`` takes the plain version only for a scene on the CPU.  For
a scene on a CUDA device it launches the kernel or raises: there is no
fallback, and a mesh outside the kernel's envelope
(``scene_types.whole_trace_variant`` is None) raises too;
``ops/trace.render_pass`` sends such scenes to a per-bounce path
instead.  The tables and the walk's rings sit in shared memory, and the
launch opts in to more than the default 48 KB, up to the device's limit.
The kernel is built on first use (``ops/cuda/build.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

from .. import bvh
from ..camera import generate_rays
from ..scene_types import DeviceScene, prim_tables, whole_trace_variant
from ..vec import Vec3
from .build import PACKAGE_DIR, Kernel, interface

SOURCE = PACKAGE_DIR / "csrc" / "trace_kernel.cu"
# The "none" and "small" variants' constants (the CUDA source's defaults,
# which chip_smoke.py's sweep sets on extra builds): the block of
# persistent warps ("small") and the block of one thread a ray ("none"),
# and the path indices a persistent warp takes from the launch's counter
# at a time
PATH_BLOCK = 128
RAY_BLOCK = 256
FETCH = 32
# The clustered variant's warp walk (the CUDA source's defaults, which
# chip_smoke.py's sweep sets on extra builds): its block, the slots of a
# chunk, the warp's ring of chunk buffers, the most admitting lanes for
# which a chunk's MT is split across the warp (32: always)
WALK_BLOCK = 128
CHUNK = 128
STAGES = 2
SPLIT_MAX = 32
# SRT_MEGA_MT_SLICES (bounce_kernel.py:126), read once, at import, as the
# JAX module reads it: the TPU megakernel runs its packed MT in that many
# 128-lane slices of its MEGA_BLOCK_R-ray block, each slice gated by its
# own rays.  The card's walk already decides MT per ray (each admitting
# lane, or one admitting ray's slots split across the warp), a finer gate
# than any slice, so the knob changes no code path here: a clustered pass
# only validates it as the JAX package does (check_mt_slices), and every
# valid value gives the same image.
MEGA_MT_SLICES = int(os.environ.get("SRT_MEGA_MT_SLICES", "1"))
MEGA_BLOCK_R = 1536      # trace_full_fused's block_r
# shared memory of the walk a block: each warp's ring of staged rows and
# one 8-byte barrier a buffer
WALK_SHARED_BYTES = (WALK_BLOCK // 32) * STAGES * (
    CHUNK * 4 * bvh.STAGED_COLS + 8)
# dynamic shared memory a block gets without opting in; above it the
# launch opts in, up to the device's limit (227 KB on an H100)
DEFAULT_SHARED_BYTES = 48 * 1024
# the kernel's triangle variants, as the CUDA source's TriMode
TRI_MODES = {"none": 0, "small": 1, "clustered": 2}
# the variant that runs persistent warps, which take path indices from a
# counter of their launch
PERSISTENT = "small"
# bytes of parameters a kernel takes on every architecture; the launch
# passes 10 pointers (TraceArgs) beside TraceParams
PARAM_LIMIT_BYTES = 4096
LAUNCH_POINTERS = 10


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
        ("n_groups", ctypes.c_int32),
        ("cluster_extent", ctypes.c_float),
        ("sky_rows", ctypes.c_int32),
    ]


# the C interface's version (srt_trace_interface in the CUDA source)
INTERFACE = 2
# srt_trace_launch(sph, pln, mat, tri, staged, boxes, supers, groups, out,
# next_path, params, stream)
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * LAUNCH_POINTERS
                   + [TraceParams, ctypes.c_void_p])
# srt_trace_count_launch: the same, and the counters before the params
COUNT_ARGTYPES = ([ctypes.c_void_p] * (LAUNCH_POINTERS + 1)
                  + [TraceParams, ctypes.c_void_p])
# the counting instance's counters of a bounce (the CUDA source's Count)
COUNTERS = ("live", "warps", "box_tests", "admitted", "union", "mt_steps",
            "lane_steps", "chunks", "split", "wasted", "cycles_walk",
            "cycles_wait", "cycles_mt", "cycles_bounce", "cycles_prims",
            "cycles_tris", "cycles_bsdf", "cycles_gen", "cycles_finish",
            "steps", "step_lanes", "fetches", "cycles_warp", "cycles_block")
# the most bounces a counting launch counts (kCountBounces)
COUNT_BOUNCES = 16


def _bind(lib: ctypes.CDLL) -> None:
    version = interface(lib, "srt_trace_interface")
    if version != INTERFACE:
        raise RuntimeError(f"whole-trace kernel: the build has C interface "
                           f"{version}, want {INTERFACE}")
    lib.srt_trace_launch.argtypes = LAUNCH_ARGTYPES
    lib.srt_trace_launch.restype = ctypes.c_int
    lib.srt_trace_count_launch.argtypes = COUNT_ARGTYPES
    lib.srt_trace_count_launch.restype = ctypes.c_int
    lib.srt_shared_optin.argtypes = [ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.srt_shared_optin.restype = ctypes.c_int


KERNEL = Kernel(SOURCE, _bind)


@functools.lru_cache(maxsize=None)
def shared_limit(device_index: int) -> int:
    """The dynamic shared memory a block of the device may opt in to."""
    out = ctypes.c_int(0)
    KERNEL.check(KERNEL.library().srt_shared_optin(device_index,
                                                   ctypes.byref(out)),
                 "shared memory query")
    return out.value


def check_shared_bytes(n_bytes: int, limit: int) -> None:
    """The launch's size rule: its tables must fit the shared memory a
    block may opt in to."""
    if n_bytes > limit:
        raise ValueError(f"trace kernel: the scene tables need {n_bytes} B "
                         f"of shared memory, above the device's {limit} B "
                         "per block")


def trace_full_plain(scene: DeviceScene, rot, position, aspect_ratio,
                     fov_scale, time, *, width, height, num_samples,
                     num_bounces, row0=0, tile_height=None, ray_tile=None,
                     segments=None, rows: bool = False):
    """The plain PyTorch version: generate_rays, then trace_rays_rows and
    add_sky; with ``rows``, the nine rows (color, sky_mask, sky_dir)
    before the environment instead."""
    from ..trace import add_sky, trace_rays_rows
    o, d, seed = generate_rays(width, height, num_samples, time, position,
                               rot, aspect_ratio, fov_scale, row0=row0,
                               tile_height=tile_height, tile=ray_tile,
                               device=scene.device)
    out = trace_rays_rows(scene, o, d, seed, num_bounces, segments)
    return out if rows else add_sky(scene, *out)


def check_mt_slices(variant: str, slices: int = None) -> None:
    """trace_full_fused's rule for SRT_MEGA_MT_SLICES (``MEGA_MT_SLICES``,
    or ``slices``): on a clustered pass a value other than 1 must be at
    least 1 and divide MEGA_BLOCK_R / 128 (12), else ValueError in the JAX
    package's words; other variants never read it."""
    mt = MEGA_MT_SLICES if slices is None else slices
    lanes = MEGA_BLOCK_R // 128
    if variant == "clustered" and mt != 1 and (mt < 1 or lanes % mt != 0):
        raise ValueError(
            f"SRT_MEGA_MT_SLICES={mt} must be >= 1 and divide "
            f"block_r/128 = {lanes} (128-lane slice alignment)")


def trace_full(scene: DeviceScene, rot, position, aspect_ratio, fov_scale,
               time, *, width, height, num_samples, num_bounces, row0=0,
               tile_height=None, ray_tile=None,
               tri_backend: str = "auto") -> Vec3:
    """Per-ray radiance of the (tile_height * W * S,) rays of one pass
    (ray i is local_pixel * S + sample, pixels in ray-tile order when
    ``ray_tile`` is set).  ``tri_backend`` sets the envelope
    (``whole_trace_variant``); a clustered pass checks SRT_MEGA_MT_SLICES
    (``check_mt_slices``).  A scene with a texture skybox takes the
    nine-row form, then the texture's sample."""
    from ..trace import add_sky
    kw = dict(width=width, height=height, num_samples=num_samples,
              num_bounces=num_bounces, row0=row0, tile_height=tile_height,
              ray_tile=ray_tile)
    check_mt_slices(whole_trace_variant(scene, tri_backend))
    if scene.device.type == "cpu":
        return trace_full_plain(scene, rot, position, aspect_ratio,
                                fov_scale, time, **kw)
    out = launch(prepare(scene, rot, position, aspect_ratio, fov_scale,
                         time, tri_backend=tri_backend, **kw))
    if out.shape[0] == 9:
        return add_sky(scene, *split_rows(out))
    return Vec3(out[0], out[1], out[2])


def split_rows(out: torch.Tensor):
    """The nine-row output -> (color, sky_mask, sky_dir) Vec3s."""
    return tuple(Vec3(out[i], out[i + 1], out[i + 2]) for i in (0, 3, 6))


@dataclasses.dataclass
class Prepared:
    """One pass's launch, checked and packed: tables and parameters."""
    tables: tuple            # spheres, planes, materials (device f32)
    tri_tables: tuple        # triangle rows; clustered: staged MT rows,
                             # cluster boxes, supers, groups (else None)
    variant: str             # scene_types.whole_trace_variant
    params: TraceParams
    n_rays: int
    device: torch.device
    shared_bytes: int        # dynamic shared memory a block

    @property
    def n_out(self) -> int:
        """Rows written per ray: 9 without the sky (a texture), else 3."""
        return 9 if self.params.sky_rows else 3

    @property
    def label(self) -> str:
        """The variant as counted: "<variant>/texture" for the 9 rows."""
        return self.variant + ("/texture" if self.params.sky_rows else "")


def prepare(scene: DeviceScene, rot, position, aspect_ratio, fov_scale,
            time, *, width, height, num_samples, num_bounces, row0=0,
            tile_height=None, ray_tile=None,
            tri_backend: str = "auto") -> Prepared:
    """Check a CUDA pass's arguments and pack its launch."""
    if tile_height is None:
        tile_height = height
    variant = whole_trace_variant(scene, tri_backend)
    if variant is None:
        tris = scene.triangles
        raise NotImplementedError(
            f"trace kernel: a mesh of {tris.material.shape[0]} triangles "
            + ("with %d cluster slots" % tris.clusters.slots.numel()
               if tris.clusters is not None else "without clusters")
            + f" is outside the whole-trace kernel under tri_backend="
            f"{tri_backend!r}; ops/trace.render_pass sends it to the split "
            "per-bounce path (a clustered mesh under \"fused\" to the fused "
            "one; ops/cuda/bvh_kernel.py for clustered meshes)")
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
    tri_tables = (tris.table, None, None, None, None)
    shared = 4 * (sph.numel() + pln.numel() + mat.numel())
    if variant == "small":
        shared += 4 * tris.table.numel()
    elif variant == "clustered":
        cl = tris.clusters
        hier = cl.hierarchy
        tri_tables = (tris.table, bvh.staged_slots(cl, tris.table),
                      hier.boxes, hier.supers, hier.groups)
        shared += WALK_SHARED_BYTES
    for name, t in zip(("spheres", "planes", "materials", "triangles",
                        "staged MT rows", "cluster boxes", "supers",
                        "groups"), (sph, pln, mat) + tri_tables):
        if t is not None and (t.device != device or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"trace kernel: bad {name} table {t.dtype} "
                             f"on {t.device}")
    check_shared_bytes(shared, shared_limit(
        device.index if device.index is not None
        else torch.cuda.current_device()))
    n_rays = width * tile_height * num_samples
    if n_rays >= 2 ** 31 - max(PATH_BLOCK, RAY_BLOCK, WALK_BLOCK):
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
    p.sky_rows = int(scene.skybox is not None)
    if variant == "small":
        p.n_tris = tris.table.shape[0]
    elif variant == "clustered":
        cl = tris.clusters
        p.n_clusters, p.cluster_k = cl.slots.shape
        p.n_groups = cl.hierarchy.groups.shape[0]
        p.cluster_extent = cl.extent
    return Prepared((sph, pln, mat), tri_tables, variant, p, n_rays, device,
                    shared)


def next_path(prep: Prepared):
    """A persistent launch's own counter of the path indices handed out:
    one word allocated on the current stream, which the launch zeroes on
    that stream before it runs (PyTorch reuses a freed block only for
    work queued after it on the same stream, so no two launches in
    flight share one); None for the other variants."""
    if prep.variant != PERSISTENT:
        return None
    return torch.empty(1, dtype=torch.int32, device=prep.device)


def launch(prep: Prepared, out: torch.Tensor = None) -> torch.Tensor:
    """Launch the kernel on the current stream into ``out`` ((n_out,
    n_rays) f32, allocated when not given), count the launch and return
    ``out``."""
    shape = (prep.n_out, prep.n_rays)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=prep.device)
    elif (out.shape != shape or out.dtype != torch.float32
          or out.device != prep.device or not out.is_contiguous()):
        raise ValueError("trace kernel: bad output tensor")
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = KERNEL.library()
    with torch.cuda.device(prep.device):
        stream = torch.cuda.current_stream(prep.device).cuda_stream
        err = lib.srt_trace_launch(*map(ptr, prep.tables + prep.tri_tables),
                                   out.data_ptr(), ptr(next_path(prep)),
                                   prep.params, stream)
    KERNEL.check(err, "trace kernel")
    KERNEL.count(prep.label)
    return out


def launch_counted(prep: Prepared):
    """One launch of the variant's counting instance (a kernel of its own,
    which the route never launches; not counted with the route's
    launches): (the output, as ``launch``'s, and one dict of ``COUNTERS``
    per bounce)."""
    if prep.params.num_bounces > COUNT_BOUNCES:
        raise ValueError(f"trace kernel: the counting instance counts at "
                         f"most {COUNT_BOUNCES} bounces")
    out = torch.empty((prep.n_out, prep.n_rays), dtype=torch.float32,
                      device=prep.device)
    counters = torch.zeros((prep.params.num_bounces, len(COUNTERS)),
                           dtype=torch.int64, device=prep.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = KERNEL.library()
    with torch.cuda.device(prep.device):
        stream = torch.cuda.current_stream(prep.device).cuda_stream
        err = lib.srt_trace_count_launch(
            *map(ptr, prep.tables + prep.tri_tables), out.data_ptr(),
            ptr(next_path(prep)), counters.data_ptr(), prep.params, stream)
    KERNEL.check(err, "trace kernel (counting)")
    return out, [dict(zip(COUNTERS, row)) for row in counters.tolist()]


def occupancy(prep: Prepared, counting: bool = False) -> int:
    """Blocks of the pass's variant (its route, or its counting instance)
    that one SM holds at once."""
    fn = KERNEL.library().srt_trace_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    KERNEL.check(fn(prep.params.tri_mode, int(counting), prep.shared_bytes,
                    ctypes.byref(out)), "occupancy query")
    return out.value
