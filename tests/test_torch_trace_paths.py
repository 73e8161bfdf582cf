"""The whole-trace kernel's path variants (csrc/trace_kernel.cu: the
persistent warps of ``kNoTris`` and ``kSmallTris``, rows 1, 1a and 1c) as
the CPU can check them, against the plain version and simple_raytracer_tpu.

The CUDA kernel runs only on the card (chip_smoke.py holds its rows, and
its counting instance's, to the plain version there).  Here
``path_schedule_emulation`` transcribes its schedule (``trace_paths``) in
PyTorch:

- warps of 32 lanes, each lane one path at a time;
- a warp refills at each step at which a lane waits for a path: it takes
  FETCH path indices at a time from the launch's own counter (the warps'
  fetches in turn) and hands the indices it holds to its waiting lanes in
  lane order; an index past the rays is no path, and a warp whose indices
  have passed the rays stops refilling;
- each warp-step, the lanes with a path run one bounce of the plain
  ``trace_rays_rows``'s body on their own ray, whatever bounce each is at
  (batched over the step's lanes: no float operation of a ray depends on
  the other rays of its batch);
- a path that misses or ends its last bounce writes its nine rows at its
  index and frees its lane; the radiance is ``add_sky`` of those rows over
  the whole batch, as the plain version takes it (PyTorch's CPU ``pow``
  may differ in the last bit between its vector body and its scalar tail,
  so the sky of a few paths at a time is not the same call; the kernel's
  sky per path is held to the plain version's on the card).

It hands every index out once, and gives the plain version's rows and
radiance bit for bit on configs 1, 2 and 3 (and the nine rows on configs 2
and 3 with a texture skybox), with the route's fetch and with others (64
and 128, one warp and five); and its radiance is within
test_torch_trace_kernel.py's bounds of JAX's ``trace_full_fused``
(``_trace_kernel`` in Pallas interpret mode).  The route runs ``small``
so (``none`` traces one thread a ray, the plain loop itself).  Both loop
over the active rows of the sphere, plane and triangle tables only
(``stage_active``): the plain version over the tables cut to their active
rows gives every bit it gives over the whole tables.
"""
import ctypes
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops.camera import camera_rotation as jrotation
from simple_raytracer_tpu.ops.pallas import bounce_kernel
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops.bsdf import (gather_materials,
                                                 sample_material)
from simple_raytracer_tpu_torch.ops.camera import (camera_rotation,
                                                   generate_rays)
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel as tk
from simple_raytracer_tpu_torch.ops.intersect import closest_hit
from simple_raytracer_tpu_torch.ops.scene_types import (from_numpy,
                                                       whole_trace_variant)
from simple_raytracer_tpu_torch.ops.trace import add_sky
from simple_raytracer_tpu_torch.ops.vec import Vec3

from torch_port_helpers import jax_scene_arrays, to_np

LANES = 32
# the kernel's constants (test_constants_match_the_cuda_source): the
# block of persistent warps and the path indices a warp fetches at once
PATH_BLOCK, FETCH = 128, 32


def _rows(v: torch.Tensor, idx) -> Vec3:
    return Vec3(v[idx, 0], v[idx, 1], v[idx, 2])


def _put(v: torch.Tensor, idx, x: Vec3, keep) -> None:
    v[idx[keep]] = torch.stack([x.x[keep], x.y[keep], x.z[keep]], 1)


def path_schedule_emulation(scene, o: Vec3, d: Vec3, seed, num_bounces,
                            *, n_warps, fetch=FETCH, rows=False):
    """The persistent warps' trace of rays (o, d, seed), the schedule of
    ``trace_paths``: (the nine rows (color, sky_mask, sky_dir) as a (9,
    R) tensor with ``rows``, else the (3, R) radiance with the scene's
    sky; the path indices in the order the lanes took them; the warp-steps
    of the launch)."""
    n = o.x.shape[0]
    col = lambda v: torch.stack([v.x, v.y, v.z], 1).clone()
    ro, rd, s = col(o), col(d), seed.clone()
    color = torch.zeros((n, 3))
    mask = torch.ones((n, 3))
    sky_mask = torch.zeros((n, 3))
    sky_dir = torch.zeros((n, 3))
    sky_dir[:, 2] = 1.0
    out = torch.full((9, n), float("nan"))
    path = torch.full((n_warps, LANES), -1, dtype=torch.long)
    bounce = torch.zeros((n_warps, LANES), dtype=torch.long)
    pool, pool_end = [0] * n_warps, [0] * n_warps
    drained, done = [False] * n_warps, [False] * n_warps
    counter, taken, steps = 0, [], 0
    while True:
        for w in range(n_warps):
            if done[w]:
                continue
            idle = path[w] < 0
            k = int(idle.sum())
            if not drained[w] and k:
                avail = pool_end[w] - pool[w]
                base = 0
                if avail < k:
                    base, counter = counter, counter + fetch
                for r, lane in enumerate(torch.nonzero(idle)[:, 0].tolist()):
                    i = pool[w] + r if r < avail else base + (r - avail)
                    if i < n:
                        path[w, lane], bounce[w, lane] = i, 0
                        taken.append(i)
                if avail < k:
                    pool[w], pool_end[w] = base + (k - avail), base + fetch
                else:
                    pool[w] += k
                drained[w] = pool[w] >= n
            done[w] = not bool((path[w] >= 0).any())
        live = path >= 0
        if not live.any():
            if not rows:
                out = torch.stack(list(add_sky(scene, *(
                    Vec3(*out[i:i + 3]) for i in (0, 3, 6)))))
            return out, taken, steps
        steps += sum(1 for w in range(n_warps) if live[w].any())
        p, b = path[live], bounce[live]
        # one bounce of trace_rays_rows's body on each lane's own ray
        o_, d_ = _rows(ro, p), _rows(rd, p)
        hit = closest_hit(scene, o_, d_)
        miss = ~hit.hit
        _put(sky_mask, p, _rows(mask, p), miss)
        _put(sky_dir, p, d_, miss)
        mat = gather_materials(scene.materials, hit.material)
        m = _rows(mask, p)
        _put(color, p, _rows(color, p) + m * mat.emission
             * mat.emission_strength, hit.hit)
        go_on = hit.hit & (b < num_bounces - 1)
        ms = sample_material(hit.position, hit.normal, hit.front, d_, mat,
                             s[p])
        _put(ro, p, ms.origin, go_on)
        _put(rd, p, ms.direction, go_on)
        _put(mask, p, m * ms.mask_mul, go_on)
        s[p[go_on]] = ms.seed[go_on]
        # the paths that end write their rows and free their lanes
        end = p[~go_on]
        out[:, end] = torch.cat([color[end].T, sky_mask[end].T,
                                 sky_dir[end].T])
        lanes = live.clone()
        lanes[live] = go_on
        bounce[lanes] += 1
        path[live & ~lanes] = -1


def _pass(n, w=48, h=16, samples=2, skybox=None):
    kw = {"skybox": "gradient"} if n == 3 else {}
    scene, camera, opt = CONFIGS[n](width=w, height=h, **kw)
    if skybox is not None:
        scene.skybox = skybox
    ts = scene.build("cpu")
    cam = camera.state(w / h)
    args = (ts, camera_rotation(cam.yaw, cam.pitch), cam.position,
            cam.aspect_ratio, cam.fov_scale, 1000)
    kw = dict(width=w, height=h, num_samples=samples,
              num_bounces=opt.num_bounces)
    o, d, seed = generate_rays(w, h, samples, 1000, cam.position,
                               args[1], cam.aspect_ratio, cam.fov_scale,
                               device="cpu")
    return ts, args, kw, (o, d, seed), opt.num_bounces


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("n,n_warps,fetch", [
    (1, 2, FETCH), (2, 2, FETCH), (3, 2, FETCH), (2, 5, 64), (3, 1, 128),
    (3, 5, 64)])
def test_schedule_matches_plain_version(n, n_warps, fetch):
    """The radiance through the persistent warps equals the plain
    version's bit for bit, every index handed out once."""
    ts, args, kw, (o, d, seed), bounces = _pass(n)
    assert whole_trace_variant(ts) == ("small" if n == 3 else "none")
    got, taken, steps = path_schedule_emulation(
        ts, o, d, seed, bounces, n_warps=n_warps, fetch=fetch)
    want = torch.stack(list(tk.trace_full_plain(*args, **kw)))
    assert sorted(taken) == list(range(o.x.shape[0]))
    assert torch.equal(_bits(got), _bits(want))
    # the warps ran fewer steps than one warp a 32 rays would: the paths
    # end at different bounces, and a freed lane takes the next path
    if n > 1:
        assert steps < -(-o.x.shape[0] // LANES) * bounces


@pytest.mark.parametrize("n", [2, 3])
def test_nine_rows_match_plain_version(n):
    """With a texture skybox the kernel writes the nine rows before the
    sample: through the persistent warps they equal the plain version's
    bit for bit."""
    rng = np.random.default_rng(n)
    sky = rng.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32)
    ts, args, kw, (o, d, seed), bounces = _pass(n, skybox=sky)
    assert ts.skybox is not None
    got, taken, _ = path_schedule_emulation(ts, o, d, seed, bounces,
                                            n_warps=3, rows=True)
    want = torch.cat([torch.stack(list(v)) for v in
                      tk.trace_full_plain(*args, **kw, rows=True)])
    assert sorted(taken) == list(range(o.x.shape[0]))
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_schedule_matches_tpu_kernel(n):
    """The radiance through the persistent warps against JAX's
    ``_trace_kernel`` (trace_full_fused in Pallas interpret mode) at 64x16,
    one sample: interpret mode runs under jit, where XLA:CPU fuses
    multiply-adds, so the bounds are test_torch_trace_kernel.py's (RMSE
    under 2e-3, the golden bound, and 99% of rays within 1e-3)."""
    w, h = 64, 16
    kw = {"skybox": "gradient"} if n == 3 else {}
    scene, camera, opt = JCONFIGS[n](width=w, height=h, **kw)
    ds = scene.build()
    ts = from_numpy(jax_scene_arrays(ds), "cpu")
    cam = camera.state(w / h)
    jcol = bounce_kernel.trace_full_fused(
        ds, jrotation(cam.yaw, cam.pitch), cam.position, cam.aspect_ratio,
        cam.fov_scale, jnp.uint32(1000), width=w, height=h, num_samples=1,
        num_bounces=opt.num_bounces, interpret=True)
    pos = tuple(float(c) for c in cam.position)
    o, d, seed = generate_rays(
        w, h, 1, 1000, pos, camera_rotation(float(cam.yaw),
                                            float(cam.pitch)),
        float(cam.aspect_ratio), float(cam.fov_scale), device="cpu")
    got, _, _ = path_schedule_emulation(ts, o, d, seed, opt.num_bounces,
                                        n_warps=4)
    a, b = to_np(jcol), got.numpy().T
    assert np.isfinite(b).all()
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    agree = float(np.mean(np.all(np.abs(a - b) < 1e-3, axis=-1)))
    assert rmse < 2e-3, rmse
    assert agree > 0.99, agree


def _cut_to_active(arrays: dict, rng, drop: int):
    """The scene arrays with ``drop`` more sphere, plane and triangle rows
    made inactive, and the same arrays cut to their active rows."""
    full = dict(arrays)
    kinds = [k for k in ("spheres", "planes", "triangles")
             if f"{k}.active" in full]
    for kind in kinds:
        act = np.asarray(full[f"{kind}.active"], bool).copy()
        on = np.flatnonzero(act)
        if min(drop, on.size - 1) > 0:
            act[rng.choice(on, size=min(drop, on.size - 1),
                           replace=False)] = False
        full[f"{kind}.active"] = act
    cut = {k: (v[np.asarray(full[k.split(".")[0] + ".active"], bool)]
               if k.split(".")[0] in kinds else v) for k, v in full.items()}
    return full, cut


@pytest.mark.parametrize("n,drop", [(1, 0), (2, 0), (3, 0), (1, 2), (3, 3)])
def test_active_rows_give_every_bit(n, drop):
    """The path variants stage only the active rows of the sphere, plane
    and triangle tables (``stage_active``): the plain version over the
    tables cut to their active rows gives the radiance and the nine rows
    of the whole tables bit for bit (padding rows, and rows made inactive,
    never win)."""
    kw = {"skybox": "gradient"} if n == 3 else {}
    scene, camera, opt = CONFIGS[n](width=48, height=16, **kw)
    full, cut = _cut_to_active(scene.arrays(), np.random.default_rng(n),
                               drop)
    ts, tc = from_numpy(full, "cpu"), from_numpy(cut, "cpu")
    assert whole_trace_variant(ts) == whole_trace_variant(tc)
    for kind in ("spheres", "planes"):
        assert bool(getattr(tc, kind).active.all())
    if n == 3:
        assert tc.triangles.table.shape[0] < ts.triangles.table.shape[0]
        assert bool((tc.triangles.table[:, 19] > 0).all())
    cam = camera.state(48 / 16)
    args = (camera_rotation(cam.yaw, cam.pitch), cam.position,
            cam.aspect_ratio, cam.fov_scale, 1000)
    kw = dict(width=48, height=16, num_samples=2,
              num_bounces=opt.num_bounces)
    for rows in (False, True):
        a = tk.trace_full_plain(ts, *args, **kw, rows=rows)
        b = tk.trace_full_plain(tc, *args, **kw, rows=rows)
        a, b = (torch.stack(list(a)) if not rows else
                torch.cat([torch.stack(list(v)) for v in a]),
                torch.stack(list(b)) if not rows else
                torch.cat([torch.stack(list(v)) for v in b]))
        assert torch.equal(_bits(a), _bits(b))


def test_constants_match_the_cuda_source():
    """The emulation's and the wrapper's constants are the CUDA source's
    -D defaults; a refill fits one fetch."""
    src = Path(tk.SOURCE).read_text()

    def const(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert (const("SRT_TRACE_PATH_BLOCK"),
            const("SRT_TRACE_FETCH")) == (PATH_BLOCK, FETCH)
    assert (tk.PATH_BLOCK, tk.FETCH) == (PATH_BLOCK, FETCH)
    assert const("SRT_TRACE_RAY_BLOCK") == tk.RAY_BLOCK
    assert LANES <= FETCH
    # "small" alone runs persistent warps, "none" one thread a ray, the
    # clustered variant the walk; no -D flag moves a variant to another
    assert re.search(r"constexpr bool kPersistent = TRI == kSmallTris;", src)
    assert tk.PERSISTENT == "small"
    assert "SRT_TRACE_PATHS" not in src
    assert re.search(r"trace_paths<TRI, COUNT>\(", src)
    assert re.search(r"if constexpr \(kWalk\) \{.*?trace_walk<COUNT>\(",
                     src, re.S)


def test_each_persistent_launch_owns_its_counter():
    """The persistent warps take path indices from their launch's own word
    (TraceArgs::next_path), which the launch zeroes on its stream before
    the kernel: no global counter that two launches in flight (two
    streams, the route and the counting instance) could split paths
    through.  The wrapper hands each "small" launch a new word and the
    other variants none."""
    src = Path(tk.SOURCE).read_text()
    assert not re.search(r"__device__\s+unsigned(\s+int)?\s+g_", src)
    paths = re.search(r"void trace_paths\((.*?)\n\}\n", src, re.S).group(1)
    # the fetch; every other atomic of the loop is the counting instance's
    assert re.findall(r"base = atomicAdd\((.*?),", paths) == ["a.next_path"]
    assert set(re.findall(r"atomicAdd\((.*?) ?[+,]", paths)) == {
        "a.next_path", "row"}
    launch = re.search(r"cudaError_t launch_variant\((.*?)\n\}\n", src,
                       re.S).group(1)
    zero = launch.index("cudaMemsetAsync(a.next_path, 0, sizeof(unsigned), "
                        "st)")
    assert zero < launch.index("<<<blocks, block, bytes, st>>>")
    assert ("if (a.next_path == nullptr) return cudaErrorInvalidValue;"
            in launch)
    for fn in ("srt_trace_launch", "srt_trace_count_launch"):
        sig = re.search(rf"int {fn}\((.*?)\)", src, re.S).group(1)
        assert "unsigned* next_path" in sig
    cpu = torch.device("cpu")
    prep = lambda variant: types.SimpleNamespace(variant=variant, device=cpu)
    a, b = tk.next_path(prep("small")), tk.next_path(prep("small"))
    assert a.shape == (1,) and a.dtype == torch.int32
    assert a.data_ptr() != b.data_ptr()
    assert tk.next_path(prep("none")) is None
    assert tk.next_path(prep("clustered")) is None


def test_parent_trace_build_binds_its_interface():
    """chip_smoke.py --parent binds a parent's whole-trace build to this C
    interface through tk._bind, and its probe build through probe._bind;
    any other version is refused, 1 too (before the launch's own path
    counter, or the probes' timing instance)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from simple_raytracer_tpu_torch.scripts import probe_kernel_ops as probe
    bind = smoke.parent_trace_kernel(Path("parent"))._bind
    assert bind is tk._bind
    assert smoke.parent_probe_kernel(Path("parent"))._bind is probe._bind
    fn = lambda: types.SimpleNamespace(argtypes=None, restype=None)

    def lib(version):
        return types.SimpleNamespace(
            srt_trace_interface=lambda: version, srt_trace_launch=fn(),
            srt_trace_count_launch=fn(), srt_shared_optin=fn())

    new = lib(tk.INTERFACE)
    bind(new)
    assert tk.INTERFACE == 2
    assert new.srt_trace_launch.argtypes == tk.LAUNCH_ARGTYPES
    assert new.srt_trace_launch.argtypes[-2:] == [tk.TraceParams,
                                                  ctypes.c_void_p]
    for version in (1, 3):
        with pytest.raises(RuntimeError,
                           match=f"interface {version}, want 2"):
            bind(lib(version))
    assert not hasattr(smoke, "bind_parent_trace")
    assert not hasattr(smoke, "bind_parent_probe")
