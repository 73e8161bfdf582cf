"""Shared helpers for the tests that hold the PyTorch port
(simple_raytracer_tpu_torch) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU, as the JAX package's own tests run it.
"""
import collections
import contextlib
import functools
import itertools
import json
import math
import os
import signal
import subprocess
import tempfile
import urllib.request
from pathlib import Path

import numpy as np
import torch

from simple_raytracer_tpu.ops.vec import Vec3 as JVec3
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.ops.scene_types import (MATERIAL_FIELDS,
                                                        SKY_VECTORS,
                                                        TRI_VECTORS)
from simple_raytracer_tpu_torch.ops.vec import Vec3 as TVec3


# -- the BVH builders of both packages --------------------------------------

BUILDERS = ("sah", "median")


def jax_native_accel():
    """``simple_raytracer_tpu.accel`` with its native library loaded, the
    builder that package uses by default.  In a checkout without
    native/libsrt_native.so the library is built as native/Makefile builds
    it, into a temporary directory of this process, and named through
    SRT_NATIVE_LIB while the JAX package loads it (it keeps the library
    it loaded); the variable is cleared after, since the port's
    host_library would load the library it names instead of its own."""
    import simple_raytracer_tpu.accel as jaccel
    if jaccel.native_available():
        return jaccel
    src = (Path(jaccel.__file__).resolve().parents[1] / "native"
           / "srt_native.cpp")
    out = Path(tempfile.mkdtemp(prefix="srt_native_")) / "libsrt_native.so"
    subprocess.run([os.environ.get("CXX") or "g++", "-O3", "-march=native",
                    "-fPIC", "-std=c++17", "-Wall", "-shared", "-o",
                    str(out), str(src)], check=True, capture_output=True)
    os.environ["SRT_NATIVE_LIB"] = str(out)
    try:
        jaccel._LIB_TRIED = False
        assert jaccel.native_available()
    finally:
        del os.environ["SRT_NATIVE_LIB"]
    return jaccel


def use_builder(monkeypatch, builder: str) -> None:
    """Put both packages on one BVH builder: "sah", each one's default
    (the JAX package's native library, the port's host library), or
    "median", the NumPy median split of both (the JAX package without its
    library, the port's build_bvh with force_python=True)."""
    from simple_raytracer_tpu_torch import accel
    jaccel = jax_native_accel()
    if builder == "median":
        monkeypatch.setattr(jaccel, "_load_library", lambda: None)
        build_bvh = accel.build_bvh
        monkeypatch.setattr(accel, "build_bvh", lambda *a, **kw: build_bvh(
            *a, **{**kw, "force_python": True}))
    else:
        assert builder == "sah", builder


def jax_scene_arrays(ds) -> dict:
    """Flatten a JAX DeviceScene into the numpy arrays that the port's
    ``from_numpy`` takes (the port's counterpart of carrying weights)."""
    a = lambda v: np.asarray(v)
    v3 = lambda v: np.stack([a(v.x), a(v.y), a(v.z)], axis=-1)
    out = {
        "spheres.center": v3(ds.spheres.center),
        "spheres.radius": a(ds.spheres.radius),
        "spheres.material": a(ds.spheres.material),
        "spheres.active": a(ds.spheres.active),
        "planes.position": v3(ds.planes.position),
        "planes.normal": v3(ds.planes.normal),
        "planes.material": a(ds.planes.material),
        "planes.active": a(ds.planes.active),
        "sky.sun_focus": a(ds.sky.sun_focus),
        "sky.sun_intensity": a(ds.sky.sun_intensity),
        "sky_reachable": ds.flags.sky_reachable,
    }
    tr = ds.triangles
    for k in ("v0", "v1", "v2", "n0", "n1", "n2"):
        out[f"triangles.{k}"] = v3(getattr(tr, k))
    out["triangles.material"] = a(tr.material)
    out["triangles.active"] = a(tr.active)
    if tr.clusters is not None:
        # the cluster slots from the TPU kernel's row table: column 19
        # marks a filled slot, column 20 holds its triangle index
        table = a(tr.clusters.table_t)
        c = tr.clusters.aabb.shape[0]
        out["clusters.aabb"] = a(tr.clusters.aabb)
        out["clusters.slots"] = np.where(table[:, 19] > 0, table[:, 20],
                                         -1).astype(np.int32).reshape(c, -1)
        if tr.clusters.sub_aabb is not None:
            out["clusters.sub_aabb"] = a(tr.clusters.sub_aabb)
    m = ds.materials
    for k in ("smoothness", "metallic", "specular", "emission_strength",
              "transmittance", "refraction_index"):
        out[f"materials.{k}"] = a(getattr(m, k))
    out["materials.color"] = v3(m.color)
    out["materials.emission"] = v3(m.emission)
    for k in ("sun_color", "sun_direction", "horizon_color", "zenith_color",
              "ground_color"):
        out[f"sky.{k}"] = v3(getattr(ds.sky, k))
    if ds.skybox is not None:
        out["skybox"] = jax_skybox_image(ds.skybox)
    return out


def port_scene_arrays(ts) -> dict:
    """The port's DeviceScene back to the from_numpy names (on the host)."""
    out = {}
    for cat, fields in (("spheres", ("center", "radius", "material",
                                     "active")),
                        ("planes", ("position", "normal", "material",
                                    "active")),
                        ("triangles", TRI_VECTORS + ("material", "active")),
                        ("materials", MATERIAL_FIELDS + ("color",
                                                         "emission"))):
        for f in fields:
            out[f"{cat}.{f}"] = getattr(getattr(ts, cat), f).cpu().numpy()
    if ts.triangles.clusters is not None:
        out["clusters.aabb"] = ts.triangles.clusters.aabb.numpy()
        out["clusters.slots"] = ts.triangles.clusters.slots.numpy()
        if ts.triangles.clusters.sub_aabb is not None:
            out["clusters.sub_aabb"] = ts.triangles.clusters.sub_aabb.numpy()
    out["sky.sun_focus"] = ts.sky.sun_focus
    out["sky.sun_intensity"] = ts.sky.sun_intensity
    for k in SKY_VECTORS:
        out[f"sky.{k}"] = np.array(getattr(ts.sky, k), np.float32)
    out["sky_reachable"] = ts.sky_reachable
    return out


def jax_skybox_image(skybox) -> np.ndarray:
    """A JAX DeviceScene's skybox as the (H, W, 3) f32 image it was built
    from.  A quad-packed ``SkyboxTex`` is decoded from its anchor texels
    (``quad[..., 0]``) with numpy, by the expressions ``pack_skybox_quad``
    accepted it with, so the image comes back bit for bit."""
    from simple_raytracer_tpu.io.image import _rgbe_to_float
    from simple_raytracer_tpu.ops.scene_types import SkyboxTex
    if not isinstance(skybox, SkyboxTex):
        return np.stack([np.asarray(c) for c in skybox], axis=-1)
    q = np.asarray(skybox.quad)[..., 0]
    channels = np.stack([(q >> (8 * c)) & 0xFF for c in range(4)],
                        axis=-1).astype(np.uint8)
    if skybox.mode == "rgb8":
        return np.power(channels[..., :3].astype(np.float32) / 255.0,
                        np.float32(2.2), dtype=np.float32)
    return _rgbe_to_float(channels)


def unit_vectors(rng: np.random.Generator, n: int) -> np.ndarray:
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def seeds(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def jvec(a: np.ndarray) -> JVec3:
    import jax.numpy as jnp
    return JVec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                 jnp.asarray(a[:, 2]))


def tvec(a: np.ndarray) -> TVec3:
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return TVec3(t[:, 0], t[:, 1], t[:, 2])


def to_np(v) -> np.ndarray:
    """A Vec3 of either package -> (N, 3) numpy array."""
    return np.stack([np.asarray(c) for c in v], axis=-1)


# The BVH kernel's warp walk (csrc/bvh_kernel.cu: ``warp_walk``) and its
# constants (tests/test_torch_bvh_two_level.py:
# test_constants_match_the_cuda_source): a warp, the slots of a chunk, the
# warp's ring of chunk buffers, the most admitting lanes that split a
# chunk's MT, the groups of a gate batch
LANES, CHUNK, STAGES, SPLIT_MAX, BATCH = 32, 64, 2, 16, 16
NO_KEY = torch.iinfo(torch.int64).max


def walk_feed(clusters, table, form):
    """The rows the walk reads, as ``col(rows)(j)`` of the plain version's
    arithmetic (``bvh._mt``'s slot-table columns from the staged MT table,
    or the Plucker coefficients), and each slot's global index."""
    if form == "plucker":
        coeffs = bvh.plucker_table(table)
        return (lambda s: lambda j: coeffs[s, j]), clusters.hierarchy.gidx
    st = bvh.stage_slots(table, clusters.hierarchy.gidx)
    where = {0: 0, 1: 1, 2: 2, 3: 4, 4: 5, 5: 6, 6: 8, 7: 9, 8: 10, 19: 7}
    return ((lambda s: lambda j: st[s, where[j]]),
            st[:, 3].contiguous().view(torch.int32))


def single_threaded(fn):
    """``fn`` run with torch on one intra-op thread (the count restored
    after): an emulation issues many small ops, which the intra-op pools
    of several test workers on one machine slow by an order of magnitude;
    the ops are elementwise, integer sums and exact minima, so the count
    changes no result."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_num_threads(threads)
    return run


@single_threaded
def warp_walk_emulation(o: TVec3, d: TVec3, alive, t_init, clusters, table,
                        form="mt", perm=None, count=None, batch=BATCH,
                        split_max=SPLIT_MAX, stages=STAGES, sub=None):
    """The warp walk of one launch in PyTorch -> ((t, slot) as the kernel
    writes them, counts of what the walk did):

    - the rays in warps of LANES, in the launch's order (``perm``, a
      compacted launch's ray order with the first ``count`` listed, or
      every ray in index order);
    - ``next_item``'s batched gates: ``batch`` groups of the front-to-back
      order tested together against each lane's t at that moment, a
      group's 16 supers when the warp enters it, a super's 16 clusters
      when it enters that; a gate passes when any lane admits the box, and
      each lane keeps its own gates;
    - the ring of ``stages`` chunk buffers: each chunk (CHUNK slots) is
      found, and its gates tested, before the MT of the chunks ahead of
      it, right after the turn of the chunk whose buffer it takes (with
      the lanes' t of that moment; 1: each chunk found just before its
      turn);
    - each lane's test of the cluster's box again, with its t then, at
      each chunk's turn;
    - MT split pair by pair when at most ``split_max`` lanes admit the
      chunk (lane l tests slots l, l + 32, ... of each admitting ray in
      turn, keeps its least (t bits << 32 | global index) key, the warp
      takes the least key and the lowest lane holding it, the ray's lane
      commits), else every admitting lane tests every slot itself (one
      commit of its least key: the commit rule is a lexicographic minimum,
      so slot-by-slot commits in order end in the same (t, index, first
      slot));
    - with ``sub`` = (the coarsened (C * 8, 8) sub-box table, the slots a
      sub-box bounds), the sub-box form: when the walk takes a super
      (``super_words``), its block of the table is copied (its 16
      clusters' rows, clamped to the table's end) and each lane slabs the
      sub-boxes of every cluster of it that it admits, against its t then
      (the t of the super's cluster gates), keeping a word of the ranges
      it may meet; a cluster no lane's word wants is skipped, and so is
      each chunk of it that holds no wanted range; at a chunk's turn a
      lane runs MT only if its word wants a range of the chunk, and only
      over the slots of its ranges (split: each admitting ray's wanted
      slots, 32 lanes at a time).

    The counts include ``lane_slots`` (32 x the warp-wide MT steps: a
    step over each wanted range's slots with every admitting lane, or
    each admitting ray's wanted slots 32 at a time), ``sub_tests`` (the
    lanes' sub-box slab tests) and ``chunks_skipped``."""
    n_rays = o.x.shape[0]
    n_cl, k = clusters.slots.shape
    hier = clusters.hierarchy
    cols, gidx = walk_feed(clusters, table, form)
    mt = bvh._mt_plucker if form == "plucker" else bvh._mt
    if sub is not None:
        sub_t, rows = sub
    live = alive > 0
    inv = bvh.inverse(d)
    order = bvh.front_to_back(hier.groups, o, live).long()
    ray_list = torch.arange(n_rays) if perm is None else perm.long()
    n_listed = n_rays if perm is None else int(count)
    t_out = torch.full((n_rays,), math.inf)
    slot_out = torch.full((n_rays,), -1, dtype=torch.int32)
    cnt = collections.Counter()
    for w0 in range(0, n_rays, LANES):
        ray = ray_list[w0:w0 + LANES]
        lanes = torch.arange(ray.numel())
        listed = (w0 + lanes < n_listed) & live[ray]
        if not listed.any():
            continue       # the warp skips the walk: every lane a miss
        pick = lambda v: TVec3(v.x[ray], v.y[ray], v.z[ray])
        ro, rd, ri = pick(o), pick(d), pick(inv)
        best_t = t_init[ray].clone()
        best_i = torch.full_like(ray, -1)
        best_s = torch.full_like(ray, -1)
        cnt["walked"] += int(listed.sum())

        def gates(boxes, parent):
            """(N, lanes): each lane's slab tests of N boxes against its
            best t now, where its parent gate passed."""
            return bvh.slab_maybe(boxes, ro, ri, best_t, listed) & parent

        def commit(lane, key, slot):
            """The commit rule at ``lane`` of a candidate key (t bits << 32
            | index; NO_KEY: none): the least (t, index) wins."""
            has = key != NO_KEY
            lane, key, slot = lane[has], key[has], slot[has]
            t = (key >> 32).to(torch.int32).view(torch.float32)
            g = key & 0xFFFFFFFF
            bt, bi = best_t[lane], best_i[lane]
            win = (t <= bt) & ((t < bt) | (g < bi))
            best_t[lane] = torch.where(win, t, bt)
            best_i[lane] = torch.where(win, g, bi)
            best_s[lane] = torch.where(win, slot, best_s[lane])

        def chunk_turn(c, base, found, word, first_chunk):
            n = min(CHUNK, k - base)
            in_box = found & gates(hier.boxes[c:c + 1], True)[0]
            ok = in_box
            if sub is not None:
                # (lanes, n): the lane's word wants slot base + j's range
                want = ((word[:, None] >> ((base + torch.arange(n))
                                           // rows)[None, :]) & 1) > 0
                ok = in_box & want.any(dim=1)
            if first_chunk and (in_box & (word != 0)).any():
                cnt["visits"] += 1
                cnt["pairs"] += int((in_box & (word != 0)).sum())
            if not ok.any():
                cnt["wasted"] += 1
                return
            cnt["chunks"] += 1
            first = min(c, n_cl - 1) * k + base
            slots = torch.arange(first, first + n)
            admit = ok.nonzero()[:, 0]
            q = lambda v: v[admit][:, None]
            t, valid = mt(q(ro.x), q(ro.y), q(ro.z), q(rd.x), q(rd.y),
                          q(rd.z), cols(slots[None, :]))          # (A, n)
            if sub is not None:
                valid = valid & want[admit]
                wanted = want[admit]
                if admit.numel() > split_max:
                    cnt["lane_slots"] += LANES * int(wanted.any(0).sum())
                else:
                    cnt["lane_slots"] += LANES * int(
                        ((wanted.sum(1) + LANES - 1) // LANES).sum())
            elif admit.numel() > split_max:
                cnt["lane_slots"] += LANES * n
            else:
                cnt["lane_slots"] += LANES * admit.numel() * (
                    (n + LANES - 1) // LANES)
            key = torch.where(valid, (t.view(torch.int32).long() << 32)
                              | gidx[slots].long()[None, :], NO_KEY)
            if admit.numel() > split_max:
                # each admitting lane alone, every slot in order
                least, at = key.min(dim=1)
                commit(admit, least, slots[at])
                return
            # split: lane l holds slots l, l + 32, ...; its least key (its
            # first slot on a tie), then the warp's least key and the
            # lowest lane holding it
            cnt["split"] += 1
            pad = -n % LANES
            keys = torch.cat([key, torch.full((key.shape[0], pad), NO_KEY)],
                             1).view(key.shape[0], -1, LANES)  # (A, j, l)
            lane_key, lane_j = keys.min(dim=1)                  # (A, l)
            least = lane_key.min(dim=1).values                  # (A,)
            src = (lane_key == least[:, None]).long().argmax(dim=1)
            j = lane_j.gather(1, src[:, None])[:, 0]
            slot = first + j * LANES + src
            commit(admit, least, torch.where(least != NO_KEY, slot, -1))

        def super_words(s, found, c_mask):
            """The sub-box form's batch when the walk takes super s: the
            copy of its sub-box block (its 16 clusters' rows, clamped to
            the table's end), then each lane's word of each found cluster
            it admits, from the block, with its t now: (16, lanes) words;
            a found cluster no lane's word wants is counted skipped."""
            first = min(s * bvh.SUPER, n_cl - 1)
            n_copy = min(bvh.SUPER, n_cl - first)
            block = sub_t[first * 8:(first + n_copy) * 8]
            assert block.shape[0] == n_copy * 8
            words = torch.zeros((bvh.SUPER, ray.numel()), dtype=torch.long)
            for ci in found:
                at = min(s * bvh.SUPER + ci, n_cl - 1) - first
                assert 0 <= at < n_copy
                boxes = block[at * 8:at * 8 + k // rows]
                hit = gates(boxes, c_mask[ci])              # (div, lanes)
                cnt["sub_tests"] += int(c_mask[ci].sum()) * boxes.shape[0]
                words[ci] = (hit.long() << torch.arange(
                    boxes.shape[0])[:, None]).sum(0)
                cnt["sub_skipped"] += int(not words[ci].any())
            return words

        def next_item():
            """The warp's chunks in order, each found (its gates tested)
            only when the walk asks for it: (cluster, first slot, each
            lane's gate of the cluster when it was tested)."""
            for j0 in range(0, order.numel(), batch):
                groups = order[j0:j0 + batch]
                g_mask = gates(hier.groups[groups], True)
                cnt["group_tests"] += groups.numel()
                for gi in g_mask.any(dim=1).nonzero()[:, 0].tolist():
                    g = int(groups[gi])
                    s_mask = gates(
                        hier.supers[g * bvh.GROUP:(g + 1) * bvh.GROUP],
                        g_mask[gi])
                    for si in s_mask.any(dim=1).nonzero()[:, 0].tolist():
                        s = g * bvh.GROUP + si
                        c_mask = gates(
                            hier.boxes[s * bvh.SUPER:(s + 1) * bvh.SUPER],
                            s_mask[si])
                        found = c_mask.any(dim=1).nonzero()[:, 0].tolist()
                        if sub is not None and found:
                            words = super_words(s, found, c_mask)
                        for ci in found:
                            c = s * bvh.SUPER + ci
                            word = torch.full_like(ray, -1)
                            wanted = range(0, k, CHUNK)
                            if sub is not None:
                                word = words[ci]
                                union = int(np.bitwise_or.reduce(
                                    word.numpy()))
                                if not union:
                                    continue    # counted by super_words
                                wanted = [b for b in range(0, k, CHUNK)
                                          if any((union >> r) & 1 for r in
                                                 range(b // rows, (min(
                                                     b + CHUNK, k) - 1)
                                                     // rows + 1))]
                                cnt["chunks_skipped"] += (
                                    len(range(0, k, CHUNK)) - len(wanted))
                            for i, base in enumerate(wanted):
                                yield c, base, c_mask[ci], word, i == 0

        # the ring: the next chunks are found before the MT of the chunks
        # ahead of them, each after the turn of the chunk whose buffer it
        # takes
        items = next_item()
        ring = collections.deque(itertools.islice(items, stages))
        while ring:
            chunk_turn(*ring.popleft())
            ring.extend(itertools.islice(items, 1))
        won = best_i >= 0
        t_out[ray] = torch.where(won, best_t, math.inf)
        slot_out[ray] = torch.where(won, best_s, -1).to(torch.int32)
    return (t_out, slot_out), cnt


# -- the port's viewer on the CPU (tests/test_torch_viewer.py,
#    test_torch_gizmo.py) ----------------------------------------------------

# seconds a server test may take in all; each HTTP request has its own
# REQUEST_TIMEOUT
SERVER_TEST_TIMEOUT = 60
REQUEST_TIMEOUT = 10


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fail the block with TimeoutError after ``seconds`` (SIGALRM, on the
    main thread, where pytest runs a test)."""
    def expire(signum, frame):
        raise TimeoutError(f"the test took more than {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@contextlib.contextmanager
def viewer_server(scene, camera, width: int = 32, height: int = 24,
                  **options):
    """The port's RenderLoop on the CPU over ``scene`` (1 spp, 2 bounces
    unless ``options`` say otherwise) behind a ThreadingHTTPServer on a
    free localhost port; yields (server, loop) and stops both."""
    import threading

    from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
    from simple_raytracer_tpu_torch.viewer import (RenderLoop,
                                                   ThreadingHTTPServer,
                                                   make_handler)
    opts = RenderOptions(width=width, height=height,
                         **dict(dict(num_samples=1, num_bounces=2),
                                **options))
    renderer = Renderer(opts, scene=scene, device="cpu")
    loop = RenderLoop(renderer, camera, scene=scene)
    loop.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              make_handler(loop, width, height))
    # a short poll interval: shutdown() waits for the server's next poll
    thread = threading.Thread(target=srv.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    try:
        yield srv, loop
    finally:
        srv.shutdown()
        srv.server_close()
        loop.stop()


def http_get(srv, path):
    port = srv.server_address[1]
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=REQUEST_TIMEOUT)


def http_post(srv, path, payload):
    port = srv.server_address[1]
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 method="POST")
    return urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT)
