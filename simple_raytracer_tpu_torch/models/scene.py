"""Editable host scene and its build into the device scene.

The counterpart of ``simple_raytracer_tpu.models.scene``: the same
primitive lists, materials and sky settings, and a ``build`` that pads
each category to the same power-of-two buckets with inactive slots, so
both packages hand their renderers identical arrays.  Mesh instances
point into a shared triangle pool and are flattened to world space at
build; a mesh of at least ``cluster_threshold`` triangles is reordered
into BVH clusters (``accel.py``) of ``cluster_size`` slots, or of 64 or
128 by the automatic rule, decided once per mesh topology.  The topology
is cached, so ``build(refit=True)`` after a transform edit recomputes
only the cluster boxes (``accel.refit_clusters``) and never changes K.
Under ``SRT_BVH_SUBBOX`` (not "0") a build of K % 64 == 0 clusters, a
refit too, also makes the BVH kernel's sub-box table (``sub_boxes``) from
the triangles' positions of that build.
A texture skybox (``Scene.skybox``, an (H, W, 3) f32 image, row 0 the
bottom) is uploaded once per image object and device
(``_build_skybox``).  ``load_mesh`` and ``import_model`` read an STL or
OBJ file into the pool (``io/stl.py``, ``io/obj.py``).  The editor's verbs
(``remove_shape``, ``duplicate_shape``, ``set_material``,
``remove_material``, ``set_model_transform``) change the host scene only;
the renderer sees an edit at its next ``update_scene``.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import accel
from ..ops.scene_types import (MATERIAL_FIELDS, SKY_VECTORS, TABLE_MAX_SLOTS,
                               TRI_VECTORS, DeviceScene, from_numpy)
from .materials import Material, MaterialSet, from_hex
from .shapes import Box, Model, Plane, Sphere, TrianglePool


def _bucket(n: int, minimum: int = 4) -> int:
    """Smallest power of two >= max(n, minimum); 0 stays 0, so an empty
    category has zero-capacity arrays."""
    if n == 0:
        return 0
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass
class SkySettings:
    """Defaults mirror the reference application's environment."""
    sun_focus: float = 25.0
    sun_intensity: float = 1.0
    sun_color: Tuple[float, float, float] = from_hex(0xFFFFD3)
    sun_direction: Tuple[float, float, float] = (
        0.7071067811865475, -0.7071067811865475, 0.0)  # normalize(1,-1,0)
    horizon_color: Tuple[float, float, float] = from_hex(0x374F62)
    zenith_color: Tuple[float, float, float] = from_hex(0x11334A)
    ground_color: Tuple[float, float, float] = from_hex(0x777777)


def _padded_clusters(c_raw: int) -> int:
    """Cluster count after padding: a power of two (at least 8) up to 512
    clusters, a multiple of 128 beyond."""
    if c_raw <= 512:
        return _bucket(c_raw, minimum=8)
    return ((c_raw + 127) // 128) * 128


def _auto_clusters(pos: np.ndarray) -> accel.Clusters:
    """BVH clusters of K = 64 triangles, or 128 when the padded K = 64
    table would exceed TABLE_MAX_SLOTS."""
    k = 128 if pos.shape[0] > TABLE_MAX_SLOTS else 64
    cl = accel.build_clusters(pos, k=k)
    if k == 64 and _padded_clusters(cl.slots.shape[0]) * 64 > TABLE_MAX_SLOTS:
        cl = accel.build_clusters(pos, k=128)
    return cl


def _pad_clusters(cl: accel.Clusters) -> accel.Clusters:
    """Padding clusters (every box plane at 3e38, no slots) fill the count
    up to _padded_clusters."""
    c_raw, k = cl.slots.shape
    c_cap = _padded_clusters(c_raw)
    pad_aabb = np.zeros((c_cap - c_raw, 8), np.float32)
    pad_aabb[:, 0:6] = 3.0e38
    return accel.Clusters(
        aabb=np.concatenate([cl.aabb, pad_aabb]),
        slots=np.concatenate([cl.slots,
                              np.full((c_cap - c_raw, k), -1, np.int32)]),
        order=cl.order, k=k)


def sub_boxes(pos: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """The (C * 8, 8) f32 sub-box table of the (C, K) cluster slots (-1
    empty) over the (T, 3, 3) triangles they index: box j of a cluster
    bounds the vertices of its slots [j * K / 8, (j + 1) * K / 8), in
    columns 0:6 as [lo, hi], zeros in 6:8; a range without a triangle is
    the sentinel box, 3e38 in both corners.  The JAX scene build's
    reductions (per-vertex masks, then min and max)."""
    c, k = slots.shape
    valid = slots >= 0
    si = np.clip(slots, 0, pos.shape[0] - 1)
    vx = pos[si].reshape(c, 8, (k // 8) * 3, 3)
    mx = np.repeat(valid.reshape(c, 8, k // 8, 1), 3, axis=2)
    big = np.float32(3.0e38)
    lo = np.where(mx, vx, big).min(axis=2)
    hi = np.where(mx, vx, -big).max(axis=2)
    empty = hi[:, :, 0:1] < lo[:, :, 0:1]
    lo = np.where(empty, big, lo)
    hi = np.where(empty, big, hi)
    out = np.zeros((c * 8, 8), np.float32)
    out[:, 0:3] = lo.reshape(c * 8, 3)
    out[:, 3:6] = hi.reshape(c * 8, 3)
    return out


def load_mesh(path, pool: TrianglePool) -> Tuple[int, int]:
    """Append the STL (by its extension) or OBJ file ``path`` to ``pool``;
    returns its (start, count) span.  A file that cannot be opened raises
    FileNotFoundError."""
    from ..io.obj import load_obj_model
    from ..io.stl import load_stl_model
    loader = (load_stl_model if str(path).lower().endswith(".stl")
              else load_obj_model)
    span = loader(path, pool)
    if span is None:
        raise FileNotFoundError(path)
    return span


class Scene:
    """Mutable scene: primitive lists, the shared triangle pool with its
    mesh instances, materials and sky settings."""

    # meshes of at least this many triangles are BVH-clustered; smaller
    # ones are intersected densely
    cluster_threshold: int = 512
    # slots per cluster: None for the automatic rule (64 while the padded
    # table has at most TABLE_MAX_SLOTS slots, else 128); an int forces K
    cluster_size: Optional[int] = None

    def __init__(self, default_material: bool = True):
        self.spheres: List[Sphere] = []
        self.planes: List[Plane] = []
        self.models: List[Model] = []
        self.pool = TrianglePool()
        self._box_span: Optional[Tuple[int, int]] = None
        self.materials = MaterialSet()
        self.sky = SkySettings()
        # (H, W, 3) f32 equirect texture, bottom-up; None: the gradient sky
        self.skybox: Optional[np.ndarray] = None
        # (image, {device: texture tensor}) of the last skybox built
        self._skybox_dev = None
        # a hint: False declares the scene enclosed (no ray reaches the
        # sky); results never depend on it
        self.sky_reachable: bool = True
        # (topology key, K) of the automatic rule, and ((K, topology key),
        # unpadded clusters) of the last build: refits reuse both
        self._auto_k = None
        self._cluster_topo = None
        if default_material:
            self.materials.push(Material(), "Material0")

    @property
    def all_shapes(self):
        return [*self.spheres, *self.planes, *self.models]

    def add_sphere(self, position, radius, material: int = 0) -> Sphere:
        s = Sphere(material=material, position=tuple(position),
                   radius=float(radius))
        self.spheres.append(s)
        return s

    def add_plane(self, position, normal, material: int = 0) -> Plane:
        p = Plane(material=material, position=tuple(position),
                  normal=tuple(normal))
        self.planes.append(p)
        return p

    def add_material(self, material: Material,
                     name: Optional[str] = None) -> int:
        return self.materials.push(material, name)

    def add_model(self, span: Tuple[int, int], material: int = 0,
                  transform: Optional[np.ndarray] = None) -> Model:
        """An instance of the pool's triangles [start, start + count)."""
        start, count = span
        m = Model(material=material, triangle_index=start,
                  num_triangles=count)
        if transform is not None:
            m.transform = np.asarray(transform, np.float32)
        self.models.append(m)
        return m

    def add_box(self, position, size=(2.0, 2.0, 2.0),
                material: int = 0) -> Model:
        """A box instance; the 12 shared triangles enter the pool on
        first use."""
        if self._box_span is None:
            self._box_span = Box.create_triangles(self.pool)
        m = Box.model(material, self._box_span, tuple(position), tuple(size))
        self.models.append(m)
        return m

    def import_model(self, path, material: int = 0,
                     transform: Optional[np.ndarray] = None) -> Model:
        """Load an STL or OBJ file into the pool (``load_mesh``) and add an
        instance of it."""
        return self.add_model(load_mesh(path, self.pool), material=material,
                              transform=transform)

    # -- the editor's verbs (the reference's editor windows) ------------
    def remove_shape(self, shape) -> None:
        """Delete ``shape``.  Matches by identity, not equality: shapes
        are dataclasses that compare by value, so a duplicate equals its
        source, and a Model's ndarray transform makes == raise."""
        for lst in (self.spheres, self.planes, self.models):
            for i, s in enumerate(lst):
                if s is shape:
                    del lst[i]
                    return
        raise ValueError("shape not in scene")

    def duplicate_shape(self, shape):
        """Append a deep copy of ``shape`` and return it; a model's copy
        shares the mesh span (instancing) but has its own fields."""
        dup = copy.deepcopy(shape)
        if isinstance(shape, Sphere):
            self.spheres.append(dup)
        elif isinstance(shape, Plane):
            self.planes.append(dup)
        elif isinstance(shape, Model):
            self.models.append(dup)
        else:
            raise TypeError(type(shape))
        return dup

    def set_material(self, shape, material_index: int) -> None:
        """Assign material ``material_index``, which must exist."""
        if not 0 <= material_index < len(self.materials):
            raise IndexError(material_index)
        shape.material = material_index

    def remove_material(self, index: int) -> None:
        """Delete a material; every shape's index is renumbered
        (``MaterialSet.remove``)."""
        self.materials.remove(index, self.all_shapes)

    def set_model_transform(self, model: Model, transform) -> None:
        """Replace a model's instance transform (its world box follows at
        build)."""
        model.transform = np.asarray(transform, np.float32)

    def _clusters(self, pos: np.ndarray, refit: bool) -> accel.Clusters:
        """The padded clusters of the (T, 3, 3) world triangles.  K is
        ``cluster_size``, else the automatic rule's, decided once per mesh
        topology (the pool's size and the models' spans).  With ``refit``
        and the topology of the last build, only the boxes are
        recomputed."""
        topo = (len(self.pool),
                tuple((m.triangle_index, m.num_triangles)
                      for m in self.models))
        k = self.cluster_size
        if not k and self._auto_k is not None and self._auto_k[0] == topo:
            k = self._auto_k[1]
        cached = self._cluster_topo
        if refit and k and cached is not None and cached[0] == (k, *topo):
            return _pad_clusters(accel.refit_clusters(cached[1], pos))
        if k:
            cl = accel.build_clusters(pos, k=k)
        else:
            cl = _auto_clusters(pos)
            self._auto_k = (topo, cl.k)
        self._cluster_topo = ((cl.k, *topo), cl)
        return _pad_clusters(cl)

    def _triangle_arrays(self, refit: bool = False) -> dict:
        """World-space triangles (BVH-reordered and clustered at or above
        cluster_threshold), padded to a power-of-two bucket."""
        pos = [np.zeros((0, 3, 3), np.float32)]
        nrm = [np.zeros((0, 3, 3), np.float32)]
        mat = [np.zeros((0,), np.int32)]
        for m in self.models:
            wpos, wnrm = m.world_triangles(self.pool)
            pos.append(wpos)
            nrm.append(wnrm)
            mat.append(np.full((wpos.shape[0],), m.material, np.int32))
        pos, nrm, mat = (np.concatenate(a) for a in (pos, nrm, mat))
        n = pos.shape[0]
        out = {}
        if n >= self.cluster_threshold:
            cl = self._clusters(pos, refit)
            pos, nrm, mat = pos[cl.order], nrm[cl.order], mat[cl.order]
            out["clusters.aabb"] = cl.aabb
            out["clusters.slots"] = cl.slots
            # the sub-box table, only where the knob could read it: a
            # default build, or a refit, pays nothing for it; every build
            # under the knob (a refit too) makes it from the triangles'
            # positions now
            if (cl.k % 64 == 0
                    and os.environ.get("SRT_BVH_SUBBOX", "0") != "0"):
                out["clusters.sub_aabb"] = sub_boxes(pos, cl.slots)
        pad = _bucket(n) - n
        # padding triangles: all-zero vertices, inactive
        pos = np.concatenate([pos, np.zeros((pad, 3, 3), np.float32)])
        nrm = np.concatenate([nrm, np.zeros((pad, 3, 3), np.float32)])
        for i, k in enumerate(TRI_VECTORS[:3]):
            out[f"triangles.{k}"] = pos[:, i]
        for i, k in enumerate(TRI_VECTORS[3:]):
            out[f"triangles.{k}"] = nrm[:, i]
        out["triangles.material"] = np.concatenate(
            [mat, np.zeros((pad,), np.int32)])
        out["triangles.active"] = np.arange(n + pad) < n
        return out

    def arrays(self, refit: bool = False) -> dict:
        """The padded scene as flat numpy arrays (``from_numpy`` names),
        with the skybox image as it is, when there is one; ``refit`` as in
        ``build``."""
        out = {} if self.skybox is None else {"skybox": self.skybox}
        n = len(self.spheres)
        cap = _bucket(n)
        out["spheres.center"] = np.zeros((cap, 3), np.float32)
        out["spheres.radius"] = np.ones((cap,), np.float32)
        out["spheres.material"] = np.zeros((cap,), np.int32)
        out["spheres.active"] = np.arange(cap) < n
        for i, s in enumerate(self.spheres):
            out["spheres.center"][i] = s.position
            out["spheres.radius"][i] = s.radius
            out["spheres.material"][i] = s.material

        n = len(self.planes)
        cap = _bucket(n)
        out["planes.position"] = np.zeros((cap, 3), np.float32)
        out["planes.normal"] = np.zeros((cap, 3), np.float32)
        out["planes.normal"][:, 1] = 1.0
        out["planes.material"] = np.zeros((cap,), np.int32)
        out["planes.active"] = np.arange(cap) < n
        for i, p in enumerate(self.planes):
            out["planes.position"][i] = p.position
            out["planes.normal"][i] = p.normal
            out["planes.material"][i] = p.material

        out.update(self._triangle_arrays(refit))

        mats = self.materials.materials or [Material()]
        pad = _bucket(len(mats)) - len(mats)
        fill = {"refraction_index": 1.0}
        for k in MATERIAL_FIELDS:
            out[f"materials.{k}"] = np.array(
                [getattr(m, k) for m in mats] + [fill.get(k, 0.0)] * pad,
                np.float32)
        for k in ("color", "emission"):
            out[f"materials.{k}"] = np.array(
                [getattr(m, k) for m in mats] + [(0, 0, 0)] * pad, np.float32)

        out["sky.sun_focus"] = np.float32(self.sky.sun_focus)
        out["sky.sun_intensity"] = np.float32(self.sky.sun_intensity)
        for k in SKY_VECTORS:
            out[f"sky.{k}"] = np.asarray(getattr(self.sky, k), np.float32)
        out["sky_reachable"] = self.sky_reachable
        return out

    def build(self, device, refit: bool = False) -> DeviceScene:
        """The device scene on ``device``.  ``refit=True`` reuses the
        cached cluster topology for moved geometry (O(T) instead of a new
        BVH); a later full build restores the boxes' quality."""
        return self.build_replicas([device], refit)[0]

    def build_replicas(self, devices, refit: bool = False) -> list:
        """One device scene on each of ``devices`` (in their order), all
        from one flattening and cluster build on the host: the replicas
        of a render spread over several devices (``parallel/shard.py``)."""
        arrays = self.arrays(refit)
        return [from_numpy(dict(arrays, skybox=self._build_skybox(d)), d)
                for d in devices]

    def _build_skybox(self, device):
        """The skybox as a tensor on ``device``, or None for the gradient
        sky, which also drops the cache (it holds the old image and its
        textures).  Memoized per image object and device, as the JAX
        ``Scene._build_skybox`` is: uploading tens of MB again for edits
        that do not touch the skybox would cost every build.  The cache
        holds the image itself and compares with ``is`` (an id() alone can
        be reused by a new array at a freed one's address).  Replace
        ``scene.skybox`` to change the environment; an image changed in
        place keeps its identity and the cached textures."""
        if self.skybox is None:
            self._skybox_dev = None
            return None
        device = torch.device(device)
        if self._skybox_dev is None or self._skybox_dev[0] is not self.skybox:
            self._skybox_dev = (self.skybox, {})
        textures = self._skybox_dev[1]
        if device not in textures:
            textures[device] = torch.tensor(
                np.asarray(self.skybox, np.float32), device=device)
        return textures[device]
