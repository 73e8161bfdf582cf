"""Procedural meshes for the preset scenes.

The port's own copy of ``simple_raytracer_tpu.models.meshgen`` (the
generators the mesh presets need, and the torus): deterministic triangle
soups in the {positions, per-vertex normals} layout of the triangle pool,
so the mesh configs run without a model file.
"""
from __future__ import annotations

import numpy as np


def _icosphere_verts_faces(subdivisions: int):
    """Shared-vertex icosphere topology: (verts (V,3) f64 unit, faces (F,3))."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]

    for _ in range(subdivisions):
        new_faces = []
        verts = list(verts)
        cache = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
        verts = np.asarray(verts)

    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def icosphere(subdivisions: int = 2, radius: float = 1.0):
    """Returns (positions (M,3,3), normals (M,3,3)) of a unit icosphere.

    Smooth per-vertex normals (the sphere normal) — exercises barycentric
    smooth shading like a Suzanne import would."""
    verts, fi = _icosphere_verts_faces(subdivisions)
    pos = (verts[fi] * radius).astype(np.float32)
    nrm = verts[fi].astype(np.float32)  # unit sphere: normal == position
    return pos, nrm


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth per-vertex normals — the shading an OBJ import
    with `vn` records carries (parser.cpp:115-131 pairs them per face)."""
    v = verts[faces]                                      # (F, 3, 3)
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])   # area-weighted
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(lens, 1e-20)


def organic_blob(subdivisions: int = 3, radius: float = 1.0, seed: int = 7):
    """A deterministic non-convex "sculpt" standing in for Suzanne.

    The reference's showcase model scene imports Blender's Suzanne
    (README.md:9-11); no such asset ships with either repo, so this
    generates a mesh with the same workload character: organic, asymmetric,
    NON-convex (rays can hit it several times; clusters overlap along rays),
    with smooth area-weighted vertex normals like an OBJ `vn` import.
    Built by displacing an icosphere radially with fixed low-frequency
    harmonics plus two gaussian lobes ("ears") and a snout bulge.

    Returns (positions (M,3,3) f32, normals (M,3,3) f32) triangle soup;
    subdivisions=3 gives 1280 triangles (Suzanne is ~1.4K triangulated)."""
    verts, faces = _icosphere_verts_faces(subdivisions)
    rng = np.random.default_rng(seed)
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]

    disp = np.zeros(len(verts))
    # low-frequency harmonics: smooth lumps over the whole surface
    for _ in range(6):
        f = rng.uniform(1.2, 3.5, size=3)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.05, 0.12)
        disp += amp * np.cos(f[0] * x + f[1] * y + f[2] * z + phase)

    def lobe(center, width, amp):
        c = np.asarray(center, np.float64)
        c /= np.linalg.norm(c)
        d2 = ((verts - c) ** 2).sum(axis=1)
        return amp * np.exp(-d2 / (2 * width * width))

    disp += lobe((0.55, 0.9, 0.1), 0.30, 0.55)    # ear +x
    disp += lobe((-0.55, 0.9, 0.1), 0.30, 0.55)   # ear -x
    disp += lobe((0.0, -0.15, 1.0), 0.45, 0.35)   # snout
    disp += lobe((0.0, 0.35, -1.0), 0.55, -0.25)  # dished back of the head

    r = (1.0 + disp) * radius
    # gentle squash: wider than tall, like a head
    out = verts * r[:, None]
    out[:, 1] *= 0.85
    out[:, 2] *= 0.95

    nrm = vertex_normals(out, faces)
    return out[faces].astype(np.float32), nrm[faces].astype(np.float32)


def torus(major: float = 1.0, minor: float = 0.35,
          n_major: int = 24, n_minor: int = 12):
    """Returns (positions, normals) of a torus triangle mesh: n_major x
    n_minor quads of the surface, two triangles each, with the exact
    surface normals at the vertices."""
    u = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    cx = (major + minor * np.cos(vv)) * np.cos(uu)
    cy = minor * np.sin(vv)
    cz = (major + minor * np.cos(vv)) * np.sin(uu)
    nx = np.cos(vv) * np.cos(uu)
    ny = np.sin(vv)
    nz = np.cos(vv) * np.sin(uu)
    pts = np.stack([cx, cy, cz], axis=-1)
    nrm = np.stack([nx, ny, nz], axis=-1)

    tris_p, tris_n = [], []
    for i in range(n_major):
        for j in range(n_minor):
            i1, j1 = (i + 1) % n_major, (j + 1) % n_minor
            quad_p = (pts[i, j], pts[i1, j], pts[i1, j1], pts[i, j1])
            quad_n = (nrm[i, j], nrm[i1, j], nrm[i1, j1], nrm[i, j1])
            tris_p += [[quad_p[0], quad_p[1], quad_p[2]],
                       [quad_p[0], quad_p[2], quad_p[3]]]
            tris_n += [[quad_n[0], quad_n[1], quad_n[2]],
                       [quad_n[0], quad_n[2], quad_n[3]]]
    return (np.asarray(tris_p, np.float32), np.asarray(tris_n, np.float32))
