"""The presets' procedural sculpt, frozen for the benchmark.

A copy of the mesh generator that the repository's mesh presets use (an
icosphere displaced radially by fixed low-frequency harmonics, two ears,
a snout and a dished back, with area-weighted smooth vertex normals),
kept here so that the benchmark's inputs cannot move with the program.
``generate(subdivisions)`` gives 20 * 4^subdivisions triangles as
(positions (M, 3, 3) f32, normals (M, 3, 3) f32) in object space.
"""
from __future__ import annotations

import numpy as np


def _icosphere(subdivisions: int):
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


def _vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v = verts[faces]
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(lens, 1e-20)


def generate(subdivisions: int = 3, radius: float = 1.0, seed: int = 7):
    verts, faces = _icosphere(subdivisions)
    rng = np.random.default_rng(seed)
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    disp = np.zeros(len(verts))
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

    disp += lobe((0.55, 0.9, 0.1), 0.30, 0.55)
    disp += lobe((-0.55, 0.9, 0.1), 0.30, 0.55)
    disp += lobe((0.0, -0.15, 1.0), 0.45, 0.35)
    disp += lobe((0.0, 0.35, -1.0), 0.55, -0.25)
    out = verts * ((1.0 + disp) * radius)[:, None]
    out[:, 1] *= 0.85
    out[:, 2] *= 0.95
    nrm = _vertex_normals(out, faces)
    return out[faces].astype(np.float32), nrm[faces].astype(np.float32)
