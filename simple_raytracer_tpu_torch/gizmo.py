"""Depth-correct 3-D gizmo handles, the tiny-gizmo analog, on the host.

The port's copy of ``simple_raytracer_tpu.gizmo``.  The reference
manipulates shapes through tiny-gizmo, which lathes real 3-D handle meshes
(arrows, rings, stretch boxes; lib/tiny-gizmo.cpp:309-327), raycasts the
mouse against those meshes in world space (tiny-gizmo.cpp:115-134) and
draws them as geometry, so handles occlude correctly and a drag lands on
the handle the user sees.  This module keeps that without a rasterizer:

- handle geometry is made in WORLD space as capsule chains
  (`handle_capsules`) sized for a constant SCREEN size (`handle_scale`,
  tiny-gizmo's screenspace_scale);
- the mouse ray is hit-tested analytically against those capsules
  (`ray_hit`: ray/capsule intersection instead of a triangle-mesh
  raycast: the same contact surface, no mesh);
- occlusion is exact along the very ray tested: the handle wins only
  where its hit t is nearer than the scene's own nearest hit (the viewer
  compares against SceneEditor.pick_t);
- for drawing, `polylines` emits the same geometry as vertex chains that
  the viewer projects and depth-tests per vertex, so the overlay shows
  the handles the hit test sees, hidden parts dimmed.

Everything is float64 numpy on the host: the gizmo is editor furniture (a
hundred rays a frame), not render work.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

AXES = {"x": np.array([1.0, 0.0, 0.0]),
        "y": np.array([0.0, 1.0, 0.0]),
        "z": np.array([0.0, 0.0, 1.0])}

# handle proportions, in units of the per-frame `handle_scale` factor
# (shapes follow tiny-gizmo.cpp:309-327: arrow = shaft + cone, ring =
# torus at 1.0, scale = shaft + box tip)
_SHAFT_LO, _SHAFT_HI = 0.25, 1.0
_TIP_HI = 1.30
_SHAFT_R, _TIP_R = 0.045, 0.11
_RING_RADIUS, _RING_R = 1.0, 0.05
_RING_SEGS = 24


def handle_scale(center, cam_position, fov: float) -> float:
    """World-units-per-handle-unit so handles keep constant screen size
    (tiny-gizmo's screenspace_scale): ~12% of the vertical frustum at
    the handle's distance."""
    dist = float(np.linalg.norm(np.asarray(center, np.float64)
                                - np.asarray(cam_position, np.float64)))
    return max(0.12 * dist * math.tan(fov / 2.0) * 2.0, 1e-6)


def handle_capsules(center, mode: str, scale: float
                    ) -> Dict[str, List[Tuple[np.ndarray, np.ndarray,
                                              float]]]:
    """Per-axis world-space capsule list [(p0, p1, radius), ...] for the
    given mode's handle set.  The hit-test contract: a mouse ray grabs
    the axis whose capsule it enters first."""
    c = np.asarray(center, np.float64)
    out: Dict[str, List[Tuple[np.ndarray, np.ndarray, float]]] = {}
    for name, a in AXES.items():
        caps = []
        if mode == "rotate":
            # ring around `a`: RING_SEGS chained capsules on the circle
            u, v = _ring_basis(a)
            ang = np.linspace(0.0, 2.0 * math.pi, _RING_SEGS + 1)
            pts = (c[None, :] + _RING_RADIUS * scale
                   * (np.cos(ang)[:, None] * u[None, :]
                      + np.sin(ang)[:, None] * v[None, :]))
            caps = [(pts[i], pts[i + 1], _RING_R * scale)
                    for i in range(_RING_SEGS)]
        else:
            # translate arrow / scale stretch: shaft capsule + fat tip
            # capsule (cone/box contact surface, tiny-gizmo.cpp:115-134
            # raycasts the mesh; a capsule of the tip's radius matches
            # its silhouette within a pixel at handle sizes)
            caps = [(c + _SHAFT_LO * scale * a, c + _SHAFT_HI * scale * a,
                     _SHAFT_R * scale),
                    (c + _SHAFT_HI * scale * a, c + _TIP_HI * scale * a,
                     _TIP_R * scale)]
        out[name] = caps
    return out


def _ring_basis(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Two unit vectors spanning the plane orthogonal to axis `a`."""
    h = np.array([1.0, 0.0, 0.0]) if abs(a[0]) < 0.9 \
        else np.array([0.0, 1.0, 0.0])
    u = np.cross(a, h)
    u /= np.linalg.norm(u)
    v = np.cross(a, u)
    return u, v


def _ray_capsule_t(o, d, p0, p1, radius) -> Optional[float]:
    """Nearest t >= 0 where ray (o + t d, |d| = 1) enters the capsule
    (segment p0-p1 swept by `radius`).  Conservative-exact for the
    cylinder body + spherical caps."""
    # infinite-cylinder intersection around the segment axis
    axis = p1 - p0
    alen = np.linalg.norm(axis)
    best = math.inf
    if alen > 1e-12:
        an = axis / alen
        oc = o - p0
        dd = d - np.dot(d, an) * an
        oo = oc - np.dot(oc, an) * an
        A = np.dot(dd, dd)
        B = 2.0 * np.dot(dd, oo)
        C = np.dot(oo, oo) - radius * radius
        if A > 1e-14:
            disc = B * B - 4.0 * A * C
            if disc >= 0.0:
                sq = math.sqrt(disc)
                for t in ((-B - sq) / (2 * A), (-B + sq) / (2 * A)):
                    if 0.0 <= t < best:
                        # inside the finite segment span?
                        s = np.dot(oc + t * d, an)
                        if 0.0 <= s <= alen:
                            best = t
    # spherical caps
    for cc in (p0, p1):
        oc = o - cc
        b = -np.dot(oc, d)
        cq = np.dot(oc, oc) - radius * radius
        disc = b * b - cq
        if disc >= 0.0:
            sq = math.sqrt(disc)
            for t in (b - sq, b + sq):
                if 0.0 <= t < best:
                    best = t
    return None if math.isinf(best) else best


def ray_hit(origin, direction, center, mode: str, scale: float
            ) -> Optional[Tuple[str, float]]:
    """First handle the world ray enters: (axis, t) or None.  This is
    the grab test — the caller owns occlusion (compare t against the
    scene's own nearest hit on the same ray)."""
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    best: Optional[Tuple[str, float]] = None
    for name, caps in handle_capsules(center, mode, scale).items():
        for p0, p1, r in caps:
            t = _ray_capsule_t(o, d, p0, p1, r)
            if t is not None and (best is None or t < best[1]):
                best = (name, t)
    return best


def polylines(center, mode: str, scale: float) -> Dict[str, np.ndarray]:
    """Per-axis (N, 3) world-space vertex chains tracing the SAME
    geometry the hit test uses, for projection + per-vertex depth test
    in the viewer.  Arrows emit shaft ends plus a tip diamond; rings
    emit the full circle."""
    c = np.asarray(center, np.float64)
    out = {}
    for name, a in AXES.items():
        if mode == "rotate":
            u, v = _ring_basis(a)
            ang = np.linspace(0.0, 2.0 * math.pi, _RING_SEGS + 1)
            out[name] = (c[None, :] + _RING_RADIUS * scale
                         * (np.cos(ang)[:, None] * u[None, :]
                            + np.sin(ang)[:, None] * v[None, :]))
        else:
            u, _ = _ring_basis(a)
            tipb = c + _SHAFT_HI * scale * a
            tip = c + _TIP_HI * scale * a
            w = _TIP_R * scale
            # shaft, then a flat diamond silhouette for the tip
            out[name] = np.stack([
                c + _SHAFT_LO * scale * a, tipb,
                tipb + w * u, tip, tipb - w * u, tipb])
    return out
