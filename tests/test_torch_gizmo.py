"""The port's gizmo against simple_raytracer_tpu's, and its endpoints.

handle_scale, handle_capsules, ray_hit and polylines are float64 numpy in
both packages: on seeded centres, cameras, modes and rays the port's
results equal JAX's to the last bit.  Then the pick -> axis-drag flow and
the occlusion cases of tests/test_gizmo.py run against the port's viewer
on the CPU (32x24, 1 spp, 2 bounces), each test under its own time limit.
"""
import json
import math
import urllib.error

import numpy as np
import pytest

from simple_raytracer_tpu import gizmo as jgizmo
from simple_raytracer_tpu_torch import gizmo
from simple_raytracer_tpu_torch.models.camera import Camera
from simple_raytracer_tpu_torch.models.scene import Scene

from torch_port_helpers import (SERVER_TEST_TIMEOUT, http_post, time_limit,
                                viewer_server)

FOV = math.radians(60.0)
MODES = ("translate", "rotate", "scale")


def _norm(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def test_axes_match_jax():
    assert sorted(gizmo.AXES) == sorted(jgizmo.AXES) == ["x", "y", "z"]
    for k, a in gizmo.AXES.items():
        np.testing.assert_array_equal(a, jgizmo.AXES[k])


@pytest.mark.parametrize("mode", MODES)
def test_geometry_matches_jax_bit_for_bit(mode):
    rng = np.random.default_rng(7 + MODES.index(mode))
    for _ in range(16):
        center = rng.uniform(-5, 5, 3)
        cam = rng.uniform(-8, 8, 3)
        fov = float(rng.uniform(0.3, 2.0))
        s = gizmo.handle_scale(center, cam, fov)
        assert s == jgizmo.handle_scale(center, cam, fov)
        caps = gizmo.handle_capsules(center, mode, s)
        jcaps = jgizmo.handle_capsules(center, mode, s)
        assert list(caps) == list(jcaps)
        for ax in caps:
            assert len(caps[ax]) == len(jcaps[ax])
            for (p0, p1, r), (q0, q1, rq) in zip(caps[ax], jcaps[ax]):
                np.testing.assert_array_equal(p0, q0)
                np.testing.assert_array_equal(p1, q1)
                assert r == rq
        polys = gizmo.polylines(center, mode, s)
        jpolys = jgizmo.polylines(center, mode, s)
        assert list(polys) == list(jpolys)
        for ax in polys:
            np.testing.assert_array_equal(polys[ax], jpolys[ax])


@pytest.mark.parametrize("mode", MODES)
def test_ray_hit_matches_jax_bit_for_bit(mode):
    """Rays aimed near points of the handles (hits and misses both) and
    at random: the same (axis, t) or None."""
    rng = np.random.default_rng(31 + MODES.index(mode))
    hits = 0
    for _ in range(200):
        center = rng.uniform(-3, 3, 3)
        cam = center + _norm(rng.normal(size=3)) * rng.uniform(3, 9)
        s = gizmo.handle_scale(center, cam, FOV)
        a = gizmo.AXES["xyz"[rng.integers(3)]]
        if mode == "rotate":
            u, v = gizmo._ring_basis(a)
            ang = rng.uniform(0, 2 * math.pi)
            on = center + s * (math.cos(ang) * u + math.sin(ang) * v)
        else:
            on = center + rng.uniform(0.2, 1.35) * s * a
        aim = on + rng.normal(size=3) * 0.08 * s
        d = aim - cam if rng.random() < 0.9 else rng.normal(size=3)
        got = gizmo.ray_hit(cam, d, center, mode, s)
        assert got == jgizmo.ray_hit(cam, d, center, mode, s)
        hits += got is not None
    assert 20 < hits < 190, hits


def test_arrow_and_ring_hits():
    """The grab contract of tests/test_gizmo.py on the port: a ray at an
    arrow's tip grabs that axis from an oblique camera, a ray at a point
    on a ring grabs the ring's axis."""
    center = np.array([1.0, 2.0, -3.0])
    cam = np.array([4.0, 3.5, 2.0])
    s = gizmo.handle_scale(center, cam, FOV)
    for axis in "xyz":
        target = center + 1.15 * s * gizmo.AXES[axis]
        hit = gizmo.ray_hit(cam, _norm(target - cam), center, "translate", s)
        assert hit is not None and hit[0] == axis
    center = np.array([0.0, 0.5, -4.0])
    cam = np.array([2.0, 3.0, 1.0])
    s = gizmo.handle_scale(center, cam, FOV)
    for axis in "xyz":
        u, v = gizmo._ring_basis(gizmo.AXES[axis])
        for ang in (0.3, 2.0, 4.4):
            p = center + s * (math.cos(ang) * u + math.sin(ang) * v)
            hit = gizmo.ray_hit(cam, _norm(p - cam), center, "rotate", s)
            assert hit is not None and hit[0] == axis


# ------------------------------------------------------------ endpoints --

@pytest.fixture()
def server():
    sc = Scene()
    sc.add_sphere((0, 0, -3), 1.0)
    with time_limit(SERVER_TEST_TIMEOUT):
        with viewer_server(sc, Camera(position=(0.0, 0.0, 5.0))) as s:
            yield s


def _post(srv, path, payload):
    return json.loads(http_post(srv, path, payload).read())


GIZMO = {"kind": "sphere", "index": 0, "mode": "translate"}
NO_INPUT = {"keys": [], "dx": 0, "dy": 0, "wheel": 0, "dt": 0.0}


def _tip_pixel(overlay, axis):
    """The projected tip vertex of an arrow (polylines: index 3) and its
    occlusion flag."""
    a = overlay[axis]
    return a["pts"][3], a["occ"][3]


def test_pick_grabs_visible_handle_and_axis_drag_moves_trs(server):
    srv, loop = server
    s = _post(srv, "/input", dict(NO_INPUT, gizmo=GIZMO))
    assert s["gizmo"] is not None
    (px, py), occ = _tip_pixel(s["gizmo"], "x")
    assert not occ
    hit = _post(srv, "/pick", {"x": px, "y": py, "gizmo": GIZMO})
    assert hit["gizmo_axis"] == "x"
    pos0 = loop.scene.spheres[0].position
    r = _post(srv, "/edit", {"op": "drag_shape", "kind": "sphere",
                             "index": 0, "mode": "translate", "axis": "x",
                             "dx": 0.1, "dy": 0.0})
    assert r["ok"]
    pos1 = loop.scene.spheres[0].position
    assert pos1[0] != pos0[0]
    assert pos1[1] == pos0[1] and pos1[2] == pos0[2]


def test_pick_without_gizmo_field_keeps_old_contract(server):
    srv, _ = server
    hit = _post(srv, "/pick", {"x": 16, "y": 12})
    assert hit["shape"] == {"kind": "sphere", "index": 0}
    assert hit["gizmo_axis"] is None


def test_occluded_handle_cannot_be_grabbed(server):
    srv, loop = server
    s = _post(srv, "/input", dict(NO_INPUT, gizmo=GIZMO))
    (px, py), occ = _tip_pixel(s["gizmo"], "x")
    assert not occ
    r = _post(srv, "/edit", {"op": "add_plane", "position": [0, 0, 2],
                             "normal": [0, 0, 1]})
    assert r["ok"]
    hit = _post(srv, "/pick", {"x": px, "y": py, "gizmo": GIZMO})
    assert hit["gizmo_axis"] is None
    assert hit["shape"] == {"kind": "plane", "index": 0}
    s = _post(srv, "/input", dict(NO_INPUT, gizmo=GIZMO))
    for ax in ("x", "y", "z"):
        assert all(s["gizmo"][ax]["occ"]), ax


def test_selected_shape_occludes_its_own_far_handles(server):
    srv, loop = server
    s = _post(srv, "/input", dict(NO_INPUT, gizmo=dict(GIZMO,
                                                       mode="rotate")))
    ring = s["gizmo"]["x"]
    assert any(ring["occ"]) and not all(ring["occ"])


def test_pick_rejects_malformed_gizmo(server):
    srv, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        http_post(srv, "/pick", {"x": 1, "y": 1, "gizmo": "zap"})
    assert e.value.code == 400
