"""The port's viewer server on the CPU: frames, input, edits, picks.

The 18 cases of tests/test_viewer.py against the port's RenderLoop and
make_handler on device="cpu" at 32x24 (1 spp, 2 bounces), each test under
its own time limit (SERVER_TEST_TIMEOUT, and REQUEST_TIMEOUT a request).
The render thread seeds each pass from the wall clock, which reaches 2^32
- 1: a Renderer step at time seeds of at least 2^31 is held to JAX's (the
camera rays and seeds bit for bit, the canvas within the golden bound,
RMSE < 2e-3).  And the viewer's main refuses to start without CUDA unless
it is given --device cpu.
"""
import io
import json
import math
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from simple_raytracer_tpu_torch import viewer
from simple_raytracer_tpu_torch.io.image import load_ppm
from simple_raytracer_tpu_torch.models.camera import Camera
from simple_raytracer_tpu_torch.models.scene import Scene

from torch_port_helpers import (SERVER_TEST_TIMEOUT, http_get, http_post,
                                time_limit, to_np, viewer_server)

BOUND = 2e-3
# a wait for the render thread, well inside SERVER_TEST_TIMEOUT
WAIT = 30


@pytest.fixture()
def server():
    sc = Scene()
    sc.add_sphere((0, 0, -3), 1.0)
    sc.add_plane((0, -1, 0), (0, 1, 0))
    with time_limit(SERVER_TEST_TIMEOUT):
        with viewer_server(sc, Camera()) as s:
            yield s


def _edit(srv, cmd):
    return json.loads(http_post(srv, "/edit", cmd).read())


def _wait(cond, loop=None, step=0.02):
    deadline = time.time() + WAIT
    while not cond() and time.time() < deadline:
        if loop is not None:
            assert loop.error is None, loop.error
        time.sleep(step)
    return cond()


def _first_frame(srv, loop):
    deadline = time.time() + WAIT
    while time.time() < deadline:
        assert loop.error is None, loop.error
        try:
            return http_get(srv, "/frame.png").read()
        except urllib.error.HTTPError:    # 503 until the first step lands
            time.sleep(0.05)
    pytest.fail("no frame produced")


def _frame_rgb(srv):
    from PIL import Image
    data = http_get(srv, "/frame.png").read()
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.int32)


def test_page_and_frame(server):
    srv, loop = server
    page = http_get(srv, "/").read()
    assert b"<title>simple_raytracer_tpu_torch</title>" in page
    png = _first_frame(srv, loop)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    from PIL import Image
    assert Image.open(io.BytesIO(png)).size == (32, 24)
    assert loop.renderer.device.type == "cpu"


def test_input_resets_accumulation(server):
    srv, loop = server
    assert _wait(lambda: loop.renderer.num_steps >= 3, loop)
    pos_before = loop.camera.position
    resets_before = loop.reset_count
    http_post(srv, "/input", {"keys": ["w"], "dx": 0, "dy": 0, "wheel": 0,
                              "dt": 0.1})
    assert loop.camera.position != pos_before
    assert _wait(lambda: loop.reset_count > resets_before)


def test_state_endpoint(server):
    srv, loop = server
    assert _wait(lambda: loop.renderer.num_steps >= 2, loop)
    s = json.loads(http_get(srv, "/state").read())
    assert {"frame", "steps", "ms", "fps", "hist", "resets",
            "error"} <= set(s)
    assert s["error"] is None
    assert isinstance(s["hist"], list) and s["hist"]
    assert len(s["hist"]) <= loop.timer.window
    assert all(isinstance(v, (int, float)) and v >= 0 for v in s["hist"])
    assert abs(sum(s["hist"]) / len(s["hist"]) - s["ms"]) < 1.0
    # the frame's parts: the step, image() and the PNG encode
    assert all(t.times for t in loop.part_timers.values())
    with pytest.raises(urllib.error.HTTPError):
        http_get(srv, "/nonexistent")


def test_state_surfaces_render_error(server):
    srv, loop = server
    loop.error = RuntimeError("boom")
    s = json.loads(http_get(srv, "/state").read())
    assert "boom" in s["error"]
    loop.error = None


def test_scene_endpoint(server):
    srv, loop = server
    s = json.loads(http_get(srv, "/scene").read())
    assert [sh["kind"] for sh in s["shapes"]] == ["sphere", "plane"]
    assert s["materials"][0]["name"] == "Material0"
    assert s["render"]["bounces"] == 2
    assert s["render"]["compiling"] is False
    assert s["camera"]["position"] == [0.0, 0.0, 5.0]
    assert "sun_intensity" in s["sky"]


def test_edit_add_shape_resets_accumulation(server):
    srv, loop = server
    resets = loop.reset_count
    r = _edit(srv, {"op": "add_sphere", "position": [2, 0, -3],
                    "radius": 0.5})
    assert r["ok"] and r["changed"]
    assert len(loop.scene.spheres) == 2
    # the device scene was built again with the new sphere
    assert int(loop.renderer.device_scene.spheres.active.sum()) == 2
    assert _wait(lambda: loop.reset_count > resets)


def test_edit_render_changes_after_emissive_edit(server):
    srv, loop = server
    _first_frame(srv, loop)
    before = _frame_rgb(srv)
    _edit(srv, {"op": "update_material", "index": 0,
                "fields": {"emission": [1, 0, 0], "emission_strength": 10}})
    assert _wait(lambda: _frame_rgb(srv)[..., 0].mean()
                 > before[..., 0].mean() + 30, step=0.1), \
        "render did not change after the material edit"


def test_edit_material_and_error_surface(server):
    srv, loop = server
    r = _edit(srv, {"op": "add_material", "name": "Glassy",
                    "fields": {"transmittance": 1.0}})
    assert r["ok"]
    idx = r["index"]
    r = _edit(srv, {"op": "set_shape_material", "kind": "sphere",
                    "index": 0, "material": idx})
    assert r["ok"] and loop.scene.spheres[0].material == idx
    r = _edit(srv, {"op": "import_model", "path": "/nope/x.stl"})
    assert not r["ok"] and "Inexistant file" in r["error"]
    r = _edit(srv, {"op": "frobnicate"})
    assert not r["ok"]


def test_pick_and_drag_shape(server):
    srv, loop = server
    hit = json.loads(http_post(srv, "/pick", {"x": 16, "y": 12}).read())
    assert hit["shape"] == {"kind": "sphere", "index": 0}
    hit = json.loads(http_post(srv, "/pick", {"x": 16, "y": 0}).read())
    assert hit["shape"] is None
    pos0 = loop.scene.spheres[0].position
    r = _edit(srv, {"op": "drag_shape", "kind": "sphere", "index": 0,
                    "dx": 0.1, "dy": 0.0})
    assert r["ok"]
    pos1 = loop.scene.spheres[0].position
    assert pos1[0] > pos0[0] and abs(pos1[1] - pos0[1]) < 1e-6
    _edit(srv, {"op": "translate_shape", "kind": "sphere", "index": 0,
                "delta": [0, 0.5, 0]})
    assert loop.scene.spheres[0].position[1] == pos1[1] + 0.5


def test_set_camera_and_rerender(server):
    srv, loop = server
    r = _edit(srv, {"op": "set_camera", "position": [1, 2, 6], "fov": 70})
    assert r["ok"]
    assert loop.camera.position == (1.0, 2.0, 6.0)
    assert abs(loop.camera.fov - math.radians(70)) < 1e-9
    resets = loop.reset_count
    _edit(srv, {"op": "rerender"})
    assert _wait(lambda: loop.reset_count > resets)


def test_set_render_params(server):
    srv, loop = server
    r = _edit(srv, {"op": "set_render", "bounces": 2, "samples": 1})
    assert r["ok"] and not r["changed"]
    r = _edit(srv, {"op": "set_render", "show_normals": True})
    assert r["ok"] and r["changed"] and r["compiling"]
    s = json.loads(http_get(srv, "/scene").read())
    assert s["render"]["show_normals"]
    assert _wait(lambda: loop.renderer.options.show_normals, loop)
    assert loop._pending_opts is None
    # the new renderer is on the old one's device, with its scene
    assert loop.renderer.device.type == "cpu"
    assert _wait(lambda: loop.renderer.num_steps >= 1, loop)


def test_screenshot_edge_triggered(server, tmp_path):
    """One P press saves exactly one screenshot, from the render thread."""
    srv, loop = server
    loop.screenshot_path = str(tmp_path / "shot.ppm")
    assert _wait(lambda: loop.renderer.num_steps >= 1, loop)
    payload = {"keys": ["p"], "dx": 0, "dy": 0, "wheel": 0, "dt": 0.03}
    http_post(srv, "/input", payload)   # press
    http_post(srv, "/input", payload)   # still held: no second request
    assert _wait(lambda: loop.screenshot_count >= 1, loop)
    assert loop.screenshot_count == 1
    assert load_ppm(loop.screenshot_path).shape == (24, 32, 3)
    http_post(srv, "/input", {"keys": [], "dx": 0, "dy": 0, "wheel": 0,
                              "dt": 0.03})
    http_post(srv, "/input", payload)
    assert _wait(lambda: loop.screenshot_count >= 2, loop)
    assert loop.screenshot_count == 2


def test_drag_rotate_and_scale_modes(server):
    srv, loop = server
    r0 = loop.scene.spheres[0].radius
    r = _edit(srv, {"op": "drag_shape", "kind": "sphere", "index": 0,
                    "mode": "scale", "dx": 0.0, "dy": -0.1})
    assert r["ok"] and loop.scene.spheres[0].radius > r0
    r = _edit(srv, {"op": "drag_shape", "kind": "sphere", "index": 0,
                    "mode": "rotate", "dx": 0.2, "dy": 0.0})
    assert r["ok"] and not r["changed"]
    n0 = np.asarray(loop.scene.planes[0].normal)
    r = _edit(srv, {"op": "drag_shape", "kind": "plane", "index": 0,
                    "mode": "rotate", "dx": 0.1, "dy": 0.05})
    n1 = np.asarray(loop.scene.planes[0].normal)
    assert r["ok"] and r["changed"]
    assert np.linalg.norm(n1 - n0) > 1e-3
    assert abs(np.linalg.norm(n1) - 1.0) < 1e-6
    r = _edit(srv, {"op": "drag_shape", "kind": "plane", "index": 0,
                    "mode": "scale", "dx": 0.0, "dy": -0.1})
    assert not r["ok"] and "scaled" in r["error"]
    r = _edit(srv, {"op": "drag_shape", "kind": "sphere", "index": 0,
                    "mode": "bogus"})
    assert not r["ok"]


def test_axis_constrained_drag(server):
    srv, loop = server
    pos0 = loop.scene.spheres[0].position
    r = _edit(srv, {"op": "drag_shape", "kind": "sphere", "index": 0,
                    "axis": "x", "dx": 0.1, "dy": 0.07})
    pos1 = loop.scene.spheres[0].position
    assert r["ok"] and pos1[0] > pos0[0]
    assert pos1[1] == pos0[1] and pos1[2] == pos0[2]
    r = _edit(srv, {"op": "drag_shape", "kind": "sphere", "index": 0,
                    "axis": "y", "dx": 0.1, "dy": -0.07})
    pos2 = loop.scene.spheres[0].position
    assert r["ok"] and pos2[1] > pos1[1]
    assert pos2[0] == pos1[0] and pos2[2] == pos1[2]
    r = _edit(srv, {"op": "drag_shape", "kind": "sphere", "index": 0,
                    "axis": "z", "dx": 0.1, "dy": 0.0})
    pos3 = loop.scene.spheres[0].position
    assert r["ok"] and abs(pos3[2] - pos2[2]) < 1e-5
    n0 = np.asarray(loop.scene.planes[0].normal)
    r = _edit(srv, {"op": "drag_shape", "kind": "plane", "index": 0,
                    "mode": "rotate", "axis": "x", "dx": 0.05, "dy": 0.0})
    n1 = np.asarray(loop.scene.planes[0].normal)
    assert r["ok"] and abs(n1[0] - n0[0]) < 1e-6
    assert np.linalg.norm(n1 - n0) > 1e-3
    r0 = loop.scene.spheres[0].radius
    r = _edit(srv, {"op": "drag_shape", "kind": "sphere", "index": 0,
                    "mode": "scale", "axis": "y", "dx": 0.0, "dy": -0.1})
    assert r["ok"] and loop.scene.spheres[0].radius > r0
    r = _edit(srv, {"op": "drag_shape", "kind": "sphere", "index": 0,
                    "axis": "w", "dx": 0.1, "dy": 0.0})
    assert not r["ok"] and "axis" in r["error"]


def test_reorder_shape(server):
    srv, loop = server
    _edit(srv, {"op": "add_sphere", "position": [2, 0, -3], "radius": 0.5})
    _edit(srv, {"op": "add_sphere", "position": [-2, 0, -3],
                "radius": 0.25})
    assert [s.radius for s in loop.scene.spheres] == [1.0, 0.5, 0.25]
    r = _edit(srv, {"op": "reorder_shape", "kind": "sphere", "index": 2,
                    "to": 0})
    assert r["ok"] and r["index"] == 0
    assert [s.radius for s in loop.scene.spheres] == [0.25, 1.0, 0.5]
    s = json.loads(http_get(srv, "/scene").read())
    sph = [sh for sh in s["shapes"] if sh["kind"] == "sphere"]
    assert [x["radius"] for x in sph] == [0.25, 1.0, 0.5]
    r = _edit(srv, {"op": "reorder_shape", "kind": "sphere", "index": 0,
                    "to": 99})
    assert r["ok"] and r["index"] == 2
    r = _edit(srv, {"op": "reorder_shape", "kind": "sphere", "index": 0})
    assert not r["ok"] and "to" in r["error"]
    r = _edit(srv, {"op": "reorder_shape", "kind": "sphere", "index": 0,
                    "to": None})
    assert not r["ok"] and "to" in r["error"]


def test_set_render_preserves_non_panel_fields_and_revert_cancels(server):
    """set_render carries over the fields the panel does not edit, and a
    revert to the live options while a new renderer is pending discards
    that renderer (swap by generation)."""
    srv, loop = server
    base = loop.renderer.options
    r = _edit(srv, {"op": "set_render", "bounces": base.num_bounces + 1})
    assert r["ok"] and r["changed"] and r["compiling"]
    with loop._lock:
        pend = loop._pending_opts
        gen = loop._render_gen
    assert pend is not None
    assert pend.all_devices == base.all_devices
    assert pend.tri_backend == base.tri_backend
    assert pend.ray_tile == base.ray_tile
    assert pend.tri_chunk == base.tri_chunk
    assert pend.aov == base.aov
    assert (pend.width, pend.height) == (base.width, base.height)
    r = _edit(srv, {"op": "set_render", "bounces": base.num_bounces})
    assert r["ok"] and not r["changed"]
    with loop._lock:
        assert loop._pending_opts is None
        assert loop._render_gen > gen
    # the superseded renderer finishes its warm-up pass and never swaps in
    import threading
    assert _wait(lambda: not any(t.name == "srt-render-warm"
                                 for t in threading.enumerate()))
    assert loop.renderer.options == base and loop.error is None


def test_malformed_input_and_pick_payloads_return_400(server):
    srv, loop = server
    for path, payload in (("/input", {"dx": None}),
                          ("/pick", {"x": [1, 2]})):
        with pytest.raises(urllib.error.HTTPError) as e:
            http_post(srv, path, payload)
        assert e.value.code == 400
        assert "bad payload" in json.loads(e.value.read())["error"]
    port = srv.server_address[1]
    req = urllib.request.Request(f"http://127.0.0.1:{port}/edit",
                                 data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400


def test_edit_response_repairs_shipped_selection(server):
    srv, loop = server
    for i in range(3):
        assert _edit(srv, {"op": "add_sphere",
                           "position": [i, 0, -4]})["ok"]
    r = _edit(srv, {"op": "reorder_shape", "kind": "sphere", "index": 1,
                    "to": 3, "sel": {"kind": "sphere", "index": 3}})
    assert r["ok"] and r["sel"] == {"kind": "sphere", "index": 2}
    r = _edit(srv, {"op": "remove_shape", "kind": "sphere", "index": 2,
                    "sel": {"kind": "sphere", "index": 2}})
    assert r["ok"] and r["sel"] is None
    r = _edit(srv, {"op": "remove_shape", "kind": "sphere", "index": 0})
    assert r["ok"] and "sel" not in r


# -- beyond tests/test_viewer.py --------------------------------------------

def test_wall_clock_seeds_match_jax():
    """Steps at time seeds the wall clock gives (2^31 + 5 and 2^32 - 1):
    config 2 at its golden size, the JAX scene carried across, against the
    JAX Renderer.  The camera rays' seeds and origins are bit for bit
    JAX's (directions within 1e-6, as at small seeds), each canvas within
    the golden bound."""
    from simple_raytracer_tpu.engine import Renderer as JRenderer
    from simple_raytracer_tpu.engine import RenderOptions as JOptions
    from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
    from simple_raytracer_tpu.ops import camera as jcam
    from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
    from simple_raytracer_tpu_torch.models.presets import CONFIGS
    from simple_raytracer_tpu_torch.ops import camera as tcam
    from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

    from torch_port_helpers import jax_scene_arrays

    w, h = 96, 54
    jscene, jcamera, jopt = JCONFIGS[2](width=w, height=h)
    _, camera, _ = CONFIGS[2](width=w, height=h)
    s, b = jopt.num_samples, jopt.num_bounces
    jstate, tstate = jcamera.state(w / h), camera.state(w / h)
    jr = JRenderer(JOptions(width=w, height=h, num_samples=s,
                            num_bounces=b), scene=jscene)
    r = Renderer(RenderOptions(width=w, height=h, num_samples=s,
                               num_bounces=b), device="cpu")
    r.set_device_scene(from_numpy(jax_scene_arrays(jscene.build()), "cpu"))
    canvases = []
    for time_seed in (2 ** 31 + 5, 0xFFFFFFFF):
        jo, jd, js = jcam.generate_rays(
            w, h, s, time_seed, jstate.position,
            jcam.camera_rotation(jstate.yaw, jstate.pitch),
            jstate.aspect_ratio, jstate.fov_scale)
        to, td, ts = tcam.generate_rays(
            w, h, s, time_seed, tstate.position,
            tcam.camera_rotation(tstate.yaw, tstate.pitch),
            tstate.aspect_ratio, tstate.fov_scale)
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                      ts.numpy())
        np.testing.assert_array_equal(to_np(jo), to_np(to))
        np.testing.assert_allclose(to_np(td), to_np(jd), rtol=0, atol=1e-6)
        jr.clear_canvas()
        jr.step(jcamera, time=time_seed)
        r.clear_canvas()
        r.step(camera, time=time_seed)
        got, want = r.canvas.numpy(), np.asarray(jr.canvas)
        assert np.isfinite(got).all() and got.std() > 0
        assert float(np.sqrt(np.mean((got - want) ** 2))) < BOUND
        canvases.append(got)
    # the seed reaches the pass: the two canvases differ
    assert not np.array_equal(*canvases)


def test_main_refuses_to_fall_back_to_the_cpu(monkeypatch, capsys):
    """Without CUDA, main exits 1 with an error unless --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(viewer, "serve", lambda *a, **k: started.append(k))
    assert viewer.main(["--config", "2"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert viewer.main(["--config", "2", "--device", "cuda:0"]) == 1
    assert not started
    assert viewer.main(["--config", "2", "--device", "cpu", "--width", "32",
                        "--height", "24", "--port", "0"]) == 0
    assert started[0]["device"] == "cpu" and started[0]["port"] == 0
    with pytest.raises(SystemExit):
        viewer.main([])     # --scene or --config is required
