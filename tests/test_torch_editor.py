"""The port's SceneEditor against simple_raytracer_tpu's.

The same commands go through a JAX SceneEditor and the port's, each on
its own package's Scene: every result, every EditError message and every
describe() must be equal, and the built scenes equal array by array.
repair_selection gives the same answer on a table of cases.  A seeded
random op sequence (the mix of tests/test_editor_fuzz.py, malformed
payloads included) keeps the scene's invariants in the port and matches
JAX's scene after every op, and one small pass of a fuzzed scene renders
within the golden bound (RMSE < 2e-3) of JAX's.
"""
import math

import numpy as np
import pytest

from simple_raytracer_tpu.editor import EditError as JEditError
from simple_raytracer_tpu.editor import SceneEditor as JEditor
from simple_raytracer_tpu.editor import decompose_trs as jdecompose
from simple_raytracer_tpu.editor import repair_selection as jrepair
from simple_raytracer_tpu.models.scene import Scene as JScene
from simple_raytracer_tpu_torch.editor import (EditError, SceneEditor,
                                               decompose_trs,
                                               repair_selection)
from simple_raytracer_tpu_torch.io.stl import save_stl
from simple_raytracer_tpu_torch.models.camera import Camera
from simple_raytracer_tpu_torch.models.scene import Scene

from torch_port_helpers import (jax_native_accel, jax_scene_arrays,
                                port_scene_arrays)

KINDS = ("sphere", "plane", "model")
BOUND = 2e-3


@pytest.fixture(autouse=True)
def jax_native():
    """The JAX package on its default BVH builder, its native library (the
    port's host library builds the same tree)."""
    jax_native_accel()


class Pair:
    """A JAX editor and the port's, each on a fresh scene, with their
    on_change calls recorded."""

    def __init__(self):
        self.changes = ([], [])
        self.j = JEditor(JScene(), on_change=self.changes[0].append)
        self.t = SceneEditor(Scene(), on_change=self.changes[1].append)

    def apply(self, cmd):
        """Both editors' outcome of ``cmd``: the result, or the error's
        message; they must be equal."""
        outs = []
        for ed, err in ((self.j, JEditError), (self.t, EditError)):
            try:
                outs.append(("ok", ed.apply(cmd)))
            except err as e:
                outs.append(("error", str(e)))
        assert outs[1] == outs[0], cmd
        assert self.changes[1] == self.changes[0]
        return outs[1]

    def same(self, arrays: bool = True):
        assert self.t.describe() == self.j.describe()
        if arrays:
            want = jax_scene_arrays(self.j.scene.build())
            got = port_scene_arrays(self.t.scene.build("cpu"))
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                np.testing.assert_array_equal(
                    np.asarray(got[k], np.asarray(w).dtype), w, err_msg=k)


def test_command_sequence_matches_jax(tmp_path):
    """The commands of tests/test_editor.py, the rejected ones too."""
    pos = np.zeros((3, 3, 3), np.float32)
    pos[:, 1, 0] = 1.0
    pos[:, 2, 1] = 1.0
    stl = tmp_path / "tri.stl"
    save_stl(stl, pos)
    p = Pair()
    cmds = [
        {"op": "add_sphere", "position": [1, 2, 3], "radius": 0.5},
        {"op": "add_plane"},
        {"op": "add_box", "position": [0, 0, -4], "size": [1, 2, 3]},
        {"op": "duplicate_shape", "kind": "sphere", "index": 0},
        {"op": "remove_shape", "kind": "sphere", "index": 0},
        {"op": "remove_shape", "kind": "sphere", "index": 5},
        {"op": "set_shape", "kind": "sphere", "index": 0,
         "position": [4, 5, 6], "radius": -2.0},
        {"op": "set_shape", "kind": "plane", "index": 0,
         "normal": [0, 0, 2]},
        {"op": "set_shape", "kind": "plane", "index": 0,
         "normal": [0, 0, 0]},
        {"op": "set_shape", "kind": "model", "index": 0,
         "translation": [1, 2, 3], "rotation": [0.3, -0.4, 0.2],
         "scale": [2, 2, 2]},
        {"op": "set_shape", "kind": "model", "index": 0,
         "transform": np.eye(4).tolist()},
        {"op": "set_shape", "kind": "model", "index": 0,
         "transform": [[1, 0], [0, 1]]},
        {"op": "set_shape", "kind": "model", "index": 0,
         "translation": [1, 2]},
        {"op": "translate_shape", "kind": "sphere", "index": 0,
         "delta": [0.5, 0, -1]},
        {"op": "translate_shape", "kind": "model", "index": 0,
         "delta": [0, 2, 0]},
        {"op": "rotate_shape", "kind": "model", "index": 0,
         "axis": [0, 1, 0], "angle": math.pi / 4},
        {"op": "scale_shape", "kind": "model", "index": 0, "factor": 2.0,
         "axis": "x"},
        {"op": "scale_shape", "kind": "model", "index": 0, "factor": 2.0,
         "axis": "w"},
        {"op": "scale_shape", "kind": "sphere", "index": 0,
         "factor": float("inf")},
        {"op": "add_material", "name": "Shiny",
         "fields": {"smoothness": 0.9, "color": [1, 0, 0]}},
        {"op": "update_material", "index": 1,
         "fields": {"transmittance": 1.0, "refraction_index": 1.5}},
        {"op": "rename_material", "index": 1, "name": "Glass"},
        {"op": "rename_material", "index": 9, "name": "Nope"},
        {"op": "add_sphere", "material": 1},
        {"op": "set_shape_material", "kind": "sphere", "index": 0,
         "material": 1},
        {"op": "set_shape_material", "kind": "sphere", "index": 0,
         "material": 77},
        {"op": "remove_material", "index": 1},
        {"op": "remove_material", "index": -1},
        {"op": "update_material", "index": 99, "fields": {}},
        {"op": "update_material", "index": 0, "fields": {"bogus": 1}},
        {"op": "update_material", "index": 0,
         "fields": {"smoothness": "x"}},
        {"op": "set_sky", "fields": {"sun_intensity": 3.0,
                                     "sun_direction": [2, 0, 0],
                                     "zenith_color": [0.1, 0.2, 0.3]}},
        {"op": "set_sky", "fields": {"sun_direction": [0, 0, 0]}},
        {"op": "set_sky", "fields": {"nope": 1}},
        {"op": "import_model", "path": "/nonexistent/m.stl"},
        {"op": "import_model"},
        {"op": "import_model", "path": str(stl)},
        {"op": "reorder_shape", "kind": "sphere", "index": 1, "to": 0},
        {"op": "reorder_shape", "kind": "sphere", "index": 0, "to": None},
        {"op": "remove_shape", "kind": "cube", "index": 0},
        {"op": "frobnicate"},
        "not a dict",
    ]
    outcomes = [p.apply(c) for c in cmds]
    assert sum(o[0] == "error" for o in outcomes) == 20
    assert any("Inexistant file" in str(o[1]) for o in outcomes)
    p.same()
    d = p.t.describe()
    assert [s["kind"] for s in d["shapes"]] == [
        "sphere", "sphere", "plane", "model", "model"]
    assert d["materials"][0]["name"] == "Material0"
    # picking: float64 numpy on the host, the same as JAX's
    rng = np.random.default_rng(5)
    for _ in range(64):
        o = rng.uniform(-6, 6, 3)
        dvec = rng.normal(size=3)
        tj, sj = p.j.pick_with_t(o, dvec)
        tt, st = p.t.pick_with_t(o, dvec)
        assert (tt, st) == (tj, sj)
        assert p.t.pick(o, dvec) == sj and p.t.pick_t(o, dvec) == tj


def test_decompose_trs_matches_jax():
    rng = np.random.default_rng(3)
    from simple_raytracer_tpu_torch.models.shapes import transform_trs
    for _ in range(32):
        m = transform_trs(rng.uniform(-3, 3, 3), rng.uniform(-3, 3, 3),
                          rng.uniform(0.2, 3, 3))
        assert decompose_trs(m) == jdecompose(m)
    lock = transform_trs((1, 2, 3), (0.5, math.pi / 2, 0.0), (1, 2, 1))
    assert decompose_trs(lock) == jdecompose(lock)   # the gimbal branch


def _repair_cases():
    sel = {"kind": "sphere", "index": 3}
    rm = {"op": "remove_shape", "kind": "sphere"}
    ro = {"op": "reorder_shape", "kind": "sphere"}
    dup = {"op": "duplicate_shape", "kind": "sphere"}
    cases = [(sel, dict(rm, index=i), {}) for i in range(6)]
    cases += [(sel, {"op": "remove_shape", "kind": "plane", "index": 0}, {})]
    cases += [(sel, dict(ro, index=a, to=b), {"index": b})
              for a in range(6) for b in range(6)]
    cases += [(sel, dict(ro, index=3, to=99), {"index": 5}),
              (sel, dict(ro, index=1, to=4), {})]
    cases += [(sel, dict(dup, index=i), {"index": r})
              for i, r in ((1, 2), (4, 5), (3, 3), (0, None))]
    cases += [("zap", dict(rm, index=0), {}),
              (None, dict(rm, index=0), {}),
              ({"kind": "sphere"}, dict(rm, index=0), {}),
              ({"kind": "sphere", "index": "x"}, dict(rm, index=0), {}),
              ({"kind": "sphere", "index": "2"}, dict(rm, index=0), {}),
              (sel, {"op": "set_shape_material", "kind": "sphere",
                     "index": 3, "material": 1}, {}),
              ({"kind": "model", "index": 0},
               {"op": "add_box", "position": [0, 0, 0]}, {"index": 1})]
    return cases


def test_repair_selection_matches_jax():
    cases = _repair_cases()
    assert len(cases) == 56
    for sel, cmd, result in cases:
        want = jrepair(sel, cmd, result)
        got = repair_selection(sel, cmd, result)
        assert got == want, (sel, cmd, result)
    # the rules of tests/test_editor.py, on the port
    sel = {"kind": "sphere", "index": 3}
    assert repair_selection(sel, {"op": "remove_shape", "kind": "sphere",
                                  "index": 3}, {}) is None
    assert repair_selection(sel, {"op": "reorder_shape", "kind": "sphere",
                                  "index": 1, "to": 3}, {"index": 3}) == {
        "kind": "sphere", "index": 2}


# -- the fuzz: tests/test_editor_fuzz.py's op mix ---------------------------

def _pick(rng, options):
    """rng.choice for ragged, mixed-type option lists."""
    return options[int(rng.integers(len(options)))]


def _rand_op(rng):
    """One random command, sometimes deliberately malformed."""
    ops = [
        lambda: {"op": "add_sphere",
                 "position": list(rng.uniform(-5, 5, 3)),
                 "radius": float(rng.uniform(0.1, 2.0))},
        lambda: {"op": "add_plane",
                 "position": list(rng.uniform(-5, 5, 3)),
                 "normal": list(rng.uniform(-1, 1, 3) + 1e-3)},
        lambda: {"op": "add_box",
                 "position": list(rng.uniform(-5, 5, 3))},
        lambda: {"op": "add_material", "name": f"m{rng.integers(1e6)}",
                 "fields": {"metallic": float(rng.uniform(0, 1))}},
        lambda: {"op": "remove_shape",
                 "kind": rng.choice(KINDS),
                 "index": int(rng.integers(-2, 6))},
        lambda: {"op": "duplicate_shape",
                 "kind": rng.choice(KINDS),
                 "index": int(rng.integers(-2, 6))},
        lambda: {"op": "reorder_shape", "kind": rng.choice(KINDS),
                 "index": int(rng.integers(-2, 6)),
                 "to": rng.choice([None, -3, 0, 2, 99])},
        lambda: {"op": "set_shape_material", "kind": rng.choice(KINDS),
                 "index": int(rng.integers(-2, 6)),
                 "material": _pick(rng, [None, -1, 0, 1, 17])},
        lambda: {"op": "remove_material",
                 "index": _pick(rng, [None, -1, 0, 1, 5])},
        lambda: {"op": "update_material", "index": int(rng.integers(0, 4)),
                 "fields": {"smoothness": _pick(rng, [0.5, None, "x"])}},
        lambda: {"op": "translate_shape", "kind": rng.choice(KINDS),
                 "index": int(rng.integers(-2, 6)),
                 "delta": _pick(rng, [[0.1, 0, 0], [1], None])},
        lambda: {"op": "rotate_shape", "kind": rng.choice(KINDS),
                 "index": int(rng.integers(-2, 6)),
                 "axis": [0, 1, 0],
                 "angle": float(rng.uniform(-3, 3))},
        lambda: {"op": "scale_shape", "kind": rng.choice(KINDS),
                 "index": int(rng.integers(-2, 6)),
                 "factor": _pick(rng, [0.5, 2.0, 0.0, -1.0]),
                 "axis": _pick(rng, [None, "x", "y", "z", "w"])},
        lambda: {"op": "set_camera", "fov": _pick(rng, [70, None, "x"])},
        lambda: {"op": _pick(rng, ["frobnicate", "", None])},
    ]
    return ops[rng.integers(len(ops))]()


def _check_invariants(sc: Scene):
    n_mats = len(sc.materials)
    assert n_mats >= 1                      # a delete refills Material0
    for shape in sc.all_shapes:
        assert 0 <= shape.material < n_mats
    for m in sc.models:
        t = np.asarray(m.transform, np.float64)
        assert t.shape == (4, 4) and np.isfinite(t).all()
        assert abs(np.linalg.det(t[:3, :3])) > 0
    for s in sc.spheres:
        assert s.radius > 0 and math.isfinite(s.radius)
    for lst in (sc.spheres, sc.planes, sc.models):
        ids = [id(x) for x in lst]
        assert len(ids) == len(set(ids))


def _fuzzed(seed: int, n_ops: int):
    """Both editors through ``n_ops`` random commands of ``seed``, their
    outcomes and describe() equal after each, the port's scene keeping
    its invariants; returns the pair and the outcomes."""
    rng = np.random.default_rng(seed)
    p = Pair()
    outcomes = []
    for _ in range(n_ops):
        outcomes.append(p.apply(_rand_op(rng))[0])
        _check_invariants(p.t.scene)
        p.same(arrays=False)
    return p, outcomes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzzed_ops_keep_invariants_and_match_jax(seed):
    p, outcomes = _fuzzed(seed, 300)
    applied = outcomes.count("ok")
    assert applied > 50 and len(outcomes) - applied > 20
    p.same()
    ds = p.t.scene.build("cpu")
    assert int(ds.materials.smoothness.shape[0]) >= len(p.t.scene.materials)


def test_fuzzed_scene_renders_like_jax():
    """One pass of a fuzzed scene (seed 12, 120 ops: 5 spheres, 8 planes,
    9 boxes, 4 materials), seen from a camera set back, at a time seed
    above 2^31: the port's Renderer on the CPU against JAX's dense scan
    path, eagerly, at 32x24, 2 spp, 4 bounces."""
    import jax.numpy as jnp
    from simple_raytracer_tpu.models.camera import Camera as JCamera
    from simple_raytracer_tpu.ops.trace import make_render_step
    from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions

    p, _ = _fuzzed(12, 120)
    p.same()
    sc = p.t.scene
    assert sc.spheres and (sc.planes or sc.models), p.t.describe()
    camera = Camera(position=(0.0, 1.0, 12.0))
    jcamera = JCamera(position=(0.0, 1.0, 12.0))
    time_seed = 2 ** 31 + 12345
    f = make_render_step(32, 24, 2, 4, tri_backend="jnp", ray_tile=None,
                         jit=False)
    want = np.asarray(f(p.j.scene.build(), jcamera.state(32 / 24),
                        jnp.zeros((24, 32, 3), jnp.float32),
                        jnp.uint32(time_seed)))
    r = Renderer(RenderOptions(width=32, height=24, num_samples=2,
                               num_bounces=4), sc, device="cpu")
    r.step(camera, time=time_seed)
    got = r.canvas.numpy()
    assert np.isfinite(got).all() and (got > 0).mean() > 0.5
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rmse < BOUND, rmse
