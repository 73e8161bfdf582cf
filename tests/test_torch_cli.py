"""The port's command-line renderer (simple_raytracer_tpu_torch.cli),
run in process at tests/test_cli.py's 64x36 with --device cpu: PNG and
PPM output, save and resume, a scene-JSON round trip, a missing scene
file, --warm, --aov, --mesh-path, the CLI's image against the Renderer's,
a port checkpoint resumed by the JAX CLI, and no card without
--device cpu."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from simple_raytracer_tpu.cli import main as jmain
from simple_raytracer_tpu_torch.cli import main
from simple_raytracer_tpu_torch.engine import Renderer
from simple_raytracer_tpu_torch.io.image import load_ppm
from simple_raytracer_tpu_torch.io.obj import save_obj
from simple_raytracer_tpu_torch.io.scene_json import save_scene
from simple_raytracer_tpu_torch.io.stl import save_stl
from simple_raytracer_tpu_torch.models.meshgen import organic_blob
from simple_raytracer_tpu_torch.models.presets import CONFIGS

W, H = 64, 36


def _run(argv, device="cpu"):
    rc = main(argv + ["--device", device])
    assert rc == 0, f"cli exited {rc}"


def _common(out, extra=(), config="1"):
    return (["--config", config, "--width", str(W), "--height", str(H),
             "--samples", "1", "--bounces", "2", "--steps", "2",
             "--out", str(out)] + list(extra))


def _png(path):
    return np.asarray(Image.open(path))


def test_png_and_ppm_output(tmp_path, capsys):
    _run(_common(tmp_path / "a.png", ["--metrics"]))
    out = capsys.readouterr()
    m = json.loads(out.out.strip().splitlines()[-1])
    assert m["device"] == "cpu" and m["steps"] == 2
    assert "wrote" in out.err and "(2 accumulated steps)" in out.err
    img = _png(tmp_path / "a.png")
    assert img.shape == (H, W, 3) and img.dtype == np.uint8 and img.std() > 0
    _run(_common(tmp_path / "a.ppm"))
    raw = (tmp_path / "a.ppm").read_bytes()
    assert raw.startswith(f"P6 {W} {H} 255\n".encode())
    assert len(raw) == raw.index(b"\n") + 1 + W * H * 3
    np.testing.assert_array_equal(load_ppm(tmp_path / "a.ppm"), img)


def test_save_resume_adds_steps_and_equals_one_run(tmp_path):
    """2 steps saved, then 2 resumed (seeds offset by the restored count),
    equal 4 steps at once, bit for bit; the counts add up."""
    seed = ["--time-seed", "5"]
    _run(_common(tmp_path / "a.png", seed + ["--save-state",
                                             str(tmp_path / "s.npz")]))
    st = np.load(tmp_path / "s.npz")
    assert int(st["num_steps"]) == 2 and st["canvas"].shape == (H, W, 3)
    _run(_common(tmp_path / "b.png",
                 seed + ["--load-state", str(tmp_path / "s.npz"),
                         "--save-state", str(tmp_path / "s2.npz")]))
    resumed = np.load(tmp_path / "s2.npz")
    assert int(resumed["num_steps"]) == 4
    argv = _common(tmp_path / "c.png", seed + [
        "--save-state", str(tmp_path / "s4.npz")])
    argv[argv.index("--steps") + 1] = "4"
    _run(argv)
    once = np.load(tmp_path / "s4.npz")
    np.testing.assert_array_equal(resumed["canvas"], once["canvas"])
    np.testing.assert_array_equal(_png(tmp_path / "b.png"),
                                  _png(tmp_path / "c.png"))
    assert not np.array_equal(_png(tmp_path / "a.png"),
                              _png(tmp_path / "b.png"))


def test_scene_json_round_trip(tmp_path):
    scene, camera, _ = CONFIGS[1]()
    save_scene(tmp_path / "scene.json", scene, camera)
    argv = _common(tmp_path / "direct.png")
    _run(argv)
    argv[:2] = ["--scene", str(tmp_path / "scene.json")]
    argv[argv.index("--out") + 1] = str(tmp_path / "from_json.png")
    _run(argv)
    np.testing.assert_array_equal(_png(tmp_path / "from_json.png"),
                                  _png(tmp_path / "direct.png"))


def test_missing_scene_file_exits_2(tmp_path, capsys):
    rc = main(["--scene", str(tmp_path / "none.json"), "--out",
               str(tmp_path / "x.png"), "--device", "cpu"])
    assert rc == 2
    assert "not found" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.png")


def test_warm_writes_nothing(tmp_path, capsys):
    _run(_common(tmp_path / "never.png",
                 ["--save-state", str(tmp_path / "never.npz"),
                  "--profile-dir", str(tmp_path / "prof")]))
    for name in ("never.png", "never.npz"):
        os.remove(tmp_path / name)
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    capsys.readouterr()
    _run(_common(tmp_path / "never.png",
                 ["--warm", "--save-state", str(tmp_path / "never.npz")]))
    assert sorted(os.listdir(tmp_path)) == ["prof"]
    assert f"warmed {W}x{H} s1 b2" in capsys.readouterr().err


@pytest.mark.parametrize("ext", ["obj", "stl"])
def test_mesh_path_and_aov(ext, tmp_path):
    """Config 4 from a mesh file the port wrote (an OBJ gives the image
    of the procedural mesh it came from), then its depth AOV: grey, 0
    where the top rows miss."""
    pos, nrm = organic_blob(subdivisions=3)
    path = tmp_path / f"blob.{ext}"
    (save_obj(path, pos, nrm) if ext == "obj" else save_stl(path, pos))
    _run(_common(tmp_path / "file.png", ["--mesh-path", str(path)],
                 config="4"))
    _run(_common(tmp_path / "blob.png", config="4"))
    file_img = _png(tmp_path / "file.png")
    assert file_img.std() > 0
    if ext == "obj":
        np.testing.assert_array_equal(file_img, _png(tmp_path / "blob.png"))
    _run(_common(tmp_path / "depth.png", ["--mesh-path", str(path),
                                          "--aov", "depth"], config="4"))
    depth = _png(tmp_path / "depth.png")
    assert depth[0].max() == 0 and depth[-1].min() > 0
    np.testing.assert_array_equal(depth[..., 0], depth[..., 1])


@pytest.mark.parametrize("aov", ["normals", "albedo", None])
def test_cli_image_equals_renderer(aov, tmp_path):
    extra = ["--time-seed", "3"] + (["--aov", aov] if aov else [])
    _run(_common(tmp_path / "a.png", extra, config="2"))
    scene, camera, options = CONFIGS[2]()
    r = Renderer(dataclasses.replace(options, width=W, height=H,
                                     num_samples=1, num_bounces=2, aov=aov),
                 scene, device="cpu")
    for t in (3, 4):
        r.step(camera, time=t)
    np.testing.assert_array_equal(_png(tmp_path / "a.png"), r.image())


def test_port_checkpoint_resumes_in_jax_cli(tmp_path):
    """The port's --save-state file loads in the JAX CLI (--steps 0): the
    same canvas, step count and PNG."""
    _run(_common(tmp_path / "port.png",
                 ["--save-state", str(tmp_path / "port.npz")]))
    argv = _common(tmp_path / "jax.png",
                   ["--load-state", str(tmp_path / "port.npz"),
                    "--save-state", str(tmp_path / "jax.npz")])
    argv[argv.index("--steps") + 1] = "0"
    assert jmain(argv) == 0
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    np.testing.assert_array_equal(a["canvas"], b["canvas"])
    assert int(a["num_steps"]) == int(b["num_steps"]) == 2
    np.testing.assert_array_equal(_png(tmp_path / "port.png"),
                                  _png(tmp_path / "jax.png"))


def test_no_card_without_device_cpu_fails(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(_common(tmp_path / "x.png"))
    assert rc != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.png")
    # the multi-device flags ask for the card as well (and, for
    # --distributed, before the process group is joined)
    for flags in (["--all-devices"], ["--all-devices", "--distributed",
                                      "--num-processes", "2"]):
        assert main(_common(tmp_path / "x.png", flags)) != 0
        assert "--device cpu" in capsys.readouterr().err
        assert not os.path.exists(tmp_path / "x.png")
