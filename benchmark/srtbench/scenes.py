"""A configuration's scene, made by the benchmark and handed to both sides.

The configuration file states the scene: materials, planes, spheres,
meshes (a generator of ``benchmark/meshes/`` by name, its arguments, a
material and a translate-rotate-scale transform), the sky, the camera
and the bounce depth.  ``meshes`` makes each mesh once and caches its
arrays under a fixed directory of the checkout; ``port_scene`` builds the
program's scene from them through its public API, as its presets do;
``reference_arrays`` gives the reference the same data in world space.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
from pathlib import Path

import numpy as np

from .spec import BENCH_DIR

CACHE_DIR = BENCH_DIR / ".cache" / "meshes"
MATERIAL_DEFAULTS = {"color": (1.0, 1.0, 1.0), "smoothness": 0.0,
                     "metallic": 0.0, "specular": 0.0, "transmittance": 0.0,
                     "refraction_index": 1.0, "emission": (0.0, 0.0, 0.0),
                     "emission_strength": 0.0}
SKY_KEYS = ("sun_focus", "sun_intensity", "sun_color", "sun_direction",
            "horizon_color", "zenith_color", "ground_color")


def material_fields(m: dict) -> dict:
    return {k: m.get(k, v) for k, v in MATERIAL_DEFAULTS.items()}


def generator(name: str, bench_dir: Path = BENCH_DIR):
    path = Path(bench_dir) / "meshes" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no mesh generator {path}")
    spec = importlib.util.spec_from_file_location(f"srtbench_mesh_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.generate


def mesh_arrays(mesh: dict, cache_dir: Path = CACHE_DIR,
                bench_dir: Path = BENCH_DIR):
    """(positions, normals) (M, 3, 3) f32 in object space of one mesh
    entry, from the cache when its generator's source and arguments are
    the same."""
    name, args = mesh["generator"], mesh.get("args", {})
    src = (Path(bench_dir) / "meshes" / f"{name}.py").read_bytes()
    key = hashlib.sha256(src + json.dumps(args, sort_keys=True).encode()
                         ).hexdigest()[:16]
    path = Path(cache_dir) / f"{name}-{key}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["positions"], z["normals"]
    pos, nrm = generator(name, bench_dir)(**args)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + ".part.npz")
    np.savez(tmp, positions=pos, normals=nrm)
    os.replace(tmp, path)
    return pos, nrm


def trs(translation=(0, 0, 0), rotation_ypr=(0, 0, 0),
        scale=(1, 1, 1)) -> np.ndarray:
    """T @ RotY(yaw) @ RotX(pitch) @ RotZ(roll) @ S as a 4x4 f32 matrix
    (the reference editor's composition)."""
    yaw, pitch, roll = rotation_ypr
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (ry @ rx @ rz) * np.asarray(scale, np.float32)[None, :]
    m[:3, 3] = translation
    return m


def transform(mesh: dict) -> np.ndarray:
    return trs(mesh.get("translation", (0, 0, 0)),
               mesh.get("rotation_ypr", (0, 0, 0)),
               mesh.get("scale", (1, 1, 1)))


def meshes(cfg: dict, cache_dir: Path = CACHE_DIR,
           bench_dir: Path = BENCH_DIR) -> list:
    return [mesh_arrays(m, cache_dir, bench_dir) for m in cfg["meshes"]]


def port_scene(cfg: dict, mesh_data: list):
    """The program's host scene, built through its public API."""
    from simple_raytracer_tpu_torch.models.materials import Material
    from simple_raytracer_tpu_torch.models.scene import Scene

    scene = Scene(default_material=False)
    for m in cfg["materials"]:
        scene.add_material(Material(**material_fields(m)), m.get("name"))
    for p in cfg.get("planes", []):
        scene.add_plane(tuple(p["position"]), tuple(p["normal"]),
                        p["material"])
    for s in cfg.get("spheres", []):
        scene.add_sphere(tuple(s["position"]), s["radius"], s["material"])
    for m, (pos, nrm) in zip(cfg["meshes"], mesh_data):
        span = scene.pool.append(pos, nrm)
        scene.add_model(span, material=m["material"], transform=transform(m))
    for k in SKY_KEYS:
        v = cfg["sky"][k]
        setattr(scene.sky, k, tuple(v) if isinstance(v, list) else v)
    return scene


def port_camera(cfg: dict):
    from simple_raytracer_tpu_torch.models.camera import Camera
    c = cfg["camera"]
    return Camera(position=tuple(c["position"]), yaw=c["yaw"],
                  pitch=c["pitch"], fov=c["fov"])


def reference_arrays(cfg: dict, mesh_data: list) -> dict:
    """The scene as the reference takes it: world-space triangles."""
    f32 = np.float32
    mats = [material_fields(m) for m in cfg["materials"]]
    out = {f"materials.{k}": np.array([m[k] for m in mats], f32)
           for k in MATERIAL_DEFAULTS}
    sph, pln = cfg.get("spheres", []), cfg.get("planes", [])
    out["spheres.center"] = np.array([s["position"] for s in sph],
                                     f32).reshape(-1, 3)
    out["spheres.radius"] = np.array([s["radius"] for s in sph], f32)
    out["spheres.material"] = np.array([s["material"] for s in sph], np.int64)
    out["planes.position"] = np.array([p["position"] for p in pln],
                                      f32).reshape(-1, 3)
    out["planes.normal"] = np.array([p["normal"] for p in pln],
                                    f32).reshape(-1, 3)
    out["planes.material"] = np.array([p["material"] for p in pln], np.int64)
    pos_w = [np.zeros((0, 3, 3), f32)]
    nrm_w = [np.zeros((0, 3, 3), f32)]
    mat = [np.zeros((0,), np.int64)]
    for m, (pos, nrm) in zip(cfg["meshes"], mesh_data):
        t = transform(m)
        pos_w.append(pos @ t[:3, :3].T + t[:3, 3])
        nrm_w.append(nrm @ t[:3, :3].T)
        mat.append(np.full((pos.shape[0],), m["material"], np.int64))
    out["triangles.positions"] = np.concatenate(pos_w).astype(f32)
    out["triangles.normals"] = np.concatenate(nrm_w).astype(f32)
    out["triangles.material"] = np.concatenate(mat)
    for k in SKY_KEYS:
        out[f"sky.{k}"] = np.asarray(cfg["sky"][k], f32)
    return out
