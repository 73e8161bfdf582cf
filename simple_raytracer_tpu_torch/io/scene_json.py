"""Scene files: JSON, with side files for the triangle pool and the
skybox texture.

The port's copy of ``simple_raytracer_tpu.io.scene_json``, in the same
format, so a scene file written by either package loads in the other:
version 1, the materials with their names, spheres, planes, models (a
span of the pool, a material and a 4x4 transform), the sky settings, the
``sky_reachable`` hint and the camera; the pool in ``<file>.pool.npz``
(positions, normals) and the texture in ``<file>.skybox.npz`` (skybox),
each named in the JSON relative to its directory.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..models.camera import Camera
from ..models.materials import Material
from ..models.scene import Scene, SkySettings


def save_scene(path: os.PathLike, scene: Scene,
               camera: Optional[Camera] = None) -> None:
    """Write ``scene`` (and ``camera``) to ``path`` and its side files."""
    path = str(path)
    doc = {
        "version": 1,
        "materials": [
            {"name": scene.materials.names[i], **vars(m)}
            for i, m in enumerate(scene.materials.materials)
        ],
        "spheres": [vars(s) for s in scene.spheres],
        "planes": [vars(p) for p in scene.planes],
        "models": [
            {
                "material": m.material,
                "triangle_index": m.triangle_index,
                "num_triangles": m.num_triangles,
                "transform": np.asarray(m.transform).tolist(),
            }
            for m in scene.models
        ],
        "sky": vars(scene.sky),
        "sky_reachable": scene.sky_reachable,
        "camera": vars(camera) if camera is not None else None,
        "pool_file": None,
    }
    if len(scene.pool) > 0:
        pool_file = path + ".pool.npz"
        np.savez_compressed(pool_file, positions=scene.pool.positions,
                            normals=scene.pool.normals)
        doc["pool_file"] = os.path.basename(pool_file)
    if scene.skybox is not None:
        skybox_file = path + ".skybox.npz"
        np.savez_compressed(skybox_file, skybox=scene.skybox)
        doc["skybox_file"] = os.path.basename(skybox_file)

    def default(o):
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, tuple):
            return list(o)
        raise TypeError(f"unserializable {type(o)}")

    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=default)


def load_scene(path: os.PathLike) -> Tuple[Scene, Optional[Camera]]:
    """The scene and camera (None when the file has none) of ``path``."""
    path = str(path)
    with open(path) as f:
        doc = json.load(f)

    scene = Scene(default_material=False)
    for m in doc["materials"]:
        name = m.pop("name")
        m["color"] = tuple(m["color"])
        m["emission"] = tuple(m["emission"])
        scene.materials.push(Material(**m), name)
    for s in doc["spheres"]:
        scene.add_sphere(tuple(s["position"]), s["radius"], s["material"])
    for p in doc["planes"]:
        scene.add_plane(tuple(p["position"]), tuple(p["normal"]),
                        p["material"])
    if doc.get("pool_file"):
        pool = np.load(os.path.join(os.path.dirname(path) or ".",
                                    doc["pool_file"]))
        scene.pool.positions = pool["positions"].astype(np.float32)
        scene.pool.normals = pool["normals"].astype(np.float32)
    for m in doc["models"]:
        scene.add_model((m["triangle_index"], m["num_triangles"]),
                        m["material"],
                        np.asarray(m["transform"], np.float32))
    sky = doc.get("sky") or {}
    scene.sky = SkySettings(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in sky.items()})
    scene.sky_reachable = bool(doc.get("sky_reachable", True))
    if doc.get("skybox_file"):
        skybox = np.load(os.path.join(os.path.dirname(path) or ".",
                                      doc["skybox_file"]))
        scene.skybox = skybox["skybox"].astype(np.float32)

    camera = None
    if doc.get("camera"):
        c = doc["camera"]
        camera = Camera(position=tuple(c["position"]), yaw=c["yaw"],
                        pitch=c["pitch"], fov=c["fov"])
    return scene, camera
