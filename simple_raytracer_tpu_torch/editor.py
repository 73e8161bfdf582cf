"""Scene editor: the reference's editor verbs as a JSON command surface.

The port's copy of ``simple_raytracer_tpu.editor``, on the port's host
``Scene``.  The reference's editor windows (src/interface.cpp:106-480:
the shape list with add, duplicate, delete, select and material
assignment, the model-import popup with its error line, the material
editor, the scene lighting editor, the render parameters) mutate host
vectors and return a ``rerender`` flag that resets accumulation
(main.cpp:270-280).  Here the same verbs are one ``apply(command)`` entry
point over the host ``Scene``, returning ``changed`` with the same
meaning; the viewer (``viewer.py``) posts these commands over HTTP, and
any other client can call them directly.  Everything here runs on the
host: picking is float64 numpy.

Shapes are addressed by (kind, index): kind in {"sphere", "plane",
"model"}, index into the scene's list of that kind.  Model transforms are
edited as TRS components, as the reference's gizmo glue decomposes and
recomposes them (interface.cpp:69-104, helper.hpp:76-89).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np

from .models.materials import Material
from .models.scene import Scene
from .models.shapes import transform_trs

_KINDS = {"sphere": "spheres", "plane": "planes", "model": "models"}

_MATERIAL_FIELDS = ("color", "smoothness", "metallic", "specular",
                    "transmittance", "refraction_index", "emission",
                    "emission_strength")

_SKY_FIELDS = ("sun_focus", "sun_intensity", "sun_color", "sun_direction",
               "horizon_color", "zenith_color", "ground_color")


class EditError(ValueError):
    """A rejected edit (bad id, bad field, missing file...); the viewer
    surfaces the message like the import popup's error line
    (interface.cpp:277-290)."""


def decompose_trs(m: np.ndarray):
    """Split a TRS matrix back into (translation, (yaw, pitch, roll),
    scale) under the transform_trs composition T @ Ry @ Rx @ Rz @ S —
    the editor's model decomposition (helper.hpp:76-89)."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    scale = np.linalg.norm(m[:3, :3], axis=0)
    scale[scale == 0] = 1.0
    r = m[:3, :3] / scale[None, :]
    # r = Ry(yaw) @ Rx(pitch) @ Rz(roll)
    pitch = math.asin(max(-1.0, min(1.0, -r[1, 2])))
    if abs(r[1, 2]) < 0.9999:
        yaw = math.atan2(r[0, 2], r[2, 2])
        roll = math.atan2(r[1, 0], r[1, 1])
    else:   # gimbal lock: fold everything into yaw
        yaw = math.atan2(-r[2, 0], r[0, 0])
        roll = 0.0
    return (tuple(float(v) for v in t), (yaw, pitch, roll),
            tuple(float(v) for v in scale))


def _vec3(value, name) -> tuple:
    try:
        x, y, z = (float(v) for v in value)
    except (TypeError, ValueError):
        raise EditError(f"{name} must be a 3-vector") from None
    return (x, y, z)


def _index_of(lst, obj) -> int:
    """Identity-based index (dataclass == compares fields, so duplicates
    would resolve to the original)."""
    for i, item in enumerate(lst):
        if item is obj:
            return i
    raise EditError("shape vanished during edit")


class SceneEditor:
    """Editing verbs over a host Scene; every successful edit invokes
    ``on_change`` (the viewer hooks accumulation reset + device re-upload
    there, the time_not_moved=1 contract)."""

    def __init__(self, scene: Scene,
                 on_change: Optional[Callable[..., None]] = None):
        self.scene = scene
        # the hook receives the op name so the viewer can pick a cheap
        # BVH refit for transform-only edits; hooks that ignore it (older
        # callers, tests) still work
        raw = on_change or (lambda *a: None)
        try:
            import inspect
            takes_op = len(inspect.signature(raw).parameters) >= 1
        except (TypeError, ValueError):
            takes_op = False
        self.on_change = raw if takes_op else (lambda op=None: raw())

    # -- inspection --------------------------------------------------------
    def describe(self) -> dict:
        """Full editable state as JSON-ready dicts (the data the ImGui
        panels render each frame)."""
        sc = self.scene
        shapes = []
        for i, s in enumerate(sc.spheres):
            shapes.append({"kind": "sphere", "index": i,
                           "material": s.material,
                           "position": list(s.position),
                           "radius": s.radius})
        for i, p in enumerate(sc.planes):
            shapes.append({"kind": "plane", "index": i,
                           "material": p.material,
                           "position": list(p.position),
                           "normal": list(p.normal)})
        for i, m in enumerate(sc.models):
            t, rot, scale = decompose_trs(m.transform)
            shapes.append({"kind": "model", "index": i,
                           "material": m.material,
                           "triangles": m.num_triangles,
                           "translation": list(t),
                           "rotation": list(rot),
                           "scale": list(scale)})
        materials = []
        for i, m in enumerate(sc.materials.materials):
            materials.append({
                "index": i, "name": sc.materials.names[i],
                "color": list(m.color), "smoothness": m.smoothness,
                "metallic": m.metallic, "specular": m.specular,
                "transmittance": m.transmittance,
                "refraction_index": m.refraction_index,
                "emission": list(m.emission),
                "emission_strength": m.emission_strength,
            })
        sky = {f: (list(v) if isinstance(v, (tuple, list)) else v)
               for f, v in ((f, getattr(sc.sky, f)) for f in _SKY_FIELDS)}
        return {"shapes": shapes, "materials": materials, "sky": sky}

    # -- commands ----------------------------------------------------------
    def apply(self, cmd: dict) -> dict:
        """Dispatch one command; returns {"ok": True, "changed": bool, ...}.
        Raises EditError for rejected edits."""
        if not isinstance(cmd, dict) or "op" not in cmd:
            raise EditError("command must be an object with an 'op' field")
        op = cmd["op"]
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            raise EditError(f"unknown op {op!r}")
        result = handler(cmd) or {}
        if result.pop("_changed", True):
            self.on_change(op)
            result.setdefault("changed", True)
        else:
            result.setdefault("changed", False)
        result["ok"] = True
        return result

    def _shape(self, cmd):
        kind = cmd.get("kind")
        if kind not in _KINDS:
            raise EditError(f"unknown shape kind {cmd.get('kind')!r}")
        lst = getattr(self.scene, _KINDS[kind])
        try:
            index = int(cmd["index"])
            if index < 0:
                raise IndexError
            return lst[index], kind
        except (KeyError, ValueError, TypeError, IndexError):
            raise EditError(f"no {kind} with index {cmd.get('index')!r}"
                            ) from None

    # shape list (interface.cpp:106-310)
    def _op_add_sphere(self, cmd):
        s = self.scene.add_sphere(cmd.get("position", (0.0, 0.0, 0.0)),
                                  float(cmd.get("radius", 1.0)),
                                  material=int(cmd.get("material", 0)))
        return {"index": _index_of(self.scene.spheres, s)}

    def _op_add_plane(self, cmd):
        p = self.scene.add_plane(cmd.get("position", (0.0, 0.0, 0.0)),
                                 cmd.get("normal", (0.0, 1.0, 0.0)),
                                 material=int(cmd.get("material", 0)))
        return {"index": _index_of(self.scene.planes, p)}

    def _op_add_box(self, cmd):
        m = self.scene.add_box(cmd.get("position", (0.0, 0.0, 0.0)),
                               size=cmd.get("size", (2.0, 2.0, 2.0)),
                               material=int(cmd.get("material", 0)))
        return {"index": _index_of(self.scene.models, m)}

    def _op_import_model(self, cmd):
        path = cmd.get("path")
        if not path:
            raise EditError("import_model needs a 'path'")
        try:
            m = self.scene.import_model(path,
                                        material=int(cmd.get("material", 0)))
        except FileNotFoundError:
            # the import popup's "Inexistant file" error line
            raise EditError(f"Inexistant file: {path}") from None
        except ValueError as e:
            raise EditError(str(e)) from None
        return {"index": _index_of(self.scene.models, m),
                "triangles": m.num_triangles}

    def _op_remove_shape(self, cmd):
        shape, _ = self._shape(cmd)
        self.scene.remove_shape(shape)
        return {}

    def _op_duplicate_shape(self, cmd):
        shape, kind = self._shape(cmd)
        dup = self.scene.duplicate_shape(shape)
        return {"index": _index_of(getattr(self.scene, _KINDS[kind]), dup)}

    def _op_reorder_shape(self, cmd):
        """Move a shape to a new position in its kind's list (the shape
        list's drag-to-reorder, interface.cpp:203-216).  Purely
        presentational for rendering (hit resolution is a global argmin),
        but indices shift: returns the shape's new index so the client
        can keep it selected."""
        shape, kind = self._shape(cmd)
        lst = getattr(self.scene, _KINDS[kind])
        try:
            to = int(cmd["to"])
        except (KeyError, ValueError, TypeError):
            raise EditError("reorder needs an integer 'to' position") from None
        to = max(0, min(len(lst) - 1, to))
        # pop by INDEX: dataclass shapes compare by value, so with a
        # duplicated shape list.remove(shape) deletes the first EQUAL
        # element, corrupting the list (same hazard _index_of documents)
        lst.pop(int(cmd["index"]))
        lst.insert(to, shape)
        return {"index": to}

    def _op_set_shape_material(self, cmd):
        shape, _ = self._shape(cmd)
        try:
            self.scene.set_material(shape, int(cmd["material"]))
        except (KeyError, ValueError, TypeError, IndexError):
            raise EditError(
                f"bad material index {cmd.get('material')!r}") from None
        return {}

    # per-shape properties incl. the gizmo writebacks
    # (interface.cpp:13-104: sphere pos/radius, plane pos/normal-from-quat,
    # model TRS recompose)
    def _op_set_shape(self, cmd):
        shape, kind = self._shape(cmd)
        if kind == "sphere":
            if "position" in cmd:
                shape.position = _vec3(cmd["position"], "position")
            if "radius" in cmd:
                shape.radius = abs(float(cmd["radius"]))
        elif kind == "plane":
            if "position" in cmd:
                shape.position = _vec3(cmd["position"], "position")
            if "normal" in cmd:
                n = np.asarray(_vec3(cmd["normal"], "normal"), np.float64)
                ln = np.linalg.norm(n)
                if ln == 0:
                    raise EditError("plane normal must be nonzero")
                shape.normal = tuple(float(v) for v in n / ln)
        else:
            t, rot, scale = decompose_trs(shape.transform)
            t = _vec3(cmd.get("translation", t), "translation")
            rot = _vec3(cmd.get("rotation", rot), "rotation")
            scale = _vec3(cmd.get("scale", scale), "scale")
            if "transform" in cmd:
                m = np.asarray(cmd["transform"], np.float32)
                if m.shape != (4, 4):
                    raise EditError("transform must be 4x4")
                self.scene.set_model_transform(shape, m)
            else:
                self.scene.set_model_transform(
                    shape, transform_trs(t, rot, scale))
        return {}

    def _op_translate_shape(self, cmd):
        """Gizmo drag analog: move any shape by a world-space delta."""
        shape, kind = self._shape(cmd)
        d = np.asarray(_vec3(cmd.get("delta", (0, 0, 0)), "delta"))
        if kind == "model":
            m = np.array(shape.transform, np.float32)
            m[:3, 3] += d.astype(np.float32)
            self.scene.set_model_transform(shape, m)
        else:
            shape.position = tuple(float(p + dv)
                                   for p, dv in zip(shape.position, d))
        return {}

    def _op_rotate_shape(self, cmd):
        """Gizmo rotate mode: rotate a shape in place about a world-space
        axis.  Planes rotate their normal (the quat glue,
        interface.cpp:46-63); models premultiply the rotation onto the
        3x3 part with the translation fixed (the TRS recompose,
        interface.cpp:69-104); spheres are rotation-invariant, so the op
        is accepted but changes nothing (the reference gizmo shows only
        translate/scale handles for spheres, interface.cpp:13-34)."""
        shape, kind = self._shape(cmd)
        axis = np.asarray(_vec3(cmd.get("axis", (0, 1, 0)), "axis"),
                          np.float64)
        ln = np.linalg.norm(axis)
        if ln == 0:
            raise EditError("rotation axis must be nonzero")
        axis /= ln
        angle = float(cmd.get("angle", 0.0))
        k = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        rot = (np.eye(3) + math.sin(angle) * k
               + (1 - math.cos(angle)) * (k @ k))
        if kind == "sphere":
            return {"_changed": False}
        if kind == "plane":
            n = rot @ np.asarray(shape.normal, np.float64)
            shape.normal = tuple(float(v) for v in n / np.linalg.norm(n))
        else:
            m = np.array(shape.transform, np.float64)
            m[:3, :3] = rot @ m[:3, :3]
            self.scene.set_model_transform(shape, m.astype(np.float32))
        return {}

    def _op_scale_shape(self, cmd):
        """Gizmo scale mode: uniform scale about the shape's own origin,
        or along ONE LOCAL axis when cmd["axis"] is "x"/"y"/"z" (the
        per-axis handle of tiny-gizmo's scale dragger, which edits one
        component of an object-frame scale vec3 — shear-free by
        construction).  Spheres scale their radius either way (the
        radius-from-scale-diff glue, interface.cpp:13-34 — a sphere has
        no per-axis extent); planes are infinite and cannot be scaled."""
        shape, kind = self._shape(cmd)
        factor = float(cmd.get("factor", 1.0))
        if not (factor > 0.0) or not math.isfinite(factor):
            raise EditError("scale factor must be positive and finite")
        axis = cmd.get("axis")
        if axis is not None and axis not in ("x", "y", "z"):
            raise EditError(f"unknown scale axis {axis!r}")
        if kind == "plane":
            raise EditError("planes are infinite and cannot be scaled")
        if kind == "sphere":
            shape.radius = float(shape.radius) * factor
        else:
            m = np.array(shape.transform, np.float64)
            if axis is None:
                m[:3, :3] *= factor
            else:
                # per-axis scale acts in the instance's LOCAL frame
                # (post-multiplied diagonal), like tiny-gizmo's scale
                # dragger adjusting one component of its scale vec3
                # (tiny-gizmo.hpp rigid_transform).  A world-axis stretch
                # (premultiplied I + (f-1)aa^T) on a rotated model
                # shears m, which the T*Ry*Rx*Rz*S decomposition
                # (decompose_trs) cannot represent — any later TRS-based
                # verb would silently snap the geometry.
                m[:3, "xyz".index(axis)] *= factor
            self.scene.set_model_transform(shape, m.astype(np.float32))
        return {}

    # material editor (interface.cpp:387-480)
    def _op_add_material(self, cmd):
        fields = cmd.get("fields", {})
        mat = Material()
        self._update_material_fields(mat, fields)
        idx = self.scene.add_material(mat, cmd.get("name"))
        return {"index": idx}

    def _op_remove_material(self, cmd):
        try:
            index = int(cmd["index"])
            if not 0 <= index < len(self.scene.materials):
                raise IndexError   # negative indexing is not part of the
                                   # command surface (reindex would corrupt)
        except (KeyError, ValueError, TypeError, IndexError):
            raise EditError(
                f"no material with index {cmd.get('index')!r}") from None
        self.scene.remove_material(index)
        return {}

    def _op_rename_material(self, cmd):
        try:
            index = int(cmd["index"])
            self.scene.materials.names[index] = str(cmd["name"])
        except (KeyError, ValueError, IndexError):
            raise EditError("rename_material needs valid 'index' and 'name'"
                            ) from None
        return {"_changed": False}   # names are host-only: no rerender

    def _op_update_material(self, cmd):
        try:
            index = int(cmd["index"])
            mat = self.scene.materials[index]
        except (KeyError, ValueError, IndexError):
            raise EditError(
                f"no material with index {cmd.get('index')!r}") from None
        self._update_material_fields(mat, cmd.get("fields", {}))
        return {}

    @staticmethod
    def _update_material_fields(mat: Material, fields: dict):
        for key, value in fields.items():
            if key not in _MATERIAL_FIELDS:
                raise EditError(f"unknown material field {key!r}")
            if key in ("color", "emission"):
                setattr(mat, key, _vec3(value, key))
            else:
                try:
                    setattr(mat, key, float(value))
                except (TypeError, ValueError):
                    raise EditError(
                        f"material field {key!r} must be a number, "
                        f"got {value!r}") from None

    # scene lighting editor (interface.cpp:344-367)
    def _op_set_sky(self, cmd):
        sky = self.scene.sky
        for key, value in cmd.get("fields", {}).items():
            if key not in _SKY_FIELDS:
                raise EditError(f"unknown sky field {key!r}")
            if key in ("sun_focus", "sun_intensity"):
                setattr(sky, key, float(value))
            else:
                v = _vec3(value, key)
                if key == "sun_direction":
                    n = np.linalg.norm(v)
                    if n == 0:
                        raise EditError("sun_direction must be nonzero")
                    v = tuple(float(c / n) for c in v)
                setattr(sky, key, v)
        return {}

    # -- picking (selection support; the reference selects via the list UI,
    #    interface.cpp:202-229 — click-to-select is a viewer nicety) -------
    # (module-level repair_selection below keeps a client's selection
    #  consistent across the structural edits this class applies)
    def pick(self, origin, direction) -> Optional[dict]:
        """Nearest shape hit by the world-space ray, as {kind, index}.
        Spheres/planes are exact; models use their world AABB (the same
        shortcut the reference kernel uses to gate triangle tests)."""
        return self.pick_with_t(origin, direction)[1]

    def pick_t(self, origin, direction) -> float:
        """Distance to the nearest shape along the ray (+inf on a miss)
        — the scene-depth term the gizmo occlusion test compares handle
        hits against (tiny-gizmo renders its handles with real depth;
        here the comparison is exact along the very ray being picked)."""
        return self.pick_with_t(origin, direction)[0]

    def pick_with_t(self, origin, direction) -> Tuple[float,
                                                      Optional[dict]]:
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        best = (math.inf, None)

        for i, s in enumerate(self.scene.spheres):
            rc = np.asarray(s.position) - o
            b = float(rc @ d)
            c = float(rc @ rc) - s.radius * s.radius
            disc = b * b - c
            if disc < 0:
                continue
            sq = math.sqrt(disc)
            t = b - sq if b - sq >= 0 else b + sq
            if 0 <= t < best[0]:
                best = (t, {"kind": "sphere", "index": i})
        for i, p in enumerate(self.scene.planes):
            denom = float(np.asarray(p.normal) @ d)
            if denom == 0:
                continue
            t = float((np.asarray(p.position) - o) @ np.asarray(p.normal))
            t /= denom
            if 0 <= t < best[0]:
                best = (t, {"kind": "plane", "index": i})
        for i, m in enumerate(self.scene.models):
            lo, hi = m.bounding_box(self.scene.pool)
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / d
                t1 = (lo - o) * inv
                t2 = (hi - o) * inv
            near = max(np.minimum(t1, t2).max(), 0.0)
            far = np.maximum(t1, t2).min()
            if near <= far and near < best[0]:
                best = (near, {"kind": "model", "index": i})
        return best


def repair_selection(sel, cmd: dict, result: dict):
    """The selection-index repair for structural edits, as ONE pure
    server-side function: deleting shifts every higher same-kind index
    down, a reorder shifts every index between source and destination,
    a duplicate inserted at-or-below the selection shifts it up.  The
    browser client passes its current selection with each /edit and
    adopts the repaired one from the response, so the arithmetic lives
    in tested Python and the client only renders.

    `sel` is {"kind", "index"} or None; `cmd` the applied edit command;
    `result` the editor's success result (reorder/duplicate report the
    landing index there).  Returns the repaired selection (or None when
    the selected shape was deleted)."""
    if not isinstance(sel, dict) or "kind" not in sel or "index" not in sel:
        return None
    try:
        sel = {"kind": sel["kind"], "index": int(sel["index"])}
    except (TypeError, ValueError):
        return None
    if cmd.get("kind") != sel["kind"]:
        return sel
    op = cmd.get("op")
    idx = sel["index"]
    if op == "remove_shape":
        src = int(cmd["index"])
        if idx == src:
            return None
        if idx > src:
            sel["index"] = idx - 1
    elif op == "reorder_shape":
        src = int(cmd["index"])
        dst = int(result.get("index", cmd.get("to", src)))
        if idx == src:
            sel["index"] = dst
        elif src < idx <= dst:
            sel["index"] = idx - 1
        elif dst <= idx < src:
            sel["index"] = idx + 1
    elif op == "duplicate_shape":
        dup = result.get("index")
        if dup is not None and int(dup) <= idx:
            sel["index"] = idx + 1
    return sel
