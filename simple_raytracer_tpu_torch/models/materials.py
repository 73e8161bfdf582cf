"""Host-side material model.

Mirrors ``Material`` (include/material.hpp:10-38: 8 fields, defaults = white
diffuse) and ``MaterialHelper`` (include/helper.hpp:33-58: parallel
materials/names vectors with push/remove).  ``MaterialSet.remove`` also
reproduces the editor's shape-reindex-on-delete semantics
(src/interface.cpp:405-422): shapes using the deleted material fall back to
0, higher indices shift down, and an empty set regrows a default
"Material0".
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

Color = Tuple[float, float, float]

WHITE: Color = (1.0, 1.0, 1.0)
BLACK: Color = (0.0, 0.0, 0.0)
GRAY: Color = (0.5, 0.5, 0.5)


def from_hex(value: int) -> Color:
    """Mirrors color::from_hex (include/color.hpp:11-13)."""
    return (
        ((value & 0xFF0000) >> 16) / 255.0,
        ((value & 0xFF00) >> 8) / 255.0,
        (value & 0xFF) / 255.0,
    )


def from_rgb(r: int, g: int, b: int) -> Color:
    """Mirrors color::from_RGB (include/color.hpp:15-17)."""
    return (r / 255.0, g / 255.0, b / 255.0)


@dataclasses.dataclass
class Material:
    color: Color = WHITE
    smoothness: float = 0.0
    metallic: float = 0.0
    specular: float = 0.0
    transmittance: float = 0.0
    refraction_index: float = 1.0
    emission: Color = BLACK
    emission_strength: float = 0.0


class MaterialSet:
    """Ordered, named material list; indices are stable handles for shapes."""

    def __init__(self):
        self.materials: List[Material] = []
        self.names: List[str] = []

    def push(self, material: Material, name: Optional[str] = None) -> int:
        """Append and return the new index (MaterialHelper::push/last_index)."""
        if name is None:
            name = f"Material{len(self.materials)}"
        self.materials.append(material)
        self.names.append(name)
        return len(self.materials) - 1

    def remove(self, index: int, shapes=None) -> None:
        """Delete a material, reindexing shape references like the editor
        (interface.cpp:405-422).  `shapes` is any iterable of objects with a
        mutable integer ``material`` attribute."""
        if not 0 <= index < len(self.materials):
            # a negative index would delete via Python indexing but then
            # decrement EVERY shape reference (shape.material > -1),
            # silently corrupting assignments to -1
            raise IndexError(index)
        del self.materials[index]
        del self.names[index]
        if not self.materials:
            self.push(Material(), "Material0")
        if shapes is not None:
            for shape in shapes:
                if shape.material == index:
                    shape.material = 0
                elif shape.material > index:
                    shape.material -= 1

    def __len__(self) -> int:
        return len(self.materials)

    def __getitem__(self, i: int) -> Material:
        return self.materials[i]
