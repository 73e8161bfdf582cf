"""Host scene model: primitives, materials, cameras, preset scenes."""

from .camera import Camera
from .materials import Material, MaterialSet
from .scene import Scene, SkySettings
from .shapes import Plane, Sphere
