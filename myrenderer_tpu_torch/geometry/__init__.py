from .device_tri import triangulate_device, triangulate_indices
from .triangulation import Triangulation, TriangulationError, triangulate
from .unirand import Unirand, unirand_seed

__all__ = [
    "Triangulation",
    "TriangulationError",
    "triangulate",
    "triangulate_device",
    "triangulate_indices",
    "Unirand",
    "unirand_seed",
]
