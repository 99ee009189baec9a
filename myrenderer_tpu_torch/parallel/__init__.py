from .sharding import Banded, Mesh, make_mesh, sharded_render_step

__all__ = ["Banded", "Mesh", "make_mesh", "sharded_render_step"]
