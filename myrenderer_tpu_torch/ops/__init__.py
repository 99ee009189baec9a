from . import raster, raster_common, raster_cuda, setup_pack, vertex_stage

__all__ = ["raster", "raster_common", "raster_cuda", "setup_pack",
           "vertex_stage"]
