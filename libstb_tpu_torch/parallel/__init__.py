from . import distributed, mesh

__all__ = ["distributed", "mesh"]
