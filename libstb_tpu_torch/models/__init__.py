from . import driver, hpyp, pyp

__all__ = ["driver", "hpyp", "pyp"]
