"""Native (C++) host-side components, loaded through ctypes.

The port's own copy of libstb_tpu/native (tests/test_torch_native.py holds
``stb_ref.cpp`` byte-equal to the original and the results bitwise equal):

* ``fill_ref(a, N, M)`` -- the long-double reference Stirling fill: the
  verification oracle beyond f64 for the port's fills (stable.c
  recurrence semantics; see stb_ref.cpp);
* ``crp_generate(...)`` -- native CRP data simulation (demo.c:284-311
  semantics), returning the port's ``models.pyp.PYPData``.

The shared library is built with g++ on first use into
``libstb_tpu_torch/_build/``, named by a hash of the source and flags, and
moved into place from a temporary file, so processes that build it at
once do not collide.  ``available()`` says whether a toolchain or a built
library is there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "build", "fill_ref", "crp_generate"]

_SRC = Path(__file__).resolve().parent / "stb_ref.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O2", "-shared", "-fPIC")
_lib = None


def _target() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD_DIR / f"stb_ref_{tag.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile stb_ref.cpp unless built; returns the library's path.
    Raises if g++ is missing or fails."""
    out = _target()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("native: g++ not found")
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"native: g++ failed on {_SRC.name}:\n"
                           f"{res.stderr}")
    os.replace(tmp, out)             # atomic against concurrent builds
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.stb_fill_ref.argtypes = [ctypes.c_double, ctypes.c_int64,
                                 ctypes.c_int64, dp, dp, dp]
    lib.stb_fill_ref.restype = None
    lib.stb_crp_generate.argtypes = [
        ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, dp, ip, ip, ip, ip, ip,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.stb_crp_generate.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """True if the library is built or g++ can build it."""
    try:
        _load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _ptr(x, ctype=ctypes.c_double):
    return None if x is None else x.ctypes.data_as(ctypes.POINTER(ctype))


def fill_ref(a: float, n_max: int, m_max: int,
             want_logs: bool = True, want_v: bool = True,
             want_s1: bool = True):
    """Long-double reference fill; returns (logS, V, S1) as f64 numpy
    arrays (None where not requested).  Layout as core/stirling.py's:
    [n-1, m-1]."""
    lib = _load()
    logS = np.empty((n_max, m_max), np.float64) if want_logs else None
    V = np.empty((n_max, m_max), np.float64) if want_v else None
    S1 = np.empty((n_max,), np.float64) if want_s1 else None
    lib.stb_fill_ref(float(a), n_max, m_max, _ptr(logS), _ptr(V), _ptr(S1))
    return logS, V, S1


def crp_generate(seed: int, n_groups: int, dim: int, n_per_group: int,
                 a: float, b: float, H: Optional[np.ndarray] = None,
                 return_latent: bool = False):
    """Native CRP simulation; returns a models.pyp.PYPData (its own
    xorshift stream, not numpy's: the data differ from
    ``pyp.crp_generate``'s for the same seed).

    ``return_latent=True`` also returns the generator's latent table
    counts: (data, t, T) with t (J, D) and T (J,) -- for the statistical
    tests against the known PYP E[T] formula."""
    lib = _load()
    from ..models import pyp

    L = n_groups * n_per_group
    n = np.zeros((n_groups, dim), np.int32)
    t = np.zeros((n_groups, dim), np.int32)
    T = np.zeros((n_groups,), np.int32)
    cats = np.zeros((L,), np.int32)
    grps = np.zeros((L,), np.int32)
    firsts = np.zeros((L,), np.uint8)
    Harr = (None if H is None
            else np.ascontiguousarray(np.asarray(H, np.float64)))
    i32 = ctypes.c_int32
    lib.stb_crp_generate(
        seed, n_groups, dim, n_per_group, float(a), float(b), _ptr(Harr),
        _ptr(n, i32), _ptr(t, i32), _ptr(T, i32), _ptr(cats, i32),
        _ptr(grps, i32), _ptr(firsts, ctypes.c_uint8))
    Hout = Harr if Harr is not None else np.full(dim, 1.0 / dim, np.float64)
    data = pyp.PYPData(cats, grps, firsts.astype(bool), n,
                       n.sum(axis=1).astype(np.int32), Hout)
    if return_latent:
        return data, t, T
    return data
