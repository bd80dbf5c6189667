"""The one kernel-call layer of the port: how its CUDA libraries are built,
bound, checked, launched and counted.

Each kernel module registers its library here once (``register``): the
source ``csrc/<name>.cu``, its C launchers with their argtypes, and the
``LAUNCHES`` dict its launches count in.  Registering builds nothing.  The
first launch builds the library (``build_all``: nvcc for sm_90a into a
shared library with a plain C interface, named by the library and a hash of
the source, every header it includes with quotes, and the flags, in
``libstb_tpu_torch/_build/``; one nvcc process per source, all at once,
each library moved into place atomically, so two processes building the
same source at once both end with a whole file), opens it with ctypes and
binds every launcher, once.

The registered libraries: ops/stirling_cuda.py's K1-K3 (``fill_grid``,
``fill_table``, ``fill_table_cols``), ops/ti_cuda.py's ``ti_sweep``,
ops/slice_cuda.py's ``slice_move`` (each an ``stb_<name>_f32`` / ``_f64``
pair) and ops/vpu_probe_cuda.py's ``vpu_probe`` (the seven ``stb_vpu_*``
launchers).  ``check`` is the one check of a kernel's tensor arguments.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "LIBRARIES", "Library",
           "nvcc", "source_bytes", "target", "build_all", "pair", "register",
           "bind_all", "run", "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

LIBRARIES: dict = {}                    # name -> Library, as registered
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_bytes(path: Path, seen: set) -> bytes:
    """``path``'s bytes followed by those of every file it includes with
    quotes, recursively, each once."""
    if path in seen:
        return b""
    seen.add(path)
    src = path.read_bytes()
    return src + b"".join(source_bytes(path.parent / inc.decode(), seen)
                          for inc in _INCLUDE.findall(src))


def target(name: str, source: Path) -> Path:
    """The library that ``source`` builds to under kernel name ``name``."""
    src = source_bytes(source, set())
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{tag}.so"


def build_all(sources: dict) -> dict:
    """Compile every source of ``sources`` ({name: path}) not yet built,
    one nvcc process per source, all started together; returns {name: .so
    path}."""
    outs = {name: target(name, src) for name, src in sources.items()}
    procs = {}
    for name, out in outs.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {sources[name].name}:\n{err}")
        else:
            os.replace(tmp, outs[name])  # atomic against concurrent builds
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def _open(path: Path):
    return ctypes.CDLL(str(path))


class Library:
    """One registered library: ``source``, its C launchers ``symbols``
    ({symbol: argtypes}; each returns a cudaError) and the ``launches``
    dict its launches count in."""

    def __init__(self, name: str, symbols: dict, launches: dict):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.symbols = symbols
        self.launches = launches
        self._fns = None

    def fns(self) -> dict:
        """{symbol: (symbol, bound function)}, and {dtype: ...} for the
        f32 / f64 pair: the library built, opened and bound on the first
        call."""
        if self._fns is None:
            lib = _open(build_all({self.name: self.source})[self.name])
            fns = {}
            for symbol, argtypes in self.symbols.items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[symbol] = (symbol, fn)
            for dtype, suffix in _SUFFIX.items():
                if f"stb_{self.name}_{suffix}" in fns:
                    fns[dtype] = fns[f"stb_{self.name}_{suffix}"]
            self._fns = fns
        return self._fns

    def launch(self, which, device, *args, key: str = None):
        """Run the launcher ``which`` (a symbol, or the dtype of a pair)
        with ``args`` on ``device``'s current stream, and count it in
        ``launches[key]`` (the library's name by default)."""
        symbol, fn = self.fns()[which]
        run(symbol, fn, device, *args)
        self.launches[self.name if key is None else key] += 1


def pair(name: str, argtypes: list) -> dict:
    """The symbols of an f32 / f64 pair of one signature."""
    return {f"stb_{name}_{suffix}": argtypes for suffix in ("f32", "f64")}


def register(name: str, symbols: dict, launches: dict) -> Library:
    """Declare csrc/``name``.cu's library; builds nothing."""
    if name in LIBRARIES:
        raise ValueError(f"library {name} registered twice")
    LIBRARIES[name] = Library(name, symbols, launches)
    return LIBRARIES[name]


def bind_all() -> dict:
    """Build every registered library not yet built, all at once, and bind
    each; returns {name: .so path}."""
    outs = build_all({name: lib.source for name, lib in LIBRARIES.items()})
    for lib in LIBRARIES.values():
        lib.fns()
    return outs


def run(symbol: str, fn, device, *args):
    """Call the bound launcher ``fn`` with ``args`` and the current stream
    of ``device`` last, under that device; raise on a cudaError."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


def check(fn: str, device: torch.device, args: dict = None, real=None,
          strided=(), then=None):
    """Raise on an argument a kernel cannot take: ``real``, the dtype it
    computes in, not float32 or float64 (TypeError); for each ``args``
    entry {name: (tensor, dtype, shape)}, a tensor on another device than
    ``device``, of another dtype (TypeError), of another shape (None: any
    shape; an extent None: any extent) or, unless ``strided`` names it,
    not contiguous; then whatever ``then()`` raises; and last ``device``
    not a CUDA device, so that every other check runs on the CPU too."""
    if real is not None and real not in _SUFFIX:
        raise TypeError(f"{fn}: dtype {real} (float32 or float64 only)")
    for name, (x, dtype, shape) in (args or {}).items():
        if x.device != device:
            raise ValueError(f"{fn}: {name} lies on {x.device}, not on "
                             f"{device}")
        if x.dtype != dtype:
            raise TypeError(f"{fn}: {name} has dtype {x.dtype}, not {dtype}")
        if shape is not None and x.shape != shape and (
                x.ndim != len(shape) or any(s is not None and n != s
                                            for n, s in zip(x.shape, shape))):
            raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, not "
                             f"{shape}")
        if name not in strided and not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if then is not None:
        then()
    if device.type != "cuda":
        where = (f"the tensors lie on {device}, not on" if args
                 else f"{device} is not")
        raise ValueError(f"{fn}: {where} a CUDA device")
