"""The one builder of the port's CUDA sources: nvcc for sm_90a into a
shared library with a plain C interface, named by its kernel and a hash of
the source, every header it includes with quotes, and the flags, in
``libstb_tpu_torch/_build/``.  ``build_all`` starts one nvcc process per
source, all at once, and moves each library into place atomically, so two
processes building the same source at once both end with a whole file.

ops/stirling_cuda.py (K1-K3) and ops/vpu_probe_cuda.py (the probes) each
pass their own name -> source map.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "nvcc", "source_bytes", "target",
           "build_all"]

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


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
