"""The port as a package: no JAX, no silent CPU fallback, jax-free copies
held equal to their originals, and the gate reference data consistent."""
import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libstb_tpu.core import quadrature as jquad
from libstb_tpu.models import hpyp as jhpyp
from libstb_tpu.utils import config as jconfig
from libstb_tpu.utils import yaps as jyaps
from libstb_tpu_torch.core import quadrature as tquad
from libstb_tpu_torch.models import hpyp as thpyp
from libstb_tpu_torch.models import pyp as tpyp
from libstb_tpu_torch.ops import _nvcc
from libstb_tpu_torch.ops import stirling_cuda as sc
from libstb_tpu_torch.utils import config as tconfig
from libstb_tpu_torch.utils import yaps as tyaps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "libstb_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__") for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax():
    assert {"libstb_tpu_torch.parallel.mesh", "libstb_tpu_torch.models.hpyp",
            "libstb_tpu_torch.core.ngg", "libstb_tpu_torch.core.quadrature",
            "libstb_tpu_torch.utils.checkpoint",
            "libstb_tpu_torch.utils.metrics",
            "libstb_tpu_torch.parallel.distributed",
            "libstb_tpu_torch.native", "libstb_tpu_torch.ops._nvcc",
            "libstb_tpu_torch.ops.vpu_probe_cuda"} <= set(_modules())
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['libstb_tpu'] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_lazy_submodule_access():
    """As libstb_tpu/__init__.py: `import libstb_tpu_torch` imports no
    submodule (no kernel module, nothing that touches CUDA), and each of
    the JAX package's submodules, the port's own convert and entry, and
    their members resolve on first touch; an unknown name raises
    AttributeError."""
    from libstb_tpu import _SUBMODULES as jax_submodules

    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['libstb_tpu'] = None\n"
            "import libstb_tpu_torch as p\n"
            "assert not [m for m in sys.modules\n"
            "            if m.startswith('libstb_tpu_torch.')], 'eager'\n"
            "print(sorted(dir(p)))\n"
            "assert callable(p.core.stirling.s1_anchored)\n"
            "assert p.entry.__name__ == 'libstb_tpu_torch.entry'\n"
            "assert p.ops.__name__ == 'libstb_tpu_torch.ops'\n"
            "try:\n"
            "    p.no_such_module\n"
            "except AttributeError as e:\n"
            "    print('AttributeError', e)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names, err = res.stdout.splitlines()
    want = set(jax_submodules) | {"convert", "entry"}
    assert want <= set(ast.literal_eval(names))
    assert "has no attribute 'no_such_module'" in err


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", *sorted((ROOT / "cli").glob("*_torch.py")),
    *sorted((ROOT / "tools").glob("*_torch.py"))],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "libstb_tpu"), (
                f"{path.name} imports {name}")


@pytest.mark.parametrize("path", sorted(
    p for p in (PKG / "ops").glob("*.py")
    if p.name not in ("_nvcc.py", "__init__.py")), ids=lambda p: p.name)
def test_kernel_calls_go_through_nvcc(path):
    """Only ops/_nvcc.py opens a CUDA library, passes PyTorch's stream,
    reports a launch's cudaError and checks a kernel's tensor arguments
    (device, dtype, shape, contiguity); vpu_probe_cuda.alu_blocks' query,
    not a launch, keeps its own cudaError."""
    text = path.read_text()
    assert "ctypes.CDLL" not in text and ".cuda_stream" not in text
    assert ".is_contiguous(" not in text
    phrases = ("lies on", "has dtype", "has shape", "must be contiguous",
               "float32 or float64 only", "CUDA device")
    for top in ast.parse(text).body:
        for node in ast.walk(top):
            if not isinstance(node, ast.Raise):
                continue
            msg = " ".join(c.value for c in ast.walk(node)
                           if isinstance(c, ast.Constant)
                           and isinstance(c.value, str))
            assert not any(p in msg for p in phrases), msg
            if "cudaError" in msg:
                assert (path.name, top.name) == ("vpu_probe_cuda.py",
                                                 "alu_blocks"), msg


@pytest.mark.parametrize("cli,argv", [
    ("ngg_torch", ["-N", "6", "-K", "3"]),
    ("ngg_torch", ["--chains", "16"]),
    ("precision_torch", ["-N", "40", "-M", "10"])])
def test_cli_runs_without_jax(cli, argv):
    """The new CLIs import nothing of JAX, also lazily inside main()."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['libstb_tpu'] = None\n"
            "sys.path.insert(0, 'cli')\n"
            f"import {cli}\n"
            f"{cli}.main({['--device', 'cpu', *argv]!r})\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout


def test_cuda_entry_rejects_cpu_tensor():
    with pytest.raises(ValueError, match="not on a CUDA device"):
        sc.fill_grid_cuda(torch.tensor([0.1, 0.5]), 16, 8)
    n = sc.LAUNCHES["fill_grid"]
    sc.fill_grid(torch.tensor([0.1, 0.5]), 16, 8)     # CPU: the plain fill
    assert sc.LAUNCHES["fill_grid"] == n


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """No CUDA device (or no repository beside it): non-zero exit and no
    result line -- nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


def test_gate_reference_matches_crp_generate():
    ref = json.loads((ROOT / "tests" / "data" /
                      "torch_gate_ref.json").read_text())
    assert sorted(ref["seeds"]) == ["11", "23", "7"]
    for seed, r in ref["seeds"].items():
        data = tpyp.crp_generate(int(seed), *ref["data_args"])
        np.testing.assert_array_equal(data.n, np.asarray(r["n"]))
        J = data.n.shape[0]
        assert len(r["T"]["mean"]) == len(r["T"]["se"]) == J
        for k in ("a", "b"):
            assert len(r[k]["mean"]) == 1 and r[k]["se"][0] > 0


def test_check_reference_matches_crp_generate():
    """tests/data/torch_check_ref.json (tools/torch_check_ref.py): the data
    of every sampler's run equals the port's crp_generate, and each moment
    has its mean and a positive SE."""
    ref = json.loads((ROOT / "tests" / "data" /
                      "torch_check_ref.json").read_text())
    assert sorted(ref["samplers"]) == ["CT", "CTW", "HSA"]
    assert ref["config"]["window"] == 10 and ref["chains"] == 256
    for r in ref["samplers"].values():
        data = tpyp.crp_generate(r["seed"], *ref["data_args"])
        np.testing.assert_array_equal(data.n, np.asarray(r["n"]))
        for k in ("T", "a", "b"):
            assert len(r[k]["mean"]) == len(r[k]["se"]) == 1
            assert r[k]["se"][0] > 0


def test_hpyp_reference_matches_crp_generate():
    """tests/data/torch_hpyp_ref.json (tools/torch_hpyp_ref.py): its data
    equals the port's crp_generate, its grid covers the level-0 bound, and
    each of the nine moments has its mean and a positive SE."""
    ref = json.loads((ROOT / "tests" / "data" /
                      "torch_hpyp_ref.json").read_text())
    data = tpyp.crp_generate(*ref["data_args"])
    np.testing.assert_array_equal(data.n, np.asarray(ref["n"]))
    assert ref["grid_n"] == int(data.n.sum(axis=0).max()) + 2
    assert ref["chains"] == 256 and ref["config"] == {"iters": 1000,
                                                      "hyper_cycle": 2}
    J = data.n.shape[0]
    sizes = {"T1": J, "T0": 1, "a1": 1, "b1": 1, "a0": 1, "b0": 1}
    assert set(ref["moments"]) == set(sizes)
    for k, size in sizes.items():
        m = ref["moments"][k]
        assert len(m["mean"]) == len(m["se"]) == size
        assert min(m["se"]) > 0


def test_ngg_reference_matches_the_workload():
    """tests/data/torch_ngg_ref.json (tools/torch_ngg_ref.py): its
    workload points are cli/ngg_torch.py's draws, its shapes the stated
    ones, every bound finite."""
    sys.path.insert(0, str(ROOT / "cli"))
    import ngg_torch

    ref = json.loads((ROOT / "tests" / "data" /
                      "torch_ngg_ref.json").read_text())
    w = ref["points"]["workload"]
    N, K = ngg_torch.workload_inputs(len(w["N"]), "cpu")
    np.testing.assert_array_equal(N.numpy(), w["N"])
    np.testing.assert_array_equal(K.numpy(), w["K"])
    assert len(w["N"]) == 256 and len(ref["points"]["cli"]["N"]) == 30
    S, kap = (np.asarray(ref["table"][k], np.float64) for k in ("S", "kappa"))
    assert S.shape == kap.shape == (10, 16) and np.isfinite(kap).all()
    assert np.asarray(ref["ratio_recurrence"]["R"]).shape == (10, 15)
    assert np.asarray(ref["ratio_quadrature"]["R"]).shape == (10, 199)


def test_hpyp_config_copy_equal():
    def fields(c):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(c)]

    assert fields(thpyp.HPYPConfig) == fields(jhpyp.HPYPConfig)
    for kw in (dict(iters=30), dict(iters=30, burnin=7), dict(iters=1)):
        assert (thpyp.HPYPConfig(**kw).resolved_burnin()
                == jhpyp.HPYPConfig(**kw).resolved_burnin())


@pytest.mark.parametrize("levels", [6, 10, 11])
def test_quadrature_nodes_copy_equal(levels):
    for x, y in zip(tquad._nodes(levels), jquad._nodes(levels)):
        assert x.dtype == y.dtype == np.float64
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cls", ["TableConfig", "SamplerConfig"])
def test_config_copy_equal(cls, monkeypatch):
    def fields(c):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(c)]

    tc, jc = getattr(tconfig, cls), getattr(jconfig, cls)
    assert fields(tc) == fields(jc)
    assert dataclasses.asdict(tconfig.from_env(tc)) == dataclasses.asdict(
        jconfig.from_env(jc))
    first = dataclasses.fields(tc)[0]
    override = {int: "7", str: "ars", bool: "true"}[type(first.default)]
    monkeypatch.setenv(f"LIBSTB_{first.name.upper()}", override)
    monkeypatch.setenv("LIBSTB_VERBOSE", "yes")
    assert dataclasses.asdict(tconfig.from_env(tc)) == dataclasses.asdict(
        jconfig.from_env(jc))


def test_yaps_copy_equal():
    for mod in (tyaps, jyaps):
        seen = []
        mod.set_sink(seen.append)
        try:
            mod.message("x=%d", 3)
            with pytest.raises(mod.LibstbError, match="bad 4"):
                mod.quit("bad %d", 4)
        finally:
            mod.set_sink(None)
        assert seen == ["x=3", "bad 4"]
        assert issubclass(mod.LibstbError, RuntimeError)
    assert tyaps.__all__ == jyaps.__all__


def test_build_flags_and_source():
    """Every kernel builds from the package's own source for sm_90a,
    without fast math, into the ignored _build directory."""
    assert sorted(sc.SOURCES) == sorted(sc.KERNELS) == sorted(sc.LAUNCHES)
    for src in sc.SOURCES.values():
        assert src.is_file() and src.parent.parent == PKG
        assert "stirling_pallas.py:_kernel" in src.read_text()
    assert "arch=compute_90a,code=sm_90a" in _nvcc.NVCC_FLAGS
    assert not any("fast_math" in f for f in _nvcc.NVCC_FLAGS)
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "libstb_tpu_torch/_build/" in ignored
    assert os.path.basename(_nvcc.BUILD_DIR) == "_build"
