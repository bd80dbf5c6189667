"""ops/_nvcc.py, the port's one kernel-call layer: the registry of CUDA
libraries, the lazy bind, the launch and its count, and the check of a
kernel's tensor arguments.  All of it runs here on the CPU, against a fake
library where a launch is needed."""
import contextlib
import ctypes
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from libstb_tpu_torch.ops import _nvcc, slice_cuda, ti_cuda
from libstb_tpu_torch.ops import stirling_cuda as sc
from libstb_tpu_torch.ops import vpu_probe_cuda as vp

ROOT = Path(__file__).resolve().parent.parent
MODULES = (sc, ti_cuda, slice_cuda, vp)


def test_every_source_is_registered_once():
    """Each csrc/*.cu is one library, declared by exactly one kernel
    module, whose SOURCES (and KERNELS) are its registry entries."""
    cu = sorted(p.stem for p in _nvcc.CSRC.glob("*.cu"))
    assert sorted(_nvcc.LIBRARIES) == cu
    declared = [name for mod in MODULES for name in mod.SOURCES]
    assert sorted(declared) == cu
    for mod in MODULES:
        for name, src in mod.SOURCES.items():
            assert _nvcc.LIBRARIES[name].source == src and src.is_file()
    assert sc.KERNELS == ("fill_grid", "fill_table", "fill_table_cols")
    assert all(_nvcc.LIBRARIES[n].launches is sc.LAUNCHES
               for n in sc.KERNELS)
    assert _nvcc.LIBRARIES["ti_sweep"].launches is ti_cuda.LAUNCHES
    assert _nvcc.LIBRARIES["slice_move"].launches is slice_cuda.LAUNCHES
    assert _nvcc.LIBRARIES["vpu_probe"].launches is vp.LAUNCHES
    for name in ("fill_grid", "fill_table", "fill_table_cols", "slice_move"):
        assert set(_nvcc.LIBRARIES[name].symbols) == {
            f"stb_{name}_f32", f"stb_{name}_f64"}
    assert set(_nvcc.LIBRARIES["ti_sweep"].symbols) == {
        f"stb_{name}_{suffix}" for name in ("ti_sweep", "ti_grid_v")
        for suffix in ("f32", "f64")}
    probes = _nvcc.LIBRARIES["vpu_probe"].symbols
    assert len(probes) == 7 and all(s.startswith("stb_vpu_") for s in probes)
    with pytest.raises(ValueError, match="registered twice"):
        _nvcc.register("ti_sweep", {}, {})


def test_importing_builds_nothing():
    """Importing every module of the package registers every library and
    builds, opens and binds none."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (ROOT / "libstb_tpu_torch").rglob("*.py"))
    code = ("import importlib\n"
            "from libstb_tpu_torch.ops import _nvcc\n"
            "def fail(*a):\n"
            "    raise SystemExit('built or bound at import')\n"
            "_nvcc.build_all = _nvcc._open = fail\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "libs = _nvcc.LIBRARIES.values()\n"
            "assert all(lib._fns is None for lib in libs)\n"
            "print(sorted(_nvcc.LIBRARIES))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(sorted(
        p.stem for p in _nvcc.CSRC.glob("*.cu")))


class _FakeLib:
    """A library whose launchers record their arguments and return
    ``err``."""

    def __init__(self, symbols):
        self.calls = []
        self.err = 0
        for symbol in symbols:
            def fn(*args, symbol=symbol):
                self.calls.append((symbol, args))
                return self.err
            setattr(self, symbol, fn)


@pytest.fixture
def fake(monkeypatch):
    """A library of one f32 / f64 pair and one named launcher, built and
    opened as fakes, launched on a fake current stream (handle 77)."""
    launches = {"fake": 0, "other": 0}
    lib = _nvcc.Library("fake", {**_nvcc.pair("fake", [ctypes.c_int] * 2),
                                 "stb_fake_named": [ctypes.c_void_p]},
                        launches)
    builds, opened, libs = [], [], []

    def build_all(sources):
        builds.append(dict(sources))
        return {name: Path(f"/nowhere/{name}.so") for name in sources}

    def open_(path):
        opened.append(path)
        libs.append(_FakeLib(lib.symbols))
        return libs[-1]

    monkeypatch.setattr(_nvcc, "build_all", build_all)
    monkeypatch.setattr(_nvcc, "_open", open_)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=77))
    return types.SimpleNamespace(lib=lib, launches=launches, builds=builds,
                                 opened=opened, libs=libs)


def test_first_launch_binds_once(fake):
    assert fake.builds == [] and fake.lib._fns is None
    dev = torch.device("cuda", 0)
    fake.lib.launch(torch.float32, dev, 1)
    fake.lib.launch(torch.float64, dev, 2)
    fake.lib.launch("stb_fake_named", dev, 3, key="other")
    assert fake.builds == [{"fake": fake.lib.source}]
    assert fake.opened == [Path("/nowhere/fake.so")]
    raw = fake.lib.fns()["stb_fake_f32"][1]
    assert raw.argtypes == [ctypes.c_int] * 2 and raw.restype is ctypes.c_int
    assert len(fake.builds) == len(fake.libs) == 1
    assert [c[0] for c in fake.libs[0].calls] == [
        "stb_fake_f32", "stb_fake_f64", "stb_fake_named"]
    assert fake.launches == {"fake": 2, "other": 1}


@pytest.mark.parametrize("which,symbol", [
    (torch.float32, "stb_fake_f32"), (torch.float64, "stb_fake_f64"),
    ("stb_fake_named", "stb_fake_named")])
def test_launch_takes_the_symbol_and_the_stream(fake, which, symbol):
    """The dtype picks the pair's symbol; the arguments pass as given,
    the current stream's handle last."""
    fake.lib.launch(which, torch.device("cuda", 0), 5, 6)
    assert fake.libs[-1].calls == [(symbol, (5, 6, 77))]


@pytest.mark.parametrize("key,counted", [(None, "fake"), ("other", "other")])
def test_launch_counts_only_on_success(fake, key, counted):
    dev = torch.device("cuda", 0)
    fake.lib.launch(torch.float32, dev, 1, key=key)
    assert fake.launches == {"fake": 0, "other": 0, counted: 1}
    fake.libs[-1].err = 700
    with pytest.raises(RuntimeError,
                       match="stb_fake_f32 launch failed: cudaError 700"):
        fake.lib.launch(torch.float32, dev, 1, key=key)
    assert fake.launches == {"fake": 0, "other": 0, counted: 1}


def test_run_raises_on_a_cuda_error(fake):
    def fn(*args):
        return 2 if args[-1] == 77 else 0
    with pytest.raises(RuntimeError, match="variant launch failed: "
                                           "cudaError 2"):
        _nvcc.run("variant", fn, torch.device("cuda", 0), 1)


def _args():
    """Valid arguments of a kernel on the CPU: a contiguous f32
    vector, an int32 matrix of any width, a transposed f32 matrix the
    kernel takes at any strides."""
    return {"x": (torch.zeros(4), torch.float32, (4,)),
            "n": (torch.zeros((4, 3), dtype=torch.int32), torch.int32,
                  (4, None)),
            "w": (torch.zeros((3, 4)).t(), torch.float32, (4, 3))}


def _bad(name, value):
    """An edit of the arguments that replaces tensor ``name`` by
    value(tensor)."""
    def edit(kw):
        x, dtype, shape = kw["args"][name]
        kw["args"][name] = (value(x), dtype, shape)
    return edit


def _raise_vrows():
    raise ValueError("kern: vrows must be (4, 8)")


@pytest.mark.parametrize("edit,error,match", [
    (lambda kw: kw.update(real=torch.float16), TypeError,
     "float32 or float64 only"),
    (lambda kw: kw.update(device=torch.device("meta")), ValueError,
     "x lies on cpu"),
    (_bad("x", lambda x: x.double()), TypeError, "x has dtype"),
    (_bad("n", lambda x: x.long()), TypeError, "dtype"),
    (_bad("x", lambda x: x[:3]), ValueError, "x has shape"),
    (_bad("n", lambda x: x[None]), ValueError, "n has shape"),
    (_bad("x", lambda x: torch.zeros(8)[::2]), ValueError,
     "x must be contiguous"),
    (_bad("n", lambda x: x.t().contiguous().t()), ValueError,
     "n must be contiguous"),
    (lambda kw: kw.update(then=_raise_vrows), ValueError, "vrows must be"),
    (lambda kw: None, ValueError, "not on a CUDA device"),
    (lambda kw: kw.update(args=None), ValueError, "not a CUDA device"),
], ids=["real", "device", "dtype", "dtype-int", "shape", "ndim",
        "contiguous", "contiguous-2d", "then", "cpu", "cpu-no-tensors"])
def test_check_refuses(edit, error, match):
    """Each failure raises its type and phrase; the device is checked
    last, so that every other check runs on the CPU."""
    kw = dict(fn="kern", device=torch.device("cpu"), args=_args(),
              real=torch.float32, strided=("w",))
    edit(kw)
    with pytest.raises(error, match=match) as info:
        _nvcc.check(**kw)
    assert str(info.value).startswith("kern: ")


def test_check_takes_wildcards_and_strides():
    """An extent None takes any extent, a shape None any shape, and a name
    in ``strided`` any strides: only the device's check is left."""
    args = _args()
    args["n"] = (torch.zeros((4, 9), dtype=torch.int32), torch.int32,
                 (4, None))
    args["s"] = (torch.zeros((2, 2, 2)), torch.float32, None)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        _nvcc.check("kern", torch.device("cpu"), args, real=torch.float64,
                    strided=("w",))
    with pytest.raises(ValueError, match="w must be contiguous"):
        _nvcc.check("kern", torch.device("cpu"), args)
