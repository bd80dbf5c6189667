"""The port's NGG and precision CLIs on the CPU against the JAX CLIs'
printed numbers (cli/ngg.py, cli/precision.py run as programs).

cli/ngg_torch.py's table mode: the saddle-point and quadrature columns
equal to the printed digits (2e-6); the table and L1-ratio columns within
tools/torch_ngg_ref.py's cancellation bounds plus the printed digits.  Its
--chains workload: the same agreement statistics as printed.
cli/precision_torch.py: the f64 variants' errors at rounding level in both
(<= 1e-10), the f32 variants' within 10% of JAX's (the f32 Srel prefix sum
runs in another order), and the CLI's conclusion in both: ratio/f32 below
log/f32."""
import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "cli"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import ngg_torch  # noqa: E402
import precision_torch  # noqa: E402
from torch_ngg_ref import (EPS, KAPPA_ULPS, ratio_kappa,  # noqa: E402
                           table_kappa)

torch.set_num_threads(1)


def _jax_cli(name, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "cli", name),
                          *argv], capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def _ours(main, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(["--device", "cpu", *argv])
    return buf.getvalue(), out


def _table_rows(text):
    rows = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 9 and parts[0].isdigit():
            rows[(int(parts[0]), int(parts[1]))] = np.array(
                [float(x) for x in parts[2:]])
    return rows


def test_ngg_cli_table_mode_matches_jax():
    ours, _ = _ours(ngg_torch.main)
    theirs = _jax_cli("ngg.py")
    ro, rt = _table_rows(ours), _table_rows(theirs)
    assert ro.keys() == rt.keys() and len(ro) == 30
    kap, S = table_kappa(0.1, 10.0, 16, 10)
    rho, R = ratio_kappa(0.1, 10.0, 16, 10)
    for (n, k), o in ro.items():
        t = rt[(n, k)]
        np.testing.assert_array_equal(np.isnan(o), np.isnan(t))
        np.testing.assert_allclose(o[1:6], t[1:6], rtol=0, atol=2e-6,
                                   err_msg=f"n={n} k={k}")
        s_tol = KAPPA_ULPS * EPS * (kap[k - 1, n - 1] + abs(S[k - 1, n - 1]))
        assert abs(o[0] - t[0]) <= s_tol + 2e-6, (n, k, o[0], t[0])
        r_tol = KAPPA_ULPS * EPS * rho[k - 1, n - 1] * abs(R[k - 1, n - 1])
        assert abs(o[6] - t[6]) <= r_tol + 2e-8, (n, k, o[6], t[6])
    big = [line for line in ours.splitlines() if line.strip().startswith("n=")]
    assert big == [line for line in theirs.splitlines()
                   if line.strip().startswith("n=")] and len(big) == 3


def test_ngg_cli_workload_matches_jax():
    ours, res = _ours(ngg_torch.main, "--chains", "512")
    theirs = _jax_cli("ngg.py", "--chains", "512")
    pat = r"agreement max (\S+) mean (\S+)"
    assert re.search(pat, ours).groups() == re.search(pat, theirs).groups()
    assert res["chains"] == 512 and res["worst"] < ngg_torch.AGREE
    assert res["evals_per_s"] > 0


def test_ngg_cli_refuses_a_disagreement(monkeypatch):
    monkeypatch.setattr(ngg_torch, "AGREE", 1e-6)
    with pytest.raises(SystemExit, match="disagree"):
        _ours(ngg_torch.main, "--chains", "64")


def _errors(text):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^  (\S+)\s*: max\|err\| =\s*(\S+)", text, re.M)}


def test_precision_cli_matches_jax():
    ours, res = _ours(precision_torch.main, "-N", "400", "-M", "100")
    theirs = _jax_cli("precision.py", "-N", "400", "-M", "100")
    eo, et = _errors(ours), _errors(theirs)
    assert eo.keys() == et.keys() == {"log/f64", "log/f32", "ratio/f64",
                                      "ratio/f32"}
    assert res["errors"].keys() == eo.keys()
    for name in ("log/f64", "ratio/f64"):
        assert eo[name] <= 1e-10 and et[name] <= 1e-10, name
    for name in ("log/f32", "ratio/f32"):
        np.testing.assert_allclose(eo[name], et[name], rtol=0.1,
                                   err_msg=name)
    for errs in (eo, et):
        assert errs["ratio/f32"] < errs["log/f32"]


@pytest.mark.parametrize("main", [ngg_torch.main, precision_torch.main])
def test_clis_default_to_the_card(main):
    """Without a CUDA device the default --device cuda fails loudly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([])
