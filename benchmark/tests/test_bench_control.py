"""The control (the reference in bfloat16 in the program's place) reads
not correct under every cell's limits, at a size a test run holds; on the
chip ``benchmark/control.py`` runs it at the cells' own sizes.  So does
the shortcut a faster program would be tempted by, the column recurrence
carried and stored in float32, and it fails by V or Srel, the numbers the
recurrence makes, not by S1 alone."""
import pytest
import torch

from benchmark import control, harness

MAN = harness.load_manifest()
RECURRENCE = ("v_rel", "srel_abs", "grid_v_rel", "grid_srel_abs")


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_control_is_not_correct(cell, seed, dtype):
    _, config, traffic, _ = harness.resolve_cell(MAN, cell)
    if config["driver"] == "remake":
        traffic = {**traffic, "n": 4096}
    out = control.control(config, traffic, seed, torch.device("cpu"),
                          tables=1, dtype=dtype)
    assert not out["correct"], out
    # it fails by a number the cell compares, not by a crash
    assert any(v > lim for v, lim in out["checks"].values())
    if dtype == "float32":
        assert any(v > lim for k, (v, lim) in out["checks"].items()
                   if k in RECURRENCE), out
