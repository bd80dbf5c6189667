"""BENCHMARK.json against the contract's limits on names, units and
files, and the harness's lookup of every piece by name."""
import json
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.load_manifest()


def _names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[kind]:
            yield kind, e["name"]


@pytest.mark.parametrize("kind,name", list(_names()))
def test_names(kind, name):
    assert NAME.match(name), name


def test_keys_and_text():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    for kind in ("end_to_end", "per_layer"):
        names = [m["name"] for m in MAN[kind]]
        assert len(names) == len(set(names))
        for m in MAN[kind]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in MAN["configs"]:
        assert c["reduced"] == [] and 1 <= len(c["why"]) <= 200
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_piece_found_by_name(cell):
    _, config, traffic, driver = harness.resolve_cell(MAN, cell)
    assert driver.exists()
    assert len(harness.cell_metrics(MAN, "end_to_end", cell)) >= 2
    per = harness.cell_metrics(MAN, "per_layer", cell)
    assert per
    for m in per:
        assert (harness.HERE / "layer_metrics" / f"{m['name']}.py").exists()
    name = next(w["config"] for w in MAN["workloads"] if w["name"] == cell)
    entry = next(c for c in MAN["configs"] if c["name"] == name)
    assert harness.ROOT / entry["file"] == (
        harness.HERE / "configs" / f"{name}.json")
    assert json.loads((harness.ROOT / entry["file"]).read_text()) == config


def test_new_cell_is_data_only(tmp_path):
    """A new traffic file and a workloads entry make a new cell; no file
    of the harness is edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    mix = json.loads((bench / "traffic" / "remake_n64k.json").read_text())
    mix["n"] = 131072
    (bench / "traffic" / "remake_n128k.json").write_text(json.dumps(mix))
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "table.remake_n128k",
                             "config": "stirling_table_m1024",
                             "traffic": "remake_n128k", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "table.remake_n64k" in m.get("workloads", []):
            m["workloads"].append("table.remake_n128k")
    cell, config, traffic, driver = harness.resolve_cell(
        man, "table.remake_n128k", bench)
    assert traffic["n"] == 131072 and driver.name == "remake.py"
    assert {m["name"] for m in harness.cell_metrics(
        man, "end_to_end", "table.remake_n128k")} == {
        "table_cells_per_s", "remake_ms_p95", "setup_s"}
    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_missing_piece_raises():
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "x.y", "config": "pyp_grid_demo",
                             "traffic": "no_such_mix", "chips": 1,
                             "why": "test"})
    with pytest.raises(FileNotFoundError):
        harness.resolve_cell(man, "x.y")
    with pytest.raises(KeyError):
        harness.resolve_cell(man, "no.such_cell")
