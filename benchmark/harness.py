"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Everything a cell is made of is found by name, so a later change adds a
cell by adding files and entries and edits none:

* ``BENCHMARK.json``'s ``workloads`` entry names a configuration and a
  traffic mix;
* ``configs/<config>.json`` holds the deployment as it is run, and names
  its ``driver``: ``drivers/<driver>.py``, the one general generator of
  that path of the program (it reads the configuration and the mix and
  sets up, drives the window and checks the outputs);
* ``traffic/<traffic>.json`` holds the mix's parameters;
* each per-layer metric is read from the traced window by
  ``layer_metrics/<metric>.py``'s ``read(view)``, which returns None where
  it finds nothing to read; the metric is then left out of the line.

A driver module defines ``SPANS`` ({span: (module, attribute)}), ``STEP``
(the span called once a step) and ``Run(config, traffic, seed, device,
log)`` (``log(what)`` notes a stage of set-up on standard error) with
``window(seconds)`` -> {metric: value} and ``check()`` -> (checks,
attempted, failed), checks being {name: (value, limit)}: the run is
correct when every value is at or below its limit.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

__all__ = ["HERE", "ROOT", "FORBIDDEN", "load_manifest", "resolve_cell",
           "load_module", "forbidden_modules", "cell_metrics", "run_cell"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run: the JAX package
# and JAX itself (the port, libstb_tpu_torch, is another top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "libstb_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import the file ``path`` as a module of its own (names may hold
    dots, which ``import`` would read as packages)."""
    name = "bench_" + "".join(c if c.isalnum() else "_" for c in
                              str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve_cell(manifest: dict, workload: str, bench_dir: Path = HERE):
    """(cell, config, traffic, driver path) of ``workload``, each found by
    its name; raises KeyError or FileNotFoundError where one is missing."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = _load_json(bench_dir / "configs" / f"{cell['config']}.json")
    traffic = _load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    driver = bench_dir / "drivers" / f"{config['driver']}.py"
    if not driver.exists():
        raise FileNotFoundError(driver)
    return cell, config, traffic, driver


def cell_metrics(manifest: dict, kind: str, workload: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``workload``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in manifest[kind]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules(names) -> list:
    """The module names whose top-level name (the part before the first
    dot) is one of FORBIDDEN, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _device_info(torch, device, chips: int, mem_peak: int) -> dict:
    from . import roofline

    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(mem_peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": int(mem_peak)}
    info["power_limit_w"] = roofline.power_limit_w()
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, manifest: Optional[dict] = None,
             bench_dir: Path = HERE) -> dict:
    """Run ``workload`` once on ``device`` and return the result object
    (the keys of the result line, ``checks`` last).  ``t_start``: the
    host clock when the process started, from which set-up is counted."""
    import torch

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    manifest = load_manifest() if manifest is None else manifest
    cell, config, traffic, driver_path = resolve_cell(manifest, workload,
                                                      bench_dir)
    drv = load_module(driver_path)

    def log(what):
        print(f"setup {what} at {time.perf_counter() - t_start:.3f} s",
              file=sys.stderr, flush=True)

    log("started")
    run = drv.Run(config, traffic, seed, device, log)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    tracer = None
    if trace:
        from .tracing import Tracer

        tt = traffic["trace"]
        tracer = Tracer(drv.SPANS, drv.STEP, tt["skip"], tt["steps"],
                        device.type == "cuda")
        with tracer.active():
            e2e = run.window(seconds)
    else:
        e2e = run.window(seconds)
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    checks, attempted, failed = run.check()
    correct = all(math.isfinite(v) and v <= lim
                  for v, lim in checks.values())
    metrics = {}
    out = {"correct": correct, "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics,
           "device": _device_info(torch, device, cell["chips"], mem_peak)}
    if trace:
        view = tracer.view
        if view is not None:
            view.params = {**config, **traffic}
            for m in cell_metrics(manifest, "per_layer", workload):
                reader = load_module(bench_dir / "layer_metrics"
                                     / f"{m['name']}.py")
                val = reader.read(view)
                if val is not None:
                    metrics[m["name"]] = {"value": val, "unit": m["unit"]}
            out["device"]["busy_s"] = view.busy_s()
            out["device"]["window_s"] = view.window_s
            out["breakdown"] = {"device_ops": view.top_device_ops(),
                                "idle_gaps": view.idle_gaps()}
    else:
        e2e["setup_s"] = setup_s
        for m in cell_metrics(manifest, "end_to_end", workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    out["checks"] = {k: [v, lim] for k, (v, lim) in checks.items()}
    return out
