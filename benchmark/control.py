#!/usr/bin/env python3
"""The control of the benchmark's ``correct``: the plain reference put in
the program's place and computed one precision below the configuration's
float32, in bfloat16, then judged by the same comparison and the same
limits as a run.  Every cell's configuration states float32, so every
cell's control is this one; it has to come out not correct.

* table cells: the tables of the window's first discounts (the seed's
  walk from its third step, as a run's window starts);
* Gibbs cells: the discount grid that set-up fills.

``--dtype float32`` reads the shortcut a faster program would be tempted
by instead: the same column recurrence carried and stored in float32
where the program carries it in float64.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \
        [--tables 2] [--dtype bfloat16|float32]

One JSON line a seed: the numbers, their limits and ``correct``.  It runs
where its inputs lie: on the card when there is one, else on the CPU
(the tests run it there at a small size through ``control``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import datagen, harness  # noqa: E402
from benchmark.reference import compare, stirling_ref  # noqa: E402

LOW = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _in_place_of_program(a, n, m, low):
    """Column getters over the reference's table in ``low``, stepped in
    lockstep with the comparison's f64 reference (column j is asked for
    in order, V before Srel)."""
    cols = stirling_ref.columns(a, n, m, low)
    held = {}

    def col(j, k):
        if j not in held:
            held.clear()
            _, v, s = next(cols)
            held[j] = (v, s)
        return held[j][k]

    s1 = stirling_ref.s1(a, n, low)
    return (lambda j: col(j, 0)), (lambda j: col(j, 1)), s1


def control(config: dict, traffic: dict, seed: int, device,
            tables: int = 2, dtype: str = "bfloat16") -> dict:
    """The control's numbers for one seed, with the cell's limits."""
    low = LOW[dtype]
    limits = {**config.get("limits", {}), **traffic.get("limits", {})}
    f64 = torch.float64
    if config["driver"] == "remake":
        w = traffic["walk"]
        walk = datagen.discount_walk(seed, w["steps"], w["start"], w["step"],
                                     config["a_lo"], config["a_hi"])
        n, m = traffic["n"], config["m"]
        parts = []
        for a in walk[2:2 + tables]:
            at = torch.tensor(float(a), dtype=f64, device=device)
            v, s, s1 = _in_place_of_program(at, n, m, low)
            parts.append(compare.table_errors(at, n, m, v, s, s1))
        names = {"v_rel": "v_rel", "srel_abs": "srel_abs",
                 "s1_abs": "s1_abs", "pattern": "pattern"}
    else:
        g = config["grid"]
        at = torch.as_tensor(np.linspace(g["a_lo"], g["a_hi"], g["g"]),
                             dtype=f64, device=device)
        v, s, s1 = _in_place_of_program(at, g["n"], g["m"], low)
        parts = [compare.table_errors(at, g["n"], g["m"], v, s, s1)]
        names = {"v_rel": "grid_v_rel", "srel_abs": "grid_srel_abs",
                 "s1_abs": "grid_s1_abs", "pattern": "grid_pattern"}
    errs = compare.merge(parts)
    checks = {names[k]: [errs[k], limits.get(names[k], 0)] for k in names}
    correct = all(v == v and v <= lim for v, lim in checks.values())
    return {"seed": seed, "dtype": dtype, "correct": correct,
            "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--tables", type=int, default=2)
    p.add_argument("--dtype", choices=sorted(LOW), default="bfloat16")
    args = p.parse_args(argv)
    _, config, traffic, _ = harness.resolve_cell(harness.load_manifest(),
                                                 args.workload)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    for seed in args.seeds:
        out = control(config, traffic, seed, dev, args.tables, args.dtype)
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
