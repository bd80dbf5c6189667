"""The benchmark's inputs, made from ``--seed`` alone.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* ``crp_generate``: the CRP simulation of upstream libstb's test/demo.c
  (:284-311), copied from the port's ``models/pyp.crp_generate``: the
  same draws in the same order, so one seed gives the same counts.  It
  returns the counts and the item sequence as numpy arrays; the driver
  hands them to the program through its own data type.
* ``discount_walk``: the discounts a_k that the table cells refill for, a
  random walk from ``start`` with N(0, ``step``) steps, reflected into
  [``lo``, ``hi``] (demo.c's a-move keeps a inside the sampler's bounds).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["CRPData", "crp_generate", "discount_walk"]


class CRPData(NamedTuple):
    """Items in seating order: category, group, first occurrence of the
    (group, category) pair; the (J, D) counts, (J,) totals, (D,) base."""
    cat: np.ndarray
    grp: np.ndarray
    first: np.ndarray
    n: np.ndarray
    N: np.ndarray
    H: np.ndarray


def crp_generate(seed: int, n_groups: int, dim: int, n_per_group: int,
                 a: float, b: float) -> CRPData:
    """Sequential Pitman-Yor seating of ``n_per_group`` items in each of
    ``n_groups`` groups over ``dim`` categories with a uniform base
    (demo.c:284-311); counts only, tables are not kept."""
    rng = np.random.default_rng(seed)
    H = np.full(dim, 1.0 / dim)
    cats, grps, firsts = [], [], []
    n = np.zeros((n_groups, dim), np.int32)
    for j in range(n_groups):
        t = np.zeros(dim, np.int32)
        T = 0
        seen = np.zeros(dim, bool)
        for c in range(n_per_group):
            if c == 0:
                i = rng.choice(dim, p=H)
                t[i] += 1
                T += 1
            else:
                val = (c + b) * rng.random() - (T * a + b)
                if val <= 0:
                    i = rng.choice(dim, p=H)
                    t[i] += 1
                    T += 1
                else:
                    for i in range(dim):
                        val -= n[j, i] - t[i] * a
                        if val < 0:
                            break
            n[j, i] += 1
            cats.append(i)
            grps.append(j)
            firsts.append(not seen[i])
            seen[i] = True
    return CRPData(np.asarray(cats, np.int32), np.asarray(grps, np.int32),
                   np.asarray(firsts), n, n.sum(axis=1).astype(np.int32), H)


def discount_walk(seed: int, steps: int, start: float, step: float,
                  lo: float, hi: float) -> np.ndarray:
    """``steps`` discounts: a_0 = start, a_k = a_{k-1} + N(0, step),
    reflected at ``lo`` and ``hi`` until it lies inside."""
    rng = np.random.default_rng(seed)
    dz = rng.normal(0.0, step, steps)
    out = np.empty(steps)
    a = float(start)
    for k in range(steps):
        out[k] = a
        a += dz[k]
        while a < lo or a > hi:
            a = 2 * lo - a if a < lo else 2 * hi - a
    return out
