"""Port parity: libstb_tpu_torch.models.sa (the numpy SA oracle, copied so
the port needs no JAX) against libstb_tpu.models.sa under one numpy
generator, and the check.c multi-sampler agreement, SA against the port's
HSA and CT runs (tests/test_sa.py's bands)."""
import numpy as np
import pytest
import torch

from libstb_tpu.models import sa as jsa
from libstb_tpu_torch.core import agrid as tag
from libstb_tpu_torch.core import rng
from libstb_tpu_torch.models import driver as tdriver
from libstb_tpu_torch.models import pyp as tpyp
from libstb_tpu_torch.models import sa as tsa

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,groups,dim,per,a,b", [
    (5, 2, 5, 20, 0.5, 1.0), (1, 3, 8, 30, 0.2, 4.0), (2, 1, 20, 40, 0.8,
                                                        0.5)])
def test_sa_copy_equal(seed, groups, dim, per, a, b):
    """The same sweeps under one numpy generator: the same seating."""
    data = tpyp.crp_generate(seed, groups, dim, per, a, b)
    st_t, st_j = tsa.sa_init(data), jsa.sa_init(data)
    r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        tsa.sa_sweep(r_t, st_t, a, b)
        jsa.sa_sweep(r_j, st_j, a, b)
        np.testing.assert_array_equal(st_t.T, st_j.T)
        np.testing.assert_array_equal(st_t.t(), st_j.t())
        for j in range(groups):
            for i in range(dim):
                np.testing.assert_array_equal(st_t.sizes[j][i],
                                              st_j.sizes[j][i])
    out_t = tsa.sa_run(data, 12, a, b, seed=seed)
    out_j = jsa.sa_run(data, 12, a, b, seed=seed)
    for k in ("tave", "Tave"):
        np.testing.assert_array_equal(out_t[k], out_j[k])


def test_sa_invariants():
    data = tpyp.crp_generate(seed=5, n_groups=2, dim=5, n_per_group=20,
                             a=0.5, b=1.0)
    st = tsa.sa_init(data)
    r = np.random.default_rng(0)
    for _ in range(5):
        tsa.sa_sweep(r, st, 0.5, 1.0)
        t = st.t()
        for j in range(2):
            for i in range(5):
                assert st.sizes[j][i].sum() == data.n[j, i]
                if data.n[j, i] > 0:
                    assert 1 <= t[j, i] <= data.n[j, i]
        assert (st.T == t.sum(axis=1)).all()


def test_sa_agrees_with_hsa_and_ct():
    """tests/test_sa.py: SA's E[T] against the port's HSA and CT runs at
    fixed (a, b), within 6 SE + 0.15."""
    data = tpyp.crp_generate(seed=11, n_groups=1, dim=5, n_per_group=30,
                             a=0.5, b=1.0)
    T_sa = float(tsa.sa_run(data, iters=3000, a=0.5, b=1.0,
                            seed=3)["Tave"].sum())
    grid = tag.make_grid(48, 36, g=100, dtype=torch.float64, device="cpu")
    C = 256
    for name in ("HSA", "CT"):
        out = tdriver.run_gibbs(rng.generator(4, "cpu"), data, grid, C, 0.5,
                                1.0, tdriver.GibbsConfig(iters=160,
                                                         sampler=name))
        Tave = out["Tave"].numpy().sum(axis=1)
        m, se = Tave.mean(), Tave.std() / np.sqrt(C)
        assert abs(m - T_sa) < 6 * se + 0.15, (name, m, se, T_sa)
