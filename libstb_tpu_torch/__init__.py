"""libstb_tpu_torch -- the PyTorch/CUDA port of libstb_tpu.

Runs the discount-grid Gibbs main path (the demo.c workload), the
single-table path, the check.c samplers, the HPYP model and the NGG
subsystem on an NVIDIA GPU, in one process or sharded over the processes
of a torch.distributed world; the JAX package ``libstb_tpu`` stays beside it
as the reference that tests/test_torch_*.py hold every ported function to.  This package imports
``torch`` and never ``jax`` or ``libstb_tpu``.

  core.stirling     StirlingTable, make / ensure / remake, fill_rows, S1,
                    asymptotes
  core.agrid        discount-grid tables (make_grid / ensure_grid)
  core.rng          uniform / gamma / loggamma / gumbel draws from a
                    torch.Generator (rng.Replay in tests)
  core.special, sympoly, sapprox, lgcache   special functions and caches
  core.ngg          NGG tables, ratio tables, saddle points, quadrature oracle
  core.quadrature   tanh-sinh quadrature
  ops.stirling_cuda K1-K3: the hand-written CUDA fills + their plain versions
  samplers.slice, ars, hyper   the (a, b) moves
  models.pyp        CRP data gen + the TI / CT / CTW / HSA sweeps
  models.sa         the explicit-seating host oracle
  models.driver     run_gibbs (traces, R-hat, ESS), run_gibbs_timed
  models.hpyp       the two-level hierarchical PYP (run_hpyp)
  parallel.distributed   torch.distributed init, backend and device choice
  parallel.mesh     chain meshes over processes, chain sharding, the
                    collectives; rhat / ess / cross_chain_moments
  native            the long-double reference fill and the native CRP
                    generator (g++, ctypes)
  convert           carry JAX tables, data and chain state across
  entry             one composite Gibbs step + example arguments; the
                    multi-process dry run (dryrun_multichip)
  utils             config, yaps logging (jax-free copies), checkpoint,
                    metrics
"""
from __future__ import annotations

import importlib

__version__ = "0.1.0"

# lazy submodule access keeps `import libstb_tpu_torch` light: nothing
# below is imported, and no kernel is built, until it is first touched
_SUBMODULES = (
    "core", "models", "samplers", "parallel", "native", "utils", "ops",
    "convert", "entry",
)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
