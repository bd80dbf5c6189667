"""The port's chain sharding (libstb_tpu_torch.parallel.mesh), the sharded
grid fill (core.agrid.make_grid(mesh=...)), the data-axis reduction of
sample_a and entry.dryrun_multichip -- at world 1 and under 2 and 4 gloo
CPU processes (tests/test_torch_distributed.run_ranks), against the
one-process port and the JAX package's 8-device virtual mesh.

Each multi-process run happens once a module (a fixture) and the tests
read its results.  The dry-run step is replayed: the one-process step on
all chains records its draws (``_Tape``), and every rank replays the
slice of each draw that belongs to its chains (``_ShardReplay``), each
sampler call's stream apart (the step's three generators), so the slice
sampler's data-dependent try counts cannot shift the streams."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from libstb_tpu.core import agrid as jag
from libstb_tpu_torch import entry
from libstb_tpu_torch.core import agrid as tag
from libstb_tpu_torch.core import rng
from libstb_tpu_torch.parallel import mesh as pmesh
from test_torch_distributed import run_ranks

torch.set_num_threads(1)

GRID = (40, 20, 16)                 # tests/test_sharded_fill.py's grid
DRY = dict(chains=16, n_max=64, m_max=32, g=16, dim=8, n_per_group=24)
C_DIAG = 16                         # chains of the diagnostics' draws


def _draws():
    r = np.random.default_rng(5)
    return dict(x=r.normal(size=(C_DIAG, 3)),
                draws=np.cumsum(r.normal(size=(101, C_DIAG)), axis=0) * 0.1
                + r.normal(size=(101, C_DIAG)))


class _Tape(rng.Replay):
    """Hands out fresh uniforms (numpy, seeded) and records them."""

    def __init__(self, seed):
        self._r = np.random.default_rng(seed)
        self.draws = []

    def next(self, shape, dtype, device):
        x = self._r.random(tuple(shape))
        self.draws.append(x)
        return torch.as_tensor(x, dtype=dtype, device=device)


_SHARD_REPLAY = """
import numpy as np
from libstb_tpu_torch.core import rng


class ShardReplay(rng.Replay):
    '''Replays recorded draws of the whole chain axis (C chains), sliced
    to this rank's chains: the one axis of size C where the request has
    the slice's size.'''

    def __init__(self, draws, C, sl):
        self._it, self.C, self.sl = iter(draws), C, sl

    def next(self, shape, dtype, device):
        x = next(self._it)
        n = self.sl.stop - self.sl.start
        axes = [k for k in range(x.ndim) if x.shape[k] == self.C
                and shape[k] == n and all(
                    x.shape[j] == shape[j] for j in range(x.ndim) if j != k)]
        assert len(shape) == x.ndim and len(axes) == 1, (x.shape, shape)
        idx = [slice(None)] * x.ndim
        idx[axes[0]] = self.sl
        return torch.as_tensor(np.ascontiguousarray(x[tuple(idx)]),
                               dtype=dtype, device=device)
"""

_WORKER = _SHARD_REPLAY + """
import json
from libstb_tpu_torch import entry
from libstb_tpu_torch.core import agrid
from libstb_tpu_torch.parallel import mesh as pmesh

with open(f"{out}/config.json") as f:
    D = json.load(f)
res = {}
arrays = {}
# -- sharding, gathers, diagnostics on a (W,) mesh and a (W/2, 2) mesh --
src = np.load(f"{out}/draws.npz")
x, draws = src["x"], src["draws"]
C = x.shape[0]
shapes = [(world,)] + ([(world // 2, 2)] if world >= 4 else [])
for shape in shapes:
    cm = pmesh.chain_mesh(shape=shape, device="cpu")
    tag_ = "x".join(map(str, shape))
    sl = pmesh.chain_slice(cm, C)
    sh = pmesh.shard_chain_tree(dict(x=x, table=np.ones((7, 5)),
                                     pair=(torch.arange(C), 3.5)), cm, C)
    assert torch.equal(sh["x"], torch.as_tensor(x[sl]))
    assert sh["table"].shape == (7, 5) and sh["pair"][1] == 3.5
    assert torch.equal(sh["pair"][0], torch.arange(C)[sl])
    g = pmesh.shard_chain_tree_global(dict(x=sh["x"], table=sh["table"]),
                                      cm, C)
    assert torch.equal(g["x"], sh["x"]) and g["x"] is not sh["x"]
    assert torch.equal(pmesh.gather_chains(sh["x"], cm), torch.as_tensor(x))
    mean, var = pmesh.cross_chain_moments(sh["x"], mesh=cm)
    local = torch.as_tensor(draws[:, sl])
    arrays[f"mean_{tag_}"] = mean.numpy()
    arrays[f"var_{tag_}"] = var.numpy()
    arrays[f"rhat_{tag_}"] = pmesh.rhat(local, mesh=cm).numpy()
    arrays[f"ess_{tag_}"] = pmesh.ess(local, mesh=cm).numpy()
    arrays[f"gathered_{tag_}"] = pmesh.gather_chains(local, cm, dim=1).numpy()
    try:
        pmesh.chain_slice(cm, C + 1)
        raise AssertionError("chain_slice took a count that does not divide")
    except ValueError:
        pass
# -- the sharded grid fill --------------------------------------------------
cm = pmesh.chain_mesh(device="cpu")
n, m, g = D["grid"]
for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
    gr = agrid.make_grid(n, m, g=g, dtype=dt, mesh=cm)
    for k in ("avec", "s1_hi", "s1_lo", "vtab", "srel"):
        arrays[f"grid_{name}_{k}"] = getattr(gr, k).numpy()
    res[f"grid_{name}_q"] = float(gr.S(30, 4, 0.37))
try:
    agrid.make_grid(n, m, g=g - 1, mesh=cm)
    raise AssertionError("a grid that does not divide was filled")
except ValueError:
    res["indivisible_raises"] = True
# -- the dry run: the card's generators, then replayed draws ---------------
dry = D["dry"]
out1 = entry.dryrun_multichip(**dry, device="cpu")
cm = out1["mesh"]
res.update(mesh=cm.shape, chains=out1["chains"], a_mean=out1["a_mean"],
           b_mean=out1["b_mean"], coord=cm.coords)
for k in ("t", "T", "a", "b"):
    arrays[f"dry_{k}"] = out1[k].numpy()
# the one-process step on this rank's chains under the same generators
step, args = entry._build(out1["local"], "cpu", dry["n_max"], dry["m_max"],
                          dry["g"], dim=dry["dim"],
                          n_per_group=dry["n_per_group"])
ref = step(entry.step_generators(0, "cpu", cm.coord("chains")), *args[1:])
for k, v in zip(("t", "T", "a", "b"), ref):
    arrays[f"one_{k}"] = v.numpy()
tape = np.load(f"{out}/tape.npz")
sl = pmesh.chain_slice(cm, out1["chains"])
gens = tuple(ShardReplay([tape[f"{c}{i}"] for i in range(int(tape[f"n{c}"]))],
                         out1["chains"], sl) for c in "sba")
out2 = entry.dryrun_multichip(**dry, device="cpu", gens=gens)
for k in ("t", "T", "a", "b"):
    arrays[f"replay_{k}"] = out2[k].numpy()
res["slice"] = [sl.start, sl.stop]
np.savez(f"{out}/r{rank}.npz", **arrays)
with open(f"{out}/r{rank}.json", "w") as f:
    json.dump(res, f)
"""


def _one_process_tape():
    """The one-process step on all of DRY's chains under recorded draws:
    (outputs, {generator: draws})."""
    step, args = entry._build(DRY["chains"], "cpu", DRY["n_max"],
                              DRY["m_max"], DRY["g"], dim=DRY["dim"],
                              n_per_group=DRY["n_per_group"])
    tapes = tuple(_Tape(s) for s in (11, 12, 13))
    outs = step(tapes, *args[1:])
    return outs, dict(zip("sba", (t.draws for t in tapes)))


def _run(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"w{world}")
    out = tmp / "out"
    out.mkdir()
    np.savez(out / "draws.npz", **_draws())
    ref, tapes = _one_process_tape()
    flat = {f"{c}{i}": x for c, xs in tapes.items() for i, x in enumerate(xs)}
    flat.update({f"n{c}": len(xs) for c, xs in tapes.items()})
    np.savez(out / "tape.npz", **flat)
    (out / "config.json").write_text(json.dumps(dict(grid=GRID, dry=DRY)))
    texts = run_ranks(_WORKER, world, tmp, timeout=120)
    ranks = [dict(np.load(out / f"r{r}.npz")) for r in range(world)]
    for r in range(world):
        ranks[r].update(json.loads((out / f"r{r}.json").read_text()))
    return dict(world=world, ranks=ranks, texts=texts,
                ref=[x.numpy() for x in ref])


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    return _run(4, tmp_path_factory)


@pytest.fixture(params=["w2", "w4"])
def run(request):
    return request.getfixturevalue(request.param)


# -- world 1 ------------------------------------------------------------------

def test_chain_mesh_world_one_needs_no_group():
    cm = pmesh.chain_mesh(device="cpu")
    assert not dist.is_initialized()
    assert cm.shape == {"chains": 1} and cm.coords == (0,)
    assert cm.groups == (None,) and cm.world_group is None
    assert cm.device == torch.device("cpu") and cm.world == 1
    assert cm.size("data") == 1 and cm.coord("data") == 0
    with pytest.raises(ValueError, match="one process a device"):
        pmesh.chain_mesh(n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        pmesh.chain_mesh(shape=(2, 2), device="cpu")


def test_shard_chain_tree_world_one():
    """Every chain stays; each leaf is a new tensor on the mesh's device
    (never an alias of the caller's); non-array leaves pass through."""
    cm = pmesh.chain_mesh(1, device="cpu")
    x = torch.arange(12.0).reshape(4, 3)
    gen = torch.Generator()
    out = pmesh.shard_chain_tree(dict(x=x, t=np.ones((5, 2)), g=gen), cm, 4)
    assert torch.equal(out["x"], x) and out["x"].data_ptr() != x.data_ptr()
    assert out["t"].shape == (5, 2) and out["g"] is gen
    again = pmesh.shard_chain_tree_global(dict(x=x), cm, 4)
    assert torch.equal(again["x"], x)
    assert pmesh.gather_chains(x, cm) is x
    d = torch.as_tensor(_draws()["draws"])
    assert torch.equal(pmesh.rhat(d, mesh=cm), pmesh.rhat(d))
    assert torch.equal(pmesh.ess(d, mesh=cm), pmesh.ess(d))


def test_sharded_fill_world_one_is_the_plain_fill():
    cm = pmesh.chain_mesh(device="cpu")
    a = tag.make_grid(*GRID[:2], g=GRID[2], mesh=cm)
    b = tag.make_grid(*GRID[:2], g=GRID[2], device="cpu")
    for k in ("avec", "s1_hi", "s1_lo", "vtab", "srel"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


# -- under 2 and 4 processes -------------------------------------------------

def test_shard_and_gather(run):
    """Each rank's slice and the all-gathered draws (checked in the
    ranks); the gathered (T, C) draws are the global ones on every rank,
    on the (P,) mesh and on the (P/2, 2) chains x data mesh."""
    d = _draws()["draws"]
    for r in run["ranks"]:
        for k in [k for k in r if k.startswith("gathered_")]:
            np.testing.assert_array_equal(r[k], d)


def test_moments_rhat_ess_over_all_chains(run):
    x = torch.as_tensor(_draws()["x"])
    d = torch.as_tensor(_draws()["draws"])
    mean, var = pmesh.cross_chain_moments(x)
    for r in run["ranks"]:
        for tag_ in [k[5:] for k in r if k.startswith("mean_")]:
            np.testing.assert_allclose(r[f"mean_{tag_}"], mean.numpy(),
                                       rtol=1e-12)
            np.testing.assert_allclose(r[f"var_{tag_}"], var.numpy(),
                                       rtol=1e-12)
            assert float(r[f"rhat_{tag_}"]) == float(pmesh.rhat(d))
            assert float(r[f"ess_{tag_}"]) == float(pmesh.ess(d))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_sharded_fill_bitwise_equal_one_process(run, dtype):
    """Each rank fills g / P discounts and all-gathers: every rank holds
    the one-process port fill, bitwise."""
    one = tag.make_grid(*GRID[:2], g=GRID[2], device="cpu",
                        dtype=getattr(torch, "float" + dtype[1:]))
    for r in run["ranks"]:
        for k in ("avec", "s1_hi", "s1_lo", "vtab", "srel"):
            np.testing.assert_array_equal(r[f"grid_{dtype}_{k}"],
                                          getattr(one, k).numpy(), err_msg=k)
        assert r[f"grid_{dtype}_q"] == float(one.S(30, 4, 0.37))


def test_sharded_fill_equals_jax_mesh_fill(run):
    """Against JAX's make_grid on the 8-device virtual mesh
    (tests/test_sharded_fill.py), within test_torch_agrid.py's f64 grid
    tolerance."""
    mesh = Mesh(np.asarray(jax.devices()), ("grid",))
    jg = jag.make_grid(*GRID[:2], g=GRID[2], dtype=jnp.float64, mesh=mesh)
    for r in run["ranks"]:
        for k in ("avec", "s1_hi", "s1_lo"):
            np.testing.assert_array_equal(r[f"grid_f64_{k}"],
                                          np.asarray(getattr(jg, k)))
        for k in ("vtab", "srel"):
            x, y = r[f"grid_f64_{k}"], np.asarray(getattr(jg, k))
            np.testing.assert_array_equal(np.isinf(x), np.isinf(y))
            fin = np.isfinite(y)
            np.testing.assert_allclose(x[fin], y[fin], rtol=1e-12,
                                       atol=1e-12)


def test_indivisible_grid_raises(run):
    assert all(r["indivisible_raises"] for r in run["ranks"])


def test_dryrun_mesh_and_state(run):
    """(P,) as ("chains",) at 2 processes, (2, 2) as ("chains", "data") at
    4; the state's invariants exact, the means over all chains finite and
    in bounds, printed once."""
    want = {2: {"chains": 2}, 4: {"chains": 2, "data": 2}}[run["world"]]
    a_all = []
    for r in run["ranks"]:
        assert r["mesh"] == want and r["chains"] == DRY["chains"]
        t, T, a, b = (r[f"dry_{k}"] for k in "tTab")
        assert t.shape == (DRY["chains"] // 2, 2, DRY["dim"])
        np.testing.assert_array_equal(t.sum(-1), T)
        assert (t >= 0).all() and ((a >= 0.01) & (a <= 0.98)).all()
        a_all.append(a)
    r0 = run["ranks"][0]
    assert 0.01 <= r0["a_mean"] <= 0.98 and np.isfinite(r0["b_mean"])
    lines = [[ln for ln in text.splitlines()
              if ln.startswith("dryrun_multichip ok")]
             for text in run["texts"]]
    assert len(lines[0]) == 2 and not any(lines[1:])     # two runs, rank 0
    assert f"chains={DRY['chains']}" in lines[0][0]
    per_shard = {tuple(r["slice"]): r["dry_a"] for r in run["ranks"]}
    np.testing.assert_allclose(
        r0["a_mean"], np.mean(np.concatenate(
            [per_shard[k] for k in sorted(per_shard)]).astype(np.float64)),
        rtol=1e-12)


def test_dryrun_equals_one_process_step_under_the_shard_generators(run):
    """Each rank's step equals the one-process step on its chains with
    the same shard generators: t, T, b exactly; a exactly on the chains
    mesh, within 1e-5 relative in all but 1% of chains on chains x data
    (the curve is summed in another order)."""
    for r in run["ranks"]:
        for k in "tTb":
            np.testing.assert_array_equal(r[f"dry_{k}"], r[f"one_{k}"])
        _check_a(run["world"], r["dry_a"], r["one_a"])


def test_dryrun_equals_one_process_step_under_replayed_draws(run):
    """The one-process step on all chains, its draws replayed per shard:
    each rank's chains end where the one-process run's did."""
    ref = dict(zip("tTab", run["ref"]))
    for r in run["ranks"]:
        sl = slice(*r["slice"])
        for k in "tTb":
            np.testing.assert_array_equal(r[f"replay_{k}"], ref[k][sl])
        _check_a(run["world"], r["replay_a"], ref["a"][sl])


def test_data_group_peers_bitwise_equal(run):
    """Peers of a data group (the same chain coordinate) hold the same
    bits in t, T, a, b; distinct chain shards drew different numbers."""
    by_shard = {}
    for r in run["ranks"]:
        by_shard.setdefault(tuple(r["slice"]), []).append(r)
    assert len(by_shard) == 2
    for peers in by_shard.values():
        assert len(peers) == run["world"] // 2
        for p in peers[1:]:
            for k in ("dry_t", "dry_T", "dry_a", "dry_b", "replay_a"):
                assert np.array_equal(p[k], peers[0][k]), k
    s0, s1 = (v[0] for v in by_shard.values())
    assert not np.array_equal(s0["dry_b"], s1["dry_b"])


def _check_a(world, got, want):
    if world == 2:                        # chains only: the same sum
        np.testing.assert_array_equal(got, want)
        return
    rel = np.abs(got.astype(np.float64) - want) / np.abs(want)
    assert np.mean(rel > 1e-5) <= 0.01, rel
