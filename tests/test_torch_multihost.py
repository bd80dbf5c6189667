"""The port's tests/test_multihost.py: two gloo CPU processes shard a chain
ensemble with shard_chain_tree_global (each passes its own slice, with a
different starting b), run a 3-iteration TI + sample_b chunk on their own
generators, take the cross-chain mean by a collective (equal on both
ranks), and round-trip a .p0 / .p1 checkpoint: the resumed chunk equals
the straight one bitwise."""
import json

import numpy as np
import pytest

from test_torch_distributed import run_ranks

_WORKER = """
import numpy as np
from libstb_tpu_torch.core import agrid, rng
from libstb_tpu_torch.models import pyp
from libstb_tpu_torch.parallel import mesh as pmesh
from libstb_tpu_torch.samplers import hyper
from libstb_tpu_torch.utils import checkpoint

GLOBAL = 8
local = distributed.host_local_chains(GLOBAL)
assert local == 4
data = pyp.crp_generate(0, 2, 6, 12, 0.5, 2.0)
n_req, m_req = agrid.required_dims(data.n)
cm = pmesh.chain_mesh(device="cpu")
grid = agrid.make_grid(n_req, m_req, g=16, mesh=cm)
t0, T0 = pyp.init_state(data, GLOBAL, "cpu")
sl = slice(rank * local, (rank + 1) * local)
st = pmesh.shard_chain_tree_global(
    dict(t=t0[sl], T=T0[sl], a=np.full(local, 0.5, np.float32),
         b=np.full(local, 2.0 + rank, np.float32)), cm, GLOBAL)
N_b = torch.as_tensor(data.N, dtype=torch.float32)


def chunk(gen, t, T, b, iters):
    for _ in range(iters):
        t, T = pyp.ti_sweep(gen, t, T, st["a"], b, grid, data)
        b, _ = hyper.sample_b(gen, b, N_b, T.float(), st["a"], 1.1, 6.0)
    return t, T, b


t, T, b = chunk(rng.generator(7 + rank, "cpu"), st["t"], st["T"], st["b"],
                3)
Tmean = pmesh.cross_chain_moments(T.double(), mesh=cm)[0].mean()
print(f"P{rank} Tmean {float(Tmean):.15g}", flush=True)

# the straight 6-iteration chunk, then 3 + checkpoint + 3
straight = chunk(rng.generator(7 + rank, "cpu"), st["t"], st["T"],
                 st["b"], 6)
gen = rng.generator(7 + rank, "cpu")
t, T, b = chunk(gen, st["t"], st["T"], st["b"], 3)
state = dict(t=t, T=T, b=b, gen=gen, extra=torch.arange(3.0))
path = checkpoint.save(f"{out}/mh", state, meta=dict(chunk=1), chains=local)
assert path.endswith(f"mh.p{rank}.npz"), path
loaded, meta = checkpoint.load(f"{out}/mh", like=state)
assert meta == {"chunk": 1}
assert torch.equal(loaded["extra"], torch.arange(3.0))
g2 = pmesh.shard_chain_tree_global(
    dict(t=loaded["t"], T=loaded["T"], b=loaded["b"]), cm, GLOBAL)
resumed = chunk(loaded["gen"], g2["t"], g2["T"], g2["b"], 3)
for x, y in zip(straight, resumed):
    assert torch.equal(x, y)
print(f"P{rank} OK", flush=True)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    return run_ranks(_WORKER, 2, tmp), tmp / "out"


def test_resume_equals_the_straight_chunk(run):
    """Each rank loads its own .p<rank> file (state and generator),
    re-shards it, and its 3 + 3 iterations equal the straight 6 bitwise
    (checked in the ranks)."""
    outs, _ = run
    for r, text in enumerate(outs):
        assert f"P{r} OK" in text, text


def test_cross_chain_mean_agrees_between_ranks(run):
    outs, _ = run
    m0, m1 = ([ln for ln in text.splitlines() if "Tmean" in ln][0].split()[-1]
              for text in outs)
    assert m0 == m1


def test_one_checkpoint_file_a_rank(run):
    """One file and sidecar a rank, each naming the world, its rank and
    its chain-sharded leaves (t, T, b; not the replicated one)."""
    _, out = run
    for r in range(2):
        f = out / f"mh.p{r}.npz"
        side = json.loads((out / f"mh.p{r}.npz.json").read_text())
        assert f.exists() and side["world_size"] == 2 and side["rank"] == r
        with np.load(f) as z:
            shard = sorted(k for k in z.files if z[k].shape[:1] == (4,))
            assert sorted(side["chain_sharded"]) == shard
            assert len(shard) == 3 and "leaf4" not in shard
    assert not (out / "mh.npz").exists()
