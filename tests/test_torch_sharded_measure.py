"""Measurement and sampling on the port's sharded engine against the JAX
package's ShardedSim (8 shards, 2^2 banks each, so a measured qubit may sit
on a device, a bank or a local bit). The JAX draws are reproduced here in
its own key-split order (``measure_qubit``, ``_ancestral_draws_traced``,
``sample``) and injected into the port, so outcomes, states (relative L2 <=
1e-5) and sampled indices must agree exactly. With the port's own generator,
counts are held to the Born rule by ``utils.stats.chi2_test``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import qubism_torch.models.circuits as TC  # noqa: E402
import qubism_tpu.models.circuits as JC  # noqa: E402
import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.parallel import ShardedSim, make_mesh  # noqa: E402
from qubism_torch.utils.stats import chi2_test  # noqa: E402
from qubism_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from qubism_tpu.parallel.sharded import ShardedSim as JaxShardedSim  # noqa: E402

TOL = 1e-5
N, BANKS = 8, 2  # positions 0-2 device bits, 3-4 bank bits, 5-7 local bits


@pytest.fixture(autouse=True)
def modes():
    JK.INTERPRET = True
    old = config.device
    config.device = "cpu"
    yield
    JK.INTERPRET = False
    config.device = old


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(8)


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def port_sim(banks=BANKS, seed=3):
    """A brickwork state (its dense gates on device bits relabel qubits)."""
    sim = ShardedSim(N, make_mesh(8), banks=banks)
    return sim.apply([TPrim(p.u, p.targets, p.diag) for p in JC.brickwork_prims(N, 2, seed=seed)])


def pair(jmesh, banks=BANKS, seed=3):
    """:func:`port_sim`'s state in both engines."""
    js = JaxShardedSim(N, jmesh, banks=banks).apply(JC.brickwork_prims(N, 2, seed=seed))
    ts = port_sim(banks, seed)
    assert ts.perm == js.perm
    return js, ts


def by_region(sim):
    """One logical qubit whose physical position is a device, a bank and a
    local bit."""
    d, w = sim.d, sim.w
    inv = sim.inv
    return {"device": inv[1], "bank": inv[d + w - 1], "local": inv[d + w + 1]}


def jax_draws(key, k):
    """The uniforms of k key splits, as measure_qubit and the marginal-table
    draws take them."""
    out = []
    for _ in range(k):
        key, sub = jax.random.split(key)
        out.append(float(jax.random.uniform(sub, dtype=np.float32)))
    return out


def test_prob_one_and_collapse_match_jax(jmesh):
    js, ts = pair(jmesh)
    for region, q in by_region(ts).items():
        assert abs(ts.prob_one(q) - js.prob_one(q)) <= 1e-6, region
        outcome = int(ts.prob_one(q) < 0.5)
        js.collapse(q, outcome)
        ts.collapse(q, outcome)
        assert abs(ts.prob_one(q) - outcome) <= 1e-6, region
        assert rel(ts.amplitudes(), js.amplitudes()) <= TOL, region


def test_measure_qubit_matches_jax(jmesh):
    js, ts = pair(jmesh, seed=5)
    key = jax.random.PRNGKey(11)
    for region, q in by_region(ts).items():
        (u,) = jax_draws(key, 1)
        want, key = js.measure_qubit(q, key)
        assert ts.measure_qubit(q, uniform=u) == want, region
        assert rel(ts.amplitudes(), js.amplitudes()) <= TOL, region


@pytest.mark.parametrize("order", ["bank,local,device", "device,local,bank,other"])
def test_measure_qubits_matches_jax(jmesh, order):
    js, ts = pair(jmesh, seed=7)
    regions = by_region(ts)
    regions["other"] = next(q for q in range(N) if q not in regions.values())
    qs = [regions[r] for r in order.split(",")]
    key = jax.random.PRNGKey(5)
    want, _ = js.measure_qubits(qs, key)
    got = ts.measure_qubits(qs, uniforms=jax_draws(key, len(qs)))
    assert got == want
    assert rel(ts.amplitudes(), js.amplitudes()) <= TOL
    mass = sum(float(np.sum(np.abs(t.numpy()) ** 2)) for row in ts.banks for t in row)
    assert abs(mass - 1) <= 1e-5


def test_measure_qubits_sequential_and_repeats(jmesh):
    js, ts = pair(jmesh, seed=9)
    qs = [by_region(ts)["bank"], by_region(ts)["device"], by_region(ts)["bank"]]
    key = jax.random.PRNGKey(2)
    want, _ = js.measure_qubits(qs, key)  # a repeat: qubit by qubit
    got = ts.measure_qubits(qs, uniforms=jax_draws(key, 3))
    assert got == want and got[0] == got[2]
    assert rel(ts.amplitudes(), js.amplitudes()) <= TOL
    # forcing the per-qubit stream gives what the table path gives
    a, b = port_sim(seed=9), port_sim(seed=9)
    u = [0.3, 0.8, 0.45]
    qs = qs[:2] + [by_region(a)["local"]]
    table = a.measure_qubits(qs, uniforms=u)
    config.force_sequential_measure = True
    try:
        seq = b.measure_qubits(qs, uniforms=u)
    finally:
        config.force_sequential_measure = False
    assert table == seq
    assert rel(a.amplitudes(), b.amplitudes()) <= TOL


@pytest.mark.parametrize("banks", [0, 2])
def test_sample_matches_jax_index_for_index(jmesh, banks):
    js, ts = pair(jmesh, banks=banks, seed=4)
    key = jax.random.PRNGKey(13)
    want = js.sample(512, key)
    u = np.asarray(jax.random.uniform(key, (512,), dtype=np.float32))
    got = ts.sample(512, uniforms=u)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_counts_follow_the_born_rule():
    gen = torch.Generator().manual_seed(17)
    n = 10
    sim = ShardedSim(n, make_mesh(4), banks=2).apply(TC.ghz_prims(n))
    idx = sim.sample(4096, gen)
    assert set(np.unique(idx)) <= {0, (1 << n) - 1}
    counts = np.array([np.sum(idx == 0), np.sum(idx == (1 << n) - 1)])
    assert bool(chi2_test(counts, np.array([0.5, 0.5])))

    n = 9
    sim = ShardedSim(n, make_mesh(8), banks=1).apply(TC.brickwork_prims(n, 3, seed=2))
    probs = np.abs(sim.amplitudes()) ** 2
    idx = sim.sample(8192, gen)
    res = chi2_test(np.bincount(idx, minlength=1 << n).astype(float), probs / probs.sum())
    assert bool(res), res


def test_marginal_in_the_given_qubit_order():
    sim = port_sim(seed=6)
    probs = (np.abs(sim.amplitudes()) ** 2).reshape((2,) * N)
    for qs in ([0, 1, 2, 3], [6, 1, 4], [3], [7, 0, 5, 2, 1]):
        rest = tuple(q for q in range(N) if q not in qs)
        want = probs.sum(axis=rest).transpose(np.argsort(np.argsort(qs))).reshape(-1)
        np.testing.assert_allclose(sim.marginal(qs), want, atol=1e-6)
