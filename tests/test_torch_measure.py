"""Measurement and shot sampling of the port against the JAX package, with
the JAX package's own uniforms injected so that draws match one for one:
outcomes must be equal and collapsed states agree to 1e-5 (relative L2);
sampled indices must be equal except where a uniform lies within 1e-6 of a
CDF boundary."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.statevec import StateVec as TStateVec  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import measure as TM  # noqa: E402
from qubism_torch.ops import sample as TS  # noqa: E402
from qubism_tpu.core.statevec import StateVec as JStateVec  # noqa: E402
from qubism_tpu.ops import measure as JM  # noqa: E402
from qubism_tpu.ops import sample as JS  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def rand_planes(n, seed, sparse=False):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    if sparse:  # many exact zeros: the CDF has flat stretches
        v[rng.uniform(size=1 << n) < 0.7] = 0
    v /= np.linalg.norm(v)
    return v.real.astype(np.float32), v.imag.astype(np.float32)


def jax_measure(re, im, n, qubits, uniforms):
    """The JAX package's marginal-table measurement with injected uniforms:
    _marginal_table_traced + _ancestral_draws_traced + the projection."""
    planes = (jnp.asarray(re), jnp.asarray(im))
    outs = []
    for i in range(0, len(qubits), JM._MEASURE_TABLE_MAX):
        chunk = tuple(qubits[i:i + JM._MEASURE_TABLE_MAX])
        table = JM._marginal_table_traced(planes, n, chunk)
        o, mask, _ = JM._ancestral_draws_traced(
            table, chunk, None, False, uniforms=jnp.asarray(uniforms[i:i + len(chunk)]))
        mass = jnp.sum(table * mask)
        scale = jnp.where(mass > 0, 1.0 / jnp.sqrt(mass), 0.0)
        rowvec, colvec = JM._projection_rowcol_traced(o, chunk, n, scale, jnp.float32)
        C = colvec.shape[0]
        ind = rowvec[:, None] * colvec[None, :]
        planes = tuple((p.reshape(-1, C) * ind).reshape(-1) for p in planes)
        outs += [int(x) for x in o]
    return outs, np.asarray(planes[0], np.float64) + 1j * np.asarray(planes[1], np.float64)


@pytest.mark.parametrize("n,qubits", [
    (8, (0, 3, 7)), (10, (9, 2, 5, 0)), (12, tuple(range(12))), (17, tuple(range(16, -1, -1))),
])
def test_measure_qubits_matches_jax(n, qubits):
    re, im = rand_planes(n, n)
    for trial in range(4):
        u = np.random.default_rng(100 * n + trial).uniform(size=len(qubits)).astype(np.float32)
        want_o, want_s = jax_measure(re, im, n, qubits, u)
        state = TA.state_from_planes(re, im)
        got_o = TM.measure_qubits(state, None, qubits, n, uniforms=u)
        assert got_o == want_o
        got_s = TA.complex_from_state(state)
        assert np.linalg.norm(got_s - want_s) <= 1e-5


def test_sequential_path_agrees_with_table_path():
    n, qubits = 9, (4, 0, 8, 2)
    re, im = rand_planes(n, 3)
    u = np.random.default_rng(5).uniform(size=4)
    a = TA.state_from_planes(re, im)
    b = TA.state_from_planes(re, im)
    oa = TM.measure_qubits(a, None, qubits, n, uniforms=u)
    config.force_sequential_measure = True
    try:
        ob = TM.measure_qubits(b, None, qubits, n, uniforms=u)
    finally:
        config.force_sequential_measure = False
    assert oa == ob
    assert float(torch.linalg.vector_norm(a - b)) <= 1e-5


@pytest.mark.parametrize("q", [0, 4, 9])
def test_prob_one_and_collapse_match_jax(q):
    n = 10
    re, im = rand_planes(n, q)
    planes = (jnp.asarray(re), jnp.asarray(im))
    state = TA.state_from_planes(re, im)
    assert abs(TM.prob_one(state, q, n) - float(JM.prob_one(planes, q, n))) < 1e-6
    for outcome in (0, 1):
        want = JM.collapse(planes, jnp.int32(outcome), q, n)
        got = TM.collapse(state.clone(), outcome, q, n)
        want = np.asarray(want[0], np.float64) + 1j * np.asarray(want[1], np.float64)
        assert np.linalg.norm(TA.complex_from_state(got) - want) <= 1e-5


@pytest.mark.parametrize("n,seed,sparse", [(6, 1, False), (9, 2, True), (12, 3, False)])
def test_sampler_matches_jax_sample_parts(n, seed, sparse):
    re, im = rand_planes(n, seed, sparse)
    shots = 2000
    key = jax.random.PRNGKey(seed)
    c, lo = JS._sample_parts((jnp.asarray(re), jnp.asarray(im)), n, shots, key)
    want = (np.asarray(c, np.int64) << (n - n // 2)) | np.asarray(lo, np.int64)
    u = np.asarray(jax.random.uniform(key, (shots,), jnp.float32))
    got = TS.sample_indices(TA.state_from_planes(re, im), n, shots, uniforms=u)
    assert got.dtype == np.int64
    p = re.astype(np.float64) ** 2 + im.astype(np.float64) ** 2
    cdf = np.cumsum(p) / p.sum()
    near = np.min(np.abs(cdf[None, :] - u[:, None].astype(np.float64)), axis=1) < 1e-6
    assert near.mean() < 0.01
    np.testing.assert_array_equal(got[~near], want[~near])
    assert (p[got] > 0).all()


def test_sample_counts_and_statevec():
    n = 5
    re, im = rand_planes(n, 9)
    jsv = JStateVec(n, (jnp.asarray(re), jnp.asarray(im)))
    tsv = TStateVec(n, TA.state_from_planes(re, im))
    assert str(tsv) == str(jsv)
    assert tsv == TStateVec(n, TA.state_from_planes(re, im))
    other = TA.state_from_planes(re, im)
    other[3] += 1e-3
    assert not tsv == TStateVec(n, other)
    assert abs(tsv.prob_one(2) - jsv.prob_one(2)) < 1e-6
    counts = tsv.sample(4096, seed=1)
    assert sum(counts.values()) == 4096 and all(len(k) == n for k in counts)
    assert TStateVec.zero(3).sample(10) == {"000": 10}
    b = TStateVec.zero(1)
    b.state[:] = torch.tensor([1, 1], dtype=torch.complex64) / math.sqrt(2)
    assert str(tsv.tensor(b)) == str(jsv.tensor(JStateVec(1, np.array([1, 1]) / math.sqrt(2))))
