"""Cross-entropy benchmarking of the port (models/xeb.py): the cases of
tests/test_xeb.py on the CPU. Probabilities to 1e-6 against the full
distribution and against the JAX package's ``sampled_probabilities`` on
the same (numpy-drawn) indices; the port's own samples by the estimator's
stated k-stderr windows (k = 6, as the JAX file)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.models.circuits as JC  # noqa: E402
import qubism_tpu.models.xeb as JX  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.statevec import StateVec  # noqa: E402
from qubism_torch.models.circuits import brickwork_prims  # noqa: E402
from qubism_torch.models.xeb import (counts_to_indices, linear_xeb, log_xeb,  # noqa: E402
                                     sampled_probabilities, xeb_stderr)
from qubism_torch.ops.fusion import CompiledCircuit  # noqa: E402
from qubism_tpu.core.statevec import StateVec as JStateVec  # noqa: E402
from qubism_tpu.ops.fusion import CompiledCircuit as JCompiled  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _brickwork_state(n: int, depth: int, seed: int = 1) -> StateVec:
    circ = CompiledCircuit(n, brickwork_prims(n, depth, seed=seed))
    return StateVec(n, circ(circ.init_state()))


def test_sampled_probabilities_match_full_distribution_and_jax():
    sv = _brickwork_state(8, 6)
    probs = sv.probs()
    idx = np.array([0, 3, 17, 255, 128, 64])
    got = sampled_probabilities(sv, idx)
    assert got.dtype == np.float64
    assert np.allclose(got, probs[idx], atol=1e-6)
    jc = JCompiled(8, JC.brickwork_prims(8, 6, seed=1), virtual_shards=0)
    jsv = JStateVec(8, jc(jc.init_state()))
    assert np.abs(got - JX.sampled_probabilities(jsv, idx)).max() < 1e-6


def test_counts_roundtrip():
    idx = counts_to_indices({"0101": 3, "1111": 2})
    assert sorted(idx.tolist()) == [5, 5, 5, 15, 15]


def test_ideal_sampler_matches_collision_number():
    """E[F_XEB] = D sum p^2 - 1 for samples of the exact distribution."""
    n, shots = 10, 8192
    sv = _brickwork_state(n, 8)
    idx = counts_to_indices(sv.sample(shots, seed=7))
    f, se = xeb_stderr(sv, idx)
    expected = (1 << n) * float(np.sum(sv.probs() ** 2)) - 1.0
    assert f == pytest.approx(expected, abs=6 * se)
    assert linear_xeb(sv, idx) == pytest.approx(f, abs=1e-12)


def test_deep_brickwork_approaches_porter_thomas():
    sv = _brickwork_state(10, 24)
    assert 2.0 < (1 << 10) * float(np.sum(sv.probs() ** 2)) < 2.6


def test_uniform_sampler_scores_near_zero():
    n, shots = 10, 8192
    sv = _brickwork_state(n, 8)
    idx = np.random.default_rng(0).integers(0, 1 << n, size=shots)
    f, se = xeb_stderr(sv, idx)
    assert abs(f) < 6 * se + 0.02


def test_mixed_sampler_interpolates():
    n, shots = 10, 8192
    sv = _brickwork_state(n, 8)
    ideal = counts_to_indices(sv.sample(shots // 2, seed=3))
    uniform = np.random.default_rng(1).integers(0, 1 << n, size=shots // 2)
    f = linear_xeb(sv, np.concatenate([ideal, uniform]))
    expected = ((1 << n) * float(np.sum(sv.probs() ** 2)) - 1.0) / 2.0
    assert f == pytest.approx(expected, abs=0.15)


def test_log_xeb_endpoints():
    n, shots = 10, 8192
    d = 1 << n
    sv = _brickwork_state(n, 8)
    probs = np.maximum(sv.probs(), 1e-38)
    gamma = 0.5772156649015329
    want_ideal = float(np.sum(probs * np.log(d * probs))) + gamma
    want_unif = float(np.mean(np.log(d * probs))) + gamma
    ideal = counts_to_indices(sv.sample(shots, seed=5))
    uniform = np.random.default_rng(2).integers(0, d, size=shots)
    assert log_xeb(sv, ideal) == pytest.approx(want_ideal, abs=0.1)
    assert log_xeb(sv, uniform) == pytest.approx(want_unif, abs=0.1)
    assert want_ideal > want_unif + 0.5


def test_works_on_a_state_tensor():
    """A bare state tensor with explicit n, flat or in any 2-D view (the
    JAX file's flat and canonical-plane cases)."""
    sv = _brickwork_state(6, 4)
    idx = np.arange(1 << 6)
    assert np.allclose(sampled_probabilities(sv.state, idx), sv.probs(), atol=1e-6)
    shots = counts_to_indices(sv.sample(512, seed=1))
    assert linear_xeb(sv.state, shots, n=6) == pytest.approx(linear_xeb(sv, shots), abs=1e-9)
    big = _brickwork_state(16, 6)
    idx = np.array([0, 1, 2047, 2048, 65535, 40000])
    assert np.allclose(sampled_probabilities(big.state.view(-1, 2048), idx),
                       sampled_probabilities(big, idx), atol=1e-7)
