"""Randomized benchmarking of the port (models/rb.py): the cases of
tests/test_rb.py on the CPU. The Clifford groups, their words, the
sequences and the simultaneous-RB program (numpy) equal the JAX package's
exactly; density survivals follow the depolarizing law to 1e-6 and equal
the JAX package's to 1e-6; trajectory survivals within 5 binomial sigma +
0.02 of the exact ones, and the Pauli-frame survivals at n = 64 within 5
sigma of the law (the JAX file's bounds)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.core.density as JD  # noqa: E402
import qubism_tpu.models.rb as JR  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.density import DensityMatrix, depolarizing, depolarizing2  # noqa: E402
from qubism_torch.models.rb import (_canon, clifford_group, clifford_words,  # noqa: E402
                                    fit_rb, inverse_index, irb_experiment, rb_experiment,
                                    rb_prims, rb_sequence, rb_survivals,
                                    simultaneous_rb_qasm, simultaneous_rb_survivals)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


@pytest.mark.parametrize("k,size", [(1, 24), (2, 11520)])
def test_clifford_group_equals_the_jax_group(k, size):
    group = clifford_group(k)
    assert len(group) == size
    assert all(np.array_equal(u, v) for u, v in zip(group, JR.clifford_group(k)))


@pytest.mark.parametrize("k", [1, 2])
def test_clifford_elements_unitary_and_invertible(k):
    group = clifford_group(k)
    eye = np.eye(1 << k)
    for i in np.random.default_rng(0).choice(len(group), size=12, replace=False):
        u = group[i]
        assert np.allclose(u @ u.conj().T, eye, atol=1e-8)
        assert np.allclose(np.abs(group[inverse_index(k, u)] @ u), eye, atol=1e-8)


@pytest.mark.parametrize("k", [1, 2])
def test_sequence_inverts_to_identity(k):
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for m in (0, 1, 5):
        seq = rb_sequence(k, m, rng)
        assert seq == JR.rb_sequence(k, m, jrng)
        p = DensityMatrix(k).apply(rb_prims(k, seq)).probs()
        assert abs(p[0] - 1.0) < 1e-6, (k, m, p)


def test_noise_free_survival_is_one():
    assert np.allclose(rb_survivals(1, [1, 4, 16], kraus=None, n_seq=3, seed=1), 1.0, atol=1e-6)


def test_rb_decay_matches_depolarizing_1q_and_jax():
    p = 0.02
    alpha_true = 1 - 4 * p / 3
    ms = [1, 2, 4, 8, 16]
    surv = rb_survivals(1, ms, depolarizing(p), n_seq=4, seed=5)
    for m, s in zip(ms, surv):
        assert abs(s - (0.5 + 0.5 * alpha_true ** m)) < 1e-6, (m, s)
    alpha, r = fit_rb(ms, surv, 1)
    assert abs(alpha - alpha_true) < 1e-6 and abs(r - 2 * p / 3) < 1e-6
    want = JR.rb_survivals(1, ms, JD.depolarizing(p), n_seq=4, seed=5)
    assert np.abs(np.asarray(surv) - np.asarray(want)).max() < 1e-6


def test_rb_decay_matches_depolarizing_2q():
    p = 0.03
    alpha_true = 1 - 16 * p / 15
    ms = [1, 2, 4, 8]
    surv = rb_survivals(2, ms, depolarizing2(p), n_seq=3, seed=2)
    for m, s in zip(ms, surv):
        assert abs(s - (0.25 + 0.75 * alpha_true ** m)) < 1e-6, (m, s)
    alpha, r = fit_rb(ms, surv, 2)
    assert abs(alpha - alpha_true) < 1e-6 and abs(r - 0.75 * (1 - alpha_true)) < 1e-6


def test_rb_experiment_end_to_end():
    p = 0.05
    ms, surv, alpha, r = rb_experiment(1, depolarizing(p), ms=(1, 2, 4), n_seq=3, seed=9)
    assert len(surv) == 3
    assert abs(alpha - (1 - 4 * p / 3)) < 1e-6 and abs(r - 2 * p / 3) < 1e-6
    with pytest.raises(ValueError, match="fewer than 2"):
        fit_rb([1, 2], [0.5, 0.5], 1)


def test_rb_trajectories_agrees_with_density():
    p = 0.1
    ms = [2, 6]
    exact = rb_survivals(1, ms, depolarizing(p), n_seq=2, seed=4)
    est = rb_survivals(1, ms, depolarizing(p), n_seq=2, seed=4, executor="trajectories",
                       ntraj=768)
    for e, s in zip(exact, est):
        assert abs(e - s) < 5 * (math.sqrt(e * (1 - e) / 768) + 1e-9) + 0.02, (e, s)


def test_interleaved_rb_recovers_gate_error():
    p1, p2 = 0.02, 0.05
    a1, a2 = 1 - 4 * p1 / 3, 1 - 4 * p2 / 3
    alpha_ref, alpha_int, r_gate = irb_experiment(1, gate_idx=3, kraus=depolarizing(p1),
                                                  gate_kraus=depolarizing(p2), ms=(1, 2, 4),
                                                  n_seq=3, seed=1)
    assert abs(alpha_ref - a1) < 1e-6
    assert abs(alpha_int - a1 * a1 * a2) < 1e-6
    assert abs(r_gate - 0.5 * (1 - a1 * a2)) < 1e-6


def test_interleaved_rb_clean_gate_measures_background():
    p = 0.03
    a = 1 - 4 * p / 3
    _, alpha_int, r_gate = irb_experiment(1, gate_idx=7, kraus=depolarizing(p),
                                          gate_kraus=None, ms=(1, 2, 4), n_seq=3, seed=2)
    assert abs(alpha_int - a * a) < 1e-6 and abs(r_gate - 0.5 * (1 - a)) < 1e-6


def test_clifford_words_reconstruct_group_and_equal_jax():
    h = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    gens = {"h": h, "s": np.diag([1, 1j]).astype(complex)}
    words = clifford_words()
    assert len(words) == 24 and words == JR.clifford_words()
    for i, w in enumerate(words):
        u = np.eye(2, dtype=complex)
        for g in w:
            u = gens[g] @ u
        assert _canon(u) == _canon(clifford_group(1)[i]), (i, w)


def test_simultaneous_rb_program_equals_jax():
    src, counts = simultaneous_rb_qasm(8, 3, np.random.default_rng(6))
    jsrc, jcounts = JR.simultaneous_rb_qasm(8, 3, np.random.default_rng(6))
    assert src == jsrc and counts == jcounts


def test_simultaneous_rb_at_scale_on_frames():
    n, m, p, T = 64, 4, 0.02, 2048
    surv, expected, used_frames = simultaneous_rb_survivals(n, m, p, ntraj=T, seed=6)
    assert used_frames and surv.shape == (n,)
    sigma = np.sqrt(expected * (1 - expected) / T)
    assert (np.abs(surv - expected) < 5 * sigma + 1e-9).all(), (
        np.abs(surv - expected).max(), sigma.max())


def test_simultaneous_rb_noise_free_is_perfect():
    surv, expected, _ = simultaneous_rb_survivals(16, 3, 0.0, ntraj=64, seed=2)
    assert np.allclose(surv, 1.0) and np.allclose(expected, 1.0)
