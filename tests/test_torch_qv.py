"""Quantum volume of the port (models/qv.py): the cases of tests/test_qv.py
on the CPU. The Haar blocks and circuits (numpy) equal the JAX package's
exactly; heavy-output probabilities by the ideal and the density executor
equal its to 1e-5 and the shot draws (numpy binomials of them) exactly;
the trajectory executor within 0.08 of the exact one (the JAX file's
bound)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.core.density as JD  # noqa: E402
import qubism_tpu.models.qv as JQ  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.density import depolarizing2  # noqa: E402
from qubism_torch.models.qv import (QVResult, haar_su4, heavy_mass, heavy_set,  # noqa: E402
                                    ideal_probs, measured_quantum_volume, qv_experiment,
                                    qv_prims)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def test_haar_su4_is_special_unitary_and_the_jax_draw():
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(5):
        u = haar_su4(rng)
        assert np.allclose(u @ u.conj().T, np.eye(4), atol=1e-10)
        assert abs(np.linalg.det(u) - 1.0) < 1e-10
        assert np.array_equal(u, JQ.haar_su4(jrng))


def test_qv_prims_layer_count_and_the_jax_circuit():
    rng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    for m in (2, 3, 5):
        prims, jprims = qv_prims(m, rng), JQ.qv_prims(m, jrng)
        assert len(prims) == m * (m // 2)
        for p, q in zip(prims, jprims):
            assert len(p.targets) == 2 and all(0 <= t < m for t in p.targets)
            assert p.targets == q.targets and np.array_equal(p.u, q.u)
    with pytest.raises(ValueError):
        qv_prims(17, rng)


def test_heavy_set_median_split():
    probs = np.array([0.1, 0.4, 0.2, 0.3])
    heavy = heavy_set(probs)
    assert set(heavy) == {1, 3} and abs(heavy_mass(probs, heavy) - 0.7) < 1e-12


def test_noiseless_hop_near_asymptote():
    res = qv_experiment(m=4, n_circuits=20, seed=7)
    assert 0.75 < res.hop_mean < 0.95, res
    assert res.passed and res.quantum_volume == 16


@pytest.mark.parametrize("kraus", [None, "dep2"])
def test_hops_equal_the_jax_package(kraus):
    k_t = depolarizing2(0.1) if kraus else None
    k_j = JD.depolarizing2(0.1) if kraus else None
    got = qv_experiment(m=3, n_circuits=4, seed=5, kraus2=k_t)
    want = JQ.qv_experiment(m=3, n_circuits=4, seed=5, kraus2=k_j)
    assert np.abs(np.asarray(got.hops) - np.asarray(want.hops)).max() < 1e-5
    shots = qv_experiment(m=3, n_circuits=4, seed=5, kraus2=k_t, shots=200)
    assert shots.hops == JQ.qv_experiment(m=3, n_circuits=4, seed=5, kraus2=k_j,
                                          shots=200).hops


def test_depolarized_device_fails():
    res = qv_experiment(m=3, n_circuits=10, seed=3, kraus2=depolarizing2(0.5))
    assert res.hop_mean < 0.62 and not res.passed and res.quantum_volume == 0


def test_mild_noise_sits_between():
    clean = qv_experiment(m=3, n_circuits=8, seed=5)
    noisy = qv_experiment(m=3, n_circuits=8, seed=5, kraus2=depolarizing2(0.05))
    assert 0.55 < noisy.hop_mean < clean.hop_mean


def test_trajectory_executor_tracks_exact():
    exact = qv_experiment(m=3, n_circuits=3, seed=11, kraus2=depolarizing2(0.1))
    est = qv_experiment(m=3, n_circuits=3, seed=11, kraus2=depolarizing2(0.1),
                        executor="trajectories", ntraj=512)
    for e, s in zip(exact.hops, est.hops):
        assert abs(e - s) < 0.08, (exact.hops, est.hops)
    with pytest.raises(ValueError, match="executor"):
        qv_experiment(m=2, n_circuits=2, kraus2=depolarizing2(0.1), executor="mps")


def test_shot_sampling_reproducible():
    r1 = qv_experiment(m=3, n_circuits=5, shots=200, seed=2)
    r2 = qv_experiment(m=3, n_circuits=5, shots=200, seed=2)
    assert isinstance(r1, QVResult) and r1 == r2
    assert all(abs(h * 200 - round(h * 200)) < 1e-9 for h in r1.hops)


def test_ideal_probs_normalized_and_measured_volume():
    p = ideal_probs(qv_prims(3, np.random.default_rng(4)), 3)
    assert abs(p.sum() - 1.0) < 1e-6 and (p >= 0).all()
    assert measured_quantum_volume(max_m=3, n_circuits=6, seed=1) == 8
