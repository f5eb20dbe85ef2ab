"""Shot-based Hamiltonian estimation of the port (models/estimation.py):
the cases of tests/test_estimation.py on the CPU. The QWC groups and the
SPSA iterates on a noiseless objective (both numpy) equal the JAX
package's exactly; the port's shot estimates are held to the exact values
within 4 of their stated standard errors, as the JAX file holds its own."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.models.estimation as JE  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim  # noqa: E402
from qubism_torch.models.estimation import (EnergyEstimator, estimate_energy_fn,  # noqa: E402
                                            estimate_pauli_sum, qwc_groups, spsa_minimize)
from qubism_torch.ops.fusion import CompiledCircuit  # noqa: E402

_H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)
_CX = np.eye(4, dtype=complex)[[0, 1, 3, 2]]


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _qwc(p, q):
    return all(a == "I" or b == "I" or a == b for a, b in zip(p, q))


def _bell_prims():
    return [Prim(_H, (0,)), Prim(_CX, (0, 1))]


@pytest.mark.parametrize("paulis", [["ZZI", "IZZ", "XXI", "IXX", "ZIZ", "YYI", "IIZ"],
                                    ["ZI", "IZ", "ZZ", "XX", "YY"],
                                    ["ZIII", "IZII", "IIZI", "ZZZZ"]])
def test_qwc_groups_partition_validity_and_jax(paulis):
    groups, bases = qwc_groups(paulis)
    assert sorted(j for g in groups for j in g) == list(range(len(paulis)))
    for g, basis in zip(groups, bases):
        for j in g:
            assert all(c == "I" or basis[q] == c for q, c in enumerate(paulis[j]))
            assert all(_qwc(paulis[j], paulis[k]) for k in g)
    assert (groups, bases) == JE.qwc_groups(paulis)


def test_qwc_groups_h2_shape():
    groups, bases = qwc_groups(["ZI", "IZ", "ZZ", "XX", "YY"])
    assert len(groups) == 3 and groups[0] == [0, 1, 2] and bases == ["ZZ", "XX", "YY"]


def test_estimate_bell_matches_exact():
    mean, err = estimate_pauli_sum(_bell_prims(), 2, [(0.5, "ZZ"), (0.25, "XX"), (1.0, "ZI")],
                                   shots=4096, seed=3)
    assert 0.0 < err < 0.05
    assert abs(mean - 0.75) < 4 * err + 1e-9


def test_estimate_identity_and_constant_exact():
    mean, err = estimate_pauli_sum(_bell_prims(), 2, [(2.0, "II"), (1.0, "ZZ")], shots=256,
                                   seed=0, constant=-0.5)
    assert mean == pytest.approx(2.5, abs=1e-9)
    assert err == pytest.approx(0.0, abs=1e-12)


def test_grouping_none_matches_qwc_in_expectation():
    terms = [(0.7, "ZZ"), (-0.3, "ZI"), (0.2, "XX")]
    for grouping in ("qwc", "none"):
        for allocation in ("weighted", "uniform"):
            mean, err = estimate_pauli_sum(_bell_prims(), 2, terms, shots=8192, seed=11,
                                           grouping=grouping, allocation=allocation)
            assert abs(mean - 0.9) < 4 * err + 1e-9, (grouping, allocation)


def test_estimator_reuse_does_not_mutate_state():
    est = EnergyEstimator(2, [(1.0, "XX"), (1.0, "ZZ")], shots=512)
    assert est.num_groups == 2
    c = CompiledCircuit(2, _bell_prims())
    state = c(c.init_state())
    before = state.clone()
    m1, _ = est.estimate(state, torch.Generator().manual_seed(0))
    m2, _ = est.estimate(state, torch.Generator().manual_seed(0))
    assert torch.equal(state, before)
    assert m1 == pytest.approx(m2) and m1 == pytest.approx(2.0, abs=1e-9)


def test_estimate_stderr_is_calibrated():
    vals, errs = [], []
    for seed in range(8):
        m, e = estimate_pauli_sum([Prim(_H, (0,))], 2, [(1.0, "ZI")], shots=1024, seed=seed)
        vals.append(m)
        errs.append(e)
    want = 1.0 / math.sqrt(1024)
    assert abs(np.mean(errs) - want) < 0.2 * want
    assert np.std(vals) < 4 * want


def test_estimate_energy_fn_h2():
    from qubism_torch.models.hamiltonians import h2_minimal
    from qubism_torch.models.variational import energy_fn, hea_ansatz, vqe_minimize

    terms, const = h2_minimal()
    ans = hea_ansatz(2, 2)
    theta0 = np.linspace(0.1, 1.0, ans.num_params).astype(np.float32)
    theta, _ = vqe_minimize(ans, terms, theta0, steps=200, constant=const)
    e_exact = float(energy_fn(ans, terms, constant=const)(theta))
    m, err = estimate_energy_fn(ans, terms, shots=8192, constant=const)(theta, seed=7)
    assert err > 0.0
    assert abs(m - e_exact) < 4 * err + 1e-9
    assert abs(m - (-1.8512)) < 0.05


def test_spsa_noiseless_quadratic_equals_jax():
    opt = np.array([0.3, -1.2, 2.0])

    def f(theta, seed=0):
        return float(np.sum((np.asarray(theta) - opt) ** 2))

    theta, hist = spsa_minimize(f, np.zeros(3), steps=300, a=0.4, c=0.05, seed=1)
    assert np.allclose(theta, opt, atol=0.05) and hist[-1] < hist[0]
    jtheta, jhist = JE.spsa_minimize(f, np.zeros(3), steps=300, a=0.4, c=0.05, seed=1)
    assert np.array_equal(theta, jtheta) and hist == jhist


def test_spsa_on_shot_noise_vqe():
    from qubism_torch.models.hamiltonians import h2_minimal
    from qubism_torch.models.variational import energy_fn, hea_ansatz

    terms, const = h2_minimal()
    ans = hea_ansatz(2, 1)
    f = estimate_energy_fn(ans, terms, shots=2048, constant=const)
    theta0 = np.full(ans.num_params, 0.3)
    theta, _ = spsa_minimize(f, theta0, steps=100, a=1.0, c=0.15, seed=4)
    efn = energy_fn(ans, terms, constant=const)
    e_end = float(efn(np.asarray(theta, np.float32)))
    assert e_end < float(efn(theta0.astype(np.float32))) - 0.1
    assert e_end < -1.8


def test_estimator_rejects_bad_args():
    with pytest.raises(ValueError):
        EnergyEstimator(2, [(1.0, "ZZ")], grouping="graph")
    with pytest.raises(ValueError):
        EnergyEstimator(2, [(1.0, "ZZ")], allocation="optimal")
    with pytest.raises(ValueError):
        EnergyEstimator(2, [(1.0, "ZA")])
