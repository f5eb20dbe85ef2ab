"""State and process tomography of the port (models/tomography.py): the
cases of tests/test_tomography.py on the CPU. Exact expectations, Choi
matrices and the direct fidelity estimate (its Paulis drawn by numpy from
the same seed) against the JAX package's to 1e-5; the port's own sampled
tomography by its fidelity (> 0.97, the JAX file's bound)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.core.density as JD  # noqa: E402
import qubism_tpu.models.circuits as JC  # noqa: E402
import qubism_tpu.models.tomography as JT  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.density import (DensityMatrix, amplitude_damping,  # noqa: E402
                                       depolarizing, depolarizing2)
from qubism_torch.core.gates import Prim  # noqa: E402
from qubism_torch.models.circuits import ghz_prims, w_state_prims  # noqa: E402
from qubism_torch.models.tomography import (_BASIS_ROT, characteristic_fn,  # noqa: E402
                                            choi_from_kraus, direct_fidelity_estimate,
                                            exact_state_tomography, fidelity, pauli_matrix,
                                            pauli_strings, process_fidelity, process_tomography,
                                            project_to_physical, reconstruct_state,
                                            sampled_state_tomography)
from qubism_torch.ops.fusion import CompiledCircuit  # noqa: E402

_Z = np.diag([1.0, -1.0])
_H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def test_basis_rotations_map_to_z():
    for axis, u in _BASIS_ROT.items():
        assert np.allclose(u @ pauli_matrix(axis) @ u.conj().T, _Z, atol=1e-12), axis


def test_exact_tomography_reconstructs_ghz_as_the_jax_package():
    n = 3
    rho = DensityMatrix(n).apply(ghz_prims(n))
    exps = exact_state_tomography(rho)
    assert len(exps) == 4 ** n
    assert np.allclose(reconstruct_state(exps, n), rho.matrix(), atol=1e-5)
    want = JT.exact_state_tomography(JD.DensityMatrix(n).apply(JC.ghz_prims(n)))
    assert max(abs(exps[p] - want[p]) for p in want) < 1e-5


def test_exact_tomography_mixed_state():
    rho = DensityMatrix(1).apply([Prim(_H, (0,))]).apply_channel(depolarizing(0.3), (0,))
    rec = reconstruct_state(exact_state_tomography(rho), 1)
    assert np.allclose(rec, rho.matrix(), atol=1e-6)
    assert abs(np.trace(rec).real - 1.0) < 1e-6


def test_project_to_physical():
    phys = project_to_physical(np.diag([0.7, 0.5, -0.2, 0.0]).astype(complex))
    assert (np.linalg.eigvalsh(phys) > -1e-12).all()
    assert abs(np.trace(phys).real - 1.0) < 1e-12
    good = np.diag([0.25, 0.25, 0.25, 0.25]).astype(complex)
    assert np.allclose(project_to_physical(good), good, atol=1e-12)


def test_fidelity_properties():
    n = 2
    rho = DensityMatrix(n).apply(ghz_prims(n)).matrix()
    assert abs(fidelity(rho, rho) - 1.0) < 1e-6
    f = fidelity(rho, DensityMatrix(n).apply(w_state_prims(n)).matrix())
    assert 0.0 <= f < 0.1


def test_sampled_tomography_ghz():
    n = 2
    exps = sampled_state_tomography(ghz_prims(n), n, shots=4096, seed=3)
    rec = project_to_physical(reconstruct_state(exps, n))
    assert fidelity(rec, DensityMatrix(n).apply(ghz_prims(n)).matrix()) > 0.97
    assert exps == sampled_state_tomography(ghz_prims(n), n, shots=4096, seed=3)


def test_process_tomography_identity_and_unitary():
    choi_id = process_tomography(lambda r: r, 1)
    assert np.allclose(choi_id, choi_from_kraus([np.eye(2)]), atol=1e-6)
    choi_h = process_tomography(lambda r: r.apply([Prim(_H, (0,))]), 1)
    assert np.allclose(choi_h, choi_from_kraus([_H]), atol=1e-6)
    assert abs(process_fidelity(choi_h, _H) - 1.0) < 1e-6
    assert abs(process_fidelity(choi_h, np.eye(2))) < 1e-6
    assert abs(process_fidelity(choi_h, _Z.astype(complex)) - 0.5) < 1e-6


def test_process_tomography_depolarizing():
    p = 0.2
    choi = process_tomography(lambda r: r.apply_channel(depolarizing(p), (0,)), 1)
    assert np.allclose(choi, choi_from_kraus(depolarizing(p)), atol=1e-6)
    assert abs(process_fidelity(choi, np.eye(2)) - (1 - p)) < 1e-6


def test_process_tomography_amplitude_damping():
    choi = process_tomography(lambda r: r.apply_channel(amplitude_damping(0.35), (0,)), 1)
    assert np.allclose(choi, choi_from_kraus(amplitude_damping(0.35)), atol=1e-6)


def test_process_tomography_2q_as_the_jax_package():
    p = 0.1
    choi = process_tomography(lambda r: r.apply_channel(depolarizing2(p), (0, 1)), 2)
    assert np.allclose(choi, choi_from_kraus(depolarizing2(p)), atol=1e-5)
    assert abs(process_fidelity(choi, np.eye(4)) - (1 - p)) < 1e-5
    want = JT.process_tomography(lambda r: r.apply_channel(JD.depolarizing2(p), (0, 1)), 2)
    assert np.abs(choi - want).max() < 1e-5


def test_pauli_strings_count():
    assert len(pauli_strings(3)) == 64
    with pytest.raises(ValueError):
        exact_state_tomography(DensityMatrix(6))


def test_characteristic_fn_pure_state_norm():
    n = 3
    chi = characteristic_fn(ghz_prims(n), n)
    assert abs(sum(v * v for v in chi.values()) - 2 ** n) < 1e-4
    assert abs(chi["I" * n] - 1.0) < 1e-6
    assert abs(chi["XXX"] - 1.0) < 1e-5 and abs(chi["ZZI"] - 1.0) < 1e-5


def test_direct_fidelity_estimate_matches_overlap_and_jax():
    """DFE of a depolarized GHZ state against the exact overlap; the
    numpy-drawn Paulis make it the JAX package's estimate."""
    n = 3
    prims = ghz_prims(n)
    rho = DensityMatrix(n).apply(prims)
    jrho = JD.DensityMatrix(n).apply(JC.ghz_prims(n))
    for q in range(n):
        rho = rho.apply_channel(depolarizing(0.05), (q,))
        jrho = jrho.apply_channel(JD.depolarizing(0.05), (q,))
    c = CompiledCircuit(n, prims)
    psi = c.state_to_complex(c(c.init_state()))
    exact = float(np.real(psi.conj() @ rho.matrix() @ psi))
    est, se = direct_fidelity_estimate(prims, n, rho.expectation, n_paulis=96, seed=1)
    assert abs(est - exact) < max(5 * se, 0.02), (est, exact, se)
    jest, jse = JT.direct_fidelity_estimate(JC.ghz_prims(n), n, jrho.expectation,
                                            n_paulis=96, seed=1)
    assert abs(est - jest) < 1e-5 and abs(se - jse) < 1e-5


def test_direct_fidelity_noiseless_is_one():
    n = 2
    rho = DensityMatrix(n).apply(ghz_prims(n))
    est, se = direct_fidelity_estimate(ghz_prims(n), n, rho.expectation, n_paulis=16, seed=0)
    assert abs(est - 1.0) < 1e-5 and se < 1e-5
