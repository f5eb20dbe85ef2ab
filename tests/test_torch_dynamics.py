"""Trotterized dynamics of the port (models/dynamics.py) against the JAX
package: the same Hamiltonians, times and start states (made with numpy
from a seed) through both packages' rotation prims, Trotter circuits,
``evolve``, ``evolve_observed``, imaginary-time evolution, correlation
functions and ``lindblad_evolve`` (on the port's ``DensityMatrix`` against
the JAX one), plus the dense oracles of tests/test_dynamics.py. Prims to
1e-12 (both are float64 host matrices), states to 1e-5 (complex64
engines), recorded values to 1e-5, Trotter-error rates as the JAX tests
state them."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_torch.models.dynamics as TD  # noqa: E402
import qubism_tpu.models.dynamics as JD  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.density import DensityMatrix as TDensity  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.core.statevec import StateVec as TSV  # noqa: E402
from qubism_torch.models.hamiltonians import heisenberg_xxz, tfim  # noqa: E402
from qubism_tpu.core.density import DensityMatrix as JDensity  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.core.statevec import StateVec as JSV  # noqa: E402

_PAULI = {"I": np.eye(2, dtype=complex), "X": np.array([[0, 1], [1, 0]], dtype=complex),
          "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
          "Z": np.array([[1, 0], [0, -1]], dtype=complex)}
_SM = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def dense_pauli(pauli):
    m = np.array([[1.0 + 0j]])
    for c in pauli:
        m = np.kron(m, _PAULI[c])
    return m


def dense_h(terms, n):
    return sum(c * dense_pauli(p) for c, p in terms) + np.zeros((1 << n, 1 << n))


def expm_herm(h, t):
    """exp(-i h t) for Hermitian h (complex t gives exp(-tau h))."""
    w, v = np.linalg.eigh(h)
    return (v * np.exp(-1j * w * t)) @ v.conj().T


def prim_dense(prim, n):
    """A prim embedded in the full 2^n x 2^n matrix (targets[0] = MSB)."""
    u = prim.dense()
    k = len(prim.targets)
    cur = list(prim.targets) + [q for q in range(n) if q not in prim.targets]
    perm = [cur.index(q) for q in range(n)]
    full = np.kron(u, np.eye(1 << (n - k)))
    return full.reshape((2,) * (2 * n)).transpose(perm + [n + p for p in perm]).reshape(
        1 << n, 1 << n)


def random_state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def same_prims(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.targets, a.diag) == (b.targets, b.diag)
        assert np.abs(np.asarray(a.u) - np.asarray(b.u)).max() < 1e-12


# -- rotation and imaginary-time prims ---------------------------------------------


@pytest.mark.parametrize("pauli", ["XX", "ZZ", "YY", "XY", "ZIZ", "IZI", "XIZ", "Y", "ZZZ"])
def test_rotation_prim_matches_jax_and_expm(pauli):
    theta = 0.731
    got = TD.pauli_rotation_prim(theta, pauli)
    same_prims([got], [JD.pauli_rotation_prim(theta, pauli)])
    want = expm_herm(dense_pauli(pauli), theta / 2.0)
    assert np.allclose(prim_dense(got, len(pauli)), want, atol=1e-12)
    assert got.diag == (set(pauli) <= {"I", "Z"})


@pytest.mark.parametrize("pauli", ["XX", "ZZ", "XY", "ZIZ", "Y"])
def test_exp_prim_matches_jax_and_expm(pauli):
    a = 0.37
    got = TD.pauli_exp_prim(a, pauli)
    same_prims([got], [JD.pauli_exp_prim(a, pauli)])
    w, v = np.linalg.eigh(dense_pauli(pauli))
    assert np.allclose(prim_dense(got, len(pauli)), (v * np.exp(-a * w)) @ v.conj().T,
                       atol=1e-12)


def test_prim_edge_cases():
    assert TD.pauli_rotation_prim(0.9, "III") is None and TD.pauli_exp_prim(0.2, "II") is None
    with pytest.raises(ValueError, match="weight"):
        TD.pauli_rotation_prim(0.1, "X" * 7)
    with pytest.raises(ValueError, match="weight"):
        TD.pauli_exp_prim(0.1, "Z" * 7)
    with pytest.raises(ValueError, match="order"):
        TD.trotter_step_prims([(1.0, "XX")], 0.1, order=3)
    with pytest.raises(ValueError, match="order"):
        TD.ite_step_prims([(1.0, "X")], 0.1, order=3)
    with pytest.raises(ValueError, match="steps"):
        TD.trotter_prims([(1.0, "XX")], 0.1, steps=0)


@pytest.mark.parametrize("order", [1, 2])
def test_step_prims_match_jax(order):
    terms, _ = heisenberg_xxz(4, jxy=0.8, jz=0.5, field=0.3, periodic=True)
    same_prims(TD.trotter_step_prims(terms, 0.13, order),
               JD.trotter_step_prims(terms, 0.13, order))
    same_prims(TD.trotter_prims(terms, 0.5, 3, order), JD.trotter_prims(terms, 0.5, 3, order))
    same_prims(TD.ite_step_prims(terms, 0.07, order), JD.ite_step_prims(terms, 0.07, order))


# -- real-time evolution -------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 2])
def test_evolve_matches_jax_and_dense_product(order):
    n = 4
    terms, _ = tfim(n, j=0.9, h=0.6)
    t, steps = 0.37, 3
    psi0 = random_state(n, 5)
    want = psi0.copy()
    for p in TD.trotter_prims(terms, t, steps, order):
        want = prim_dense(p, n) @ want
    sv = TSV.from_amplitudes(psi0)
    got = TD.evolve(sv, terms, t, steps, order).amps
    jax_got = JD.evolve(JSV.from_amplitudes(psi0), terms, t, steps, order).amps
    assert np.linalg.norm(got - want) < 1e-5 and np.linalg.norm(got - jax_got) < 1e-5
    assert np.linalg.norm(sv.amps - psi0) < 1e-6  # the input state is left as it was


def test_evolve_wide_chain_matches_jax():
    """n = 10: the ZZ ladder as diagonal passes, the X terms a 1q layer
    above the lane block, the XX and YY rotations dense blocks."""
    n = 10
    terms, _ = heisenberg_xxz(n, jxy=0.6, jz=0.9, field=0.2)
    terms += tfim(n, j=0.0, h=0.4)[0][n - 1:]
    psi0 = random_state(n, 8)
    got = TD.evolve(TSV.from_amplitudes(psi0), terms, 0.4, 2).amps
    want = JD.evolve(JSV.from_amplitudes(psi0), terms, 0.4, 2).amps
    assert np.linalg.norm(got - want) < 1e-5


def trotter_error(terms, n, t, steps, order, psi0):
    exact = expm_herm(dense_h(terms, n), t) @ psi0
    return np.linalg.norm(TD.evolve(TSV.from_amplitudes(psi0), terms, t, steps, order).amps
                          - exact)


def test_trotter_error_rates():
    """First order halves the error when the steps double; Strang quarters
    it and beats first order (the rates of tests/test_dynamics.py)."""
    n = 3
    terms, _ = heisenberg_xxz(n, jxy=0.8, jz=0.5, field=0.3)
    psi0 = random_state(n, 11)
    e1, e2 = (trotter_error(terms, n, 0.9, s, 1, psi0) for s in (8, 16))
    s1, s2 = (trotter_error(terms, n, 0.9, s, 2, psi0) for s in (8, 16))
    assert e1 > 1e-4 and e1 / e2 == pytest.approx(2.0, rel=0.35)
    assert s1 / s2 == pytest.approx(4.0, rel=0.35) and s1 < e1


def test_tfim_quench_matches_exact_propagator():
    n = 5
    terms, _ = tfim(n)
    psi0 = np.zeros(1 << n, dtype=complex)
    psi0[0] = 1.0
    assert trotter_error(terms, n, 1.0, 64, 2, psi0) < 2e-3


def test_evolve_observed_matches_jax():
    n = 4
    terms, _ = tfim(n)
    obs = ["Z" + "I" * (n - 1), terms, [(0.5, "XXII"), (-0.3, "IYZI")]]
    times, values, final = TD.evolve_observed(TSV.zero(n), terms, obs, t=0.8, steps=16,
                                              record_every=4)
    jt, jv, jfinal = JD.evolve_observed(JSV.zero(n), terms, obs, t=0.8, steps=16,
                                        record_every=4)
    assert times.shape == (5,) and values.shape == (5, 3)
    assert np.abs(times - jt).max() < 1e-12
    assert np.abs(values - jv).max() < 1e-5
    assert values[0, 0] == pytest.approx(1.0, abs=1e-6)
    assert np.all(np.abs(values[:, 1] - values[0, 1]) < 2e-2)  # energy kept to O(dt^2)
    assert values[-1, 0] < 0.95
    direct = TD.evolve(TSV.zero(n), terms, 0.8, 16)
    assert np.linalg.norm(final.amps - direct.amps) < 1e-5
    assert np.linalg.norm(final.amps - jfinal.amps) < 1e-5
    with pytest.raises(ValueError, match="record_every"):
        TD.evolve_observed(TSV.zero(2), tfim(2)[0], ["ZI"], t=0.1, steps=5, record_every=2)


# -- imaginary time ---------------------------------------------------------------------


def test_ite_matches_jax_and_dense_projection():
    n = 3
    terms, _ = tfim(n, j=1.1, h=0.7)
    psi0 = random_state(n, 2)
    want = expm_herm(dense_h(terms, n), -1j * 0.6) @ psi0
    want /= np.linalg.norm(want)
    sv = TSV.from_amplitudes(psi0)
    got, energies = TD.imaginary_time_evolve(sv, terms, 0.6, 48)
    jgot, _ = JD.imaginary_time_evolve(JSV.from_amplitudes(psi0), terms, 0.6, 48)
    assert energies == []
    assert np.linalg.norm(got.amps - want) < 2e-3
    assert np.linalg.norm(got.amps - jgot.amps) < 1e-5
    assert np.linalg.norm(sv.amps - psi0) < 1e-6


def test_ite_energies_match_jax_and_reach_ground_state():
    n = 5
    terms, _ = tfim(n)
    e0 = np.linalg.eigvalsh(dense_h(terms, n))[0]
    sv, energies = TD.imaginary_time_evolve(TSV.zero(n), terms, tau=6.0, steps=120,
                                            record_energy=True)
    _, jenergies = JD.imaginary_time_evolve(JSV.zero(n), terms, tau=6.0, steps=120,
                                            record_energy=True)
    assert len(energies) == len(jenergies) == 120
    assert np.abs(np.array(energies) - np.array(jenergies)).max() < 1e-5
    assert energies[-1] == pytest.approx(e0, abs=2e-2)
    assert np.all(np.diff(energies) < 1e-3)
    assert sv.expectation_sum(terms) == pytest.approx(e0, abs=2e-2)


# -- correlation functions -------------------------------------------------------------


def test_correlation_single_qubit_phase():
    """H = -(w/2) Z: C(t) = <X(t) X> on |0> is e^{-i w t} exactly."""
    w, t, steps = 2.0, 3.0, 48
    times, corr = TD.correlation_observed(TSV.zero(1), [(-w / 2.0, "Z")], "X", "X", t, steps)
    assert len(times) == steps + 1
    assert np.allclose(corr, np.exp(-1j * w * times), atol=1e-5)


@pytest.mark.parametrize("case", ["xxz", "tfim_y"])
def test_correlation_matches_jax_and_dense(case):
    if case == "xxz":
        n, (a, b) = 3, ("IZI", "XII")
        terms, _ = heisenberg_xxz(n, jxy=1.0, jz=0.7)
    else:  # Y strings on both sides: the i^{#Y} factor
        n, (a, b) = 4, ("YIZI", "IIXY")
        terms, _ = tfim(n, j=0.8, h=0.5)
    psi0 = random_state(n, 5)
    times, corr = TD.correlation_observed(TSV.from_amplitudes(psi0), terms, a, b, 1.0, 400,
                                          record_every=100)
    jt, jcorr = JD.correlation_observed(JSV.from_amplitudes(psi0), terms, a, b, 1.0, 400,
                                        record_every=100)
    assert corr.dtype == np.complex128 and np.abs(times - jt).max() < 1e-12
    assert np.abs(corr - jcorr).max() < 1e-5
    h = dense_h(terms, n)
    for tk, ck in zip(times, corr):
        u = expm_herm(h, tk)
        want = psi0.conj() @ (u.conj().T @ dense_pauli(a) @ u @ dense_pauli(b) @ psi0)
        assert abs(ck - want) < 2e-3, (tk, ck, want)
    with pytest.raises(ValueError):
        TD.correlation_observed(TSV.zero(1), [(1.0, "Z")], "X", "X", 1.0, 10, record_every=3)


def test_spectral_function_matches_jax_and_peaks_at_the_gap():
    w = 3.0
    times, corr = TD.correlation_observed(TSV.zero(1), [(-w / 2.0, "Z")], "X", "X",
                                          2.0 * np.pi * 8 / w, 256)
    omegas, s = TD.spectral_function(times, corr)
    jo, js = JD.spectral_function(times, corr)
    assert np.array_equal(omegas, jo) and np.abs(s - js).max() < 1e-12
    assert abs(float(omegas[int(np.argmax(np.abs(s)))]) - w) < w / 8 + 1e-9


# -- open systems -------------------------------------------------------------------------


def test_dissipator_kraus_matches_jax():
    rng = np.random.default_rng(3)
    for d in (2, 4):
        L = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
        got, want = TD.dissipator_kraus(L, 0.5, 0.2), JD.dissipator_kraus(L, 0.5, 0.2)
        assert len(got) == len(want)
        assert max(np.abs(a - b).max() for a, b in zip(got, want)) < 1e-12
        assert np.allclose(sum(k.conj().T @ k for k in got), np.eye(d), atol=1e-9)
    a = rng.normal(size=(6, 6)) + 1j * rng.normal(size=(6, 6))
    assert np.abs(TD._expm(a) - JD._expm(a)).max() < 1e-12


@pytest.mark.parametrize("case", ["decay", "rabi", "two_qubit"])
def test_lindblad_evolve_matches_jax(case):
    """The port's DensityMatrix against the JAX one: the same start state,
    Hamiltonian and jump operators, observables recorded every step."""
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    h1 = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)
    if case == "decay":
        n, prep, h_terms, collapse = 1, [(x, (0,))], [], [(0.9, _SM, 0)]
        obs = ["Z", "X"]
    elif case == "rabi":
        n, prep, h_terms = 1, [(h1, (0,))], [(0.7, "X"), (0.3, "Z")]
        collapse, obs = [(0.4, _SM, 0), (0.2, np.diag([1.0, -1.0]).astype(complex), (0,))], ["Z", "Y"]
    else:
        n, prep = 3, [(h1, (0,)), (np.eye(4)[[0, 1, 3, 2]], (0, 2))]
        h_terms = heisenberg_xxz(n, jxy=0.5, jz=0.8, field=0.2)[0]
        collapse = [(0.3, _SM, 1), (0.15, np.kron(_SM, _SM), (0, 2))]
        obs = ["ZIZ", "XXI", "IYZ"]
    t_rho, j_rho = TDensity(n), JDensity(n)
    for u, tg in prep:
        t_rho.apply(TPrim(u, tg))
        j_rho.apply(JPrim(u, tg))
    got, vals = TD.lindblad_evolve(t_rho, h_terms, collapse, 1.3, 6, observables=obs)
    _, jvals = JD.lindblad_evolve(j_rho, h_terms, collapse, 1.3, 6, observables=obs)
    assert got is t_rho and vals.shape == (7, len(obs))
    assert np.abs(vals - jvals).max() < 1e-5
    assert got.trace() == pytest.approx(1.0, abs=1e-5)
    assert np.abs(got.matrix() - np.asarray(j_rho.matrix())).max() < 1e-5
    if case == "decay":  # a single dissipator is exact at any step count
        assert got.prob_one(0) == pytest.approx(math.exp(-0.9 * 1.3), abs=1e-5)
    assert TD.lindblad_evolve(TDensity(n), h_terms, collapse, 0.2, 2) is not None


def test_trajectory_programs_are_not_ported():
    """Ported since: the two trajectory functions run (their parity with the
    JAX package is in tests/test_torch_trajectories.py); the step program
    has the JAX package's shape and a one-qubit decay keeps |0> at rest."""
    step = TD.lindblad_step_program([(1.0, "Z")], [(0.5, _SM, 0)], 0.1)
    want = JD.lindblad_step_program([(1.0, "Z")], [(0.5, _SM, 0)], 0.1)
    assert [type(x).__name__ for x in step] == [type(x).__name__ for x in want]
    states, est = TD.lindblad_mcwf(1, [], [(1.0, "Z")], [(0.5, _SM, 0)], 1.0, 4, 8,
                                   observables=["Z"])
    assert states.shape == (8, 2) and est == [(pytest.approx(1.0), pytest.approx(0.0))]
