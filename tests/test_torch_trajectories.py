"""The port's quantum trajectories (qubism_torch/models/trajectories.py) and
the MCWF unraveling of the Lindblad equation (models/dynamics.py) against
the JAX package's: the same programs with the JAX package's own uniforms
injected (``jax.random.uniform(fold_in(split(key, T)[t], item))``) give the
same final states to 1e-5, and the estimators agree on the same states."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from qubism_torch.config import config  # noqa: E402
from qubism_torch.core import density as TD  # noqa: E402
from qubism_torch.core.density import DensityMatrix  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.models import dynamics as TDy  # noqa: E402
from qubism_torch.models import trajectories as TT  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.models import dynamics as JDy  # noqa: E402
from qubism_tpu.models import trajectories as JT  # noqa: E402

_H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_CX = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
_SM = np.array([[0, 1], [0, 0]], dtype=complex)
_U3 = np.array([[np.cos(0.4), -np.exp(0.3j) * np.sin(0.4)],
                [np.exp(0.2j) * np.sin(0.4), np.exp(0.5j) * np.cos(0.4)]])


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _kraus_generic():
    """A 3-branch channel that is neither mixed-unitary nor monomial."""
    a = np.array([[np.sqrt(0.9), 0], [0, np.sqrt(0.6)]], dtype=complex)
    b = np.array([[0, np.sqrt(0.3)], [0, 0]], dtype=complex)
    c = np.array([[0, 0], [0, np.sqrt(0.1)]], dtype=complex) @ _H
    # complete to CPTP: K3 = sqrt(I - sum K^dag K)
    rest = np.eye(2) - sum(k.conj().T @ k for k in (a, b, c))
    w, v = np.linalg.eigh(rest)
    d = v @ np.diag(np.sqrt(np.clip(w, 0, None))) @ v.conj().T
    return [a, b, c, d]


PROGRAMS = {
    "bell dep": lambda P, C: [P(_H, (0,)), P(_CX, (0, 1)), C(TD.depolarizing(0.3), (1,))],
    "ad and pd": lambda P, C: [P(_H, (0,)), P(_CX, (0, 1)), C(TD.amplitude_damping(0.4), (0,)),
                               C(TD.phase_damping(0.3), (1,)), P(_U3, (2,))],
    "dep2 descending": lambda P, C: [P(_U3, (0,)), P(_CX, (2, 0)),
                                     C(TD.depolarizing2(0.2), (2, 0)), P(_H, (1,))],
    "generic kraus": lambda P, C: [P(_U3, (1,)), C(_kraus_generic(), (1,)), P(_CX, (1, 2)),
                                   C(TD.bit_flip(0.25), (2,)), C(TD.phase_flip(0.2), (0,))],
}


def jax_uniforms(key, ntraj, items):
    """The JAX package's channel uniforms: item i of trajectory t draws
    uniform(fold_in(split(key, T)[t], i)); columns in channel order."""
    pos = [i for i, it in enumerate(items) if isinstance(it, tuple)]
    keys = jax.random.split(key, ntraj)
    return np.array([[float(jax.random.uniform(jax.random.fold_in(k, i))) for i in pos]
                     for k in keys])


def both(name, ntraj=12, seed=3):
    """(port states (T, 2^n) complex128, JAX states, the uniforms)."""
    jprog = PROGRAMS[name](JPrim, JT.ChannelOp)
    tprog = PROGRAMS[name](TPrim, TT.ChannelOp)
    key = jax.random.PRNGKey(seed)
    u = jax_uniforms(key, ntraj, JT._elaborate(jprog))
    jre, jim = JT.run_trajectories(3, jprog, ntraj, key=key)
    tz = TT.run_trajectories(3, tprog, ntraj, uniforms=u)
    return tz.numpy().astype(np.complex128), np.asarray(jre) + 1j * np.asarray(jim), u


def test_channelop_rejects_non_cptp():
    for mod in (TT, JT):
        with pytest.raises(ValueError, match="CPTP"):
            mod.ChannelOp([np.eye(2) * 0.5], (0,))
        with pytest.raises(ValueError, match="does not match 2 targets"):
            mod.ChannelOp([np.eye(2)], (0, 1))
    assert TT.ChannelOp([_X], (1,)).shifted(2).targets == (3,)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_injected_uniforms_give_the_jax_states(name):
    tz, jz, _ = both(name)
    assert np.abs(tz - jz).max() < 1e-5
    norms = np.linalg.norm(tz, axis=1)
    assert np.allclose(norms, 1.0, atol=1e-5)


@pytest.mark.parametrize("chan", [TD.depolarizing(0.1), TD.depolarizing2(0.2),
                                  TD.bit_flip(0.3), TD.amplitude_damping(0.2)])
def test_unitary_mix_probe_matches(chan):
    t, j = TT._unitary_mix(chan), JT._unitary_mix(chan)
    assert (t is None) == (j is None)
    if t is not None:
        assert np.array_equal(t[0], j[0])
        assert np.array_equal(t[1], (j[1] + 1j * j[2]).astype(np.complex64))


@pytest.mark.parametrize("name", ["ad and pd", "generic kraus"])
def test_estimators_match_on_the_same_states(name):
    tz, jz, _ = both(name, ntraj=16)
    planes = (jz.real.astype(np.float32), jz.imag.astype(np.float32))
    states = torch.from_numpy(tz.astype(np.complex64))
    for pauli in ("ZZI", "XIY", "IXX"):
        tm, ts = TT.trajectory_expectation(states, pauli, 3)
        jm, js = JT.trajectory_expectation(planes, pauli, 3)
        assert abs(tm - jm) < 1e-5 and abs(ts - js) < 1e-5
    terms = [(0.5, "ZZI"), (-1.25, "YIX"), (2.0, "IIZ")]
    tm, ts = TT.trajectory_pauli_sum(states, terms, 3, constant=0.3)
    jm, js = JT.trajectory_pauli_sum(planes, terms, 3, constant=0.3)
    assert abs(tm - jm) < 1e-5 and abs(ts - js) < 1e-5
    assert np.abs(TT.trajectory_probs(states) - JT.trajectory_probs(planes)).max() < 1e-6


def test_one_trajectory_stderr_is_inf():
    states = TT.run_trajectories(1, [TPrim(_H, (0,))], 1)
    assert TT.trajectory_expectation(states, "X", 1) == (pytest.approx(1.0), float("inf"))


def test_sample_with_injected_uniforms_matches_jax():
    tz, jz, _ = both("bell dep", ntraj=24)
    key = jax.random.PRNGKey(11)
    u = np.array([float(jax.random.uniform(k)) for k in jax.random.split(key, 24)])
    planes = (jz.real.astype(np.float32), jz.imag.astype(np.float32))
    want = JT.trajectory_sample(planes, key=key)
    got = TT.trajectory_sample(torch.from_numpy(tz.astype(np.complex64)), uniforms=u)
    assert got.dtype == np.uint8 and got.shape == (24, 3)
    assert np.array_equal(got, want)


def test_seeded_runs_repeat_and_seeds_differ():
    prog = PROGRAMS["bell dep"](TPrim, TT.ChannelOp)
    a = TT.run_trajectories(3, prog, 32, seed=4)
    assert torch.equal(a, TT.run_trajectories(3, prog, 32, seed=4))
    assert not torch.equal(a, TT.run_trajectories(3, prog, 32, seed=5))
    # the first rows do not depend on how many trajectories follow
    assert torch.equal(a[:8], TT.run_trajectories(3, prog, 8, seed=4))


def test_trajectory_mean_matches_density_matrix():
    prog = PROGRAMS["ad and pd"](TPrim, TT.ChannelOp)
    rho = DensityMatrix(3)
    for it in prog:
        if isinstance(it, TT.ChannelOp):
            rho.apply_channel(it.kraus, it.targets)
        else:
            rho.apply([it])
    states = TT.run_trajectories(3, prog, 2000, seed=1)
    for pauli in ("ZII", "XXI", "IZI"):
        mean, se = TT.trajectory_expectation(states, pauli, 3)
        assert abs(mean - rho.expectation(pauli)) < 4 * se + 0.01, pauli
    assert np.abs(TT.trajectory_probs(states) - rho.probs()).max() < 0.04


def test_gate_objects_and_bad_items():
    from qubism_torch.core.gates import cnot, hadamard, on_just

    states = TT.run_trajectories(2, [on_just(0, hadamard(), 2), cnot(0, 1, 2),
                                     TT.ChannelOp(TD.bit_flip(0.0), (1,))], 2)
    assert np.allclose(states.numpy()[:, [0, 3]], 2 ** -0.5, atol=1e-6)
    with pytest.raises(TypeError, match="trajectory program item"):
        TT.run_trajectories(1, ["h"], 1)


# -- the Lindblad equation by trajectories --------------------------------------------


def test_lindblad_step_program_matches_jax():
    h_terms = [(0.7, "XI"), (0.4, "ZZ")]
    collapse = [(0.5, _SM, 0), (0.2, np.diag([1.0, -1.0]), (1,))]
    tp = TDy.lindblad_step_program(h_terms, collapse, 0.1)
    jp = JDy.lindblad_step_program(h_terms, collapse, 0.1)
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert type(a).__name__ == type(b).__name__
        assert a.targets == b.targets
        got = a.kraus if isinstance(a, TT.ChannelOp) else [a.u]
        want = b.kraus if isinstance(b, JT.ChannelOp) else [b.u]
        assert all(np.allclose(x, y, atol=1e-12) for x, y in zip(got, want))


def test_lindblad_mcwf_with_jax_uniforms_matches_jax():
    omega, rate, t, steps, ntraj = 2.0, 0.5, 0.6, 6, 10
    h_terms = [(omega / 2.0, "X")]
    prep = [JPrim(_X, (0,))]
    key = jax.random.PRNGKey(2)
    program = prep + JDy.lindblad_step_program(h_terms, [(rate, _SM, 0)], t / steps) * steps
    u = jax_uniforms(key, ntraj, JT._elaborate(program))
    (jre, jim), jest = JDy.lindblad_mcwf(1, prep, h_terms, [(rate, _SM, 0)], t, steps, ntraj,
                                         observables=["Z"], seed=2)
    ts, test = TDy.lindblad_mcwf(1, [TPrim(_X, (0,))], h_terms, [(rate, _SM, 0)], t, steps,
                                 ntraj, observables=["Z"], uniforms=u)
    assert np.abs(ts.numpy() - (np.asarray(jre) + 1j * np.asarray(jim))).max() < 1e-5
    assert abs(test[0][0] - jest[0][0]) < 1e-5 and abs(test[0][1] - jest[0][1]) < 1e-5


def test_lindblad_mcwf_matches_exact_density():
    """The damped Rabi case of tests/test_lindblad.py: the trajectory mean
    converges to lindblad_evolve."""
    omega, rate, t = 2.0, 0.5, 1.2
    h_terms = [(omega / 2.0, "X")]
    rho = DensityMatrix(1).apply([TPrim(_X, (0,))])
    TDy.lindblad_evolve(rho, h_terms, [(rate, _SM, 0)], t, steps=60)
    want = rho.expectation("Z")
    states, est = TDy.lindblad_mcwf(1, [TPrim(_X, (0,))], h_terms, [(rate, _SM, 0)], t,
                                    steps=60, ntraj=800, observables=["Z"], seed=2)
    mean, se = est[0]
    assert states.shape == (800, 2) and se > 0.0
    assert abs(mean - want) < 4 * se + 0.01


def test_lindblad_mcwf_two_qubit_dephasing_and_ten_qubits():
    rate, t = 0.4, 0.7
    rho = DensityMatrix(2).apply([TPrim(_H, (0,)), TPrim(_H, (1,))])
    TDy.lindblad_evolve(rho, [(1.0, "ZZ")], [(rate, np.diag([1.0, -1.0]), 0)], t, steps=40)
    _, est = TDy.lindblad_mcwf(2, [TPrim(_H, (0,)), TPrim(_H, (1,))], [(1.0, "ZZ")],
                               [(rate, np.diag([1.0, -1.0]), 0)], t, steps=40, ntraj=600,
                               observables=["XX", "ZI"], seed=5)
    for pauli, (mean, se) in zip(["XX", "ZI"], est):
        assert abs(mean - rho.expectation(pauli)) < 4 * se + 0.02, pauli
    states, est = TDy.lindblad_mcwf(10, [TPrim(_H, (0,))], [(0.5, "Z" + "I" * 9)],
                                    [(0.3, _SM, 0)], 0.5, steps=5, ntraj=32,
                                    observables=["Z" + "I" * 9], seed=1)
    assert states.shape == (32, 1 << 10) and -1.0 <= est[0][0] <= 1.0
    assert TDy.lindblad_mcwf(1, [], [(1.0, "X")], [(0.1, _SM, 0)], 0.1, 1, 4)[1] is None
