"""Maximum-likelihood amplitude estimation of the port
(models/amplitude.py) against the JAX package: the cases of
tests/test_amplitude.py on the CPU, where the compiled circuits run the
kernels' plain versions. Probabilities to 1e-5 of the rotation law and
1e-6 of the JAX package's; the binomial hits, drawn by numpy from the same
seed, equal the JAX package's."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.core.gates as JG  # noqa: E402
import qubism_tpu.models.amplitude as JA  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim  # noqa: E402
from qubism_torch.models.amplitude import (amplitude_exact, grover_iterate_prims,  # noqa: E402
                                           invert_prims, mlae_estimate, reflection_prim,
                                           schedule_probabilities)
from qubism_torch.models.circuits import ghz_prims, w_state_prims  # noqa: E402
from qubism_torch.ops.fusion import CompiledCircuit  # noqa: E402

_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _uniform_prims(n, P=Prim):
    return [P(_H, (q,)) for q in range(n)]


def _run(prims, n):
    c = CompiledCircuit(n, list(prims))
    return c.state_to_complex(c(c.init_state()))


def test_invert_prims_roundtrip():
    n = 5
    prims = w_state_prims(n) + ghz_prims(n)[1:]
    amps = _run(prims + invert_prims(prims), n)
    expected = np.zeros(1 << n)
    expected[0] = 1.0
    assert np.linalg.norm(amps - expected) < 1e-5


def test_reflection_prim_flips_selected():
    n = 3
    p = reflection_prim(n, (2, 5))
    assert p.diag and p.targets == (0, 1, 2)
    amps = _run(_uniform_prims(n) + [p], n)
    signs = np.sign(amps.real * math.sqrt(1 << n))
    expected = np.ones(1 << n)
    expected[[2, 5]] = -1
    assert np.allclose(signs, expected)
    with pytest.raises(ValueError, match="out of range"):
        reflection_prim(n, 8)
    with pytest.raises(ValueError, match="demo-scale"):
        grover_iterate_prims(_uniform_prims(2), 17, 0)


@pytest.mark.parametrize("n,good", [(4, (3,)), (5, (1, 7, 20))])
def test_grover_iterate_rotation_law(n, good):
    """P(good) after Q^m A|0> follows sin^2((2m+1) theta), and equals the
    JAX package's schedule."""
    a_prims = _uniform_prims(n)
    a = amplitude_exact(a_prims, n, good)
    assert abs(a - len(good) / (1 << n)) < 1e-6
    theta = math.asin(math.sqrt(a))
    schedule = [0, 1, 2, 3, 5, 8]
    probs = schedule_probabilities(a_prims, n, good, schedule)
    for m, p in zip(schedule, probs):
        assert abs(p - math.sin((2 * m + 1) * theta) ** 2) < 1e-5, (m, p)
    want = JA.schedule_probabilities(_uniform_prims(n, JG.Prim), n, good, schedule)
    assert np.abs(np.asarray(probs) - np.asarray(want)).max() < 1e-6


def test_rotation_law_nonuniform_prep():
    """Same law for a structured (W-state) preparation circuit."""
    n = 4
    a_prims = w_state_prims(n)
    good = (1 << (n - 1), 1)
    a = amplitude_exact(a_prims, n, good)
    assert abs(a - 2.0 / n) < 1e-6
    theta = math.asin(math.sqrt(a))
    for m, p in zip([0, 1, 4], schedule_probabilities(a_prims, n, good, [0, 1, 4])):
        assert abs(p - math.sin((2 * m + 1) * theta) ** 2) < 1e-5


def test_mlae_recovers_amplitude_as_the_jax_package():
    n = 5
    good = (3, 17, 30)
    res = mlae_estimate(_uniform_prims(n), n, good, shots=256, seed=11)
    assert abs(res.a_exact - 3 / 32) < 1e-6
    assert abs(res.a_hat - res.a_exact) < 0.01, res
    assert res.queries == sum(2 * m + 1 for m in res.schedule)
    want = JA.mlae_estimate(_uniform_prims(n, JG.Prim), n, good, shots=256, seed=11)
    assert res.hits == want.hits and res.schedule == want.schedule
    assert abs(res.a_hat - want.a_hat) < 1e-6


def test_mlae_beats_classical_shot_noise():
    n = 4
    good = (5,)
    shots = 64
    res = mlae_estimate(_uniform_prims(n), n, good,
                        schedule=[0, 1, 2, 4, 8, 16, 32], shots=shots, seed=3)
    a = res.a_exact
    classical_sigma = math.sqrt(a * (1 - a) / (shots * 7))
    assert abs(res.a_hat - a) < classical_sigma / 2, (res, classical_sigma)


def test_mlae_seeded_reproducible():
    n = 3
    r1 = mlae_estimate(_uniform_prims(n), n, (2,), shots=64, seed=7)
    r2 = mlae_estimate(_uniform_prims(n), n, (2,), shots=64, seed=7)
    assert r1 == r2
