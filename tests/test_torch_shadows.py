"""Classical shadows of the port (models/shadows.py): the cases of
tests/test_shadows.py on the CPU. The bases, drawn by numpy from the seed,
equal the JAX package's; the outcomes are the port's own draws, held by
the JAX file's error windows and, per basis setting, by a chi-square test
(alpha 1e-3, ``utils.stats.chi2_test``) against the exact probabilities of
the rotated state."""

import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.core.gates as JG  # noqa: E402
import qubism_tpu.models.shadows as JS  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim  # noqa: E402
from qubism_torch.models.shadows import (ShadowRecord, shadow_expectation,  # noqa: E402
                                         shadow_pauli_sum, shadow_snapshots)
from qubism_torch.models.tomography import _BASIS_ROT  # noqa: E402
from qubism_torch.ops.fusion import CompiledCircuit  # noqa: E402
from qubism_torch.utils.stats import chi2_test  # noqa: E402

_H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_CX = np.eye(4, dtype=complex)[[0, 1, 3, 2]]


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _bell(P=Prim):
    return [P(_H, (0,)), P(_CX, (0, 1))]


def test_record_shapes_reproducible_and_bases_of_the_jax_package():
    rec = shadow_snapshots(_bell(), 2, 300, seed=5)
    rec2 = shadow_snapshots(_bell(), 2, 300, seed=5)
    assert rec.bases.shape == (300, 2) and rec.bits.shape == (300, 2)
    assert set(np.unique(rec.bases)) <= {0, 1, 2} and set(np.unique(rec.bits)) <= {0, 1}
    assert np.array_equal(rec.bases, rec2.bases) and np.array_equal(rec.bits, rec2.bits)
    want = JS.shadow_snapshots(_bell(JG.Prim), 2, 300, seed=5)
    assert np.array_equal(rec.bases, want.bases)


def test_snapshot_values_structure():
    rec = shadow_snapshots(_bell(), 2, 400, seed=1)
    v1 = rec.pauli_values("ZI")
    assert set(np.unique(v1)) <= {-3.0, 0.0, 3.0}
    assert np.all(v1[rec.bases[:, 0] != 2] == 0.0)
    assert set(np.unique(rec.pauli_values("XX"))) <= {-9.0, 0.0, 9.0}
    # the estimator is the JAX package's on the same record
    jrec = JS.ShadowRecord(rec.bases, rec.bits)
    for p in ("ZI", "XX", "YZ"):
        assert np.array_equal(rec.pauli_values(p), jrec.pauli_values(p))


def test_outcomes_follow_the_rotated_distribution():
    """Per basis setting of a 3-qubit state, the outcome counts against
    |<b| U_bases |psi>|^2 (chi-square, alpha 1e-3)."""
    n = 3
    prims = [Prim(_H, (0,)), Prim(_CX, (0, 1)), Prim(_CX, (1, 2)),
             Prim(np.array([[1, 0], [0, np.exp(0.7j)]]), (2,))]
    rec = shadow_snapshots(prims, n, 20000, seed=4)
    c = CompiledCircuit(n, prims)
    psi = c.state_to_complex(c(c.init_state()))
    rots = [_BASIS_ROT["X"], _BASIS_ROT["Y"], np.eye(2)]
    codes = rec.bases @ (3 ** np.arange(n)[::-1])
    outs = rec.bits.astype(np.int64) @ (1 << np.arange(n)[::-1])
    for setting in itertools.product(range(3), repeat=n):
        u = np.array([[1.0]])
        for b in setting:
            u = np.kron(u, rots[b])
        probs = np.abs(u @ psi) ** 2
        sel = codes == sum(b * 3 ** (n - 1 - q) for q, b in enumerate(setting))
        counts = np.bincount(outs[sel], minlength=1 << n)
        res = chi2_test(counts, probs)
        assert res.ok, (setting, res)


def test_bell_expectations():
    rec = shadow_snapshots(_bell(), 2, 6000, seed=3)
    assert abs(shadow_expectation(rec, "XX") - 1.0) < 0.2
    assert abs(shadow_expectation(rec, "ZZ") - 1.0) < 0.2
    assert abs(shadow_expectation(rec, "YY") + 1.0) < 0.2
    assert abs(shadow_expectation(rec, "ZI")) < 0.1
    assert abs(shadow_expectation(rec, "IX")) < 0.1


def test_product_state_z():
    rec = shadow_snapshots([Prim(_X, (1,))], 2, 4000, seed=7)
    assert abs(shadow_expectation(rec, "IZ") + 1.0) < 0.15
    assert abs(shadow_expectation(rec, "ZI") - 1.0) < 0.15


def test_pauli_sum_and_identity():
    rec = shadow_snapshots(_bell(), 2, 6000, seed=11)
    got = shadow_pauli_sum(rec, [(2.0, "II"), (1.0, "ZZ"), (1.0, "XX"), (-1.0, "YY")],
                           constant=0.5)
    assert abs(got - 5.5) < 0.5


def test_error_shrinks_with_snapshots():
    errs = [np.mean([abs(shadow_expectation(shadow_snapshots(_bell(), 2, T, seed=s), "ZZ")
                         - 1.0) for s in range(3)]) for T in (500, 8000)]
    assert errs[1] < errs[0]


def test_chunking_keeps_the_bases():
    r1 = shadow_snapshots(_bell(), 2, 100, seed=9, chunk=256)
    r2 = shadow_snapshots(_bell(), 2, 100, seed=9, chunk=32)
    assert np.array_equal(r1.bases, r2.bases)
    assert abs(shadow_expectation(r1, "ZZ") - shadow_expectation(r2, "ZZ")) < 1.0


def test_three_qubit_ghz():
    prims = [Prim(_H, (0,)), Prim(_CX, (0, 1)), Prim(_CX, (1, 2))]
    rec = shadow_snapshots(prims, 3, 8000, seed=2)
    assert abs(shadow_expectation(rec, "ZZI") - 1.0) < 0.2
    assert abs(shadow_expectation(rec, "IZZ") - 1.0) < 0.2
    assert abs(shadow_expectation(rec, "XXX") - 1.0) < 0.4
    assert abs(shadow_expectation(rec, "ZII")) < 0.15


def test_bad_inputs():
    rec = shadow_snapshots(_bell(), 2, 50, seed=0)
    with pytest.raises(ValueError):
        rec.pauli_values("ZZZ")
    with pytest.raises(ValueError):
        rec.pauli_values("ZA")
    assert isinstance(rec, ShadowRecord)
