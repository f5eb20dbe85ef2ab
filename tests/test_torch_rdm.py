"""Reduced density matrices and entanglement entropies: the cases of
tests/test_rdm.py through the JAX package and the port on the same circuits,
and against a dense partial trace in float64 numpy. rho_A to 1e-6 against the
oracle and 1e-5 against the JAX value; entropies to 1e-5."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_torch as tq  # noqa: E402
import qubism_tpu as jq  # noqa: E402
import qubism_tpu.models.circuits as JC  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import rdm as TR  # noqa: E402
from qubism_tpu.ops import rdm as JR  # noqa: E402
from qubism_tpu.ops.fusion import CompiledCircuit as JCompiled  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def states(n, prims):
    """The circuit's state in both packages: the JAX engine runs it, the port
    takes the planes through its boundary function."""
    circ = JCompiled(n, prims)
    planes = circ(circ.init_state())
    re, im = (np.asarray(p).reshape(-1) for p in planes)
    return planes, TA.state_from_planes(re, im), re.astype(np.complex128) + 1j * im


def dense_rdm(psi, n, subset):
    keep = list(subset)
    rest = [q for q in range(n) if q not in keep]
    t = psi.reshape((2,) * n).transpose(keep + rest).reshape(1 << len(keep), -1)
    return t @ t.conj().T


def test_ghz_single_qubit_entropy():
    n = 6
    planes, state, _ = states(n, JC.ghz_prims(n))
    for q in (0, 3, 5):
        s = TR.entanglement_entropy(state, n, (q,))
        assert abs(s - math.log(2)) < 1e-5
        assert abs(s - JR.entanglement_entropy(planes, n, (q,))) < 1e-5
        assert abs(TR.entanglement_entropy(state, n, (q,), base=2) - 1.0) < 1e-5
    assert abs(TR.entanglement_entropy(state, n, (0, 1, 2)) - math.log(2)) < 1e-5


def test_product_state_zero_entropy():
    h = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)
    n = 4
    planes, state, _ = states(n, [jq.Prim(h, (q,)) for q in range(n)])
    assert abs(TR.entanglement_entropy(state, n, (1, 2))) < 1e-5
    assert abs(TR.renyi2_entropy(state, n, (0, 3))) < 1e-5
    assert abs(TR.renyi2_entropy(state, n, (0, 3)) - JR.renyi2_entropy(planes, n, (0, 3))) < 1e-5


@pytest.mark.parametrize("piece", [26, 3])
def test_rdm_matches_dense_partial_trace(piece, monkeypatch):
    """Also with the columns taken in pieces of 2^3 amplitudes."""
    monkeypatch.setattr(TR, "_PIECE", piece)
    n = 6
    planes, state, psi = states(n, JC.brickwork_prims(n, depth=3, seed=7))
    for subset in ((0,), (2, 4), (5, 1), (0, 1, 2), (4, 2, 0), (0, 1, 2, 3, 4, 5), ()):
        got = TR.reduced_density_matrix(state, n, subset)
        want = dense_rdm(psi, n, subset)
        assert np.abs(got - want).max() < 1e-6, subset
        assert np.abs(got - JR.reduced_density_matrix(planes, n, subset)).max() < 1e-5, subset
        w = np.linalg.eigvalsh(want)
        w = w[w > 1e-12]
        s_want = float(-(w * np.log(w)).sum())
        assert abs(TR.entanglement_entropy(state, n, subset) - s_want) < 1e-5
        assert abs(TR.entanglement_entropy(state, n, subset)
                   - JR.entanglement_entropy(planes, n, subset)) < 1e-5
        r2 = -np.log(np.real(np.trace(want @ want)))
        assert abs(TR.renyi2_entropy(state, n, subset) - r2) < 1e-5


def test_rdm_validation():
    planes, state, _ = states(3, JC.ghz_prims(3))
    for bad in ((0, 0), (5,), (-1,)):
        with pytest.raises(ValueError) as te:
            TR.reduced_density_matrix(state, 3, bad)
        with pytest.raises(ValueError) as je:
            JR.reduced_density_matrix(planes, 3, bad)
        assert str(te.value) == str(je.value)
    wide = TA.zero_state(13)
    with pytest.raises(ValueError, match="k > 12 refused"):
        TR.reduced_density_matrix(wide, 13, tuple(range(13)))


def test_statevec_methods():
    tsv = (tq.cnot(0, 1, 2) @ tq.on_just(0, tq.hadamard(), 2))(tq.mk_state_vec(2))
    jsv = (jq.cnot(0, 1, 2) @ jq.on_just(0, jq.hadamard(), 2))(jq.mk_state_vec(2))
    assert abs(tsv.entanglement_entropy((0,), base=2) - 1.0) < 1e-5
    assert abs(tsv.entanglement_entropy((0,), base=2)
               - jsv.entanglement_entropy((0,), base=2)) < 1e-5
    rho = tsv.reduced_density_matrix((1,))
    assert np.abs(rho - np.eye(2) / 2).max() < 1e-6
    assert np.abs(rho - jsv.reduced_density_matrix((1,))).max() < 1e-5
