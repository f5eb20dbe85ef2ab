"""The port's four QASM generators of models/circuits (grover_qasm,
w_state_qasm, qaoa_qasm, qpe_qasm) against the JAX package's: the text is
the same character for character over the parameters of
tests/test_models.py (and a few more), ``grover_qasm(3, 5)`` is
``examples/grover.qasm`` below its two comment lines, and each program,
run through the port's interpreter on the CPU, gives the amplitudes of the
port's own ``*_prims`` to 1e-5 (the four ``*_qasm_matches_prims`` cases of
tests/test_models.py)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qubism_torch.config import config  # noqa: E402
from qubism_torch.models import circuits as T  # noqa: E402
from qubism_torch.models import qaoa_qasm  # noqa: E402
from qubism_torch.ops.fusion import CompiledCircuit  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm  # noqa: E402
from qubism_torch.run.interpreter import run_program  # noqa: E402
from qubism_tpu.models import circuits as J  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def final_amplitudes(prims, n):
    c = CompiledCircuit(n, prims)
    return c.state_to_complex(c(c.init_state()))


def run_q(src, name):
    """The interpreter's amplitudes of register q's backing state, and the
    register's view."""
    ps = run_program(parse_openqasm(os.path.join(EXAMPLES, name), src), seed=0)
    view = ps.qregs["q"]
    return np.asarray(ps.stvecs[view.target].amps), view


@pytest.mark.parametrize("name,args", [
    ("grover_qasm", (3, 5)), ("grover_qasm", (4, 9)), ("grover_qasm", (2, 1)),
    ("grover_qasm", (5, 17, 2)),
    ("w_state_qasm", (2,)), ("w_state_qasm", (3,)), ("w_state_qasm", (5,)),
    ("w_state_qasm", (8,)),
    ("qaoa_qasm", (6, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0)], [0.7], [0.3])),
    ("qaoa_qasm", (4, [(0, 2), (1, 3)], [0.1, 0.25], [0.2, 0.35])),
    ("qpe_qasm", (5, 0.40625)), ("qpe_qasm", (6, 0.171875)), ("qpe_qasm", (8, 0.359375)),
    ("qpe_qasm", (5, 0.5)),
])
@pytest.mark.parametrize("measure", [True, False])
def test_text_equals_jax(name, args, measure):
    assert getattr(T, name)(*args, measure=measure) == getattr(J, name)(*args, measure=measure)


def test_grover_qasm_is_the_example():
    with open(os.path.join(EXAMPLES, "grover.qasm")) as f:
        lines = f.read().splitlines(keepends=True)
    body = "".join(ln for ln in lines if not ln.startswith("//"))
    assert lines[1].startswith("// Generated by") and "grover_qasm(3, 5)" in lines[1]
    assert T.grover_qasm(3, 5) == body


@pytest.mark.parametrize("n,marked", [(3, 5), (4, 9)])
def test_grover_qasm_matches_prims(n, marked):
    """The ccx-cascade oracle with ancillas agrees with the
    whole-register-diagonal prims on the q register (the ancillas are
    uncomputed to |0>); 1e-5 on the probabilities."""
    amps, view = run_q(T.grover_qasm(n, marked, measure=False), "_grover_tmp.qasm")
    assert view.start == 0
    probs = np.abs(amps.reshape(1 << n, -1)[:, 0]) ** 2
    expected = np.abs(final_amplitudes(T.grover_prims(n, marked), n)) ** 2
    assert np.linalg.norm(probs - expected) < 1e-5


def test_w_state_qasm_matches_prims(n=5):
    amps, _ = run_q(T.w_state_qasm(n, measure=False), "_w_tmp.qasm")
    expected = final_amplitudes(T.w_state_prims(n), n)
    assert np.linalg.norm(np.abs(amps) - np.abs(expected)) < 1e-5


def test_qaoa_qasm_matches_prims(n=6):
    assert qaoa_qasm is T.qaoa_qasm  # exported from models, as the JAX package does
    edges = T.ring_edges(n)
    gammas, betas = [0.7], [0.3]
    amps, _ = run_q(T.qaoa_qasm(n, edges, gammas, betas, measure=False), "_qaoa_tmp.qasm")
    expected = final_amplitudes(T.qaoa_prims(n, edges, gammas, betas), n)
    # the rz-based cost differs from e^{-i g ZZ} by a global phase only
    assert abs(abs(np.vdot(amps, expected)) - 1.0) < 1e-5


def test_qpe_qasm_matches_prims(t=5):
    phi = 0.40625
    amps, _ = run_q(T.qpe_qasm(t, phi, measure=False), "_qpe_tmp.qasm")
    expected = final_amplitudes(T.qpe_prims(t, phi), t + 1)
    assert np.linalg.norm(np.abs(amps) - np.abs(expected)) < 1e-5
