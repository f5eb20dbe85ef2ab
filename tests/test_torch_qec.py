"""The port's mid-circuit Pauli-frame executor and repetition-code memory
against the JAX package's (the cases of tests/test_qec.py): frame runs
reproduce the exact tableau batch's and the JAX package's marginals and
joint statistics (within 0.03 at 6000 trajectories), the memory matches
its closed-form logical error law (within 4 sigma + 0.005) with every
syndrome consistent, and the law itself is the JAX package's."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qubism_torch.config import config  # noqa: E402
from qubism_torch.models.qec import (repetition_logical_rate,  # noqa: E402
                                     repetition_memory)
from qubism_torch.qasm.parser import parse_openqasm as tparse  # noqa: E402
from qubism_torch.stabilizer import tableau as T  # noqa: E402
from qubism_torch.stabilizer.noise import StabilizerTrajectoryProgram  # noqa: E402
from qubism_tpu.models import qec as JQ  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm as jparse  # noqa: E402
from qubism_tpu.stabilizer.noise import StabilizerTrajectoryProgram as JProg  # noqa: E402

H_GATE = "U(1.5707963267948966, 0, 3.141592653589793)"
MIDCIRCUIT = f"""qreg q[3]; creg c[1]; creg m[3];
{H_GATE} q[0];
CX q[0], q[1];
measure q[1] -> c[0];
reset q[1];
CX q[0], q[2];
measure q -> m;
"""


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def prog(src, noise):
    return StabilizerTrajectoryProgram(tparse("<test>", src), noise=noise)


def test_midcircuit_rides_frames_and_matches_exact_marginals():
    sp = prog(MIDCIRCUIT, "bf:0.05")
    out = sp.run_vals(6000, seed=0)
    assert sp.used_frames
    ex = prog(MIDCIRCUIT, "bf:0.05")
    ex._frame_plan = ex._frame_plan_midcircuit = lambda: None
    exact = ex.run_vals(6000, seed=1)
    assert not ex.used_frames
    jp = JProg(jparse("<test>", MIDCIRCUIT), noise="bf:0.05")
    jout = jp.run_vals(6000, seed=2)
    assert jp.used_frames
    for other in (exact, jout):
        for reg in ("c", "m"):
            assert (np.abs(out[reg].mean(0) - other[reg].mean(0)) < 0.03).all(), reg
        agree = (out["c"][:, 0] == out["m"][:, 0]).mean()
        assert abs(agree - (other["c"][:, 0] == other["m"][:, 0]).mean()) < 0.03


def test_midcircuit_nondeterministic_outcomes_decorrelate():
    src = (f"qreg q[2]; creg c[1];\n{H_GATE} q[0];\nCX q[0], q[1];\n"
           "measure q[0] -> c[0];\nreset q[0];\nmeasure q[0] -> c[0];\n")
    sp = prog(src, "bf:0.01")
    out = sp.run_vals(4096, seed=0)
    assert sp.used_frames and out["c"].mean() < 0.01
    src1 = (f"qreg q[2]; creg c[1];\n{H_GATE} q[0];\nCX q[0], q[1];\n"
            "measure q[0] -> c[0];\n")
    sp1 = prog(src1, "bf:0.0")
    m = sp1.run_vals(4096, seed=0)["c"].mean()
    assert sp1.used_frames and abs(m - 0.5) < 4 * 0.5 / 64


def test_feed_forward_still_exact_path():
    src = (f"qreg q[2]; creg c[1]; creg d[1];\n{H_GATE} q[0];\n"
           "measure q[0] -> c[0];\n"
           "if (c == 1) U(3.141592653589793, 0, 3.141592653589793) q[1];\n"
           "measure q[1] -> d[0];\n")
    sp = prog(src, "bf:0.02")
    out = sp.run_vals(512, seed=0)
    assert not sp.used_frames
    agree = (out["c"][:, 0] == out["d"][:, 0]).mean()
    # d mirrors c except where one of the two bf sites flipped q[1]
    want = 1 - 0.02 * 0.5
    assert abs(agree - want) < 5 * math.sqrt(want * (1 - want) / 512) + 0.01


def test_reset_of_superposed_qubit_falls_back():
    src = (f"qreg q[1]; creg c[1];\n{H_GATE} q[0];\nreset q[0];\n"
           "measure q[0] -> c[0];\n")
    sp = prog(src, "bf:0.0")
    out = sp.run_vals(64, seed=0)
    assert not sp.used_frames and out["c"].sum() == 0


@pytest.mark.parametrize("d,rounds,p", [(3, 4, 0.08), (5, 3, 0.1), (7, 2, 0.12)])
def test_repetition_memory_matches_analytic_law(d, rounds, p):
    ntraj = 4000
    res = repetition_memory(d, rounds, p, ntraj, seed=2)
    assert res.syndrome_consistent
    assert res.analytic == JQ.repetition_logical_rate(d, rounds, p)
    sig = (res.analytic * (1 - res.analytic) / ntraj) ** 0.5
    assert abs(res.logical_rate - res.analytic) < 4 * sig + 0.005, (res.logical_rate, res.analytic)
    jres = JQ.repetition_memory(d, rounds, p, ntraj, seed=2)
    assert abs(res.logical_rate - jres.logical_rate) < 6 * sig + 0.005


def test_repetition_memory_noiseless_is_silent():
    res = repetition_memory(3, 3, 0.0, 64, seed=4)
    assert res.logical_rate == 0.0 and res.data.sum() == 0
    assert all(s.sum() == 0 for s in res.syndromes) and res.syndrome_consistent


def test_repetition_memory_validates_args():
    with pytest.raises(ValueError, match="odd d"):
        repetition_memory(4, 2, 0.1, 8)
    with pytest.raises(ValueError, match="rounds"):
        repetition_memory(3, 0, 0.1, 8)


def test_logical_rate_monotone_in_rounds():
    rates = [repetition_logical_rate(5, r, 0.05) for r in (1, 2, 4, 8)]
    assert all(a < b for a, b in zip(rates, rates[1:]))
    assert rates == [JQ.repetition_logical_rate(5, r, 0.05) for r in (1, 2, 4, 8)]
    assert rates[0] == pytest.approx(
        sum(math.comb(5, k) * 0.05 ** k * 0.95 ** (5 - k) for k in (3, 4, 5)))


def test_memory_scales_to_1000_qubits():
    """A 1001-qubit (d=501) memory, one frame scan for all trajectories:
    the clean record reads each round's 500 syndromes in one batch (one
    host read an event, no measurement round)."""
    T.reset_stats()
    res = repetition_memory(501, 2, 0.001, 64, seed=5)
    assert res.syndrome_consistent and res.logical_rate < 0.05
    assert T.stats["rounds"] == 0
