"""The exact density engine's composed runs (``DensityProgram`` on one
buffer): each run of consecutive gates on at most two qubits, with the
channels after each, is one superoperator pass over rho. Held against the
same programs applied pass by pass (a gate's rows, its columns, then each
channel in the spec's order, with ``DensityMatrix.apply`` and
``apply_channel``) on the benchmark's noisy random circuit, a random mix of
dense and diagonal gates, a 3-qubit gate that takes the pass-by-pass route,
targeted noise, ``dep2`` after 1-qubit gates and two channels that do not
commute; and, with a mid-circuit measurement, reset and conditional, against
the JAX package's ``DensityProgram``."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import qubism_torch.core.density as TD  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim  # noqa: E402
from qubism_torch.ops import kernels  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm as t_parse  # noqa: E402
from qubism_torch.run import noisy as TN  # noqa: E402
from qubism_torch.run.compiler import EvGates  # noqa: E402
from qubism_torch.utils import profiling  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm as j_parse  # noqa: E402
from qubism_tpu.run import noisy as JN  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from qbench.circuits import noisy_boixo  # noqa: E402

TOL = 1e-6
#: a file of qbench/, so that a text's include finds qbench/qelib1.inc
PATH = os.path.join(ROOT, "qbench", "program.qasm")
#: the benchmark's noisy random circuit at 2 x 3
BOIXO = {"lattice": [2, 3], "qubits": 6, "num_qubits": 12, "cz_depth": 8}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")
    kernels.reset_launches()


def _unitary(k, rng):
    q, r = np.linalg.qr(rng.normal(size=(1 << k, 1 << k))
                        + 1j * rng.normal(size=(1 << k, 1 << k)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _program(n, noise, prims):
    """A DensityProgram on n qubits whose one event is ``prims``."""
    prog = TN.DensityProgram(t_parse("<t>", f"qreg q[{n}];"), noise=noise)
    prog.events = [EvGates(tuple(prims))]
    return prog


def _passwise(prog, order=None):
    """The program's gates pass by pass: a gate's rows and columns, then each
    channel the noise attaches to it (a 1-qubit one on each of its qubits in
    the channel's set, a 2-qubit one on a 2-qubit gate inside the set), in
    the spec's order or the channels' ``order``."""
    chans = prog.noise if order is None else [prog.noise[i] for i in order]
    rho = TD.DensityMatrix(prog.n)
    for ev in prog.events:
        for p in ev.prims:
            rho.apply([p])
            t = tuple(int(q) for q in p.targets)
            for _, ks, tset in chans:
                if np.asarray(ks[0]).shape[0] == 4:
                    if len(t) == 2 and (tset is None or set(t) <= tset):
                        rho.apply_channel(ks, t)
                else:
                    for q in t:
                        if tset is None or q in tset:
                            rho.apply_channel(ks, (q,))
    return rho


def _greedy_runs(targets, width=2):
    """How many runs a list of gate targets falls into when each run takes
    the next gates while their qubits together number at most ``width``."""
    runs, cur = 0, set()
    for t in targets:
        if not cur or len(cur | set(t)) > width:
            runs, cur = runs + 1, set(t)
        else:
            cur |= set(t)
    return runs


def _boixo(noise):
    p = noisy_boixo.draw(BOIXO, 7)
    return TN.DensityProgram(t_parse(PATH, noisy_boixo.text(BOIXO, p)), noise=noise)


def _random_mix():
    """Dense and diagonal gates on one and two qubits, targets in either
    order, on 4 qubits."""
    rng = np.random.default_rng(11)
    prims = []
    for _ in range(40):
        k = int(rng.integers(1, 3))
        t = tuple(int(q) for q in rng.choice(4, size=k, replace=False))
        if rng.random() < 0.4:
            prims.append(Prim(np.exp(1j * rng.uniform(0, 2 * np.pi, 1 << k)), t, True))
        else:
            prims.append(Prim(_unitary(k, rng), t))
    return _program(4, "dep:0.03,ad:0.05,dep2:0.04", prims)


def _wide_prim():
    """A 3-qubit gate between runs: it ends the run before it and takes the
    pass-by-pass route (dep2 skipped on it); the gates after it start anew."""
    rng = np.random.default_rng(4)
    prims = [Prim(_unitary(1, rng), (0,)), Prim(_unitary(2, rng), (2, 1)),
             Prim(_unitary(3, rng), (0, 3, 2)), Prim(_unitary(1, rng), (3,)),
             Prim(_unitary(2, rng), (3, 1))]
    return _program(4, "dep:0.03,ad:0.05,dep2:0.04", prims)


def _one_of_a_cx():
    """Noise restricted to q[1]: the 1-qubit channel on that qubit of each
    cx alone, dep2 on no cx that q[0] or q[2] is part of."""
    src = ('OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[3];\n'
           "h q[0];\ncx q[0], q[1];\nu3(0.3, 0.2, 0.1) q[1];\ncx q[1], q[2];\n"
           "t q[2];\ncx q[2], q[0];\n")
    return TN.DensityProgram(t_parse(PATH, src), noise="dep:0.05@q[1],dep2:0.1@q[1]+q[2]")


def _dep2_on_one_qubit():
    """Only 1-qubit gates under dep2: no channel fires."""
    src = ('OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[2];\n'
           "h q[0];\nu3(0.3, 0.2, 0.1) q[1];\nt q[0];\nrx(0.7) q[1];\n")
    return TN.DensityProgram(t_parse(PATH, src), noise="dep2:0.3")


CASES = {
    "boixo_sycamore": lambda: _boixo("depolarizing:0.0016,dep2:0.0062"),
    "boixo_strong": lambda: _boixo("depolarizing:0.05,dep2:0.2"),
    "random_mix": _random_mix,
    "wide_prim": _wide_prim,
    "one_of_a_cx": _one_of_a_cx,
    "dep2_on_one_qubit": _dep2_on_one_qubit,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_run_equals_pass_by_pass(case):
    prog = CASES[case]()
    got, _ = prog.run(seed=0)
    c = dict(profiling.counters)
    want = _passwise(prog)
    assert np.abs(got.matrix() - want.matrix()).max() < TOL
    assert abs(got.trace() - 1.0) < 1e-5
    prims = [p for ev in prog.events for p in ev.prims]
    narrow = [tuple(p.targets) for p in prims if len(p.targets) <= 2]
    assert c["rho_fused_prims"] == len(narrow)
    if case == "wide_prim":
        # runs {0}, {1, 2}, then the 3-qubit gate's rows, columns and its
        # three 1-qubit channels of each kind, then {1, 3}
        assert c["rho_fused_passes"] == 3
        assert (c["rho_unitary_passes"], c["rho_channel_passes"]) == (2, 6)
    else:
        assert c["rho_fused_passes"] == _greedy_runs(narrow)
        assert c.get("rho_unitary_passes", 0) + c.get("rho_channel_passes", 0) == 0
    if case == "dep2_on_one_qubit":
        assert got.purity() == pytest.approx(1.0, abs=1e-5)


def test_channels_compose_in_the_spec_order():
    """Amplitude damping after depolarizing: the composed pass follows the
    spec's order, and the other order is a different state."""
    src = ('OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[2];\n'
           "u3(0.9, 0.2, 0.1) q[0];\ncx q[0], q[1];\nh q[1];\nrx(0.4) q[0];\n")
    prog = TN.DensityProgram(t_parse(PATH, src), noise="depolarizing:0.1,amplitude-damping:0.2")
    got, _ = prog.run(seed=0)
    assert profiling.counters["rho_fused_passes"] == 1
    assert np.abs(got.matrix() - _passwise(prog).matrix()).max() < TOL
    assert np.abs(got.matrix() - _passwise(prog, order=(1, 0)).matrix()).max() > 1e-3


def _jax_draws(key, k):
    """The uniforms of k key splits, as the JAX package's measure_qubit
    takes them."""
    out = []
    for _ in range(k):
        key, sub = jax.random.split(key)
        out.append(float(jax.random.uniform(sub)))
    return out


#: gates, a measurement, a conditional on it, a reset, more gates and a
#: second measurement and conditional: every event that ends a run
MID_CIRCUIT = """OPENQASM 2.0;
include "qelib1.inc";
qreg q[3];
creg c[1];
creg d[1];
h q[0];
cx q[0], q[1];
u3(0.3, 0.2, 0.1) q[2];
t q[2];
measure q[0] -> c[0];
if(c==1) x q[2];
reset q[1];
h q[1];
cx q[1], q[2];
measure q[2] -> d[0];
if(d==0) u3(0.5, 0.1, 0.4) q[0];
rz(0.4) q[1];
cx q[0], q[1];
"""


def test_mid_circuit_events_against_the_jax_package():
    noise = "dep:0.02,ad:0.05,pd:0.03,dep2:0.04"
    outcomes = set()
    for seed in range(6):
        jrho, jcregs = JN.DensityProgram(j_parse(PATH, MID_CIRCUIT), noise=noise).run(seed=seed)
        kernels.reset_launches()
        tprog = TN.DensityProgram(t_parse(PATH, MID_CIRCUIT), noise=noise)
        trho, tcregs = tprog.run(seed=seed, uniforms=_jax_draws(jax.random.PRNGKey(seed), 16))
        assert {k: str(v) for k, v in tcregs.items()} == {k: str(v) for k, v in jcregs.items()}
        assert np.abs(trho.matrix() - jrho.matrix()).max() < TOL
        assert abs(trho.trace() - 1.0) < 1e-5
        c = profiling.counters
        assert c["rho_fused_passes"] >= 4
        assert c.get("rho_unitary_passes", 0) + c.get("rho_channel_passes", 0) == 0
        outcomes.add((str(tcregs["c"]), str(tcregs["d"])))
    assert len(outcomes) > 1  # both branches of a conditional ran
