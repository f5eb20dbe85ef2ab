"""The exact density engine's composed runs (``DensityProgram`` on one
buffer): the gates between two barriers, grouped by ``run.noisy.group_runs``
into runs on at most two qubits (a gate joins the latest run on its qubits
where it fits, a single-qubit gate waits for its qubit's next run), each run
with the channels after each gate one superoperator pass over rho. Held
against the same programs applied pass by pass (a gate's rows, its columns,
then each channel in the spec's order, with ``DensityMatrix.apply`` and
``apply_channel``) on the benchmark's noisy random circuit, a random mix of
dense and diagonal gates, a 3-qubit gate that takes the pass-by-pass route,
targeted noise, ``dep2`` after 1-qubit gates, two channels that do not
commute, a qubit's gates around its cx under amplitude damping, and gates
still waiting at a measurement, reset, conditional, dump and the end; with
a mid-circuit measurement, reset and conditional, against the JAX package's
``DensityProgram``; and the grouping alone on the cell's 15-qubit gate
list."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import qubism_torch.core.density as TD  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.creg import CReg  # noqa: E402
from qubism_torch.core.gates import Prim  # noqa: E402
from qubism_torch.ops import kernels  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm as t_parse  # noqa: E402
from qubism_torch.run import noisy as TN  # noqa: E402
from qubism_torch.run.compiler import EvCond, EvDump, EvGates, EvMeasure, EvReset  # noqa: E402
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
#: the uniforms of a case's measurements, the same for the run and the reference
UNIFORMS = (0.3, 0.8, 0.55, 0.1)


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
    """The program's gates pass by pass, in program order: a gate's rows and
    columns, then each channel the noise attaches to it (a 1-qubit one on
    each of its qubits in the channel's set, a 2-qubit one on a 2-qubit gate
    inside the set), in the spec's order or the channels' ``order``. A
    measurement takes the next of ``UNIFORMS``. Returns rho, the cregs, rho
    at each dump and the number of gates applied."""
    chans = prog.noise if order is None else [prog.noise[i] for i in order]
    rho = TD.DensityMatrix(prog.n)
    cregs = dict(prog.cregs0)
    draws = iter(UNIFORMS)
    dumps, prims = [], []

    def walk(events):
        for ev in events:
            if isinstance(ev, EvGates):
                for p in ev.prims:
                    rho.apply([p])
                    prims.append(p)
                    t = tuple(int(q) for q in p.targets)
                    for _, ks, tset in chans:
                        if np.asarray(ks[0]).shape[0] == 4:
                            if len(t) == 2 and (tset is None or set(t) <= tset):
                                rho.apply_channel(ks, t)
                        else:
                            for q in t:
                                if tset is None or q in tset:
                                    rho.apply_channel(ks, (q,))
            elif isinstance(ev, EvMeasure):
                bits = [rho.measure_qubit(q, None, next(draws)) for q in ev.qubits]
                off = 0
                for creg, bit, count in ev.writes:
                    cregs[creg] = (CReg.of(bits[off:off + count]) if bit is None
                                   else cregs[creg].set_bit(bit, bits[off]))
                    off += count
            elif isinstance(ev, EvReset):
                for q in ev.qubits:
                    rho.reset(q)
            elif isinstance(ev, EvCond):
                if cregs[ev.creg].to_natural() == ev.value:
                    walk(ev.body)
            elif isinstance(ev, EvDump):
                dumps.append(rho.matrix())

    walk(prog.events)
    return rho, cregs, dumps, len(prims)


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


def _text(body, n=3, noise="dep:0.03,ad:0.05,dep2:0.04"):
    """A DensityProgram of ``body`` on n qubits and one classical bit."""
    src = f'OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[{n}];\ncreg c[1];\n{body}'
    return TN.DensityProgram(t_parse(PATH, src), noise=noise)


#: q[0]'s gates before and after its cx with q[1] and after its cx with
#: q[2], under amplitude damping, which commutes with no gate on its qubit;
#: h q[1] joins the run of the first cx, ahead of the second
AROUND_A_CX = """u3(0.9, 0.2, 0.1) q[0];
rx(0.7) q[1];
cx q[0], q[1];
ry(0.4) q[0];
cx q[0], q[2];
h q[1];
u3(0.5, 0.3, 0.2) q[0];
t q[2];
"""
#: q[1]'s gates wait through a cx on q[0], q[2] for the barrier ``{}``,
#: then pair up on their own; the gates after it start anew
WAIT_AT = """h q[0];
u3(0.3, 0.2, 0.1) q[1];
cx q[0], q[2];
t q[1];
{}
rx(0.6) q[1];
cx q[1], q[2];
"""
#: the gates on q[1] and q[0] still wait at the conditional, whose body
#: joins the next run whether it runs or not
WAIT_AT_IF = """h q[0];
cx q[0], q[2];
measure q[2] -> c[0];
u3(0.3, 0.2, 0.1) q[1];
t q[0];
if(c==1) x q[1];
rx(0.6) q[1];
cx q[1], q[2];
"""
#: waiting gates on three qubits at the end: q[2] and q[3] pair up, q[4]
#: is a run of its own
WAIT_AT_THE_END = """cx q[0], q[1];
h q[2];
t q[3];
rx(0.6) q[4];
h q[0];
ry(0.4) q[2];
u3(0.3, 0.2, 0.1) q[4];
"""

CASES = {
    "boixo_sycamore": lambda: _boixo("depolarizing:0.0016,dep2:0.0062"),
    "boixo_strong": lambda: _boixo("depolarizing:0.05,dep2:0.2"),
    "random_mix": _random_mix,
    "wide_prim": _wide_prim,
    "one_of_a_cx": _one_of_a_cx,
    "dep2_on_one_qubit": _dep2_on_one_qubit,
    "around_a_cx": lambda: _text(AROUND_A_CX, noise="ad:0.1,dep:0.05,dep2:0.04"),
    "wait_at_measure": lambda: _text(WAIT_AT.format("measure q[1] -> c[0];")),
    "wait_at_reset": lambda: _text(WAIT_AT.format("reset q[1];")),
    "wait_at_if": lambda: _text(WAIT_AT_IF),
    "wait_at_dump": lambda: _text(WAIT_AT.format(":dump;")),
    "wait_at_the_end": lambda: _text(WAIT_AT_THE_END, n=5),
}
#: the composed passes of each case: every cx of the 2 x 3 circuit opens a
#: run that its qubits' single-qubit gates join (9 cz); wide_prim's runs
#: {1, 2} and q[0]'s waiting gate before its 3-qubit gate, {1, 3} after it
PASSES = {"boixo_sycamore": 9, "boixo_strong": 9, "random_mix": 13, "wide_prim": 3,
          "one_of_a_cx": 3, "dep2_on_one_qubit": 1, "around_a_cx": 2, "wait_at_measure": 3,
          "wait_at_reset": 3, "wait_at_if": 3, "wait_at_dump": 3, "wait_at_the_end": 3}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_run_equals_pass_by_pass(case):
    prog = CASES[case]()
    dumps = []
    prog._pretty = lambda rho, cregs: dumps.append(rho.matrix()) or ""
    got, cregs = prog.run(seed=0, uniforms=UNIFORMS)
    c = dict(profiling.counters)
    want, want_cregs, want_dumps, prims = _passwise(prog)
    assert np.abs(got.matrix() - want.matrix()).max() < TOL
    assert {k: str(v) for k, v in cregs.items()} == {k: str(v) for k, v in want_cregs.items()}
    assert len(dumps) == len(want_dumps) == (case == "wait_at_dump")
    assert all(np.abs(a - b).max() < TOL for a, b in zip(dumps, want_dumps))
    assert abs(got.trace() - 1.0) < 1e-5
    assert c["rho_fused_passes"] == PASSES[case]
    if case == "wide_prim":
        # the 3-qubit gate's rows, columns and its three 1-qubit channels of
        # each kind
        assert c["rho_fused_prims"] == prims - 1
        assert (c["rho_unitary_passes"], c["rho_channel_passes"]) == (2, 6)
    else:
        assert c["rho_fused_prims"] == prims
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
    assert np.abs(got.matrix() - _passwise(prog)[0].matrix()).max() < TOL
    assert np.abs(got.matrix() - _passwise(prog, order=(1, 0))[0].matrix()).max() > 1e-3


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


@pytest.mark.parametrize("lattice, runs", [((3, 5), 22), ((2, 3), 9)])
def test_group_runs_on_the_cell(lattice, runs):
    """The grouping of the cell's gate list (3 x 5) and of the tests' 2 x 3:
    one run a cx, every gate in exactly one run, at most two qubits a run,
    every qubit's gates in program order; and the runs applied in order to
    a state vector, with a random unitary for each gate, give the state of
    program order."""
    cfg = {**json.loads((Path(ROOT) / "qbench" / "configs" / "noisyrcs15.json").read_text()),
           "lattice": list(lattice), "qubits": lattice[0] * lattice[1]}
    n = cfg["qubits"]
    rng = np.random.default_rng(5)
    for seed in (0, 7, 2**35 + 17):
        targets = [t for _, t in noisy_boixo.elaborated(cfg, noisy_boixo.draw(cfg, seed))]
        got = TN.group_runs(targets)
        assert len(got) == runs == sum(len(t) == 2 for t in targets)
        order = [g for run in got for g in run]
        assert sorted(order) == list(range(len(targets)))
        assert all(len({q for g in run for q in targets[g]}) <= 2 for run in got)
        for q in range(n):
            on_q = [g for g in order if q in targets[g]]
            assert on_q == sorted(on_q)
        us = [_unitary(len(t), rng) for t in targets]
        psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
        want, have = psi, psi
        for g in range(len(targets)):
            want = _apply_sv(want, us[g], targets[g], n)
        for g in order:
            have = _apply_sv(have, us[g], targets[g], n)
        assert np.abs(want - have).max() < 1e-12


def _apply_sv(psi, u, targets, n):
    """``u`` on ``targets`` of an n-qubit state vector (qubit 0 the lowest
    bit, the first target the most significant of ``u``'s index)."""
    axes = [n - 1 - q for q in targets]
    k = len(targets)
    t = np.moveaxis(psi.reshape((2,) * n), axes, range(k))
    t = (u @ t.reshape(1 << k, -1)).reshape(t.shape)
    return np.moveaxis(t, range(k), axes).reshape(-1)
