"""The QASM routes' scheduled fusion (``ops.fusion.fuse_scheduled``): the
diagonal runs it makes of qelib1's cz and cu1, the layered order, the exact
product of both against a complex128 gate-by-gate evolution, the
interpreter's and ``--compile``'s final states scheduled and greedy (and the
JAX package's where the parity tests hold it), and the plan it keeps at
n = 30 on the benchmark's texts, counted from fusion alone."""

import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim, u3_matrix  # noqa: E402
from qubism_torch.models.circuits import qft_prims  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import fusion  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm  # noqa: E402
from qubism_torch.run import compiler  # noqa: E402
from qubism_torch.run.interpreter import run_program  # noqa: E402
from qubism_torch.utils import profiling  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from qbench.circuits import boixo, qft  # noqa: E402

EXAMPLES = os.path.join(ROOT, "examples")
#: a path whose includes resolve to examples/qelib1.inc
VIRTUAL = os.path.join(EXAMPLES, "<schedule>.qasm")
HEADER = 'OPENQASM 2.0;\ninclude "qelib1.inc";\n'
CX = np.eye(4, dtype=np.complex128)[[0, 1, 3, 2]]


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(profiling, "counters", {})


def prims_of(text):
    """The prims of a measurement-free text, as the interpreter queues them."""
    n, events, *_ = compiler.elaborate(parse_openqasm(VIRTUAL, text))
    (ev,) = events
    return n, list(ev.prims)


def rcs_text(rows, cols, seed):
    with open(os.path.join(ROOT, "qbench", "configs", "rcs30.json")) as f:
        cfg = json.load(f)
    cfg.update(lattice=[rows, cols], num_qubits=rows * cols)
    return boixo.text(cfg, boixo.draw(cfg, seed))


def qft_text(n, seed=0):
    with open(os.path.join(ROOT, "qbench", "configs", "qft30.json")) as f:
        cfg = json.load(f)
    cfg.update(num_qubits=n)
    return qft.text(cfg, qft.draw(cfg, seed))


def evolve(prims, n, psi=None):
    """complex128 gate by gate from ``psi`` (|0...0> by default); qubit q
    is axis q."""
    if psi is None:
        psi = np.zeros(1 << n, dtype=np.complex128)
        psi[0] = 1
    psi = psi.reshape((2,) * n)
    for p in prims:
        k = len(p.targets)
        u = np.asarray(p.dense(), dtype=np.complex128).reshape((2,) * (2 * k))
        psi = np.tensordot(u, psi, axes=(list(range(k, 2 * k)), list(p.targets)))
        psi = np.moveaxis(psi, list(range(k)), list(p.targets))
    return psi.reshape(-1)


# -- diagonal runs ------------------------------------------------------------


def test_a_cz_is_one_diagonal_prim():
    _, prims = prims_of(HEADER + "qreg q[2];\ncz q[0],q[1];\n")
    assert len(prims) == 3  # h, cx, h
    out, runs = fusion.diagonal_runs(prims)
    assert runs == [tuple(prims)]
    (p,) = out
    assert p.diag and sorted(p.targets) == [0, 1]
    np.testing.assert_allclose(p.u, [1, 1, 1, -1], atol=1e-15)


@pytest.mark.parametrize("lam", [math.pi / 2, math.pi / 64, 1.234])
def test_the_cu1_chain_gives_its_diagonal(lam):
    _, prims = prims_of(HEADER + f"qreg q[3];\ncu1({lam!r}) q[2],q[0];\n")
    assert len(prims) == 5  # u1, cx, u1, cx, u1
    out, runs = fusion.diagonal_runs(prims)
    # the leading u1 is diagonal itself: the run starts at the first cx
    assert out[0] is prims[0] and runs == [tuple(prims[1:])]
    assert all(p.diag for p in out) and len(out) == 2
    psi = np.array([1, 1j]) @ np.random.default_rng(7).normal(size=(2, 8))
    want = evolve([Prim(np.array([1, 1, 1, np.exp(1j * lam)]), (2, 0), True)], 3, psi)
    np.testing.assert_allclose(evolve(out, 3, psi), want, atol=1e-14)


@pytest.mark.parametrize("text", [
    "h q[1]; cx q[0],q[1];",                # a Bell pair: not diagonal
    "h q[1]; cx q[0],q[1]; t q[2]; h q[1];",  # a third qubit cuts the cz
    "rx(0.3) q[0]; ry(0.2) q[1]; cx q[1],q[0];",
])
def test_a_run_that_is_not_diagonal_stays_as_it_was(text):
    _, prims = prims_of(HEADER + "qreg q[3];\n" + text + "\n")
    out, runs = fusion.diagonal_runs(prims)
    assert runs == [] and len(out) == len(prims)
    assert all(a is b for a, b in zip(out, prims))


def test_a_run_on_one_qubit_and_the_longest_run_is_taken():
    h = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
    t = np.array([1, np.exp(0.25j * math.pi)])
    prims = [Prim(h, (3,)), Prim(h, (3,)), Prim(t, (3,), True),  # h h t on one qubit
             Prim(CX, (1, 2)), Prim(CX, (1, 2)), Prim(t, (1,), True)]  # cx cx t
    out, runs = fusion.diagonal_runs(prims)
    assert [len(r) for r in runs] == [3, 3]
    assert [(p.targets, p.diag) for p in out] == [((3,), True), ((1, 2), True)]
    np.testing.assert_allclose(out[0].u, t, atol=1e-15)
    np.testing.assert_allclose(out[1].u, [1, 1, t[1], t[1]], atol=1e-15)


# -- the layered order is exact -------------------------------------------------


def random_prims(n, count, seed):
    """1q dense and diagonal gates, cx, 2q diagonals (some as qelib1's cz)
    and a wide diagonal, on random qubits."""
    rng = np.random.default_rng(seed)
    h = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
    out = []
    for _ in range(count):
        r = rng.uniform()
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        if r < 0.3:
            out.append(Prim(u3_matrix(*rng.uniform(0, 2 * math.pi, 3), reference_bug=False), (a,)))
        elif r < 0.45:
            out.append(Prim(np.exp(1j * rng.uniform(0, 2 * math.pi, 2)), (a,), True))
        elif r < 0.65:
            out.append(Prim(CX, (a, b)))
        elif r < 0.8:
            out += [Prim(h, (b,)), Prim(CX, (a, b)), Prim(h, (b,))]
        elif r < 0.95:
            out.append(Prim(np.exp(1j * rng.uniform(0, 2 * math.pi, 4)), (a, b), True))
        else:
            wide = tuple(int(x) for x in rng.choice(n, 5, replace=False))
            out.append(Prim(np.exp(1j * rng.uniform(0, 2 * math.pi, 32)), wide, True))
    return out


@pytest.mark.parametrize("n,seed", [(9, 0), (9, 1), (10, 2), (11, 3)])
def test_diagonal_runs_and_layers_keep_the_product(n, seed):
    prims = random_prims(n, 80, seed)
    diagonal, runs = fusion.diagonal_runs(prims)
    assert runs and len(diagonal) < len(prims)
    want = evolve(prims, n)
    np.testing.assert_allclose(evolve(diagonal, n), want, atol=1e-12)
    order = fusion.layered(diagonal, n)
    assert sorted(map(id, order)) == sorted(map(id, diagonal))
    np.testing.assert_allclose(evolve(order, n), want, atol=1e-12)


def test_a_layer_puts_row_gates_by_qubit_then_the_rest_then_the_lane():
    n = 10  # the lane block is qubits 3..9
    u = u3_matrix(0.1, 0.2, 0.3, reference_bug=False)
    prims = [Prim(u, (9,)), Prim(CX, (2, 5)), Prim(u, (1,)), Prim(u, (4,)), Prim(u, (0,))]
    assert [p.targets for p in fusion.layered(prims, n)] == [(0,), (1,), (2, 5), (4,), (9,)]


# -- the interpreter and --compile: scheduled against greedy ---------------------


def greedy(monkeypatch):
    monkeypatch.setattr(fusion, "fuse_scheduled",
                        lambda prims, n, max_block=fusion.DEFAULT_MAX_BLOCK:
                        fusion.fuse(prims, n, max_block))


def interpret(text, seed=1):
    """(amplitudes, cregs, the prims of each flush) of the port's interpreter."""
    flushes = []
    apply = fusion.apply_prims_fused

    def record(state, prims, n):
        flushes.append(len(prims))
        return apply(state, prims, n)

    fusion.apply_prims_fused = record
    try:
        ps = run_program(parse_openqasm(VIRTUAL, text), seed=seed)
    finally:
        fusion.apply_prims_fused = apply
    (sv,) = ps.stvecs.values()
    return TA.complex_from_state(sv.state), {k: str(v) for k, v in ps.cregs.items()}, flushes


def jax_interpret(text, seed=1):
    from qubism_tpu.qasm.parser import parse_openqasm as jparse
    from qubism_tpu.run.interpreter import run_program as jrun

    ps = jrun(jparse(VIRTUAL, text), seed=seed)
    (sv,) = ps.stvecs.values()
    re, im = (np.asarray(x, dtype=np.float64).reshape(-1) for x in sv.planes)
    return re + 1j * im, {k: str(v) for k, v in ps.cregs.items()}


#: measurements, a reset and an if between the gates; every measured qubit
#: is in a basis state, so the JAX package draws the same outcomes
MID_CIRCUIT = HEADER + """qreg q[6];
creg c[2];
x q[0]; h q[1]; h q[2]; h q[3]; h q[4]; h q[5];
cz q[0],q[1]; cz q[2],q[3]; t q[4]; rx(pi/2) q[5];
measure q[0] -> c[0];
cz q[1],q[2]; cz q[4],q[5]; t q[3]; cz q[0],q[4];
reset q[3];
cu1(pi/8) q[3],q[4]; h q[3]; cz q[0],q[3];
if(c==1) cz q[1],q[5];
rx(pi/2) q[1]; cz q[1],q[2]; x q[0];
measure q[0] -> c[1];
cz q[2],q[3]; t q[2]; h q[3]; h q[5];
"""


def ghz_text(n):
    return HEADER + f"qreg q[{n}];\nh q[0];\n" + "".join(
        f"cx q[{i}],q[{i + 1}];\n" for i in range(n - 1))


def read(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        return f.read()


@pytest.mark.parametrize("case", ["rcs3x4-0", "rcs3x4-1", "rcs3x4-2", "qft12", "ghz12",
                                  "rippleCarryAdder", "teleportation", "mid_circuit"])
def test_the_interpreter_scheduled_and_greedy_give_one_state(monkeypatch, case):
    text = {"qft12": lambda: qft_text(12), "ghz12": lambda: ghz_text(12),
            "rippleCarryAdder": lambda: read("rippleCarryAdder.qasm"),
            "teleportation": lambda: read("teleportation.qasm"),
            "mid_circuit": lambda: MID_CIRCUIT}.get(
                case, lambda: rcs_text(3, 4, int(case[-1])))()
    got, cregs, flushes = interpret(text)
    counted = dict(profiling.counters)
    with monkeypatch.context() as m:
        greedy(m)
        want, want_cregs, want_flushes = interpret(text)
    # the flush boundaries are the interpreter's: no gate crosses one
    assert flushes == want_flushes and cregs == want_cregs
    assert counted["prims"] == sum(flushes)
    assert counted.get("sched_greedy", 0) + counted.get("sched_layered", 0) == len(flushes)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    if case in ("rippleCarryAdder", "mid_circuit"):
        jax_amps, jax_cregs = jax_interpret(text)
        assert cregs == jax_cregs
        assert np.linalg.norm(got - jax_amps) <= 1e-5


def test_compile_makes_the_interpreters_passes():
    text = rcs_text(3, 4, 5)
    got, _, _ = interpret(text)
    passes = profiling.counters["fused_ops"]
    assert profiling.counters["sched_layered"] == 1
    prog = compiler.CompiledProgram(parse_openqasm(VIRTUAL, text))
    state, _, _ = prog.run(seed=1)
    (circ,) = prog._segments.values()
    assert circ.num_passes == passes
    assert np.linalg.norm(TA.complex_from_state(state) - got) <= 1e-6


# -- the plan kept at n = 30, from fusion alone ------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rcs30_keeps_the_layered_plan_in_at_most_90_passes(seed):
    n, prims = prims_of(rcs_text(5, 6, seed))
    assert n == 30 and len(prims) == 1260
    ops = fusion.fuse_scheduled(prims, n, fusion.MAX_BLOCK)
    assert len(ops) <= 90 < len(fusion.fuse(prims, n, fusion.MAX_BLOCK))
    assert profiling.counters == {"sched_layered": 1, "diag_runs": 245}


def test_the_qft30_text_keeps_the_greedy_plan():
    n, prims = prims_of(qft_text(30))
    ops = fusion.fuse_scheduled(prims, n, fusion.MAX_BLOCK)
    assert len(ops) == len(fusion.fuse(prims, n, fusion.MAX_BLOCK)) == 52
    assert profiling.counters == {"sched_greedy": 1}


def test_compiled_circuits_keep_the_greedy_plan():
    """``qft30.compiled``'s circuit (the QFT and its swaps) and the DSL's."""
    with open(os.path.join(ROOT, "qbench", "configs", "qft30.json")) as f:
        body = [Prim(np.asarray(u), tuple(t), d) for u, t, d in qft.body(json.load(f))]
    assert fusion.CompiledCircuit(30, body).num_passes == 8
    assert fusion.CompiledCircuit(30, qft_prims(30)).num_passes == 7
    assert profiling.counters == {}
