"""The goldens of tests/test_interpreter.py re-run against the port's
interpreter, the port's CLI against the JAX package's, and the rule that
the port never imports JAX."""

import io
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qubism_torch import cli as tcli  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.qasm.parser import (  # noqa: E402
    initial_state,
    parse_openqasm,
    parse_openqasm_incremental,
)
from qubism_torch.run.interpreter import Interpreter, run_program, run_program_incremental  # noqa: E402
from qubism_torch.run.progstate import QasmRuntimeError, blank_state  # noqa: E402
from tests.test_interpreter import H, X, cu1, embed  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = os.path.join(ROOT, "examples")


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def run_file(name, seed=0):
    path = os.path.join(EXAMPLES, name)
    with open(path) as f:
        return run_program(parse_openqasm(path, f.read()), seed=seed)


def run_src(src, seed=0, with_qelib=False):
    if with_qelib:
        src = f'include "{EXAMPLES}/qelib1.inc";\n' + src
    return run_program(parse_openqasm("<test>", src), seed=seed)


# -- example goldens ---------------------------------------------------------------


def test_error_correction_deterministic():
    for seed in range(4):
        ps = run_file("errorCorrection.qasm", seed=seed)
        assert str(ps.cregs["c"]) == "000"
        assert str(ps.cregs["syn"]) == "10"


@pytest.mark.parametrize("a,b", [(1, 15), (5, 6)])
def test_ripple_carry_adder(a, b):
    """The Cuccaro adder of rippleCarryAdder.qasm at both operand sets."""
    from qubism_torch.models.circuits import adder_qasm

    if (a, b) == (1, 15):
        ps = run_file("rippleCarryAdder.qasm", seed=1)
        assert str(ps.cregs["ans"]) == "00001"
    else:
        ps = run_program(parse_openqasm(os.path.join(EXAMPLES, "<t>.qasm"),
                                        adder_qasm(4, a, b)), seed=0)
    assert ps.cregs["ans"].to_natural() == a + b


TELEPORT_ONE = """
qreg q[3]; creg c0[1]; creg c1[1]; creg c2[1];
x q[0];
h q[1]; cx q[1],q[2];
cx q[0],q[1]; h q[0];
measure q[0] -> c0[0];
measure q[1] -> c1[0];
if(c0==1) z q[2];
if(c1==1) x q[2];
measure q[2] -> c2[0];
"""


def test_teleportation_deterministic_input():
    for seed in range(8):
        assert str(run_src(TELEPORT_ONE, seed=seed, with_qelib=True).cregs["c2"]) == "1"


def test_teleportation_file_and_statistics():
    ps = run_file("teleportation.qasm", seed=3)
    assert set(ps.cregs) == {"c0", "c1", "c2"}
    ones = sum(int(str(run_file("teleportation.qasm", seed=s).cregs["c2"]))
               for s in range(300))
    assert abs(ones / 300 - math.sin(0.15) ** 2) < 0.035


def test_fourier_amplitudes_vs_dense_oracle():
    src = """
    qreg q[4];
    x q[0]; x q[2];
    h q[0];
    cu1(pi/2) q[1],q[0];
    h q[1];
    cu1(pi/4) q[2],q[0];
    cu1(pi/2) q[2],q[1];
    h q[2];
    cu1(pi/8) q[3],q[0];
    cu1(pi/4) q[3],q[1];
    cu1(pi/2) q[3],q[2];
    h q[3];
    """
    got = run_src(src, with_qelib=True).stvecs["q"].amps
    v = np.zeros(16, dtype=complex)
    v[0] = 1
    seq = [(X, (0,)), (X, (2,)), (H, (0,)), (cu1(math.pi / 2), (1, 0)), (H, (1,)),
           (cu1(math.pi / 4), (2, 0)), (cu1(math.pi / 2), (2, 1)), (H, (2,)),
           (cu1(math.pi / 8), (3, 0)), (cu1(math.pi / 4), (3, 1)),
           (cu1(math.pi / 2), (3, 2)), (H, (3,))]
    for u, t in seq:
        v = embed(u, t, 4) @ v
    assert np.allclose(got, v, atol=1e-6)


def test_inverse_qft_reproducible_and_fourier_runs():
    a = run_file("inverseQFT.qasm", seed=11)
    b = run_file("inverseQFT.qasm", seed=11)
    assert str(a.cregs["c"]) == str(b.cregs["c"]) and a.cregs["c"].size == 4
    assert run_file("fourier.qasm", seed=5).cregs["c"].size == 4


# -- register fusion and semantics ---------------------------------------------------------


def test_lazy_register_fusion():
    ps = run_src("qreg a[1]; qreg b[2]; CX a[0],b[1];")
    assert set(ps.stvecs) == {"a(x)b"}
    assert (ps.qregs["a"].target, ps.qregs["a"].start) == ("a(x)b", 0)
    assert (ps.qregs["b"].target, ps.qregs["b"].start) == ("a(x)b", 1)
    assert ps.stvecs["a(x)b"].n == 3
    ps = run_src("qreg a[2]; qreg b[2]; U(pi,0,pi) a[0];")
    assert set(ps.stvecs) == {"a", "b"}


def test_single_qubit_gate_after_fusion_not_lost():
    src = "qreg a[1]; qreg b[1]; creg m[1]; CX a[0],b[0]; U(pi,0,pi) b[0]; measure b[0] -> m[0];"
    for seed in range(4):
        assert str(run_src(src, seed=seed).cregs["m"]) == "1"


def test_fusion_entangles_correctly():
    src = """qreg a[1]; qreg b[1]; creg ca[1]; creg cb[1];
    U(pi/2,0,pi) a[0]; CX a[0],b[0]; measure a[0] -> ca[0]; measure b[0] -> cb[0];"""
    seen = set()
    for seed in range(16):
        ps = run_src(src, seed=seed)
        pair = (str(ps.cregs["ca"]), str(ps.cregs["cb"]))
        assert pair[0] == pair[1]
        seen.add(pair)
    assert len(seen) == 2


def test_reset_projects_every_bit_to_zero():
    ps = run_src("qreg q[2]; creg c[2]; U(pi,0,pi) q[0]; reset q; measure q -> c;")
    assert str(ps.cregs["c"]) == "00"
    ps = run_src("qreg a[1]; qreg b[2]; creg c[2]; CX a[0],b[0];"
                 "U(pi,0,pi) b[0]; U(pi,0,pi) b[1]; reset b; measure b -> c;")
    assert str(ps.cregs["c"]) == "00"


def test_cx_broadcasting():
    ps = run_src("qreg a[2]; qreg b[2]; creg c[2]; U(pi,0,pi) a[0]; U(pi,0,pi) a[1];"
                 "CX a,b; measure b -> c;")
    assert str(ps.cregs["c"]) == "11"
    ps = run_src("qreg a[1]; qreg b[2]; creg c[2]; U(pi,0,pi) a[0]; CX a[0],b; measure b -> c;")
    assert str(ps.cregs["c"]) == "11"
    ps = run_src("qreg a[2]; qreg b[1]; creg c[1]; U(pi,0,pi) a[0]; CX a,b[0]; measure b -> c;")
    assert str(ps.cregs["c"]) == "1"


def test_cond_lsb_first():
    src = """qreg q[2]; creg c[2]; creg out[1];
    U(pi,0,pi) q[1]; measure q -> c; if(c==2) U(pi,0,pi) q[0]; measure q[0] -> out[0];"""
    ps = run_src(src)
    assert ps.cregs["c"].to_natural() == 2
    assert str(ps.cregs["out"]) == "1"


@pytest.mark.parametrize("src,match", [
    ("qreg a[2]; qreg b[3]; CX a,b;", "different sizes"),
    ("qreg q[2]; creg c[3]; measure q -> c;", "Mismatched size"),
    ("qreg q[2]; creg c[2]; measure q[0] -> c[5];", "out of bounds"),
    ("qreg q[1]; qreg r[1]; gate g a { CX a,r; } g q;", "Could not bind r"),
    ("qreg q[1];\nopaque blackbox x;\nblackbox q[0];", "opaque gate blackbox"),
])
def test_runtime_errors(src, match):
    with pytest.raises(QasmRuntimeError, match=match):
        run_src(src)


def test_runtime_error_carries_line_info():
    with pytest.raises(QasmRuntimeError, match="ERROR on line 3"):
        run_src("qreg a[2];\nqreg b[3];\nCX a,b;")


def test_user_gates():
    ps = run_src("gate flip(t) a { U(t,0,pi) a; } qreg q[1]; creg c[1];"
                 "flip(pi) q[0]; measure q[0] -> c[0];")
    assert str(ps.cregs["c"]) == "1"
    ps = run_src("qreg q[3]; creg c[1]; x q[0]; x q[1]; ccx q[0],q[1],q[2]; measure q[2] -> c[0];",
                 with_qelib=True)
    assert str(ps.cregs["c"]) == "1"


def test_incremental_run_atomic():
    """A failed line leaves the caller's state intact, although the kernels
    update states in place."""
    decl = "qreg q[2]; creg c[1]; U(pi/3,0,0) q[0];"
    ps = run_src(decl)
    _, pstate = parse_openqasm_incremental(initial_state(), decl)
    before = ps.stvecs["q"].amps.copy()
    gen_before = ps.gen.get_state().clone()
    ast, _ = parse_openqasm_incremental(
        pstate, "U(pi/2,0,0) q[1]; CX q[0],q[1]; measure q[0] -> c[0]; "
                "qreg q2[2]; creg c2[3]; measure q2 -> c2;")
    with pytest.raises(QasmRuntimeError):
        run_program_incremental(ast, ps)
    assert np.array_equal(ps.stvecs["q"].amps, before)
    assert torch.equal(ps.gen.get_state(), gen_before)
    assert "q2" not in ps.qregs and set(ps.stvecs) == {"q"}
    ast, _ = parse_openqasm_incremental(pstate, "U(pi,0,pi) q[1];")
    ok = run_program_incremental(ast, ps)
    assert np.array_equal(ps.stvecs["q"].amps, before)
    assert not np.allclose(ok.stvecs["q"].amps, before)


def test_dump_output():
    out = []
    interp = Interpreter(blank_state(0), dump_writer=out.append)
    for s in parse_openqasm("<t>", "qreg q[1]; creg c[1]; :dump;"):
        interp.run_stmt(s)
    dump = "".join(out)
    assert "State Vector q:" in dump
    assert 'QReg q[1] -- targets state vector "q" starting at qubit 0' in dump
    assert "CReg c[1] = 0" in dump


def test_reference_compat_u1_global_phase():
    config.reference_u3_bug = True
    try:
        ps = run_src("qreg q[1]; creg c[1]; U(pi,0,pi) q[0]; U(0,0,pi) q[0]; measure q[0] -> c[0];")
        assert str(ps.cregs["c"]) == "1"
    finally:
        config.reference_u3_bug = False


# -- CLI ---------------------------------------------------------------------------------


#: examples/adder_bench_*.qasm are leftovers of bench.py (28-qubit adders,
#: ~40 s each on the CPU); chip_smoke.py runs that size on the card
@pytest.mark.parametrize("name", sorted(f for f in os.listdir(EXAMPLES)
                                        if f.endswith(".qasm") and not f.startswith("adder_bench")))
def test_eval_file_examples(name):
    out = io.StringIO()
    assert tcli.eval_file(os.path.join(EXAMPLES, name), seed=1, out=out, shots=64) == 0
    assert out.getvalue().rstrip().endswith("Done.")


@pytest.mark.parametrize("name,seed", [("rippleCarryAdder.qasm", 0),
                                       ("errorCorrection.qasm", 2)])
def test_dump_state_equals_jax(name, seed):
    from qubism_tpu import cli as jcli

    path = os.path.join(EXAMPLES, name)
    want, got = io.StringIO(), io.StringIO()
    assert jcli.eval_file(path, seed=seed, dump_state=True, out=want) == 0
    assert tcli.eval_file(path, seed=seed, dump_state=True, out=got) == 0
    # where an amplitude is exactly 0 both engines leave float32 round-off
    # of ~1e-17 whose sign depends on the order of operations, and the
    # "% 6.4f" dump prints it as "-0.0000" or " 0.0000"
    assert (got.getvalue().replace("-0.0000", " 0.0000")
            == want.getvalue().replace("-0.0000", " 0.0000"))


def test_eval_file_virtual_source_and_errors():
    out = io.StringIO()
    seen = []
    src = 'include "qelib1.inc"; qreg q[2]; creg c[2]; h q[0]; cx q[0],q[1]; measure q -> c;'
    assert tcli.eval_file(os.path.join(EXAMPLES, "<virtual>.qasm"), source=src, out=out,
                          inspect=seen.append) == 0
    assert str(seen[0].cregs["c"]) in ("00", "11")
    out = io.StringIO()
    assert tcli.eval_file("<t>", source="qreg q[1]; U(0,0,0) r[0];", out=out) == 1
    assert "Undeclared identifier: r" in out.getvalue()
    out = io.StringIO()
    assert tcli.eval_file("<t>", source="qreg a[2]; qreg b[3]; CX a,b;", out=out) == 1
    assert "different sizes" in out.getvalue()
    config.device = "cuda"
    if not torch.cuda.is_available():
        out = io.StringIO()
        assert tcli.eval_file("<t>", source="qreg q[1];", out=out) == 2
        assert "QUBISM_TORCH_DEVICE=cpu" in out.getvalue()


def test_main_flags(capsys, monkeypatch):
    path = os.path.join(EXAMPLES, "rippleCarryAdder.qasm")
    assert tcli.main([path, "--seed", "1", "--dump-state"]) == 0
    assert "CReg ans[5] = 00001" in capsys.readouterr().out
    assert tcli.main([path, "--no-such-flag"]) == 2
    assert "not ported yet" in capsys.readouterr().err
    # the mps backend is ported: the adder's registers through the MPS engine
    assert tcli.main([path, "--seed", "1", "--backend", "mps", "--chi", "4", "--dump-state"]) == 0
    out = capsys.readouterr().out
    assert "Dump of the internal state (mps backend)" in out and "CReg ans[5] = 00001" in out
    # trajectory mode is ported: counts over the classical registers
    for argv, ntraj in (([path, "--trajectories", "8"], 8), ([path, "--noise", "dep:0.1"], 512)):
        assert tcli.main(argv) == 0
        out = capsys.readouterr().out
        assert out.startswith(f"Counts over classical registers ({ntraj} trajectories):")
        assert out.endswith("Done.\n")
    with pytest.raises(SystemExit, match="complex128 amplitudes are not supported"):
        tcli.main([path, "--dtype", "complex128"])
    assert tcli.main([path, "--observable", "ZZ"]) == 2  # the adder declares 10 qubits
    assert "qubism: --observable: Pauli string must be 10 chars" in capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.StringIO("qreg q[1];\n:obs Z\n:q\n"))
    assert tcli.main([]) == 0  # no file: the REPL
    assert capsys.readouterr().out == "QASM> QASM> <Z> = 1.000000\nQASM> "


def test_package_imports_no_jax():
    code = ("import sys, qubism_torch, qubism_torch.cli, qubism_torch.ops.kernels, "
            "qubism_torch.ops.fusion, qubism_torch.ops.build, qubism_torch.models.circuits, "
            "qubism_torch.run.compiler, qubism_torch.session, qubism_torch.core.algebra, "
            "qubism_torch.parallel; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
            "assert not any(m.startswith('qubism_tpu') for m in sys.modules)")
    env = dict(os.environ, QUBISM_TORCH_DEVICE="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
