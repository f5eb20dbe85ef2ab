"""The port's compiled program path (``CompiledProgram``, ``--compile``)
against its own interpreter and the JAX package's ``CompiledProgram``, after
tests/test_compiler.py: the example goldens, mid-circuit measurement, reset,
``if``, measure coalescing, ``--dump-state`` text and the CLI flags.

Random outcomes are never compared draw for draw across the packages (jax
threefry against torch's generator): deterministic programs are compared
exactly, the port's compiled path against the port's interpreter under one
seed, and sampled counts against the JAX state's Born probabilities with
``chi2_test``. Amplitudes: L2 <= 1e-5."""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qubism_torch import cli as tcli  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm  # noqa: E402
from qubism_torch.run.compiler import CompiledProgram, EvCond, EvGates, EvMeasure  # noqa: E402
from qubism_torch.run.interpreter import run_program  # noqa: E402
from qubism_torch.run.progstate import QasmRuntimeError  # noqa: E402
from qubism_torch.utils.stats import chi2_test  # noqa: E402

EXAMPLES = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "examples"))


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def parse_file(name, parser=parse_openqasm):
    path = os.path.join(EXAMPLES, name)
    with open(path) as f:
        return parser(path, f.read())


def parse_src(src, with_qelib=True, parser=parse_openqasm):
    if with_qelib:
        src = f'include "{EXAMPLES}/qelib1.inc";\n' + src
    return parser("<test>", src)


def jax_compiled(src=None, name=None, seed=0):
    """The JAX package's CompiledProgram on the same text: (amps, cregs)."""
    from qubism_tpu.ops.apply import complex_from_planar
    from qubism_tpu.qasm.parser import parse_openqasm as jparse
    from qubism_tpu.run.compiler import CompiledProgram as JProgram

    ast = parse_file(name, jparse) if name else parse_src(src, parser=jparse)
    state, cregs, _ = JProgram(ast).run(seed=seed)
    return complex_from_planar(state), {k: str(v) for k, v in cregs.items()}


def test_error_correction_compiled():
    prog = CompiledProgram(parse_file("errorCorrection.qasm"))
    want_amps, want_cregs = jax_compiled(name="errorCorrection.qasm")
    for seed in range(4):
        state, cregs, _ = prog.run(seed=seed)
        assert str(cregs["c"]) == "000" and str(cregs["syn"]) == "10"
        assert {k: str(v) for k, v in cregs.items()} == want_cregs
        assert np.linalg.norm(TA.complex_from_state(state) - want_amps) < 1e-5


def test_adder_compiled():
    prog = CompiledProgram(parse_file("rippleCarryAdder.qasm"))
    state, cregs, _ = prog.run(seed=0)
    assert cregs["ans"].to_natural() == 16
    want_amps, want_cregs = jax_compiled(name="rippleCarryAdder.qasm")
    assert str(cregs["ans"]) == want_cregs["ans"]
    assert np.linalg.norm(TA.complex_from_state(state) - want_amps) < 1e-5


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


def test_teleportation_compiled_deterministic():
    prog = CompiledProgram(parse_src(TELEPORT_ONE))
    for seed in range(6):
        _, cregs, _ = prog.run(seed=seed)
        assert str(cregs["c2"]) == "1"


def test_compiled_matches_interpreter_and_jax_amplitudes():
    """Measurement-free, multi-register: the compiled layout (a then b)
    equals the interpreter's fused "a(x)b" vector and JAX's compiled state."""
    src = """
    qreg a[2]; qreg b[2];
    h a[0];
    cx a[0],b[1];
    cu1(pi/4) a[1],b[0];
    x b[0];
    """
    ast = parse_src(src)
    ref = run_program(ast, seed=0).stvecs["a(x)b"].amps
    prog = CompiledProgram(ast)
    assert prog.name == "a(x)b"
    state, _, _ = prog.run(seed=0)
    got = TA.complex_from_state(state)
    assert np.linalg.norm(got - ref) < 1e-5
    assert np.linalg.norm(got - jax_compiled(src)[0]) < 1e-5


def test_compiled_same_outcomes_as_interpreter():
    """Same seed: the compiled path draws the generator in the interpreter's
    order, so the outcomes are identical."""
    ast = parse_file("inverseQFT.qasm")
    prog = CompiledProgram(ast)
    for seed in (0, 1, 7, 42):
        _, cregs, _ = prog.run(seed=seed)
        assert str(cregs["c"]) == str(run_program(ast, seed=seed).cregs["c"])
    ast = parse_file("teleportation.qasm")
    prog = CompiledProgram(ast)
    for seed in range(4):
        _, cregs, _ = prog.run(seed=seed)
        ps = run_program(ast, seed=seed)
        assert {k: str(v) for k, v in cregs.items()} == {k: str(v) for k, v in ps.cregs.items()}


def test_conditional_measure_in_compiled_mode():
    src = """
    qreg q[2]; creg c[1]; creg out[1];
    x q[0];
    measure q[0] -> c[0];
    if(c==1) measure q[1] -> out[0];
    """
    _, cregs, _ = CompiledProgram(parse_src(src)).run(seed=0)
    assert str(cregs["c"]) == "1" and str(cregs["out"]) == "0"


def test_reset_in_compiled_mode():
    src = "qreg q[2]; creg c[2]; x q[0]; x q[1]; reset q[0]; measure q -> c;"
    state, cregs, _ = CompiledProgram(parse_src(src)).run(seed=0)
    assert str(cregs["c"]) == "01"
    want_amps, want_cregs = jax_compiled(src)
    assert want_cregs["c"] == "01"
    assert np.linalg.norm(TA.complex_from_state(state) - want_amps) < 1e-5


def test_event_stream_structure():
    src = """
    qreg q[2]; creg c[2];
    h q[0]; cx q[0],q[1];
    measure q[0] -> c[0];
    if(c==1) x q[1];
    h q[1];
    """
    prog = CompiledProgram(parse_src(src))
    assert [type(e).__name__ for e in prog.events] == ["EvGates", "EvMeasure", "EvCond", "EvGates"]
    cond = prog.events[2]
    assert isinstance(cond, EvCond) and len(cond.body) == 1
    assert isinstance(cond.body[0], EvGates)


def test_compiled_runtime_errors_surface():
    with pytest.raises(QasmRuntimeError, match="different sizes"):
        CompiledProgram(parse_src("qreg a[2]; qreg b[3]; CX a,b;", with_qelib=False))
    with pytest.raises(QasmRuntimeError, match="Mismatched size"):
        CompiledProgram(parse_src("qreg q[2]; creg c[3]; measure q -> c;"))


def test_compiled_dump():
    out = []
    CompiledProgram(parse_src("qreg a[1]; qreg b[1]; creg c[1]; h a[0]; :dump;")).run(
        seed=0, dump_writer=out.append)
    dump = "".join(out)
    assert "Dump of the internal state" in dump and "a(x)b" in dump


def test_adjacent_measures_coalesce_into_one_event():
    src = """
    qreg q[3]; creg c[3]; creg d[1];
    x q[0]; x q[2];
    measure q[0] -> c[0];
    measure q[1] -> c[1];
    measure q[2] -> d[0];
    """
    prog = CompiledProgram(parse_src(src))
    measures = [e for e in prog.events if isinstance(e, EvMeasure)]
    assert len(measures) == 1
    assert measures[0].qubits == (0, 1, 2)
    assert [w[0] for w in measures[0].writes] == ["c", "c", "d"]
    _, cregs, _ = prog.run(seed=0)
    assert cregs["c"][0] == 1 and cregs["c"][1] == 0 and cregs["d"][0] == 1


@pytest.mark.parametrize("name,seed", [("rippleCarryAdder.qasm", 0),
                                       ("errorCorrection.qasm", 2)])
def test_compile_dump_state_equals_jax(name, seed):
    from qubism_tpu import cli as jcli

    path = os.path.join(EXAMPLES, name)
    want, got = io.StringIO(), io.StringIO()
    assert jcli.eval_file(path, seed=seed, dump_state=True, out=want, compile_mode=True) == 0
    assert tcli.eval_file(path, seed=seed, dump_state=True, out=got, compile_mode=True) == 0
    # exact zeros print as "-0.0000" or " 0.0000" after float32 round-off
    # of either sign (tests/test_torch_interpreter.py)
    assert (got.getvalue().replace("-0.0000", " 0.0000")
            == want.getvalue().replace("-0.0000", " 0.0000"))


def test_cli_compile_flags(tmp_path, capsys):
    path = os.path.join(EXAMPLES, "errorCorrection.qasm")
    assert tcli.main([path, "--seed", "0", "--compile"]) == 0
    assert capsys.readouterr().out.strip().endswith("Done.")
    assert tcli.main([path, "--seed", "0", "--compile", "--fuse-width", "2",
                      "--dump-state"]) == 0
    out = capsys.readouterr().out
    assert "CReg c[3] = 000" in out and "CReg syn[2] = 10" in out
    f = tmp_path / "ghz.qasm"
    f.write_text("qreg q[3]; U(pi/2,0,pi) q[0]; CX q[0],q[1]; CX q[1],q[2];")
    assert tcli.main([str(f), "--compile", "--shots", "64", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert "Counts for state vector q (64 shots):" in out
    counts = [line.strip() for line in out.splitlines() if line.strip().startswith("|")]
    assert counts and all(c.startswith(("|000>", "|111>")) for c in counts)
    assert tcli.main([str(f), "--compile", "--observable", "ZZI", "--observable", "XXX"]) == 0
    assert capsys.readouterr().out == "<ZZI> = 1.000000\n<XXX> = 1.000000\nDone.\n"
    assert tcli.main([path, "--compile", "--observable", "ZZ"]) == 2  # 5 qubits declared
    assert "qubism: --observable: Pauli string must be 5 chars" in capsys.readouterr().out
    assert tcli.main([path, "--compile", "--trajectories", "4"]) == 2
    assert capsys.readouterr().out == ("qubism: --noise/--trajectories is its own execution "
                                       "mode; drop --compile\n")


def test_compile_shots_follow_born_rule():
    """--compile --shots counts against the Born probabilities of the JAX
    package's compiled state (chi2 at alpha = 1e-3)."""
    body = """qreg q[3];
    u3(0.7,0.2,1.1) q[0]; u3(1.9,0.4,0.3) q[1]; cx q[0],q[2]; u3(0.5,2.0,0.1) q[2];"""
    amps, _ = jax_compiled(body)
    src = 'include "qelib1.inc";\n' + body
    probs = np.abs(amps) ** 2
    out = io.StringIO()
    assert tcli.eval_file(os.path.join(EXAMPLES, "<born>.qasm"), source=src, seed=4,
                          shots=4096, out=out, compile_mode=True) == 0
    observed = np.zeros(8)
    for line in out.getvalue().splitlines():
        line = line.strip()
        if line.startswith("|"):
            bits, c = line[1:].split(">:")
            observed[int(bits, 2)] += int(c)
    assert observed.sum() == 4096
    res = chi2_test(observed, probs)
    assert bool(res), res


def test_compile_inspect_sees_one_state_vector():
    seen = []
    src = "qreg a[1]; qreg b[2]; creg c[3]; U(pi,0,pi) b[1]; measure a[0] -> c[0];"
    assert tcli.eval_file("<t>", source=src, out=io.StringIO(), inspect=seen.append,
                          compile_mode=True) == 0
    ps = seen[0]
    assert set(ps.stvecs) == {"a(x)b"} and ps.stvecs["a(x)b"].n == 3
    assert (ps.qregs["b"].target, ps.qregs["b"].start, ps.qregs["b"].size) == ("a(x)b", 1, 2)
    assert abs(ps.stvecs["a(x)b"].amps[0b001]) == pytest.approx(1.0, abs=1e-6)
