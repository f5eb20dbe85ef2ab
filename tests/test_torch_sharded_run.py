"""The port's mesh path through the compiler and the CLI
(``CompiledProgram.run_sharded``, ``--mesh D``) on CPU meshes: against the
port's own single-device ``CompiledProgram.run`` at the same seed (the two
draw the same uniforms, so cregs and states must agree), and against the
JAX package's ``run_sharded`` on deterministic programs
(tests/test_compiler.py, tests/test_cli.py). Amplitudes: relative L2 <=
1e-5."""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch import cli as tcli  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.models.circuits import ghz_qasm  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.parallel import mesh as tmesh  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm  # noqa: E402
from qubism_torch.run.compiler import CompiledProgram  # noqa: E402

EXAMPLES = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "examples"))
GOLDENS = ("errorCorrection", "teleportation", "rippleCarryAdder", "fourier", "grover")


@pytest.fixture(autouse=True)
def modes():
    JK.INTERPRET = True
    old = config.device
    config.device = "cpu"
    yield
    JK.INTERPRET = False
    config.device = old


def read(name):
    with open(os.path.join(EXAMPLES, f"{name}.qasm")) as f:
        return f.read()


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("name", GOLDENS + ("ghz10",))
def test_run_sharded_matches_single_device(name):
    if name == "ghz10":
        src, path = ghz_qasm(10, measure=True), os.path.join(EXAMPLES, "<ghz10>.qasm")
    else:
        src, path = read(name), os.path.join(EXAMPLES, f"{name}.qasm")
    prog = CompiledProgram(parse_openqasm(path, src))
    for seed, mesh, banks in ((0, 8, None), (3, 2, 1 if prog.n >= 4 else 0)):
        state, cregs, _ = prog.run(seed=seed)
        sim, scregs, _ = prog.run_sharded(mesh=mesh, seed=seed, banks=banks)
        assert {k: str(v) for k, v in scregs.items()} == {k: str(v) for k, v in cregs.items()}
        assert sim.D == min(mesh, 1 << (prog.n - 2))
        assert rel(sim.amplitudes(), TA.complex_from_state(state)) <= 1e-5, (name, seed)


def test_run_sharded_matches_jax_on_deterministic_programs():
    from qubism_tpu.qasm.parser import parse_openqasm as jparse
    from qubism_tpu.run.compiler import CompiledProgram as JProgram

    path = os.path.join(EXAMPLES, "errorCorrection.qasm")
    for seed in (0, 3):
        _, cregs, _ = JProgram(jparse(path, read("errorCorrection"))).run_sharded(mesh=8, seed=seed)
        sim, tcregs, _ = CompiledProgram(parse_openqasm(path, read("errorCorrection"))).run_sharded(
            mesh=8, seed=seed)
        assert {k: str(v) for k, v in tcregs.items()} == {k: str(v) for k, v in cregs.items()} \
            == {"c": "000", "syn": "10"}

    src = (f'include "{EXAMPLES}/qelib1.inc";\n'
           "qreg q[4]; h q[0]; cx q[0],q[1]; cu1(pi/2) q[2],q[1];")
    jsim, _, _ = JProgram(jparse("<t>", src)).run_sharded(mesh=4, seed=0)
    sim, _, _ = CompiledProgram(parse_openqasm("<t>", src)).run_sharded(mesh=4, seed=0)
    assert sim.D == jsim.D == 4 and sim.perm == jsim.perm
    assert rel(sim.amplitudes(), jsim.amplitudes()) <= 1e-5


def test_mesh_flag(capsys):
    assert tcli.main([os.path.join(EXAMPLES, "errorCorrection.qasm"),
                      "--mesh", "8", "--seed", "0", "--dump-state"]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("Done.")
    assert "CReg c[3] = 000" in out and "CReg syn[2] = 10" in out
    assert 'targets state vector "q(x)a"' in out


def test_mesh_flag_with_shots(tmp_path, capsys):
    f = tmp_path / "ghz.qasm"
    f.write_text("qreg q[3]; U(pi/2,0,pi) q[0]; CX q[0],q[1]; CX q[1],q[2];")
    assert tcli.main([str(f), "--mesh", "4", "--shots", "32", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert "Counts for state vector q (32 shots):" in out
    counts = [line.strip() for line in out.splitlines() if line.strip().startswith("|")]
    assert counts and all(c.startswith(("|000>", "|111>")) for c in counts)
    assert sum(int(c.split(":")[1]) for c in counts) == 32


def test_mesh_flag_verbose_and_inspect(tmp_path, capsys):
    from qubism_torch.utils import profiling

    f = tmp_path / "ghz.qasm"
    f.write_text("qreg q[6]; creg c[6]; U(pi/2,0,pi) q[0]; CX q[0],q[1]; measure q -> c;")
    seen = []
    old = profiling.VERBOSE
    profiling.VERBOSE = True
    try:
        assert tcli.eval_file(str(f), seed=2, mesh=4, inspect=seen.append) == 0
    finally:
        profiling.VERBOSE = old
    assert "mesh run: 4 device(s) x 2^0 bank(s), 4 local qubits/bank" in capsys.readouterr().err
    (ps,) = seen
    assert not ps.stvecs and str(ps.cregs["c"]) in ("000000", "110000")


def test_mesh_flag_errors(tmp_path, capsys, monkeypatch):
    f = tmp_path / "ghz.qasm"
    f.write_text("qreg q[4]; U(pi/2,0,pi) q[0]; CX q[0],q[1];")
    assert tcli.main([str(f), "--mesh", "2", "--observable", "ZZII"]) == 0
    assert capsys.readouterr().out == "<ZZII> = 1.000000\nDone.\n"
    assert tcli.main([str(f), "--mesh", "2", "--observable", "ZZ"]) == 2
    assert "qubism: --observable: Pauli string must be 4 chars" in capsys.readouterr().out
    # --traj-engine alone starts no trajectory run (as in the JAX CLI)
    assert tcli.main([str(f), "--mesh", "2", "--traj-engine", "vmap"]) == 0
    assert capsys.readouterr().out == "Done.\n"
    assert tcli.main([str(f), "--mesh", "3"]) == 2
    assert "power of two" in capsys.readouterr().out
    # on CUDA, a mesh of more GPUs than the machine has exits 2: no fallback
    monkeypatch.setattr(config, "device", "cuda")
    monkeypatch.setattr(TA, "device", lambda: torch.device("cpu"))
    monkeypatch.setattr(tmesh.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 1)
    out = io.StringIO()
    assert tcli.eval_file(str(f), mesh=4, out=out) == 2
    assert "--mesh 4: requested 4 devices, have 1" in out.getvalue()
    assert "Done." not in out.getvalue()
