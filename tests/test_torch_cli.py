"""The port's CLI and REPL against the JAX package's: ``--observable`` on
the four execution modes, unfused registers, ``--dtype``, the REPL
transcripts of tests/test_cli.py (the same input lines to both ``Repl``s,
the same output text up to the sign of printed zeros), the atomic failed
line with the kept state tensor unchanged bit for bit, every flag of the
JAX CLI run through both CLIs, trajectory mode (``--noise``,
``--trajectories``, ``--traj-engine``, ``--observable`` as mean +- stderr,
``--mesh``), ``--backend stabilizer`` (file mode with ``--shots`` /
``--dump-state`` / ``--observable``, noisy Clifford trajectories, and its
exit codes) and ``--backend mps`` with ``--chi``, ``--trunc-budget`` and
``--max-chi`` (the dump, shots, observables, MPS trajectories and every
refusal) against the JAX CLI's text and messages. Numbers the MPS dump
prints (norm, trunc_error, bond entropies) are held within 1e-4, the rest
word for word; counts drawn from each package's own random stream are held
by their format, total and the program's law."""

import io
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch import cli as tcli  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_tpu import cli as jcli  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = os.path.join(ROOT, "examples")
BELL = ("qreg q[2];\nU(1.5707963267948966, 0, 3.141592653589793) q[0];\nCX q[0], q[1];\n")


@pytest.fixture(autouse=True)
def modes(monkeypatch):
    JK.INTERPRET = True
    monkeypatch.setattr(config, "device", "cpu")
    yield
    JK.INTERPRET = False


def eval_both(path, **kw):
    out = []
    for mod in (tcli, jcli):
        buf = io.StringIO()
        out.append((mod.eval_file(str(path), out=buf, **kw), buf.getvalue()))
    return out


def unsigned_zeros(text):
    """The text with the sign of printed zeros dropped: ``<P> = -0.000000``
    and the dump's ``-0.0000`` (a column of width 7)."""
    text = re.sub(r"= -(0\.0+)$", r"= \1", text, flags=re.M)
    return re.sub(r"-(0\.0000)(?!\d)", r" \1", text)


def transcript(lines, **kw):
    """The same lines through both REPLs: (port repl, jax repl, port text,
    jax text)."""
    touts, jouts = io.StringIO(), io.StringIO()
    tr, jr = tcli.Repl(seed=0, out=touts, **kw), jcli.Repl(seed=0, out=jouts, **kw)
    for text in lines:
        assert tr.line(text) == jr.line(text), text
    return tr, jr, touts.getvalue(), jouts.getvalue()


def same_transcript(lines, **kw):
    tr, jr, tout, jout = transcript(lines, **kw)
    assert unsigned_zeros(tout) == unsigned_zeros(jout)
    return tr, jr, tout


# -- --observable ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"compile_mode": True}, {"mesh": 2},
                                {"backend": "density"}, {"backend": "mps", "chi": 4}],
                         ids=["file", "compile", "mesh", "density", "mps"])
def test_observable_flag_all_modes(kw, tmp_path):
    f = tmp_path / "bell.qasm"
    f.write_text(BELL)
    (rc, out), (jrc, jout) = eval_both(f, seed=0, observables=["ZZ", "xx", "ZI", "YY"], **kw)
    assert rc == jrc == 0
    vals = dict(re.findall(r"<(\w+)> = (-?\d+\.\d+)", out))
    assert abs(float(vals["ZZ"]) - 1.0) < 1e-5 and abs(float(vals["XX"]) - 1.0) < 1e-5
    assert abs(float(vals["ZI"])) < 1e-5 and abs(float(vals["YY"]) + 1.0) < 1e-5
    assert unsigned_zeros(out) == unsigned_zeros(jout)


@pytest.mark.parametrize("kw", [{}, {"compile_mode": True}, {"mesh": 2}],
                         ids=["file", "compile", "mesh"])
def test_observable_flag_bad_string(kw, tmp_path):
    f = tmp_path / "bell.qasm"
    f.write_text(BELL)
    (rc, out), (jrc, jout) = eval_both(f, observables=["ZZ", "ZZZ"], **kw)
    assert rc == jrc == 2 and out == jout
    assert "qubism: --observable: Pauli string must be 2 chars of I/X/Y/Z: 'ZZZ'" in out
    assert "Done." not in out


def test_observable_flag_unfused_registers(tmp_path):
    """The file path: <P> factorizes over the lazily fused clusters."""
    f = tmp_path / "two.qasm"
    f.write_text("qreg a[1]; qreg b[1];\nU(3.141592653589793, 0, 3.141592653589793) a[0];\n")
    (rc, out), (jrc, jout) = eval_both(f, seed=0, observables=["ZZ", "ZI", "IZ"])
    assert rc == jrc == 0 and out == jout
    assert "<ZZ> = -1.000000" in out and "<ZI> = -1.000000" in out and "<IZ> = 1.000000" in out


def test_observable_on_a_program_without_qubits(tmp_path):
    f = tmp_path / "none.qasm"
    f.write_text("creg c[1];\n")
    for kw in ({}, {"compile_mode": True}):
        (rc, out), (jrc, jout) = eval_both(f, observables=["Z"], **kw)
        assert rc == jrc == 0 and out == jout == "Done.\n"


def test_main_observable_flag_is_repeatable(capsys):
    path = os.path.join(EXAMPLES, "errorCorrection.qasm")
    assert tcli.main([path, "--seed", "2", "--observable", "ZZIII", "--observable", "iizzi",
                      "--compile"]) == 0
    out = capsys.readouterr().out
    assert "<ZZIII> = " in out and "<IIZZI> = " in out and out.endswith("Done.\n")


# -- --dtype ---------------------------------------------------------------------


def test_dtype_flag(capsys):
    path = os.path.join(EXAMPLES, "teleportation.qasm")
    assert tcli.main([path, "--dtype", "complex64", "--seed", "1"]) == 0
    assert capsys.readouterr().out == "Done.\n"
    with pytest.raises(SystemExit) as te:
        tcli.main([path, "--dtype", "complex128"])
    with pytest.raises(SystemExit) as je:
        jcli.main([path, "--dtype", "complex128"])
    start = "qubism: complex128 amplitudes are not supported"
    assert str(te.value).startswith(start) and str(je.value).startswith(start)
    assert "float2" in str(te.value) and "TPU" not in str(te.value)
    with pytest.raises(SystemExit):  # argparse refuses any other precision
        tcli.main([path, "--dtype", "float16"])


# -- every flag of the JAX CLI through both CLIs ---------------------------------------


def counts_block(text):
    """(header line, {row: count}, the lines after the block) of a trajectory
    run's output."""
    lines = text.splitlines()
    head = lines[0]
    rows = {}
    i = 1
    while i < len(lines) and lines[i].startswith("  "):
        row, _, c = lines[i].strip().rpartition(": ")
        rows[row] = int(c)
        i += 1
    return head, rows, lines[i:]


#: every row runs both CLIs (``named`` labels the flags that were the last
#: to be ported, the mps backend's) and holds the port's output against the
#: JAX CLI's: the counts come from each package's own random stream, so the
#: rows are held by their format and total, and the text otherwise word for
#: word
@pytest.mark.parametrize("argv,named", [
    (["--backend", "mps"], "--backend mps"),
    (["--noise", "dep:0.1"], None),
    (["--trajectories", "16"], None), (["--traj-engine", "fused"], None),
    (["--chi", "8"], "--chi"), (["--trunc-budget", "1e-6"], "--trunc-budget"),
    (["--max-chi", "64"], "--max-chi"),
    (["--backend", "density", "--trajectories", "4"], None)])
def test_unported_flags_exit_2(argv, named, capsys):
    path = os.path.join(EXAMPLES, "teleportation.qasm")
    jcli.build_arg_parser().parse_args([path] + argv)  # the JAX CLI knows the flag
    trc = tcli.main([path, "--seed", "3"] + argv)
    ours = capsys.readouterr()
    jrc = jcli.main([path, "--seed", "3"] + argv)
    theirs = capsys.readouterr()
    assert trc == jrc and ours.err == theirs.err == ""
    if not ours.out.startswith("Counts over"):
        assert ours.out == theirs.out  # no trajectory run, or a refusal
        return
    (th, trows, ttail), (jh, jrows, jtail) = counts_block(ours.out), counts_block(theirs.out)
    assert th == jh and ttail == jtail == ["Done."]
    want = int(argv[1]) if argv[0] == "--trajectories" else 512
    assert sum(trows.values()) == sum(jrows.values()) == want
    assert all(re.fullmatch(r"c0=[01] c1=[01] c2=[01]", r) for r in trows)


# -- trajectory mode -------------------------------------------------------------


NO_CREG = "qreg q[2];\nU(0.3, 0, 0) q[0];\nCX q[0], q[1];\n"


@pytest.mark.parametrize("src,kw", [
    (BELL, dict(noise="dep:0.1", compile_mode=True)),
    (BELL, dict(noise="dep:0.1")),
    (BELL + "creg c[2];\nmeasure q -> c;\n", dict(noise="dep:0.1", mesh=2, traj_engine="fused")),
    (BELL + "creg c[2];\nmeasure q -> c;\n", dict(noise="nope:0.1")),
    (BELL + "creg c[2];\nmeasure q -> c;\n", dict(noise="dep:0.1@r[0]")),
    (BELL + "creg c[2];\nmeasure q[0] -> c[0];\nmeasure q[0] -> c[1];\nU(0.1,0,0) q[1];\n",
     dict(noise="dep:0.1", traj_engine="fused")),
    (BELL + "creg c[2];\nmeasure q -> c;\n", dict(noise="dep:0.1", observables=["ZZZ"])),
], ids=["compile", "no creg", "fused mesh", "unknown channel", "bad target", "fused refuses",
        "bad observable"])
def test_trajectory_mode_messages_match_jax(src, kw, tmp_path):
    f = tmp_path / "t.qasm"
    f.write_text(src)
    (trc, tout), (jrc, jout) = eval_both(f, seed=1, **kw)
    assert trc == jrc != 0
    if "observables" in kw:  # the counts come first, each engine's own
        tout, jout = tout.splitlines()[-1], jout.splitlines()[-1]
    assert tout == jout


def test_trajectory_observables_and_mesh(tmp_path):
    f = tmp_path / "t.qasm"
    f.write_text(NO_CREG)
    (trc, tout), (jrc, jout) = eval_both(f, seed=2, noise="dep:0.05", trajectories=64,
                                         observables=["ZZ", "xi"])
    assert trc == jrc == 0
    pat = r"<ZZ> = -?\d\.\d{6} \+- \d\.\d{6}\n<XI> = -?\d\.\d{6} \+- \d\.\d{6}\nDone\.\n"
    assert re.fullmatch(pat, tout) and re.fullmatch(pat, jout)
    # the mesh splits the batch: the same text
    buf = io.StringIO()
    assert tcli.eval_file(str(f), seed=2, noise="dep:0.05", trajectories=64,
                          observables=["ZZ", "xi"], mesh=4, out=buf) == 0
    assert buf.getvalue() == tout
    # the fused engine prints the same block as the vmapped one
    path = os.path.join(EXAMPLES, "teleportation.qasm")
    for engine in ("fused", "auto"):
        buf = io.StringIO()
        assert tcli.eval_file(path, seed=1, noise="dep:0.01", trajectories=64,
                              traj_engine=engine, out=buf) == 0
        head, rows, tail = counts_block(buf.getvalue())
        assert head == "Counts over classical registers (64 trajectories):"
        assert sum(rows.values()) == 64 and tail == ["Done."]


def test_eval_file_refuses_unported_engines(tmp_path):
    """No engine is refused any more: --backend mps runs as the JAX CLI runs
    it (with ``source=`` too), and a trajectory program with no creg and no
    observable is refused as the JAX CLI refuses it."""
    f = tmp_path / "t.qasm"
    f.write_text("qreg q[1];\nU(pi, 0, pi) q[0];\n")
    (trc, tout), (jrc, jout) = eval_both(f, backend="mps", dump_state=True, chi=2)
    assert trc == jrc == 0 and tout == jout and tout.endswith("Done.\n")
    out = io.StringIO()
    assert tcli.eval_file("<t>", source=f.read_text(), out=out, backend="mps", chi=2,
                          dump_state=True) == 0
    assert out.getvalue() == tout
    (trc, tout), (jrc, jout) = eval_both(f, noise="dep:0.1")
    assert trc == jrc == 2 and tout == jout
    assert tout.startswith("qubism: trajectory mode reports classical-register counts")
    for backend in ("mps", "stabilizer"):
        (trc, tout), (jrc, jout) = eval_both(f, noise="dep:0.1", backend=backend)
        assert trc == jrc == 2 and tout == jout


# -- --backend mps (tests/test_cli.py's mps cases) ----------------------------------------


def numbers(text):
    """The text with its decimal numbers cut out, and the numbers."""
    pat = r"-?\d+\.\d+(?:e[-+]\d+)?"
    return re.sub(pat, "#", text), [float(x) for x in re.findall(pat, text)]


def same_dump(tout, jout, tol=1e-4):
    """Word for word but the numbers, which agree within ``tol``."""
    (ttext, tnum), (jtext, jnum) = numbers(tout), numbers(jout)
    assert ttext == jtext
    assert len(tnum) == len(jnum) and all(abs(a - b) <= tol for a, b in zip(tnum, jnum))


BELL_MEASURED = "qreg q[2]; creg c[2];\nU(pi/2,0,pi) q[0]; CX q[0],q[1];\nmeasure q -> c;\n"


def test_mps_backend_flag(tmp_path):
    """A measured Bell pair at --chi 4 with --dump-state and --shots: each
    package's outcome is its own draw, so the creg and the counts row are
    held by the law (all 64 shots on the measured outcome), the rest of the
    dump word for word with its numbers within 1e-4."""
    f = tmp_path / "bell.qasm"
    f.write_text(BELL_MEASURED)
    outs = eval_both(f, seed=0, backend="mps", shots=64, dump_state=True, chi=4)
    for rc, out in outs:
        assert rc == 0 and out.endswith("Done.\n")
        assert "mps backend" in out and "chi=4" in out
        bit = re.search(r"CReg c\[2\] = (00|11)", out).group(1)
        assert f"  |{bit}>: 64\n" in out
    (_, tout), (_, jout) = outs
    mask = lambda t: re.sub(r"(= |\|)(00|11)", r"\1bb", t)  # noqa: E731
    same_dump(mask(tout), mask(jout))


def test_mps_backend_nonclifford_ok(tmp_path):
    """T gates run on the MPS backend: |<0|HTH|0>|^2 = cos^2(pi/8) ~ 0.854
    of 200 shots (the reference's > 130), in both CLIs' formats."""
    f = tmp_path / "t.qasm"
    f.write_text("qreg q[1];\nU(pi/2,0,pi) q[0]; U(0,0,pi/4) q[0]; U(pi/2,0,pi) q[0];\n")
    for rc, out in eval_both(f, seed=0, backend="mps", shots=200, chi=2):
        head, rows, tail = counts_block(out)
        assert rc == 0 and head == "Counts for state vector q (200 shots):" and tail == ["Done."]
        assert set(rows) <= {"|0>", "|1>"} and sum(rows.values()) == 200 and rows["|0>"] > 130


def test_large_n_programs_skip_dense_allocation(tmp_path):
    """A 64-qubit GHZ runs on the stabilizer and mps backends of both CLIs
    (no 2^64 allocation), every shot all zeros or all ones."""
    f = tmp_path / "ghz64.qasm"
    f.write_text("\n".join(["qreg q[64];", "U(pi/2,0,pi) q[0];"]
                           + [f"CX q[{i}],q[{i + 1}];" for i in range(63)]) + "\n")
    for backend, kw in (("stabilizer", {}), ("mps", {"chi": 4})):
        for rc, out in eval_both(f, seed=0, backend=backend, shots=32, **kw):
            head, rows, tail = counts_block(out)
            assert rc == 0 and tail == ["Done."], (backend, out)
            assert set(rows) <= {"|" + "0" * 64 + ">", "|" + "1" * 64 + ">"}
            assert sum(rows.values()) == 32


def test_mps_noise_flag(tmp_path):
    """MPS trajectories: bit flips on a GHZ-3 (the counts' format and total,
    both GHZ rows seen), phase damping through the K rows, and the
    unknown-channel refusal word for word."""
    f = tmp_path / "mn.qasm"
    f.write_text(f"qreg q[3]; creg c[3];\n{GHZ_H} q[0];\nCX q[0], q[1];\nCX q[1], q[2];\n"
                 "measure q -> c;\n")
    for rc, out in eval_both(f, seed=0, backend="mps", chi=4, noise="bitflip:0.05",
                             trajectories=256):
        head, rows, tail = counts_block(out)
        assert rc == 0 and head == "Counts over classical registers (256 trajectories):"
        assert sum(rows.values()) == 256 and tail == ["Done."]
        assert "c=000" in rows and "c=111" in rows
    for rc, out in eval_both(f, seed=0, backend="mps", chi=4, noise="pd:0.1", trajectories=64):
        assert rc == 0 and counts_block(out)[0].endswith("(64 trajectories):")
    (trc, tout), (jrc, jout) = eval_both(f, backend="mps", noise="nope:0.1")
    assert trc == jrc == 2 and tout == jout and "unknown noise channel" in tout


GHZ_H = "U(1.5707963267948966, 0, 3.141592653589793)"


def test_mps_observables(tmp_path):
    """--observable on the mps backend: Bell <ZZ> = <XX> = 1, <ZI> = 0, the
    same text; in trajectory mode mean +- stderr in both formats."""
    f = tmp_path / "bell.qasm"
    f.write_text(BELL)
    (trc, tout), (jrc, jout) = eval_both(f, seed=0, backend="mps", chi=4,
                                         observables=["ZZ", "XX", "ZI"])
    assert trc == jrc == 0 and unsigned_zeros(tout) == unsigned_zeros(jout)
    assert tout.startswith("<ZZ> = 1.000000\n<XX> = 1.000000\n")
    (trc, tout), (jrc, jout) = eval_both(f, seed=2, backend="mps", chi=4, noise="dep:0.05",
                                         trajectories=64, observables=["ZZ", "xi"])
    pat = r"<ZZ> = -?\d\.\d{6} \+- \d\.\d{6}\n<XI> = -?\d\.\d{6} \+- \d\.\d{6}\nDone\.\n"
    assert trc == jrc == 0 and re.fullmatch(pat, tout) and re.fullmatch(pat, jout)
    # a bad string: the same refusal
    (trc, tout), (jrc, jout) = eval_both(f, backend="mps", observables=["ZZZ"])
    assert trc == jrc == 2 and tout == jout


def test_mps_trunc_budget_flags(tmp_path):
    """--trunc-budget grows chi from --chi: the dump of brickwork-10 at
    depth 8 is the JAX CLI's (trunc_error=0.000e+00 in both); a budget the
    --max-chi cannot hold exits 1 with the JAX message, its discarded
    weight within a relative 1e-3."""
    import shutil

    from qubism_torch.models.circuits import brickwork_qasm

    shutil.copy(os.path.join(EXAMPLES, "qelib1.inc"), tmp_path / "qelib1.inc")
    f = tmp_path / "bw.qasm"
    f.write_text(brickwork_qasm(10, 8, seed=11) + "\n")
    (trc, tout), (jrc, jout) = eval_both(f, seed=0, backend="mps", chi=4, trunc_budget=1e-6,
                                         max_chi=64, dump_state=True)
    assert trc == jrc == 0 and "trunc_error=0.000e+00" in tout
    mask = lambda t: re.sub(r"CReg c\[10\] = [01]+", "CReg c[10] = #", t)  # noqa: E731
    same_dump(mask(tout), mask(jout))
    (trc, tout), (jrc, jout) = eval_both(f, seed=0, backend="mps", chi=4, trunc_budget=1e-9,
                                         max_chi=4)
    assert trc == jrc == 1 and "trunc_budget" in tout
    pat = r"discarded ([0-9.e+-]+) of"
    (ttext, tw), (jtext, jw) = ((re.sub(pat, "#", t), float(re.search(pat, t).group(1)))
                                for t in (tout, jout))
    assert ttext == jtext and abs(tw - jw) <= 1e-3 * jw
    assert tout.startswith("qubism: mps backend: trunc_budget 1e-09 exceeded at max_chi=4 ")


@pytest.mark.parametrize("kw", [
    dict(mesh=2), dict(noise="dep:0.1", traj_engine="fused"),
    dict(noise="dep:0.1", traj_engine="fused", mesh=2), dict(noise="dep:0.1@r[0]"),
], ids=["mesh", "fused", "fused mesh", "bad target"])
def test_mps_refusals_match_jax(kw, tmp_path):
    f = tmp_path / "t.qasm"
    f.write_text(BELL_MEASURED)
    (trc, tout), (jrc, jout) = eval_both(f, seed=1, backend="mps", chi=4, **kw)
    assert trc == jrc == 2 and tout == jout and tout.startswith("qubism: ")


@pytest.mark.parametrize("where", ["program", "trajectories", "observables"])
def test_mps_not_adjacent_exits_1(where, tmp_path, monkeypatch):
    """A prim the MPS engine cannot route (none reaches it from QASM, whose
    gates elaborate to 1q and 2q prims: it is raised in its place here)
    exits 1 with the JAX CLI's message in each of the three places that
    catch it."""
    from qubism_torch import mps as tmps
    from qubism_tpu import mps as jmps
    from qubism_tpu.mps import noise as jnoise

    def raiser(err):
        def f(*a, **k):
            raise err("wide prim")
        return f

    if where == "program":
        monkeypatch.setattr(tmps.MPSProgram, "run", raiser(tmps.NotAdjacentError))
        monkeypatch.setattr(jmps.MPSProgram, "run", raiser(jmps.NotAdjacentError))
        kw = {}
    else:
        monkeypatch.setattr(tmps.MPSTrajectoryProgram, "run_vals", raiser(tmps.NotAdjacentError))
        monkeypatch.setattr(tmps.MPSTrajectoryProgram, "expectations",
                            raiser(tmps.NotAdjacentError))
        monkeypatch.setattr(jnoise.MPSTrajectoryProgram, "run_vals",
                            raiser(jmps.NotAdjacentError))
        monkeypatch.setattr(jnoise.MPSTrajectoryProgram, "expectations",
                            raiser(jmps.NotAdjacentError))
        kw = dict(noise="dep:0.1")
        if where == "observables":
            kw["observables"] = ["ZZ"]
    f = tmp_path / "t.qasm"
    f.write_text(BELL if where == "observables" else BELL_MEASURED)
    (trc, tout), (jrc, jout) = eval_both(f, seed=1, backend="mps", chi=4, **kw)
    assert trc == jrc == 1 and tout == jout
    assert tout == f"qubism: mps {'backend' if where == 'program' else 'trajectories'}: wide prim\n"


# -- --backend stabilizer ------------------------------------------------------------


GHZ_FILE = "\n".join(["qreg q[40]; creg c[40];", "U(pi/2, 0, pi) q[0];"]
                     + [f"CX q[{k}], q[{k + 1}];" for k in range(39)]) + "\n"


def test_stabilizer_dump_state_prints_the_jax_text():
    path = os.path.join(EXAMPLES, "errorCorrection.qasm")
    (trc, tout), (jrc, jout) = eval_both(path, seed=0, backend="stabilizer", dump_state=True)
    assert trc == jrc == 0 and tout == jout
    assert "Stabilizers of q(x)a:\n" in tout and "CReg syn[2] = 10\n" in tout


def test_stabilizer_shots_and_observables(tmp_path):
    f = tmp_path / "ghz.qasm"
    f.write_text(GHZ_FILE)
    obs = ["Z" + "I" * 38 + "Z", "X" * 40, "Z" + "I" * 39]
    (trc, tout), (jrc, jout) = eval_both(f, seed=3, backend="stabilizer", shots=256,
                                         observables=obs)
    assert trc == jrc == 0
    head, rows, tail = counts_block(tout)
    jhead, jrows, jtail = counts_block(jout)
    assert head == jhead == "Counts for state vector q (256 shots):"
    assert set(rows) <= {"|" + "0" * 40 + ">", "|" + "1" * 40 + ">"} and sum(rows.values()) == 256
    assert tail == jtail and tail[-1] == "Done." and tail[:2] == [f"<{o}> = 1.000000" for o in obs[:2]]


def test_stabilizer_trajectory_mode(tmp_path):
    f = tmp_path / "ghz.qasm"
    f.write_text(GHZ_FILE + "measure q -> c;\n")
    kw = dict(seed=1, backend="stabilizer", noise="bf:0.01", trajectories=128,
              observables=["Z" + "I" * 39])
    (trc, tout), (jrc, jout) = eval_both(f, **kw)
    assert trc == jrc == 0
    (th, trows, ttail), (jh, jrows, jtail) = counts_block(tout), counts_block(jout)
    assert th == jh == "Counts over classical registers (128 trajectories):"
    assert sum(trows.values()) == sum(jrows.values()) == 128
    pat = r"<ZI{39}> = -?\d\.\d{6} \+- \d\.\d{6}"
    assert re.fullmatch(pat, ttail[0]) and re.fullmatch(pat, jtail[0]) and ttail[1] == "Done."
    # feed-forward runs the tableau batch; --mesh splits it, the same text
    ff = tmp_path / "ff.qasm"
    ff.write_text("qreg q[2]; creg c[1]; creg d[1];\nU(pi/2, 0, pi) q[0];\n"
                  "measure q[0] -> c[0];\nif (c == 1) U(pi, 0, pi) q[1];\nmeasure q[1] -> d[0];\n")
    outs = []
    for mesh in (None, 2):
        buf = io.StringIO()
        assert tcli.eval_file(str(ff), seed=4, backend="stabilizer", noise="dep:0.02",
                              trajectories=64, mesh=mesh, out=buf) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and counts_block(outs[0])[0].endswith("(64 trajectories):")


@pytest.mark.parametrize("src,kw,rc", [
    (BELL + "creg c[2];\nmeasure q -> c;\n", dict(mesh=2), 2),
    (BELL + "creg c[2];\nmeasure q -> c;\n", dict(noise="dep:0.1", traj_engine="fused"), 2),
    (BELL + "creg c[2];\nmeasure q -> c;\n", dict(noise="ad:0.1"), 2),
    (BELL + "creg c[2];\nmeasure q -> c;\n", dict(noise="dep:0.1@q[0]"), 2),
    ("qreg q[1]; creg c[1];\nU(pi/4, 0, 0) q[0];\nmeasure q -> c;\n", {}, 1),
    ("qreg q[1]; creg c[1];\nU(pi/4, 0, 0) q[0];\nmeasure q -> c;\n",
     dict(noise="bf:0.1", trajectories=8), 1),
    ("qreg q[1];\nU(pi/4, 0, 0) q[0];\n", dict(noise="bf:0.1", observables=["Z"]), 1),
], ids=["mesh", "fused", "ad", "targeted", "non-clifford", "non-clifford trajectories",
        "non-clifford observable"])
def test_stabilizer_exit_codes_match_jax(src, kw, rc, tmp_path):
    f = tmp_path / "t.qasm"
    f.write_text(src)
    (trc, tout), (jrc, jout) = eval_both(f, seed=1, backend="stabilizer", **kw)
    assert trc == jrc == rc and tout == jout
    assert tout.startswith("qubism: ")


def test_every_flag_of_the_jax_cli_is_parsed():
    ours = {s for a in tcli.build_arg_parser()._actions for s in a.option_strings}
    theirs = {s for a in jcli.build_arg_parser()._actions for s in a.option_strings}
    assert theirs <= ours


# -- the REPL ------------------------------------------------------------------------


def test_repl_state_persists():
    tr, jr, _ = same_transcript(["qreg q[1]; creg c[1];", "U(pi,0,pi) q[0];",
                                 "measure q[0] -> c[0];"])
    assert str(tr.prog.cregs["c"]) == str(jr.prog.cregs["c"]) == "1"


def test_repl_failed_line_atomic():
    tr, jr, out = same_transcript(["qreg q[2]; creg c[2];",
                                   "qreg extra[1]; creg c2[3]; measure q -> c2;"])
    assert "ERROR on line" in out
    assert set(tr.prog.stvecs) == {"q"} and "extra" not in tr.prog.qregs
    assert set(tr.pstate.id_table) == set(jr.pstate.id_table) == {"q", "c"}


def test_repl_failed_line_leaves_the_state_tensor_untouched():
    """The appliers and the collapse work in place: a line that rotates and
    measures a qubit and then fails must not reach the kept tensor."""
    out = io.StringIO()
    r = tcli.Repl(seed=0, out=out)
    r.line("qreg q[3]; creg c[3];")
    r.line("U(1.1,0.2,0.3) q[0]; CX q[0],q[1]; U(0.4,0,0) q[2];")
    kept = r.prog.stvecs["q"].state
    before, gen_before = kept.clone(), r.prog.gen.get_state()
    r.line("U(pi/2,0,pi) q[1]; measure q -> c; CX q[0],q[7];")
    assert "Index 7 out of bounds" in out.getvalue()
    assert r.prog.stvecs["q"].state is kept and torch.equal(kept, before)
    assert str(r.prog.cregs["c"]) == "000"
    assert torch.equal(r.prog.gen.get_state(), gen_before)
    # and a copy owns its tensors
    copy = r.prog.copy()
    copy.stvecs["q"].state.zero_()
    assert torch.equal(kept, before)
    r.line("measure q[2] -> c[2];")  # the session goes on
    assert r.prog.stvecs["q"].state is not kept


def test_repl_parse_error_keeps_state():
    tr, _, out = same_transcript(["qreg q[1];", "qreg q[1];"])
    assert "Redeclaration of q" in out and "q" in tr.prog.qregs


def test_repl_quit():
    tr, jr, out, jout = transcript([":q"])
    assert out == jout == ""
    assert tcli.Repl(seed=0, out=io.StringIO()).line(":q") is False


def test_repl_dump():
    _, _, out = same_transcript(["qreg q[2];", "U(pi/2,0,pi) q[0]; CX q[0],q[1];", ":dump;"])
    assert "Dump of the internal state" in out and "0.7071" in out


def test_repl_include():
    tr, jr, _ = same_transcript([f'include "{EXAMPLES}/qelib1.inc";',
                                 "qreg q[1]; creg c[1]; x q[0]; measure q[0] -> c[0];"])
    assert str(tr.prog.cregs["c"]) == str(jr.prog.cregs["c"]) == "1"


def test_repl_include_base_and_cd():
    lines = ['include "qelib1.inc";', "qreg q[1]; creg c[1]; x q[0]; measure q[0] -> c[0];"]
    tr, _, out = same_transcript([f":cd {EXAMPLES}"] + lines)
    assert "include base" in out and str(tr.prog.cregs["c"]) == "1"
    tr, _, _ = same_transcript(lines, include_base=EXAMPLES)
    assert str(tr.prog.cregs["c"]) == "1"
    _, _, out = same_transcript([":cd /definitely/not/a/dir"])
    assert "no such directory" in out
    _, _, out = same_transcript(lines)  # without a base the include fails in both
    assert "qelib1.inc" in out


def test_repl_cd_prefix_does_not_swallow_other_commands():
    _, _, out = same_transcript([":cdump"])
    assert "include base" not in out
    _, _, out = same_transcript([":cd"])
    assert out == f"include base: {os.getcwd()}\n"


def test_repl_run_loop_with_stdin():
    outs = []
    for mod in (tcli, jcli):
        out = io.StringIO()
        mod.Repl(seed=0, out=out).run(infile=io.StringIO("qreg q[1];\n:q\n"))
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and outs[0].count("QASM> ") == 2
    out = io.StringIO()
    tcli.Repl(seed=0, out=out).run(infile=io.StringIO("qreg q[1];\n"))  # EOF ends it
    assert out.getvalue() == "QASM> QASM> \n"


def test_repl_observable_command():
    _, _, out = same_transcript(["qreg q[2];", "U(pi/2,0,pi) q[0]; CX q[0],q[1];", ":obs ZZ;",
                                 ":observable XX", ":obs yy", ":obs WAT;", "qreg r[1];",
                                 ":obs ZZZ", ":obs IIX", "CX q[1],r[0];", ":obs ZIZ"])
    assert "<ZZ> = 1.000000" in out and "<XX> = 1.000000" in out and "<YY> = -1.000000" in out
    assert "qubism: :observable:" in out and "<ZZZ> = 1.000000" in out


def test_repl_teleportation_transcript():
    """examples/teleportation.qasm line by line, but for the measurements
    (each package draws from its own generator); q[0] is then measured in
    the state it was rotated to, so <ZII> is +-1 and <IIZ> is cos(0.3)."""
    with open(os.path.join(EXAMPLES, "teleportation.qasm")) as f:
        lines = [ln for ln in f.read().splitlines()
                 if ln and not ln.startswith("//") and not ln.startswith("OPENQASM")]
    unitary = [ln for ln in lines if "measure" not in ln and not ln.startswith("if")]
    _, _, out = same_transcript(unitary + [":obs ZZI", ":obs XIX", ":dump;"],
                                include_base=EXAMPLES)
    assert "<ZZI> = " in out
    tr, _, tout, _ = transcript(lines + [":obs IIZ"], include_base=EXAMPLES)
    assert "ERROR" not in tout and set(tr.prog.cregs) == {"c0", "c1", "c2"}


def test_main_without_a_file_starts_the_repl(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "qreg q[2];\nU(pi/2,0,pi) q[0]; CX q[0],q[1];\n:obs ZZ\n:q\n"))
    assert tcli.main(["--seed", "4", "--include-base", EXAMPLES]) == 0
    assert capsys.readouterr().out == "QASM> QASM> QASM> <ZZ> = 1.000000\nQASM> "
    monkeypatch.setattr(config, "device", "cuda")
    if not torch.cuda.is_available():  # the REPL never drops to the CPU unasked
        assert tcli.main([]) == 2
        assert "QUBISM_TORCH_DEVICE=cpu" in capsys.readouterr().err


def test_module_entry_point_runs_the_repl():
    env = dict(os.environ, QUBISM_TORCH_DEVICE="cpu")
    res = subprocess.run([sys.executable, "-m", "qubism_torch"], cwd=ROOT, env=env, text=True,
                         input="qreg q[1];\nU(pi,0,pi) q[0];\n:obs Z\n:q\n", capture_output=True,
                         timeout=120)
    assert res.returncode == 0 and "<Z> = -1.000000" in res.stdout


def test_port_imports_no_jax():
    """No module of the port and not chip_smoke.py imports jax, the JAX
    package or its experiments."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|qubism_tpu|experiments)\b", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "qubism_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    assert len(paths) > 40
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path
    code = ("import sys, qubism_torch.cli, qubism_torch.core.density, qubism_torch.run.noisy, "
            "qubism_torch.parallel.density, qubism_torch.ops.rdm, qubism_torch.utils.checkpoint, "
            "qubism_torch.stabilizer, qubism_torch.models.qec; "
            "assert 'jax' not in sys.modules and 'triton' not in sys.modules; "
            "assert not any(m.startswith('qubism_tpu') for m in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, QUBISM_TORCH_DEVICE="cpu"), timeout=120)
    assert res.returncode == 0, res.stderr
