"""The port's CLI and REPL against the JAX package's: ``--observable`` on
the four execution modes, unfused registers, ``--dtype``, the REPL
transcripts of tests/test_cli.py (the same input lines to both ``Repl``s,
the same output text up to the sign of printed zeros), the atomic failed
line with the kept state tensor unchanged bit for bit, each flag that is
not ported yet exiting 2 and naming itself, trajectory mode (``--noise``,
``--trajectories``, ``--traj-engine``, ``--observable`` as mean +- stderr,
``--mesh``) and ``--backend stabilizer`` (file mode with ``--shots`` /
``--dump-state`` / ``--observable``, noisy Clifford trajectories, and its
exit codes) against the JAX CLI's text and messages."""

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
                                {"backend": "density"}],
                         ids=["file", "compile", "mesh", "density"])
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


# -- flags that are not ported yet -------------------------------------------------


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


#: named None: the trajectory flags, ported since; the case runs both CLIs
#: and holds the port's output against the JAX CLI's (the counts come from
#: each package's own random stream, so the rows are held by their format
#: and total, and the text otherwise word for word)
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
    if named is not None:
        assert trc == 2
        assert ours.err == f"qubism: {named}: not ported yet\n" and ours.out == ""
        return
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
    out = io.StringIO()
    assert tcli.eval_file("<t>", source="qreg q[1];", out=out, backend="mps") == 2
    assert out.getvalue() == "qubism: --backend mps: not ported yet\n"
    # --noise is ported: a program with no creg and no observable is refused
    # as the JAX CLI refuses it
    f = tmp_path / "t.qasm"
    f.write_text("qreg q[1];")
    (trc, tout), (jrc, jout) = eval_both(f, noise="dep:0.1")
    assert trc == jrc == 2 and tout == jout
    assert tout.startswith("qubism: trajectory mode reports classical-register counts")


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
