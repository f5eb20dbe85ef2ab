"""Checkpoint / resume of the port: the cases of tests/test_checkpoint.py,
and a checkpoint written by each package loaded by the other (same
amplitudes bit for bit, qregs, cregs, gate table and id_table). The PRNG
does not cross: the port writes ``torch_rng_state`` and never ``prng_key``."""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qubism_torch.cli import Repl as TRepl  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.ops.apply import planes_from_state  # noqa: E402
from qubism_torch.qasm.parser import initial_state as t_initial  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm_incremental as t_parse  # noqa: E402
from qubism_torch.qasm.serialize import to_jsonable as t_jsonable  # noqa: E402
from qubism_torch.run.interpreter import run_program_incremental as t_run  # noqa: E402
from qubism_torch.run.progstate import blank_state as t_blank  # noqa: E402
from qubism_torch.utils import checkpoint as TCK  # noqa: E402
from qubism_tpu.cli import Repl as JRepl  # noqa: E402
from qubism_tpu.qasm.parser import initial_state as j_initial  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm_incremental as j_parse  # noqa: E402
from qubism_tpu.qasm.serialize import to_jsonable as j_jsonable  # noqa: E402
from qubism_tpu.run.interpreter import run_program_incremental as j_run  # noqa: E402
from qubism_tpu.run.progstate import blank_state as j_blank  # noqa: E402
from qubism_tpu.utils import checkpoint as JCK  # noqa: E402

QELIB = os.path.join(os.path.dirname(__file__), "..", "examples", "qelib1.inc")
SRC = """
include "QELIB";
qreg a[2]; qreg b[1]; creg c[2];
gate mygate(t) x { U(t,0,0) x; }
h a[0]; cx a[0],b[0];
mygate(0.5) a[1];
measure a[0] -> c[0];
""".replace("QELIB", QELIB)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def torch_session():
    ast, st = t_parse(t_initial(), SRC)
    return t_run(ast, t_blank(5)), st


def jax_session():
    ast, st = j_parse(j_initial(), SRC)
    return j_run(ast, j_blank(5)), st


def planar(sv):
    """A state vector of either package as (2, 2^n) float32."""
    if hasattr(sv, "planar"):
        return np.asarray(sv.planar)
    return np.stack(planes_from_state(sv.state))


def same_tables(a, b, sta, stb):
    assert {k: (v.target, v.start, v.size) for k, v in a.qregs.items()} == \
        {k: (v.target, v.start, v.size) for k, v in b.qregs.items()}
    assert {k: tuple(v.bits) for k, v in a.cregs.items()} == \
        {k: tuple(v.bits) for k, v in b.cregs.items()}
    assert set(a.funcs) == set(b.funcs)
    for name in a.funcs:
        fa, fb = a.funcs[name], b.funcs[name]
        assert (fa.params, fa.args) == (fb.params, fb.args)
        ja = (t_jsonable if type(fa).__module__.startswith("qubism_torch") else j_jsonable)(fa.body)
        jb = (t_jsonable if type(fb).__module__.startswith("qubism_torch") else j_jsonable)(fb.body)
        assert ja == jb
    assert {k: (p.file, p.line, p.col) for k, p in sta.id_table.items()} == \
        {k: (p.file, p.line, p.col) for k, p in stb.id_table.items()}


def test_progstate_roundtrip(tmp_path):
    ps, st = torch_session()
    path = str(tmp_path / "ckpt.npz")
    TCK.save_progstate(ps, path, st)
    ps2, st2 = TCK.load_progstate(path)
    assert set(ps2.stvecs) == set(ps.stvecs)
    for name in ps.stvecs:
        assert torch.equal(ps2.stvecs[name].state, ps.stvecs[name].state)
        assert ps2.stvecs[name].n == ps.stvecs[name].n
    assert ps2.qregs == ps.qregs
    assert ps2.cregs == ps.cregs
    assert ps2.funcs["mygate"].body == ps.funcs["mygate"].body
    same_tables(ps, ps2, st, st2)
    # the generator continues the same stream
    assert torch.equal(ps2.gen.get_state(), ps.gen.get_state())
    assert torch.equal(torch.rand(4, generator=ps2.gen), torch.rand(4, generator=ps.gen))
    with np.load(path) as data:
        assert "torch_rng_state" in data and "prng_key" not in data
        assert data["sv_a(x)b"].shape == (2, 8) and data["sv_a(x)b"].dtype == np.float32


def test_repl_save_load_resume(tmp_path):
    path = str(tmp_path / "session.npz")
    out1 = io.StringIO()
    r1 = TRepl(seed=3, out=out1)
    r1.line("qreg q[2]; creg c[2];")
    r1.line("U(pi/2,0,pi) q[0]; CX q[0],q[1];")
    r1.line(f":save {path}")
    assert "Saved session" in out1.getvalue()
    out2 = io.StringIO()
    r2 = TRepl(seed=999, out=out2)
    r2.line(f":load {path}")
    assert "Loaded session" in out2.getvalue()
    r2.line("measure q -> c;")
    assert "Undeclared" not in out2.getvalue()
    bits = str(r2.prog.cregs["c"])
    assert bits in ("00", "11")
    # the same seed stream in the original session yields the same outcome
    r1.line("measure q -> c;")
    assert str(r1.prog.cregs["c"]) == bits


def test_load_missing_file_is_graceful(tmp_path):
    out, jout = io.StringIO(), io.StringIO()
    r = TRepl(out=out)
    assert r.line(f":load {tmp_path}/nope.npz") is True
    assert JRepl(out=jout).line(f":load {tmp_path}/nope.npz") is True
    assert out.getvalue() == jout.getvalue() and "qubism:" in out.getvalue()


def test_written_by_the_port_loads_in_the_jax_package(tmp_path):
    ps, st = torch_session()
    path = str(tmp_path / "from_torch.npz")
    TCK.save_progstate(ps, path, st)
    jps, jst = JCK.load_progstate(path)
    assert set(jps.stvecs) == set(ps.stvecs)
    for name in ps.stvecs:
        assert np.array_equal(planar(jps.stvecs[name]), planar(ps.stvecs[name]))
        assert jps.stvecs[name].n == ps.stvecs[name].n
    same_tables(ps, jps, st, jst)
    assert jps.key is None  # no prng_key in the file: the JAX REPL keeps its own
    out = io.StringIO()
    r = JRepl(seed=1, out=out)
    r.line(f":load {path}")
    r.line("measure b -> c;")  # wrong size: still a known register
    r.line("mygate(0.1) a[1];")
    assert "Undeclared" not in out.getvalue() and r.prog.key is not None


def test_written_by_the_jax_package_loads_in_the_port(tmp_path):
    jps, jst = jax_session()
    path = str(tmp_path / "from_jax.npz")
    JCK.save_progstate(jps, path, jst)
    ps, st = TCK.load_progstate(path)
    assert set(ps.stvecs) == set(jps.stvecs)
    for name in jps.stvecs:
        assert np.array_equal(planar(ps.stvecs[name]), planar(jps.stvecs[name]))
        assert ps.stvecs[name].state.dtype == torch.complex64
    same_tables(jps, ps, jst, st)
    assert ps.gen is None  # prng_key is not read
    out = io.StringIO()
    r = TRepl(seed=1, out=out)
    own = r.prog.gen
    r.line(f":load {path}")
    assert r.prog.gen is own  # the REPL keeps its own generator
    r.line("mygate(0.1) a[1];")
    r.line("measure a[1] -> c[1];")
    r.line(":obs ZZI")
    # a[0] and a[1] are both measured by now: their parity is +1 or -1
    assert "Undeclared" not in out.getvalue()
    assert out.getvalue().splitlines()[-1] in ("<ZZI> = 1.000000", "<ZZI> = -1.000000")


def test_both_packages_write_the_same_arrays(tmp_path):
    """Same program and seed: ``sv_*`` agree to 1e-6 and ``meta_json`` is
    equal but for the position of the last statement's file name."""
    import json

    (ps, st), (jps, jst) = torch_session(), jax_session()
    TCK.save_progstate(ps, str(tmp_path / "t.npz"), st)
    JCK.save_progstate(jps, str(tmp_path / "j.npz"), jst)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert set(t.files) - {"torch_rng_state"} == set(j.files) - {"prng_key"}
        tm, jm = (json.loads(bytes(d["meta_json"]).decode()) for d in (t, j))
        assert tm.keys() == jm.keys()
        for key in ("svs", "qregs", "funcs", "pos", "id_table"):
            assert tm[key] == jm[key], key
        for name in tm["svs"]:
            assert t[f"sv_{name}"].shape == j[f"sv_{name}"].shape
            assert t[f"sv_{name}"].dtype == j[f"sv_{name}"].dtype
