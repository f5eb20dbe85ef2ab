"""The port's native OpenQASM scanner (qubism_torch/native) against the JAX
package's Python lexer, token for token (the counterparts of
tests/test_native.py), and the port's lexer route: long inputs go native,
bad ones raise the reference's diagnostic, and a box without a compiler
still parses through the Python route."""

import json
import os
import shutil
import threading
import time

import pytest

pytest.importorskip("torch")

from qubism_torch import native  # noqa: E402
from qubism_torch.qasm import lexer as torch_lexer  # noqa: E402
from qubism_torch.qasm import parser as torch_parser  # noqa: E402
from qubism_torch.qasm import serialize as torch_serialize  # noqa: E402
from qubism_tpu.models.circuits import brickwork_qasm  # noqa: E402
from qubism_tpu.qasm import lexer as jax_lexer  # noqa: E402
from qubism_tpu.qasm import parser as jax_parser  # noqa: E402
from qubism_tpu.qasm import serialize as jax_serialize  # noqa: E402

EXAMPLES = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "examples"))
EDGE = ('OPENQASM 2.0; // c\n/* block\n*/ qreg q[2]; U(1.5e-3,-0.25,pi) q[0]; '
        'measure q -> c; :dump; include "x/y.inc";\n\n  ')
#: a text past the native threshold
LONG = brickwork_qasm(12, 64, seed=3)


@pytest.fixture(autouse=True)
def built():
    """The scanner builds wherever there is a compiler (a failed build with
    one is a fault, not a skip)."""
    if shutil.which(native.CXX) is None:
        pytest.skip(f"no C++ compiler ({native.CXX})")
    assert native.ensure_built() is not None, native.build_error


def key(toks):
    return [(t.kind, t.value, t.pos.line, t.pos.col) for t in toks]


def assert_same(text, file="<t>"):
    ref = jax_lexer._tokenize_py(text, file)
    got = native.native_tokenize(text, file)
    assert got is not None
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert a.kind == b.kind, (a, b)
        if a.kind == "real":
            assert abs(a.value - b.value) <= 1e-12, (a, b)
        else:
            assert a.value == b.value, (a, b)
        assert (a.pos.file, a.pos.line, a.pos.col) == (b.pos.file, b.pos.line, b.pos.col), (a, b)


@pytest.mark.parametrize("name", [
    "qelib1.inc", "teleportation.qasm", "fourier.qasm", "inverseQFT.qasm",
    "errorCorrection.qasm", "rippleCarryAdder.qasm", "grover.qasm",
    "wstate.qasm",
])
def test_native_matches_python_on_examples(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        assert_same(f.read(), name)


def test_native_matches_on_generated_circuit():
    assert_same(brickwork_qasm(20, depth=50, seed=1))


def test_native_edge_cases():
    assert_same(EDGE)


def test_native_rejects_garbage():
    assert native.native_tokenize("qreg q[1]; !!!") is None


def test_native_big_integer_literals_exact():
    big = (1 << 60) + 1
    text = f"// pad\nqreg q[{big}];\n"
    assert [t.value for t in native.native_tokenize(text) if t.kind == "nat"] == [big]
    assert [t.value for t in jax_lexer._tokenize_py(text) if t.kind == "nat"] == [big]


def test_native_is_fast():
    # comment-heavy: scanning dominates, so the margin holds on a loaded host
    text = brickwork_qasm(24, depth=12, seed=0) + ("// " + "x" * 117 + "\n") * 20000

    def best_of(f, k=3):
        out, best = None, float("inf")
        for _ in range(k):
            t0 = time.perf_counter()
            out = f()
            best = min(best, time.perf_counter() - t0)
        return out, best

    native.native_tokenize(text)
    nat, t_native = best_of(lambda: native.native_tokenize(text))
    py, t_py = best_of(lambda: torch_lexer._tokenize_py(text))
    assert nat == py
    assert t_native < t_py


def test_long_input_takes_the_native_route():
    assert len(LONG) >= torch_lexer._NATIVE_THRESHOLD
    before = dict(torch_lexer.routes)
    toks = torch_lexer.tokenize(LONG, "<t>")
    assert torch_lexer.routes == {"native": before["native"] + 1, "python": before["python"]}
    assert key(toks) == key(jax_lexer.tokenize(LONG, "<t>"))
    before = dict(torch_lexer.routes)
    torch_lexer.tokenize(EDGE)
    assert torch_lexer.routes == {"native": before["native"], "python": before["python"] + 1}


def test_long_bad_input_raises_the_reference_diagnostic():
    text = LONG + "!!!"
    with pytest.raises(jax_lexer.LexError) as ref:
        jax_lexer.tokenize(text, "<t>")
    with pytest.raises(torch_lexer.LexError) as got:
        torch_lexer.tokenize(text, "<t>")
    assert (got.value.pos.line, got.value.pos.col) == (ref.value.pos.line, ref.value.pos.col)
    assert got.value.message == ref.value.message
    assert str(got.value) == str(ref.value)


def test_non_ascii_text_keeps_character_positions():
    """The scanner counts bytes, the lexer characters: tokens after a
    non-ASCII character on their line, a string holding one, and the end of
    the input keep the Python lexer's columns and values."""
    text = ('/* café — ü */ qreg q[1]; include "dír/ü.inc"; // ñ\n'
            + LONG + "// end é")
    assert_same(text)
    before = torch_lexer.routes["native"]
    toks = torch_lexer.tokenize(text, "<t>")
    assert torch_lexer.routes["native"] == before + 1
    assert key(toks) == key(jax_lexer._tokenize_py(text, "<t>"))


def test_parse_of_brickwork30_serialises_as_the_reference():
    text = brickwork_qasm(30, 40, seed=0)
    path = os.path.join(EXAMPLES, "<brickwork30>.qasm")
    before = torch_lexer.routes["native"]
    got = torch_serialize.to_jsonable(torch_parser.parse_openqasm(path, text))
    assert torch_lexer.routes["native"] == before + 1
    ref = jax_serialize.to_jsonable(jax_parser.parse_openqasm(path, text))
    assert json.dumps(got) == json.dumps(ref)


def test_builds_under_build_and_nothing_beside_the_source(tmp_path, monkeypatch):
    src_dir = native.SOURCE.parent
    listed = sorted(os.listdir(src_dir))
    monkeypatch.setattr(native, "_PKG", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_error", None)
    lib = native.ensure_built()
    assert lib is not None, native.build_error
    out = native.library_path()
    assert out.exists() and out.parent.parent == tmp_path / "_build"
    assert out.parent.name.startswith("native-")
    assert sorted(os.listdir(src_dir)) == listed
    assert_same(EDGE)


def test_builds_at_once_leave_one_whole_library(tmp_path, monkeypatch):
    """Builds racing into one path (xdist workers) each rename a whole file
    into place; every one loads and scans."""
    monkeypatch.setattr(native, "_PKG", tmp_path)
    out = native.library_path()
    errors = []

    def build():
        try:
            native._build(out)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert os.listdir(out.parent) == [out.name]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_error", None)
    assert native.ensure_built() is not None, native.build_error
    assert_same(EDGE)


def test_missing_compiler_is_recorded_and_parses_by_python(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_PKG", tmp_path)
    monkeypatch.setattr(native, "CXX", "qubism-no-such-compiler")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_error", None)
    assert native.ensure_built() is None
    assert "qubism-no-such-compiler" in native.build_error
    assert native.native_tokenize(LONG) is None
    before = dict(torch_lexer.routes)
    toks = torch_lexer.tokenize(LONG, "<t>")
    assert torch_lexer.routes == {"native": before["native"], "python": before["python"] + 1}
    assert key(toks) == key(jax_lexer._tokenize_py(LONG, "<t>"))
