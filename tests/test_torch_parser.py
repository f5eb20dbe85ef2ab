"""qubism_torch's copy of the OpenQASM front-end against qubism_tpu's: the
same text must give the same AST (compared through serialize.to_jsonable)
or the same rendered parse error."""

import glob
import os

import pytest

pytest.importorskip("torch")

from qubism_torch.qasm import parser as torch_parser  # noqa: E402
from qubism_torch.qasm import serialize as torch_serialize  # noqa: E402
from qubism_tpu.qasm import parser as jax_parser  # noqa: E402
from qubism_tpu.qasm import serialize as jax_serialize  # noqa: E402

EXAMPLES = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "examples"))

#: the sources tests/test_parser.py parses (accepted and rejected)
CORPUS = [
    "qreg q[2];",
    "OPENQASM 2.0; qreg q[2];",
    "OPENQASM 2.0;\nqreg q[2];",
    "qreg q[3]; creg c[2];",
    "qreg q[1]; creg q[1];",
    "U(0,0,0) q[0];",
    "qreg measure[1];",
    "// line comment\n/* block\ncomment */ qreg q[1];",
    "qreg q[1]",
    "qreg q[1] creg c[1];",
    "gate foo a { U(0,0,0) a; } qreg q[1];",
    "gate post q { }",
    "gate r(theta) a { U(theta,0,0) a; } qreg q[1]; U(theta,0,0) q[0];",
    "qreg a[1]; gate g(a) b { U(a,0,0) b; } U(0,0,0) a[0];",
    "gate foo a { U(0,0,0) a }",
    "qreg q[2]; creg c[2]; U(0,0,0) q[0]; CX q[0],q[1]; barrier q; "
    "measure q -> c; reset q[1]; :dump;",
    "qreg q[1]; creg c[1]; if(c==1) U(0,0,0) q[0];",
    "qreg q[1]; creg c[1]; if(c==0) measure q[0] -> c[0];",
    "qreg q[2]; gate f(x,y) a,b { U(x,y,0) a; } f(1.0,2.0) q[0],q[1];",
    'include "nope.inc";',
    "qreg r[2]; bogus! stuff;",
    "qreg q[1];\nU(0,0,0) r[0];",
    "qreg q[2];\nopaque magic(a, b) x, y;",
    "qreg q[1]; opaque f x; U(0,0,0) x;",
    "opaque f x; opaque f y;",
    "qreg q[1];\ngate opaque x { U(0, 0, 0) x; }\nopaque q[0];",
] + [f"qreg q[1]; U({e},0,0) q[0];" for e in (
    "1+2*3", "(1+2)*3", "-pi/2", "2 pow 3 pow 2", "sin(pi/2)", "sqrt 4",
    "cos 0 + 1", "1.5e2", "-(1+2)", "exp 0", "ln(exp(1))", "2 pow -1")]


def _both(path, text):
    out = []
    for parser, ser in ((jax_parser, jax_serialize), (torch_parser, torch_serialize)):
        try:
            out.append(("ast", ser.to_jsonable(parser.parse_openqasm(path, text))))
        except parser.QasmParseError as e:
            out.append(("error", e.pretty()))
    return out


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(EXAMPLES, "*.qasm")))
                         + [os.path.join(EXAMPLES, "qelib1.inc")],
                         ids=os.path.basename)
def test_example_files_parse_alike(path):
    with open(path) as f:
        text = f.read()
    jax_out, torch_out = _both(path, text)
    assert jax_out[0] == "ast"
    assert torch_out == jax_out


@pytest.mark.parametrize("src", CORPUS)
def test_parser_corpus_alike(src):
    jax_out, torch_out = _both("<test>", src)
    assert torch_out == jax_out
