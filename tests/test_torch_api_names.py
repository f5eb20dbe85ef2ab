"""The port's public names against the JAX package's: every name a module
of qubism_tpu defines or exports at its top level exists in the port's
module of the same path (read from the reference's source with ``ast``,
so no JAX code runs), but for the names ROADMAP.md lists as left out on
purpose; and the last names ported: ``utils.{trace, timed, hbm_fraction}``,
``stabilizer.measure_qubit`` and ``stabilizer.frames.frame_expectation``."""

import ast
import importlib
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm as tparse  # noqa: E402
from qubism_torch.stabilizer import frames as TF  # noqa: E402
from qubism_torch.stabilizer import tableau as TT  # noqa: E402
from qubism_torch.stabilizer.noise import StabilizerTrajectoryProgram  # noqa: E402
from qubism_torch.utils import hbm_fraction, timed, trace  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm as jparse  # noqa: E402
from qubism_tpu.stabilizer import frames as JF  # noqa: E402
from qubism_tpu.stabilizer import noise as JN  # noqa: E402
from qubism_tpu.stabilizer import tableau as JT  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "qubism_tpu"
#: modules not compared: the entry point runs the CLI when imported, and
#: the split-real Jacobi SVD is left out with its module (ROADMAP.md)
NOT_COMPARED = {"__main__.py", "mps/_svd.py"}
MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                 if str(p.relative_to(REF)) not in NOT_COMPARED)

#: names of the reference the port leaves out on purpose, by module (the
#: reasons are in ROADMAP.md, "Names left out on purpose")
_JAX_IMPORTS = {"lax", "pl", "pltpu", "partial", "OrderedDict", "Mesh", "NamedSharding", "P"}
_PLANES = {"Planes", "complex_from_planar", "complex_from_planes", "planar_from_complex",
           "planes_from_complex", "inner_planes"}
_TRACED = {"apply_gate_traced", "apply_gate_lane_traced", "apply_gate_row_traced",
           "diag_factor_traced", "expand_diag_traced", "collapse_traced", "prob_one_traced",
           "apply_pauli_traced", "apply_pauli_sum_traced", "plan_view", "prepare_gate"}
_VIRTUAL = {"default_virtual_shards", "zero_state_virtual", "state_to_complex_virtual",
            "expectation_pauli_virtual", "expectation_pauli_sum_virtual", "collapse_sharded",
            "measure_qubit_sharded", "prob_one_sharded", "sample_indices_sharded"}
_CANONICAL = {"INTERPRET", "canon_cols", "canon_shape", "to_canon", "like_shape", "row_gate",
              "row_gate_prepare", "lane_gate", "lane_gate_prepare", "diag_layer",
              "diag_layer_prepare", "diag_layer_apply", "layer1q_prepare", "stage_prepare",
              "stage2_prepare", "engine_uses_pallas"}
_OPERAND_CACHE = {"OpPlanner", "plan_chunk", "plan_sig", "run_plans"}
LEFT_OUT = {
    "core/gates.py": {"StateVec"},
    "models/adjoint_engine.py": _CANONICAL | {"pallas_adjoint_value_and_grad_fn"},
    "models/adjoint_mesh.py": _JAX_IMPORTS | _CANONICAL | {"AXIS", "plan_units"},
    "models/trajectories.py": _JAX_IMPORTS | {"zero_state"},
    "models/variational.py": _TRACED | {"zero_state"},
    "mps/engine.py": _JAX_IMPORTS | {"jacobi_svd"},
    "mps/noise.py": _JAX_IMPORTS,
    "ops/apply.py": _JAX_IMPORTS | _PLANES | _TRACED,
    "ops/fusion.py": _JAX_IMPORTS | _VIRTUAL | _CANONICAL | _OPERAND_CACHE,
    "ops/kernels.py": _JAX_IMPORTS | _PLANES | _CANONICAL,
    "ops/measure.py": _JAX_IMPORTS | _PLANES | _TRACED | _VIRTUAL,
    "ops/rdm.py": {"A"},
    "ops/sample.py": _VIRTUAL | {"sample_indices_np"},
    "parallel/density.py": {"kernels"},
    "parallel/mesh.py": _JAX_IMPORTS,
    "parallel/sharded.py": _JAX_IMPORTS | _OPERAND_CACHE | _TRACED | {"AXIS"},
    "run/compiler.py": _VIRTUAL,
    "run/interpreter.py": {"StateVec"},
    "run/noisy.py": _TRACED | {"zero_state"},
    "stabilizer/frames.py": _JAX_IMPORTS,
    "stabilizer/noise.py": _JAX_IMPORTS,
    "stabilizer/tableau.py": _JAX_IMPORTS,
}
#: what the port calls the reference's names it renamed
RENAMED = {"pallas_adjoint_value_and_grad_fn": "kernel_adjoint_value_and_grad_fn",
           "sample_indices_np": "sample_indices"}


def public_names(path: Path) -> set[str]:
    """Top-level names a module defines, assigns or imports from another
    module, without a leading underscore (``import x`` binds a module, not
    an API name)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_") and n != "annotations"}


def port_module(rel: str):
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join(["qubism_torch", *parts]))


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_of_the_reference_is_in_the_port(rel):
    mod = port_module(rel)
    names = public_names(REF / rel)
    left_out = LEFT_OUT.get(rel, set()) & names
    missing = sorted(n for n in names - left_out if not hasattr(mod, n))
    assert missing == [], f"qubism_torch/{rel} lacks {missing}"
    stale = sorted(n for n in left_out if hasattr(mod, n))
    assert stale == [], f"qubism_torch/{rel} has {stale}: take them off LEFT_OUT"


def test_renamed_names_exist_under_their_port_names():
    from qubism_torch.models import adjoint_engine
    from qubism_torch.ops import sample

    assert callable(getattr(adjoint_engine, RENAMED["pallas_adjoint_value_and_grad_fn"]))
    assert callable(getattr(sample, RENAMED["sample_indices_np"]))


def test_hbm_fraction_is_against_the_h100_rate():
    s = 0.0123
    assert hbm_fraction(28, 2, s) == pytest.approx(2 * 16 * 2**28 / s / 3.35e12, rel=1e-12)
    assert hbm_fraction(20, 1, 1.0, peak_bw=1e9) == pytest.approx(16 * 2**20 / 1e9, rel=1e-12)


def test_timed_gives_positive_seconds_per_call():
    calls = []
    x = torch.arange(1 << 12, dtype=torch.float32)

    def fn(a):
        calls.append(1)
        return (a * 2).sum()

    secs = timed(fn, x, reps=3, warmup=2)
    assert secs > 0 and len(calls) == 5


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(256)
    with trace(str(tmp_path / "tr")):
        (x * 3).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        assert json.load(f)["traceEvents"]


_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_CX = np.eye(4, dtype=np.complex128)[[0, 1, 3, 2]]


def ghz_prims(prim, n):
    return [prim(_H, (0,))] + [prim(_CX, (q, q + 1)) for q in range(n - 1)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_measure_qubit_on_ghz_gives_equal_outcomes(seed):
    n = 4
    tab = TT.apply_prims(TT.identity_tableau(n), ghz_prims(TPrim, n))
    gen = torch.Generator().manual_seed(seed)
    outs = []
    for q in range(n):
        out, tab, gen2 = TT.measure_qubit(tab, q, gen, n)
        assert gen2 is gen
        outs.append(out)
    assert len(set(outs)) == 1, outs
    # after the first measurement the state is a basis state: every Z reads it
    assert TT.expectation(tab, "ZZZZ", n) == 1.0
    assert TT.expectation(tab, "ZIII", n) == (1.0 if outs[0] == 0 else -1.0)


def test_measure_qubit_seeds_give_both_outcomes():
    n = 4
    tab = TT.apply_prims(TT.identity_tableau(n), ghz_prims(TPrim, n))
    firsts = {TT.measure_qubit(tab, 0, torch.Generator().manual_seed(s), n)[0] for s in range(16)}
    assert firsts == {0, 1}


@pytest.mark.parametrize("flip", [False, True])
def test_measure_qubit_deterministic_as_the_reference(flip):
    import jax

    n = 3
    tprims = [TPrim(_X, (1,))] if flip else []
    jprims = [JPrim(_X, (1,))] if flip else []
    ttab = TT.apply_prims(TT.identity_tableau(n), tprims)
    jtab = JT.apply_prims(JT.identity_tableau(n), jprims)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    for q in range(n):
        jout, jtab, key = JT.measure_qubit(jtab, q, key, n)
        tout, ttab, gen = TT.measure_qubit(ttab, q, gen, n)
        assert tout == jout == int(flip and q == 1)
    for got, ref in zip(TT.planes_from_tableau(ttab), jtab):
        np.testing.assert_array_equal(got, np.asarray(ref))


BELL = "qreg q[2];\nU(1.5707963267948966, 0, 3.141592653589793) q[0];\nCX q[0], q[1];"


def test_frame_expectation_is_the_one_term_sum():
    prog = StabilizerTrajectoryProgram(tparse("<t>", BELL), noise="dep:0.1")
    prims = prog._prims()
    for pauli in ("ZZ", "XX"):
        got = TF.frame_expectation(prog, prims, pauli, 512, seed=5)
        assert got == TF.frame_expectation_sum(prog, prims, ((1.0, pauli),), 512, seed=5)
        assert got[1] > 0


@pytest.mark.parametrize("pauli", ["ZZ", "XX", "YY", "ZI"])
def test_frame_expectation_noiseless_is_the_reference_clean_value(pauli):
    import jax

    tprog = StabilizerTrajectoryProgram(tparse("<t>", BELL), noise=None)
    jprog = JN.StabilizerTrajectoryProgram(jparse("<t>", BELL), noise=None)
    jprims = [p for e in jprog.events for p in e.prims]
    ref = JF.frame_expectation(jprog, jprims, pauli, 64, jax.random.PRNGKey(0))
    got = TF.frame_expectation(tprog, tprog._prims(), pauli, 64, seed=0)
    assert got == (float(ref[0]), float(ref[1]))
    assert got[0] == {"ZZ": 1.0, "XX": 1.0, "YY": -1.0, "ZI": 0.0}[pauli]
