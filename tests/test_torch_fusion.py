"""The port's fused executor (plain versions on the CPU) against the JAX
package's apply_prims_fused on random QASM-like gate runs: u3, u1, CX on
random pairs and h over the whole register, as the interpreter queues them.
Tolerance: relative L2 <= 1e-5 (complex64)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import fusion as TF  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.core.gates import u3_matrix  # noqa: E402
from qubism_tpu.ops import fusion as JF  # noqa: E402

CX = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def qasm_like(n, count, seed):
    """(u, targets, diag) triples in the interpreter's shapes."""
    rng = np.random.default_rng(seed)
    out = [(H, (q,), False) for q in range(n)]  # h q;
    for _ in range(count):
        r = rng.uniform()
        if r < 0.35:
            u = u3_matrix(*rng.uniform(0, 2 * math.pi, 3), reference_bug=False)
            out.append((u, (int(rng.integers(n)),), False))
        elif r < 0.6:
            d = np.array([1, np.exp(1j * rng.uniform(0, 2 * math.pi))])
            out.append((d, (int(rng.integers(n)),), True))
        else:
            c, t = rng.choice(n, 2, replace=False)
            out.append((CX, (int(c), int(t)), False))
    if seed % 2:
        out += [(H, (q,), False) for q in range(n)]
    return out


@pytest.mark.parametrize("n,seed", [(10, 1), (11, 2), (12, 3), (12, 4), (7, 5)])
def test_fused_run_matches_jax(n, seed):
    gates = qasm_like(n, 60, seed)
    rng = np.random.default_rng(seed + 50)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    re, im = v.real.astype(np.float32), v.imag.astype(np.float32)

    jplanes = JF.apply_prims_fused((jnp.asarray(re), jnp.asarray(im)),
                                   [JPrim(u, t, d) for u, t, d in gates], n)
    want = (np.asarray(jplanes[0], np.float64).reshape(-1)
            + 1j * np.asarray(jplanes[1], np.float64).reshape(-1))

    state = TA.state_from_planes(re, im)
    TF.apply_prims_fused(state, [TPrim(u, t, d) for u, t, d in gates], n)
    got = TA.complex_from_state(state)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5


def test_fuse_reaches_every_kernel():
    n = 12
    kinds = set()
    for seed in range(4):
        prims = [TPrim(u, t, d) for u, t, d in qasm_like(n, 60, seed)]
        kinds |= {TF.plan(op, n)[0] for op in TF.fuse(prims, n)}
    assert kinds == {"gate", "diag", "lane", "layer1q"}


def test_fuse_semantics():
    n = 12
    # h over the register: 5 row qubits -> one Layer1QOp (cut at 6 gates
    # when longer); the 7 lane qubits fuse into one lane block
    ops = TF.fuse([TPrim(H, (q,)) for q in range(n)], n)
    assert [type(o).__name__ for o in ops] == ["Layer1QOp", "DenseOp"]
    assert ops[0].targets == (0, 1, 2, 3, 4)
    assert ops[1].targets == tuple(range(5, 12))
    ops = TF.fuse([TPrim(H, (q,)) for q in range(5)] + [TPrim(H, (q,)) for q in range(5)]
                  + [TPrim(H, (0,))], 20)
    assert [len(o.gates) for o in ops if isinstance(o, TF.Layer1QOp)] == [5, 5]
    ops = TF.fuse([TPrim(H, (q,)) for q in range(9)], 20)
    assert [len(o.targets) for o in ops] == [6, 3]
    # row blocks stop at 4 targets; mixed row+lane unions merge up to 4
    ops = TF.fuse([TPrim(CX, (i, i + 1)) for i in range(6)], n)
    assert [o.targets for o in ops] == [(0, 1, 2, 3), (3, 4, 5, 6)]
    # consecutive diagonals merge into one layer
    d = np.array([1, 1j])
    ops = TF.fuse([TPrim(d, (0,), True), TPrim(d, (9,), True), TPrim(d, (3,), True),
                   TPrim(d, (11,), True), TPrim(d, (5,), True)], n)
    assert len(ops) == 1 and isinstance(ops[0], TF.DiagLayer)
    # cu1 as qelib1 defines it (u1/cx/u1/cx/u1) fuses to one diagonal
    cu1 = [TPrim(np.array([1, np.exp(0.2j)]), (0,), True), TPrim(CX, (0, 6)),
           TPrim(np.array([1, np.exp(-0.2j)]), (6,), True), TPrim(CX, (0, 6)),
           TPrim(np.array([1, np.exp(0.2j)]), (6,), True)]
    ops = TF.fuse(cu1, n)
    assert len(ops) == 1 and isinstance(ops[0], TF.DiagLayer)
    np.testing.assert_allclose(ops[0].factors[0][0], [1, 1, 1, np.exp(0.4j)], atol=1e-12)


def _canon_op(op):
    """A fused op of either package as (class name, nested tuple of targets
    and complex arrays), for a structural comparison."""
    kind = type(op).__name__
    if kind == "DenseOp":
        return kind, (op.targets, np.asarray(op.u))
    if kind == "DiagLayer":
        return kind, tuple((tuple(t), np.asarray(d)) for d, t in op.factors)
    if kind == "Layer1QOp":
        return kind, tuple((q, np.asarray(u)) for u, q in op.gates)
    assert kind == "StageBlockOp", kind
    return kind, tuple((q, np.asarray(u), tuple((tuple(t), np.asarray(d)) for d, t in f))
                       for u, q, f in op.stages)


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.shape == np.shape(b) and np.allclose(a, b, rtol=0, atol=1e-12)
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


def _stream(family, n):
    import qubism_tpu.models.circuits as JC
    from tests.test_fusion import random_prims

    return {"qft": lambda: JC.qft_prims(n), "ghz": lambda: JC.ghz_prims(n),
            "brickwork": lambda: JC.brickwork_prims(n, 3, seed=5),
            "random": lambda: random_prims(n, 60, 9)}[family]()


@pytest.mark.parametrize("family", ["qft", "ghz", "brickwork", "random"])
@pytest.mark.parametrize("w", [0, 1, 2])
def test_bank_fusion_and_split_match_jax(family, w):
    """fuse(keep_separate_below=w) then split_op_virtual(op, w), as the mesh
    path lowers a segment, against the JAX package's mixed_lane fusion.
    max_block=3 on both sides: at 4 targets the JAX fusion adds its TPU pass
    cost model (_merge_pays), which the port does not carry."""
    n = 10
    jprims = _stream(family, n)
    tprims = [TPrim(p.u, p.targets, p.diag) for p in jprims]
    jops = JF.fuse(jprims, n, max_block=3, keep_separate_below=w,
                   stage_group=TF.STAGE_GROUP, mixed_lane=True)
    tops = TF.fuse(tprims, n, max_block=3, keep_separate_below=w)
    assert len(tops) == len(jops)
    cross = 0
    for jop, top in zip(jops, tops):
        assert _same(_canon_op(top), _canon_op(jop))
        jkind, jpay = JF.split_op_virtual(jop, w)
        tkind, tpay = TF.split_op_virtual(top, w)
        assert tkind == jkind
        if tkind == "cross":
            cross += 1
            assert _same(_canon_op(tpay), _canon_op(jpay))
            assert any(t < w for t in tpay.targets)
        else:
            assert len(tpay) == len(jpay) == 1 << w
            for a, b in zip(tpay, jpay):
                assert _same(_canon_op(a), _canon_op(b))
    assert (cross > 0) == (w > 0)
