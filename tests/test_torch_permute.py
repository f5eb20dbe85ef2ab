"""The bit-permutation pass: a run of qubit swaps as one PermuteOp and one
launch of the permute kernel (csrc/permute.cu).

* The plain version (``kernels.permute_plain``) and the port's fused
  executor against the JAX package's ``apply_prims_fused`` on the same SWAP
  prims at n = 7-12: the full bit reversal, random disjoint swaps, swaps
  among lane qubits only, among row qubits only, and between the two.
  A permutation only moves amplitudes: the states are equal.
* A numpy walker of the kernel's tile pairing on the layout that
  ``kernels.permute_prepare`` hands it (the kernel's index arithmetic
  replayed per block): at n = 10-17 every amplitude is read once and
  written once, to its image, and the result is the plain version's.
* The fusion rule: what becomes a PermuteOp and what does not, the mesh's
  bank bits, ``split_op_virtual``.
* End to end: a QFT with its swaps through ``CompiledCircuit``,
  ``eval_file`` (the interpreter and ``--compile``) and ``ShardedSim``
  against the same prims one op each (``optimize=False``)."""

import io
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qubism_torch.models.circuits as TC  # noqa: E402
from qubism_torch import cli as tcli  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import fusion as TF  # noqa: E402
from qubism_torch.ops import kernels as TK  # noqa: E402
from qubism_torch.parallel import ShardedSim, make_mesh  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.ops import fusion as JF  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
SWAP = np.eye(4, dtype=complex)[[0, 2, 1, 3]]
CX = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)
KINDS = ("reverse", "random", "lane", "row", "mixed")


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def swap_pairs(kind, n, seed):
    """Disjoint pairs of qubits to swap: the whole bit reversal, random
    pairs, pairs among the lane qubits (the last 7), among the row qubits,
    or each pairing a row qubit with a lane qubit; in a seeded order."""
    rng = np.random.default_rng(seed)
    b = max(n - TA._COL, 0)
    if kind == "reverse":
        pairs = [(q, n - 1 - q) for q in range(n // 2)]
    elif kind == "mixed":
        rows, lanes = rng.permutation(b), rng.permutation(np.arange(b, n))
        pairs = list(zip(rows, lanes))
    else:
        pool = {"random": np.arange(n), "lane": np.arange(b, n),
                "row": np.arange(b)}[kind]
        pool = rng.permutation(pool)
        pairs = [(pool[2 * i], pool[2 * i + 1]) for i in range(len(pool) // 2)]
    pairs = [(int(a), int(c)) for a, c in pairs]
    assert pairs
    return [pairs[i] for i in rng.permutation(len(pairs))]


def qubit_map(pairs, n):
    perm = list(range(n))
    for a, c in pairs:
        perm[a], perm[c] = c, a
    return tuple(perm)


def rand_vec(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return (v / np.linalg.norm(v)).astype(np.complex64)


def jax_state(v, prims, n):
    planes = (jnp.asarray(v.real.copy()), jnp.asarray(v.imag.copy()))
    re, im = JF.apply_prims_fused(planes, prims, n)
    return np.asarray(re).reshape(-1) + 1j * np.asarray(im).reshape(-1)


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

CASES = ([(k, n) for k in KINDS for n in (9, 10, 12)]
         + [("reverse", 7), ("reverse", 8), ("reverse", 11), ("random", 7), ("lane", 8)])


@pytest.mark.parametrize("kind,n", CASES)
def test_plain_matches_jax_swaps(kind, n):
    pairs = swap_pairs(kind, n, seed=n)
    v = rand_vec(n, 3 * n)
    want = jax_state(v, [JPrim(SWAP, p) for p in pairs], n)
    got = TK.permute_plain(torch.from_numpy(v.copy()), qubit_map(pairs, n), n).numpy()
    np.testing.assert_array_equal(got, want.astype(np.complex64))
    fused = torch.from_numpy(v.copy())
    TF.apply_prims_fused(fused, [TPrim(SWAP, p) for p in pairs], n)
    np.testing.assert_array_equal(fused.numpy(), got)
    # the wrapper on a CPU state runs the plain version, a prepared plan too
    plan = TK.permute_prepare(qubit_map(pairs, n), n)
    again = TK.permute(torch.from_numpy(v.copy()), plan, n).numpy()
    np.testing.assert_array_equal(again, got)


def test_prepare_refuses_what_is_not_an_involution():
    with pytest.raises(ValueError, match="involution"):
        TK.permute_prepare((1, 2, 0, 3), 4)
    with pytest.raises(ValueError, match="involution"):
        TK.permute_prepare((1, 0, 2), 4)
    with pytest.raises(ValueError, match="map of 3 qubits"):
        TK.permute(TA.zero_state(4), TK.permute_prepare((1, 0, 2), 3), 4)


# ---------------------------------------------------------------------------
# the kernel's tile pairing, walked in numpy
# ---------------------------------------------------------------------------

THREADS = 256  # qk::kThreads


def walk(plan, n, s):
    """csrc/permute.cu's blocks replayed on the host array ``s`` (in place),
    every block's item in turn: each thread copies one amplitude a step into
    shared memory, then stores two. Returns the reads and writes of each
    amplitude and the index each written amplitude was loaded from."""
    cols, nrows = plan.col_bits, len(plan.rows)
    vec_bits = cols - 1
    tile_amps = 1 << (cols + nrows)
    tile_vecs = tile_amps >> 1
    stride = (1 << cols) + 1
    tile_words = (1 << nrows) * stride
    reads = np.zeros(1 << n, dtype=np.int64)
    writes = np.zeros(1 << n, dtype=np.int64)
    source = np.full(1 << n, -1, dtype=np.int64)
    assert plan.tile[:cols] == tuple(range(cols)) and len(plan.tile) <= 12

    def offsets(row, weights):
        out = np.zeros_like(row)
        for j, w in enumerate(weights):
            out += ((row >> j) & 1) * w
        return out

    rowoff = [1 << p for p in plan.rows]
    for r in range(1 << (n - len(plan.tile))):
        base = r
        for p in plan.tile:
            base = ((base >> p) << (p + 1)) | (base & ((1 << p) - 1))
        other = base
        for a, b in plan.pairs:
            if ((other >> a) ^ (other >> b)) & 1:
                other ^= (1 << a) | (1 << b)
        if other < base:
            continue
        tiles = 1 if other == base else 2
        # the copies into shared memory: one amplitude a thread and step
        f = np.arange(tiles * tile_amps)
        sel = (f >= tile_amps).astype(np.int64)
        row = (f - sel * tile_amps) >> cols
        lcol = (f % THREADS) & ((1 << cols) - 1)
        g = np.where(sel == 1, other, base) + offsets(row, rowoff) + lcol
        sm = np.zeros(2 * tile_words, dtype=s.dtype)
        slot = np.full(2 * tile_words, -1, dtype=np.int64)
        at = sel * tile_words + row * stride + lcol
        np.add.at(reads, g, 1)
        sm[at] = s[g]
        slot[at] = g
        # the stores: two amplitudes (16 bytes) a thread and step
        f = np.arange(tiles * tile_vecs)
        sel = (f >= tile_vecs).astype(np.int64)
        row = (f - sel * tile_vecs) >> vec_bits
        c = ((f % THREADS) & ((1 << vec_bits) - 1)) << 1
        g = np.where(sel == 1, other, base) + offsets(row, rowoff) + c
        assert np.all(g % 2 == 0)  # 16-byte aligned
        ccol = sum(((c >> j) & 1) * w for j, w in enumerate(plan.wcol))
        src = (1 - sel if tiles == 2 else 0) * tile_words + ccol + offsets(row, plan.wrow)
        for half, off in ((0, 0), (1, plan.wcol[0])):
            assert np.all(slot[src + off] >= 0)  # loaded by this block
            s[g + half] = sm[src + off]
            source[g + half] = slot[src + off]
            np.add.at(writes, g + half, 1)
    return reads, writes, source


def image(i, plan, n):
    """The index amplitude i moves to: bit p of i becomes bit sigma[p]."""
    return sum(((i >> p) & 1) << q for p, q in enumerate(plan.sigma))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [10, 13, 15, 17])
def test_tile_pairing_reads_and_writes_each_amplitude_once(kind, n):
    perm = qubit_map(swap_pairs(kind, n, seed=100 + n), n)
    plan = TK.permute_prepare(perm, n)
    v = rand_vec(n, n)
    s = v.copy()
    reads, writes, source = walk(plan, n, s)
    assert np.all(reads == 1) and np.all(writes == 1)
    idx = np.arange(1 << n)
    assert np.array_equal(image(source, plan, n), idx)  # each written to its image
    want = TK.permute_plain(torch.from_numpy(v.copy()), perm, n).numpy()
    np.testing.assert_array_equal(s, want)


def test_tile_layout_of_the_qft30_reversal():
    """QFT-30's swaps: tiles of the low 6 bits and the top 6, the middle 18
    bits paired as a reversal (2^18 rest values, about half skipped)."""
    plan = TK.permute_prepare(tuple(range(29, -1, -1)), 30)
    assert plan.tile == (0, 1, 2, 3, 4, 5, 24, 25, 26, 27, 28, 29)
    assert plan.rows == (24, 25, 26, 27, 28, 29)
    assert plan.wcol == (2080, 1040, 520, 260, 130, 65)
    assert plan.wrow == (32, 16, 8, 4, 2, 1)
    assert plan.pairs == tuple((p, 29 - p) for p in range(6, 15))
    assert plan.packed.dtype == np.int32 and plan.packed.size == 66
    assert list(plan.packed[:4]) == [6, 6, 12, 9]


def test_small_states_are_one_tile():
    for n in (2, 4, 6, 9, 12):
        perm = qubit_map([(0, n - 1)], n)
        plan = TK.permute_prepare(perm, n)
        assert len(plan.tile) == n and plan.pairs == () and plan.col_bits == min(6, n)
        v = rand_vec(n, n)
        s = v.copy()
        reads, writes, _ = walk(plan, n, s)
        assert np.all(reads == 1) and np.all(writes == 1)
        np.testing.assert_array_equal(
            s, TK.permute_plain(torch.from_numpy(v.copy()), perm, n).numpy())


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------


def kinds(ops):
    return [type(o).__name__ for o in ops]


@pytest.mark.parametrize("n", [12, 16, 30])
def test_qft_swaps_end_in_one_permute_op(n):
    prims = TC.qft_prims(n) + [TPrim(SWAP, (q, n - 1 - q)) for q in range(n // 2)]
    without = TF.fuse(TC.qft_prims(n), n)
    ops = TF.fuse(prims, n)
    assert kinds(ops[:-1]) == kinds(without)
    assert isinstance(ops[-1], TF.PermuteOp)
    assert ops[-1].perm == tuple(range(n - 1, -1, -1))
    if n == 30:  # 5 stage blocks of 4, one of 3, the lane block, one permute
        assert len(ops) == 8


def test_qelib1_three_cx_swap_is_detected():
    n = 14
    pairs = [(0, 13), (1, 12), (2, 11), (3, 10)]
    prims = [TPrim(CX, t) for a, b in pairs for t in ((a, b), (b, a), (a, b))]
    ops = TF.fuse(prims, n)
    assert kinds(ops) == ["PermuteOp"] and ops[0].perm == qubit_map(pairs, n)
    assert ops[0].targets == (0, 1, 2, 3, 10, 11, 12, 13)


def test_cnot_blocks_and_a_lone_swap_stay_dense():
    n = 14
    ops = TF.fuse([TPrim(CX, (0, 1)), TPrim(CX, (2, 3)), TPrim(CX, (4, 5))], n)
    assert kinds(ops) == ["DenseOp", "DenseOp"]
    ops = TF.fuse([TPrim(SWAP, (0, 13))], n)
    assert kinds(ops) == ["DenseOp"]
    # a swap block, then a CNOT block, then a swap block: nothing to merge
    ops = TF.fuse([TPrim(SWAP, (0, 1)), TPrim(SWAP, (2, 3)), TPrim(CX, (4, 5)),
                   TPrim(CX, (6, 7)), TPrim(SWAP, (0, 1)), TPrim(SWAP, (2, 3))], n)
    assert kinds(ops) == ["DenseOp"] * 3
    assert TF.plan(ops[0], n)[0] == "gate"
    # an H makes a block that is no permutation, however many swaps it has
    ops = TF.fuse([TPrim(SWAP, (0, 1)), TPrim(H, (2,)), TPrim(SWAP, (4, 5)),
                   TPrim(SWAP, (6, 7))], n)
    assert kinds(ops) == ["DenseOp", "DenseOp"]


def test_a_composition_that_is_no_involution_is_cut():
    """(01)(23), then (14)(56): a 3-cycle 0 -> 4 -> 1 -> 0, so the first
    block stays dense; the second starts a run with (78)(9 10)."""
    n = 20
    prims = [TPrim(SWAP, p) for p in [(0, 1), (2, 3), (1, 4), (5, 6), (7, 8), (9, 10)]]
    ops = TF.fuse(prims, n)
    assert kinds(ops) == ["DenseOp", "PermuteOp"]
    assert ops[0].targets == (0, 1, 2, 3)
    assert ops[1].perm == qubit_map([(1, 4), (5, 6), (7, 8), (9, 10)], n)
    # the same cut on 12 qubits, against one op a prim
    n = 12
    v = rand_vec(n, 1)
    prims = [TPrim(SWAP, p) for p in [(0, 1), (2, 3), (1, 4), (5, 6), (7, 8), (9, 10)]]
    assert kinds(TF.fuse(prims, n)) == ["DenseOp", "PermuteOp"]
    a = TF.CompiledCircuit(n, prims)
    b = TF.CompiledCircuit(n, prims, optimize=False)
    sa, sb = torch.from_numpy(v.copy()), torch.from_numpy(v.copy())
    np.testing.assert_array_equal(a(sa).numpy(), b(sb).numpy())


def test_an_identity_run_launches_nothing():
    n = 12
    pairs = [(0, 1), (2, 3), (4, 5), (0, 1), (2, 3), (4, 5)]
    prims = [TPrim(SWAP, p) for p in pairs]
    # greedy blocks (01)(23) | (45)(01) | (23)(45); the first half alone is
    # the two blocks (01)(23) | (45), one permutation
    assert TF.fuse(prims[:3], n) == [TF.PermuteOp(qubit_map(pairs[:3], n))]
    circ = TF.CompiledCircuit(n, prims)
    assert circ.ops == [] and circ._plans == [] and circ.stats()["fused_ops"] == 0
    v = rand_vec(n, 2)
    np.testing.assert_array_equal(circ(torch.from_numpy(v.copy())).numpy(), v)


@pytest.mark.parametrize("w", [1, 2])
def test_bank_bit_swaps_are_left_alone(w):
    n = 12
    pairs = [(q, n - 1 - q) for q in range(n // 2)]
    ops = TF.fuse([TPrim(SWAP, p) for p in pairs], n, keep_separate_below=w)
    perms = [o for o in ops if isinstance(o, TF.PermuteOp)]
    assert len(perms) == 1 and all(perms[0].perm[q] == q for q in range(w))
    assert perms[0].perm == qubit_map(pairs[w:], n)
    for op in ops:
        if not isinstance(op, TF.PermuteOp):
            assert any(t < w for t in op.targets) and len(op.targets) == 2
            assert TF.split_op_virtual(op, w)[0] == "cross"


def test_split_op_virtual_shifts_a_local_permute_op():
    n, v = 12, 2
    perm = qubit_map([(2, 11), (3, 10), (4, 9)], n)
    kind, per = TF.split_op_virtual(TF.PermuteOp(perm), v)
    assert kind == "per_shard" and len(per) == 1 << v
    assert all(p == TF.PermuteOp(qubit_map([(0, 9), (1, 8), (2, 7)], n - v)) for p in per)
    x = rand_vec(n, 4)
    want = TK.permute_plain(torch.from_numpy(x.copy()), perm, n).numpy()
    banks = [torch.from_numpy(b.copy()) for b in x.reshape(1 << v, -1)]
    for bank, op in zip(banks, per):
        name, args = TF.plan(op, n - v)
        assert name == "permute"
        TK.KERNEL_FNS[name][1](bank, *args, n - v)
    np.testing.assert_array_equal(np.concatenate([b.numpy() for b in banks]), want)
    with pytest.raises(ValueError, match="bank bits"):
        TF.split_op_virtual(TF.PermuteOp(qubit_map([(1, 5)], n)), v)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def qft_swap_prims(n, x):
    """X on the qubits that read 1 in x, the QFT, its final swaps."""
    inputs = [TPrim(np.array([[0, 1], [1, 0]], dtype=complex), (q,))
              for q in range(n) if (x >> (n - 1 - q)) & 1]
    return inputs + TC.qft_prims(n) + [TPrim(SWAP, (q, n - 1 - q)) for q in range(n // 2)]


@pytest.mark.parametrize("n", [9, 12, 14])
def test_compiled_qft_with_swaps_matches_one_op_a_prim(n):
    prims = qft_swap_prims(n, 5 * n + 3)
    a = TF.CompiledCircuit(n, prims)
    b = TF.CompiledCircuit(n, prims, optimize=False)
    assert [name for name, _ in a._plans].count("permute") == 1
    got = a.state_to_complex(a(a.init_state()))
    want = b.state_to_complex(b(b.init_state()))
    assert rel(got, want) <= 1e-5
    k = np.arange(1 << n)  # the closed form 2^(-n/2) exp(2 pi i x k / 2^n)
    closed = np.exp(2j * np.pi * (((5 * n + 3) * k) % (1 << n)) / (1 << n)) / 2 ** (n / 2)
    assert rel(got, closed) <= 1e-5


def qft_qasm(n, x):
    lines = ['OPENQASM 2.0;', 'include "qelib1.inc";',
             "gate swap a,b { cx a,b; cx b,a; cx a,b; }", f"qreg q[{n}];"]
    lines += [f"x q[{q}];" for q in range(n) if (x >> (n - 1 - q)) & 1]
    for q in range(n):
        lines.append(f"h q[{q}];")
        lines += [f"cu1(pi/{1 << (j - q)}) q[{j}],q[{q}];" for j in range(q + 1, n)]
    lines += [f"swap q[{q}],q[{n - 1 - q}];" for q in range(n // 2)]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("compile_mode", [False, True])
def test_eval_file_qft_with_swaps(monkeypatch, compile_mode):
    n, x = 11, 1234
    ran = []
    fn, plain = TK.KERNEL_FNS["permute"]
    monkeypatch.setitem(TK.KERNEL_FNS, "permute",
                        (lambda *a: ran.append(a[-1]) or fn(*a), plain))
    seen = []
    rc = tcli.eval_file(os.path.join(EXAMPLES, "<qft>.qasm"), source=qft_qasm(n, x),
                        out=io.StringIO(), inspect=seen.append, compile_mode=compile_mode)
    assert rc == 0 and ran == [n]
    (sv,) = seen[0].stvecs.values()
    got = TA.complex_from_state(sv.state)
    ref = TF.CompiledCircuit(n, qft_swap_prims(n, x), optimize=False)
    want = ref.state_to_complex(ref(ref.init_state()))
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("shards,banks", [(2, 1), (4, 2)])
def test_sharded_qft_with_swaps(shards, banks):
    n = 14
    prims = qft_swap_prims(n, 777)
    sim = ShardedSim(n, make_mesh(shards), banks=banks).apply(prims)
    names = {name for steps in sim._lowered.values() for step in steps if step[0] == "banks"
             for per_bank in step[1] for plans in per_bank for name, _ in plans}
    assert "permute" in names
    ref = TF.CompiledCircuit(n, prims, optimize=False)
    want = ref.state_to_complex(ref(ref.init_state()))
    assert rel(sim.amplitudes(), want) <= 1e-5
