"""The port's QFT stage-block kernel (K5) on the CPU.

* ``stage_block`` (which runs ``stage_block_plain`` on a CPU tensor)
  against the JAX package's stage_block_prepare kernel in interpret mode;
* the operands the CUDA kernel reads (the folded block C and the per-byte
  phase tables of ``stage_block_prepare``), applied by a few lines of torch
  the way csrc/stage.cu applies them, against the plain version.

Tolerance: relative L2 <= 1e-5 (complex64), the bound of
tests/test_kernels.py."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import kernels as TK  # noqa: E402

TOL = 1e-5
H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)


@pytest.fixture(autouse=True)
def modes():
    JK.INTERPRET = True
    old = config.device
    config.device = "cpu"
    yield
    JK.INTERPRET = False
    config.device = old


def rand_vec(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def unitary(rng):
    m = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    return np.linalg.qr(m)[0]


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def make_stages(n, q0, k, seed, off_one=False, dup=False):
    """k stages on q0..q0+k-1, each a random 1q gate and a ladder to every
    higher qubit. ``off_one`` gives some factors d[2] != 1; ``dup`` repeats
    the first factor of each ladder (twice the same (q, j) pair)."""
    rng = np.random.default_rng(seed)
    stages = []
    for q in range(q0, q0 + k):
        ladder = []
        for j in range(q + 1, n):
            d = np.array([1, 1, 1, np.exp(1j * rng.uniform(0, 2 * math.pi))])
            if off_one and (j + q) % 3 == 0:
                d[2] = np.exp(1j * rng.uniform(0, 2 * math.pi))
            ladder.append((d, (q, j)))
        if dup and ladder:
            ladder.append(ladder[0])
        stages.append((unitary(rng), q, tuple(ladder)))
    return tuple(stages)


def emulate_kernel(state, plan, n):
    """csrc/stage.cu's arithmetic in torch: per group of 2^k amplitudes,
    y = C x, then output l times prod_{t : bit k-1-t of l is 1} P_t(g), with
    P_t(g) the product of one table entry per byte of the group number."""
    k = len(plan.targets)
    dims, axes = TA.target_view(n, plan.targets)
    rest = [a for a in range(len(dims)) if a not in axes]
    perm = rest + axes
    x = state.view(dims).permute(perm).reshape(-1, 1 << k)
    y = x @ torch.from_numpy(plan.coef.astype(np.complex64)).T
    g = torch.arange(y.shape[0])
    tabs = torch.from_numpy(plan.tables.astype(np.complex64))
    for t in range(k):
        p = torch.ones(y.shape[0], dtype=torch.complex64)
        for c in range(plan.chunks):
            p = p * tabs[t, c][(g >> (8 * c)) & 255]
        cols = [l for l in range(1 << k) if (l >> (k - 1 - t)) & 1]
        y[:, cols] *= p[:, None]
    inv = [perm.index(a) for a in range(len(dims))]
    state.view(dims).copy_(y.view([dims[a] for a in perm]).permute(inv))
    return state


@pytest.mark.parametrize("n,q0,k,off_one", [
    (12, 0, 1, False), (12, 2, 2, True), (12, 1, 3, False), (12, 1, 4, True),
])
def test_stage_block_matches_pallas_stage_kernel(n, q0, k, off_one):
    stages = make_stages(n, q0, k, seed=10 * n + k, off_one=off_one)
    v = rand_vec(n, n + k)
    re, im = v.real.astype(np.float32), v.imag.astype(np.float32)
    fn, coef, *tabs = JK.stage_block_prepare(stages, n)
    out = fn((jnp.asarray(re), jnp.asarray(im)), coef, *tabs)
    want = (np.asarray(out[0], np.float64).reshape(-1)
            + 1j * np.asarray(out[1], np.float64).reshape(-1))
    state = TA.state_from_planes(re, im)
    plan = TK.stage_block_prepare(stages, n, "cpu")
    assert TK.stage_block(state, plan, n) is state
    assert rel(TA.complex_from_state(state), want) <= TOL


@pytest.mark.parametrize("n,q0,k,opts", [
    (9, 0, 1, {}),                      # ladder over the whole lane block
    (10, 1, 2, {"off_one": True}),      # d[2] != 1
    (12, 2, 3, {"dup": True}),          # a repeated (q, j) factor
    (12, 1, 4, {"off_one": True, "dup": True}),
    (11, 3, 1, {}),                     # ladder bits 0..6: one chunk
    (10, 2, 4, {}),                     # block qubits reaching into the lane block
])
def test_kernel_operands_match_plain(n, q0, k, opts):
    stages = make_stages(n, q0, k, seed=n * 31 + k, **opts)
    plan = TK.stage_block_prepare(stages, n, "cpu")
    assert plan.chunks == (n - 1 - plan.targets[-1] - 1) // 8 + 1
    v = rand_vec(n, n * 7 + k).astype(np.complex64)
    got = emulate_kernel(torch.from_numpy(v.copy()), plan, n)
    want = TK.stage_block_plain(torch.from_numpy(v.copy()), stages, n)
    assert rel(got.numpy(), want.numpy()) <= TOL


def test_stage_without_outside_ladder_needs_no_table():
    n = 6
    d = np.array([1, 1, 1, 1j])
    stages = ((H, 2, ((d, (2, 3)),)), (H, 3, ()))
    plan = TK.stage_block_prepare(stages, n, "cpu")
    assert plan.chunks == 0
    v = rand_vec(n, 3).astype(np.complex64)
    got = emulate_kernel(torch.from_numpy(v.copy()), plan, n)
    want = TK.stage_block_plain(torch.from_numpy(v.copy()), plan, n)
    assert rel(got.numpy(), want.numpy()) <= TOL


def test_stage_block_prepare_rejects_bad_blocks():
    d = np.array([1, 1, 1, 1j])
    with pytest.raises(ValueError, match="inside the block"):
        TK.stage_block_prepare(((H, 0, ((d, (0, 1)),)), (H, 2, ())), 8, "cpu")
    with pytest.raises(ValueError, match="not a ladder factor"):
        TK.stage_block_prepare(((H, 0, ((np.array([1j, 1, 1, 1]), (0, 3)),)),), 8, "cpu")
    with pytest.raises(ValueError, match="ascending"):
        TK.stage_block_prepare(((H, 3, ()), (H, 1, ())), 8, "cpu")
    with pytest.raises(ValueError, match="table chunks"):
        TK.stage_block_prepare(((H, 0, ((d, (0, 1)),)),), 40, "cpu")
    state = TA.zero_state(8)
    plan = TK.stage_block_prepare(((H, 0, ((d, (0, 5)),)),), 8, "cpu")
    with pytest.raises(ValueError):
        TK.stage_block(state[:128].clone(), plan, 8)
