"""K6, the cross-bank butterfly: the port's plain version (which the wrapper
runs on CPU tensors) against the JAX package's Pallas kernel
(``shard_butterfly_prepare``) in interpret mode, on the same random banks.
Tolerance: relative L2 <= 1e-6 over all banks (complex64 in, float32
arithmetic on both sides)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.ops import kernels as TK  # noqa: E402

TOL = 1e-6


@pytest.fixture(autouse=True)
def modes():
    JK.INTERPRET = True
    old = config.device
    config.device = "cpu"
    yield
    JK.INTERPRET = False
    config.device = old


def unitary(S, rng):
    m = rng.normal(size=(S, S)) + 1j * rng.normal(size=(S, S))
    return np.linalg.qr(m)[0]


def rand_banks(S, m, rng):
    return [(rng.normal(size=1 << m) + 1j * rng.normal(size=1 << m)).astype(np.complex64)
            for _ in range(S)]


@pytest.mark.parametrize("S,m", [(2, 8), (2, 10), (4, 9), (8, 8), (16, 8), (16, 10)])
def test_butterfly_matches_pallas(S, m):
    rng = np.random.default_rng(S * 100 + m)
    u = unitary(S, rng)
    banks = rand_banks(S, m, rng)

    fn, coef = JK.shard_butterfly_prepare(u, m)
    pairs = tuple(JK.to_canon((jnp.asarray(b.real), jnp.asarray(b.imag)), m) for b in banks)
    outs = fn(pairs, coef)
    want = np.concatenate([np.asarray(re, np.float64).reshape(-1)
                           + 1j * np.asarray(im, np.float64).reshape(-1) for re, im in outs])

    tb = [torch.from_numpy(b.copy()) for b in banks]
    before = TK.launches["butterfly"]
    got_banks = TK.shard_butterfly(tb, TK.shard_butterfly_prepare(u, "cpu"), m)
    assert TK.launches["butterfly"] == before  # a CPU tensor runs the plain version
    assert all(g is t for g, t in zip(got_banks, tb))  # in place
    got = np.concatenate([t.numpy().astype(np.complex128) for t in tb])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= TOL


def test_plain_takes_a_matrix_or_a_plan():
    rng = np.random.default_rng(3)
    u = unitary(4, rng)
    banks = rand_banks(4, 6, rng)
    a = [torch.from_numpy(b.copy()) for b in banks]
    b = [torch.from_numpy(x.copy()) for x in banks]
    TK.shard_butterfly_plain(a, u, 6)
    TK.shard_butterfly_plain(b, TK.shard_butterfly_prepare(u, "cpu"), 6)
    want = u @ np.stack(banks).astype(np.complex128)
    for x, y, row in zip(a, b, want):
        assert torch.equal(x, y)
        assert np.allclose(x.numpy(), row, atol=1e-5)


def test_butterfly_rejects_bad_operands():
    rng = np.random.default_rng(4)
    u = unitary(4, rng)
    with pytest.raises(ValueError, match="S x S"):
        TK.shard_butterfly_prepare(unitary(32, rng), "cpu")
    with pytest.raises(ValueError, match="S x S"):
        TK.shard_butterfly_prepare(np.eye(3), "cpu")
    banks = [torch.zeros(1 << 5, dtype=torch.complex64) for _ in range(4)]
    with pytest.raises(ValueError, match="3 banks"):
        TK.shard_butterfly(banks[:3], u, 5)
    whole = torch.zeros(4 << 5, dtype=torch.complex64)
    overlapping = [whole[i * 16:i * 16 + 32] for i in range(4)]
    with pytest.raises(ValueError, match="overlap"):
        TK.shard_butterfly(overlapping, u, 5)
    with pytest.raises(ValueError, match="contiguous complex64"):
        TK.shard_butterfly([b.to(torch.complex128) for b in banks], u, 5)
