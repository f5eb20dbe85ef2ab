"""The port's amplitude-sharded engine (``qubism_torch.parallel.ShardedSim``)
on an 8-shard CPU mesh against the JAX package's ShardedSim on the
conftest's 8-device virtual mesh (Pallas in interpret mode), with 2^0, 2^1
and 2^2 banks per shard: the same amplitudes (relative L2 <= 1e-5 at
complex64) and the same logical -> physical permutation. The cases follow
tests/test_sharded.py: local gates, a dense gate on a device bit (a
relabelling swap), diagonals on device bits (no swap), dense gates on bank
bits (K6) and on bank and local bits together (the block decomposition),
QFT, GHZ and random circuits, and the swap round trip."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_torch.models.circuits as TC  # noqa: E402
import qubism_tpu.models.circuits as JC  # noqa: E402
import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.ops import fusion as TF  # noqa: E402
from qubism_torch.parallel import ShardedSim, make_mesh  # noqa: E402
from qubism_torch.parallel import mesh as tmesh  # noqa: E402
from qubism_torch.parallel import sharded as tsharded  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from qubism_tpu.parallel.sharded import ShardedSim as JaxShardedSim  # noqa: E402
from tests.test_fusion import random_prims  # noqa: E402

TOL = 1e-5
H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)
X = np.array([[0, 1], [1, 0]], dtype=complex)
CX = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
CZ = np.array([1, 1, 1, -1], dtype=complex)


@pytest.fixture(autouse=True)
def modes():
    JK.INTERPRET = True
    old = config.device
    config.device = "cpu"
    yield
    JK.INTERPRET = False
    config.device = old


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(8)


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def both(n, jprims, jmesh, banks, fused=True):
    """The same prims through the JAX package's ShardedSim and the port's."""
    js = JaxShardedSim(n, jmesh, banks=banks).apply(jprims, fused=fused)
    ts = ShardedSim(n, make_mesh(8), banks=banks)
    ts.apply([TPrim(p.u, tuple(p.targets), p.diag) for p in jprims], fused=fused)
    return js, ts


def step_kinds(sim):
    return {step[0] for steps in sim._lowered.values() for step in steps}


def mixed_prims(n):
    """H everywhere, then (on the 8-shard mesh, bits 0-2 device, 3..3+w-1
    bank): a CX on a device bit (swap), diagonals on device bits and on
    device + bank + local bits, a bank-bit H (K6 when w > 0), CXs on a bank
    bit and a local bit both ways (the block decomposition), a 2-bank-bit
    CX (K6 with S = 4 when w = 2), then a random stream."""
    prims = [JPrim(H, (q,)) for q in range(n)]
    prims += [
        JPrim(CX, (0, n - 1)),
        JPrim(CZ, (1, n - 2), diag=True),
        JPrim(np.array([1, 1j]), (2,), diag=True),
        JPrim(np.exp(1j * np.arange(8) * 0.3), (1, 3, n - 1), diag=True),
        JPrim(H, (3,)),
        JPrim(CX, (3, 6)),
        JPrim(CX, (n - 1, 3)),
        JPrim(CX, (4, 3)),
        JPrim(X, (4,)),
        JPrim(CZ, (0, 3), diag=True),
    ]
    return prims + random_prims(n, 25, n)


@pytest.mark.parametrize("banks", [0, 1, 2])
def test_mixed_circuit_matches_jax(jmesh, banks):
    n = 9
    js, ts = both(n, mixed_prims(n), jmesh, banks)
    assert (ts.D, ts.d, ts.w, ts.m) == (8, 3, banks, n - 3 - banks)
    assert ts.perm == js.perm and ts.perm != list(range(n))
    assert rel(ts.amplitudes(), js.amplitudes()) <= TOL
    want = {"banks", "gdiag"} | ({"bfly", "crossmix"} if banks else set())
    assert step_kinds(ts) == want
    assert ts.dispatch_count == js.dispatch_count


@pytest.mark.parametrize("banks", [0, 1, 2])
@pytest.mark.parametrize("family", ["qft", "ghz", "random"])
def test_families_match_jax(jmesh, family, banks):
    n = 8
    jprims = {"qft": lambda: JC.qft_prims(n), "ghz": lambda: JC.ghz_prims(n),
              "random": lambda: random_prims(n, 30, banks)}[family]()
    js, ts = both(n, jprims, jmesh, banks)
    assert ts.perm == js.perm
    assert rel(ts.amplitudes(), js.amplitudes()) <= TOL


def test_local_and_device_bit_gates(jmesh):
    """A local gate moves no qubit; a dense gate on a device bit swaps it
    to the outermost free local position; a diagonal on device bits moves
    none."""
    n = 6
    for prims, moved in [([JPrim(H, (4,))], False), ([JPrim(H, (0,))], True),
                         ([JPrim(H, (4,)), JPrim(CZ, (0, 4), diag=True)], False)]:
        js, ts = both(n, prims, jmesh, 0)
        assert ts.perm == js.perm and (ts.perm != list(range(n))) == moved
        assert rel(ts.amplitudes(), js.amplitudes()) <= TOL
    js, ts = both(n, [JPrim(H, (0,))], jmesh, 0)
    assert ts.perm[0] == 3  # the outermost local position


def test_swap_roundtrip(jmesh):
    n = 7
    prims = [JPrim(H, (q,)) for q in range(n)] + random_prims(n, 10, 4)
    js, ts = both(n, prims, jmesh, 1)
    before, perm = ts.amplitudes(), list(ts.perm)
    js.swap_global_local(1, 5)
    ts.swap_global_local(1, 5)
    assert ts.perm == js.perm
    assert rel(ts.amplitudes(), js.amplitudes()) <= TOL
    assert rel(ts.amplitudes(), before) <= TOL  # amplitudes() follows perm
    ts.swap_global_local(1, 5)
    assert ts.perm == perm
    assert rel(ts.amplitudes(), before) <= 1e-7  # a swap only moves amplitudes
    with pytest.raises(ValueError, match="device and a local"):
        ts.swap_global_local(3, 5)  # 3 is a bank bit


@pytest.mark.parametrize("banks", [0, 2])
def test_fused_matches_unfused(banks):
    n = 9
    prims = [TPrim(p.u, p.targets, p.diag) for p in JC.brickwork_prims(n, 3, seed=5)]
    a = ShardedSim(n, make_mesh(8), banks=banks).apply(prims, fused=True)
    b = ShardedSim(n, make_mesh(8), banks=banks).apply(prims, fused=False)
    assert a.perm == b.perm
    assert rel(a.amplitudes(), b.amplitudes()) <= TOL


def test_dispatch_count_and_single_device_engine():
    """A fused sharded QFT runs at most twice as many segments and swaps as
    the single-device engine runs fused passes, and gives its state
    (tests/test_sharded.py::test_fused_apply_dispatch_count)."""
    n = 16
    single = TF.CompiledCircuit(n, TC.qft_prims(n))
    want = single.state_to_complex(single(single.init_state()))
    sim = ShardedSim(n, make_mesh(8)).apply(TC.qft_prims(n))
    assert 0 < sim.dispatch_count <= 2 * len(single.ops)
    assert rel(sim.amplitudes(), want) <= TOL


def test_lowered_segments_are_reused():
    n = 8
    prims = TC.ghz_prims(n)
    sim = ShardedSim(n, make_mesh(2), banks=1).apply(prims)
    first = sim.amplitudes()
    keys = list(sim._lowered)
    sim.reset_state().apply(prims)
    assert list(sim._lowered) == keys  # no new lowering on a rerun
    assert rel(sim.amplitudes(), first) <= 1e-7


def test_layout_rules():
    assert tsharded.LOCAL_MAX == 29
    assert [tsharded.default_banks(n, 3) for n in (30, 32, 33, 34)] == [0, 0, 1, 2]
    assert tsharded.default_banks(30, 0) == 1  # one card at 30 qubits: 2 banks
    plan = ShardedSim(34, make_mesh(8), allocate=False)
    assert (plan.w, plan.m, plan.banks) == (2, 29, None)
    with pytest.raises(ValueError, match="power of two"):
        ShardedSim(6, [torch.device("cpu")] * 3)
    with pytest.raises(ValueError, match="local qubit"):
        ShardedSim(5, make_mesh(8), banks=1)
    sim = ShardedSim(6, [torch.device("cpu")] * 4, banks=1)  # repeats allowed
    assert len({id(t) for row in sim.banks for t in row}) == 8
    assert all(t.numel() == 8 and t.dtype == torch.complex64 for row in sim.banks for t in row)


def test_make_mesh(monkeypatch):
    assert make_mesh(4) == (torch.device("cpu"),) * 4
    assert make_mesh() == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="power of two"):
        make_mesh(3)
    monkeypatch.setattr(config, "device", "cuda")
    monkeypatch.setattr(tmesh.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 2)
    assert make_mesh(2) == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh() == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="requested 4 devices, have 2"):
        make_mesh(4)
