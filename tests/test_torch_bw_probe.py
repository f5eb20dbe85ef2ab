"""The bandwidth probe's two kernels (their wrappers, which run the plain
versions on a CPU tensor, and the plain versions themselves) against the
JAX probes of ``experiments/bw_probe.py``, run with their Pallas kernels in
interpret mode on the same seeded numpy planes; and the bookkeeping of the
port's probe entry point (``qubism_torch.experiments.bw_probe``).

Tolerances: copy and write are exact; phase and pair agree to 1e-6 relative
L2 (a few float32 operations per value, in another order); the read probe's
sum agrees with the sum of the JAX probe's accumulator tile to 1e-5
relative (float32 partial sums in another order); the lane probe agrees to
1e-5 relative L2 (128-term complex64 dot products, the bound of
tests/test_kernels.py). The JAX probe module is loaded by path and left as
it is; each test routes its ``pl.pallas_call`` to interpret mode.
"""

import functools
import importlib.util
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from qubism_torch.config import config  # noqa: E402
from qubism_torch.experiments import bw_probe as TB  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import kernels as TK  # noqa: E402
from qubism_torch.ops import probes as TP  # noqa: E402

REF_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "experiments", "bw_probe.py")
TOL = 1e-6
H = TB.HADAMARD


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("jax_bw_probe", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


@pytest.fixture
def outputs(monkeypatch, ref):
    """The JAX probe's pallas_call in interpret mode; every kernel output is
    appended to the returned list."""
    original = pl.pallas_call
    outs = []

    def patched(*args, **kw):
        call = functools.partial(original, interpret=True)(*args, **kw)

        def run(*operands):
            out = call(*operands)
            outs.append(out)
            return out

        return run

    monkeypatch.setattr(ref.pl, "pallas_call", patched)
    return outs


def planes(n, seed):
    """Seeded float32 planes; the offset keeps the read probe's sum far
    from 0."""
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=1 << n) + 0.5).astype(np.float32) for _ in range(2))


def to_complex(re, im):
    return (np.asarray(re, dtype=np.float64).reshape(-1)
            + 1j * np.asarray(im, dtype=np.float64).reshape(-1))


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def port(fn, re, im, *args, **kw):
    """``fn`` on a fresh state from the planes, with ``out`` made when
    ``kw["out"]`` is True; the tensor it returns as complex128."""
    s = TA.state_from_planes(re, im)
    if kw.get("out") is True:
        kw["out"] = torch.empty_like(s)
    got = fn(s, *args, **kw)
    if kw.get("out") is not None:
        assert got is kw["out"]
    elif got.is_complex():
        assert got is s  # in place
    return to_complex(*TA.planes_from_state(got)) if got.is_complex() else got


def jax_run(run, re, im, shape=None):
    shape = shape or (-1,)
    out = run((jnp.asarray(re.reshape(shape)), jnp.asarray(im.reshape(shape))))
    return to_complex(*out)


# ---------------------------------------------------------------------------
# the stream probe (P1-P5, P11)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", [TP.stream, TP.stream_plain])
@pytest.mark.parametrize("BR,C", [(8, 128), (4, 256)])
def test_copy_matches_pallas_copy(ref, outputs, fn, BR, C):
    n = 12
    re, im = planes(n, 1)
    want = jax_run(ref.make_pallas_copy(n, BR, C), re, im)
    got = port(fn, re, im, "copy", n, out=True)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fn", [TP.stream, TP.stream_plain])
@pytest.mark.parametrize("BR,C,arbitrary", [(8, 128, False), (8, 128, True), (2, 512, False)])
def test_phase_matches_pallas_phase(ref, outputs, fn, BR, C, arbitrary):
    """P1 in place (P11, main_canon's phase2d, has the same kernel body)."""
    n = 12
    re, im = planes(n, 2)
    want = jax_run(ref.make_pallas_phase(n, BR, C, arbitrary), re, im)
    assert rel(port(fn, re, im, "phase", n), want) <= TOL
    assert len(outputs) == 1


@pytest.mark.parametrize("fn", [TP.stream, TP.stream_plain])
def test_phase_noalias_matches_pallas(ref, outputs, fn):
    n = 11
    re, im = planes(n, 3)
    want = jax_run(ref.make_pallas_phase_noalias(n, 8, 128), re, im)
    assert rel(port(fn, re, im, "phase", n, out=True), want) <= TOL


@pytest.mark.parametrize("fn", [TP.stream, TP.stream_plain])
@pytest.mark.parametrize("BR,C", [(8, 128), (2, 256)])
def test_read_matches_pallas_accumulator(ref, outputs, fn, BR, C):
    n = 12
    re, im = planes(n, 4)
    jax_run(ref.make_pallas_read_only(n, BR, C), re, im)
    (acc,) = outputs
    assert acc.shape == (BR, C)
    want = float(np.sum(np.asarray(acc), dtype=np.float64))
    got = port(fn, re, im, "read", n)
    assert got.dtype == torch.float32 and got.shape == (1,)
    assert abs(float(got[0]) - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("fn", [TP.stream, TP.stream_plain])
@pytest.mark.parametrize("into_out", [False, True])
def test_write_matches_pallas_write(ref, outputs, fn, into_out):
    n = 12
    re, im = planes(n, 5)
    want = jax_run(ref.make_pallas_write_only(n, 8, 128), re, im)
    got = port(fn, re, im, "write", n, **({"out": True} if into_out else {}))
    assert np.array_equal(got, want)
    assert got[0] == re[0] + 0.5j * re[0]


# ---------------------------------------------------------------------------
# the pair probe (P6-P9)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", [TP.pair, TP.pair_plain])
@pytest.mark.parametrize("n,q,BB,C", [(12, 5, 128, 2048), (12, 2, 2, 128), (11, 0, 4, 256),
                                      (10, 9, 128, 2048)])
def test_pair_matches_stage(ref, outputs, fn, n, q, BB, C):
    """P6: H on qubit q, then C1 + i C2 on the |1> branch, (A, 2, B, C) view."""
    re, im = planes(n, 6 + q)
    want = jax_run(ref.make_stage(n, q, BB, C), re, im)
    assert rel(port(fn, re, im, q, H, n, phase=TP.PHASE), want) <= TOL


@pytest.mark.parametrize("fn", [TP.pair, TP.pair_plain])
@pytest.mark.parametrize("q", [3, 5, 8])
def test_pair_matches_stage_flat(ref, outputs, fn, q):
    """P7: the same pass on an (A, 2 * tail) view."""
    n = 12
    re, im = planes(n, 20 + q)
    want = jax_run(ref.make_stage_flat(n, q), re, im)
    assert rel(port(fn, re, im, q, H, n, phase=TP.PHASE), want) <= TOL


@pytest.mark.parametrize("fn", [TP.pair, TP.pair_plain])
@pytest.mark.parametrize("smem,bt,ct", [(True, True, True), (True, False, False),
                                        (False, True, False), (False, False, True)])
@pytest.mark.parametrize("n,q,C", [(12, 3, 32), (12, 0, 8)])
def test_pair_matches_stage_tables(ref, outputs, fn, smem, bt, ct, n, q, C):
    """P8 with each selection of its operands. At (12, 3, 32) the row table
    has B = 8 < 128 entries (one block of rows); at (12, 0, 8) B = 256, so
    the JAX probe streams it in blocks of 128. The operands are drawn again
    after the same np.random.seed, in the JAX probe's order."""
    re, im = planes(n, 40 + q)
    np.random.seed(1000 + q)
    run = ref.make_stage_tables(n, q, 128, C, smem, bt, ct)
    want = jax_run(run, re, im)
    np.random.seed(1000 + q)
    tail = 1 << (n - 1 - q)
    B = tail // C
    cf = np.random.randn(2, 2, 2).astype(np.float32)
    bts = np.random.randn(2, max(B, 128)).astype(np.float32)
    cts = np.random.randn(2, C).astype(np.float32)

    def table(t):
        return torch.from_numpy((t[0] + 1j * t[1]).astype(np.complex64))

    got = port(fn, re, im, q, cf[0] + 1j * cf[1] if smem else H, n, phase=TP.PHASE,
               row=table(bts[:, :B]) if bt else None, lane=table(cts) if ct else None, cols=C)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("fn", [TP.pair, TP.pair_plain])
@pytest.mark.parametrize("n,stride,BR", [(12, 512, 2), (12, 2048, 2), (13, 4096, 4)])
def test_pair_matches_roll_butterfly(ref, outputs, fn, n, stride, BR):
    """P9: H alone at stride 512 (a lane roll of the (R, 2048) tile), 2048
    and 4096 (row rolls)."""
    q = n - 1 - int(math.log2(stride))
    run, shape = ref.make_roll_butterfly(n, q, BR)
    re, im = planes(n, 60 + q)
    want = jax_run(run, re, im, shape)
    assert rel(port(fn, re, im, q, H, n, phase=1), want) <= TOL


class _NumpyWithEye:
    """numpy, except that ``eye`` returns a given matrix."""

    def __init__(self, m):
        self._m = m

    def eye(self, *args, **kw):
        return self._m

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.mark.parametrize("fn", [TK.lane, TK.lane_plain])
def test_lane_probe_is_the_lane_kernel(ref, outputs, monkeypatch, fn):
    """P10, x . (M + 0.5 i M) on every 128-amplitude row, with a random M in
    place of the JAX probe's identity: K3 with U = (M + 0.5 i M)^T."""
    n = 12
    m = np.random.default_rng(10).normal(size=(128, 128)).astype(np.float32) / 8
    monkeypatch.setattr(ref, "np", _NumpyWithEye(m))
    run, shape = ref.make_lane_matmul_canonical(n, 2)
    re, im = planes(n, 11)
    want = jax_run(run, re, im, shape)
    u = (m.astype(np.complex128) * (1 + 0.5j)).T
    assert rel(port(fn, re, im, u, n), want) <= 1e-5


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------


def test_wrappers_launch_or_raise_off_the_cpu():
    """A state that is not on the CPU goes to the kernel, never to the plain
    version: on a meta tensor the wrappers raise and count nothing."""
    TP.reset_launches()
    s = torch.empty(1 << 8, dtype=torch.complex64, device="meta")
    for call in (lambda: TP.stream(s, "phase", 8), lambda: TP.stream(s, "read", 8),
                 lambda: TP.stream(s, "write", 8),
                 lambda: TP.stream(s, "phase", 8, torch.empty_like(s)),
                 lambda: TP.pair(s, 3, H, 8, phase=TP.PHASE)):
        with pytest.raises(ValueError, match="no kernel"):
            call()
    assert TP.launches == {"probe_stream": 0, "probe_copy": 0, "probe_read": 0,
                           "probe_pair": 0}


@pytest.mark.parametrize("case", ["copy_no_out", "copy_in_place", "bad_mode", "geometry",
                                  "pair_geometry", "row_length", "lane_dtype", "qubit",
                                  "out_shape"])
def test_wrappers_refuse_bad_operands(case):
    n = 8
    s = torch.zeros(1 << n, dtype=torch.complex64)
    lane = torch.ones(1 << 4, dtype=torch.complex64)
    calls = {
        "copy_no_out": lambda: TP.stream(s, "copy", n),
        "copy_in_place": lambda: TP.stream(s, "copy", n, s),
        "bad_mode": lambda: TP.stream(s, "scale", n),
        "geometry": lambda: TP.stream(s, "phase", n, geometry=(100, 4)),
        "pair_geometry": lambda: TP.pair(s, 0, H, n, geometry=(1024, 4)),
        "row_length": lambda: TP.pair(s, 0, H, n, row=lane, cols=16),
        "lane_dtype": lambda: TP.pair(s, 0, H, n, lane=lane.real.contiguous(), cols=16),
        "qubit": lambda: TP.pair(s, n, H, n),
        "out_shape": lambda: TP.stream(s, "phase", n, torch.empty(2, dtype=torch.complex64)),
    }
    with pytest.raises(ValueError):
        calls[case]()


def test_pair_tables_index_the_tail_offset():
    """p = row[b] * lane[c] with (b, c) = divmod(offset in the tail, C), on a
    state of ones with an identity coefficient: y1 is p itself."""
    n, q, cols = 9, 2, 8
    tail = 1 << (n - 1 - q)
    row = torch.arange(1, tail // cols + 1, dtype=torch.float32).to(torch.complex64)
    lane = torch.arange(cols, dtype=torch.float32).to(torch.complex64) * 1j + 1
    s = torch.ones(1 << n, dtype=torch.complex64)
    TP.pair(s, q, np.eye(2), n, row=row, lane=lane, cols=cols)
    y = s.view(-1, 2, tail)
    off = torch.arange(tail)
    want = row[off // cols] * lane[off % cols]
    assert torch.equal(y[:, 1], want.expand(1 << q, tail))
    assert torch.equal(y[:, 0], torch.ones(1 << q, tail, dtype=torch.complex64))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_jax_variants_cover_every_reference_probe(ref):
    canon = re.findall(r'\("(\w+)", ', open(REF_PATH).read().split("def main_canon")[1])
    assert tuple(canon) == TB.CANON
    assert set(TB.JAX_VARIANTS) == set(ref.VARIANTS) | set(canon)
    assert len(TB.JAX_VARIANTS) == 32
    assert set(TB.JAX_VARIANTS.values()) <= set(TB.VARIANTS)


def test_costs_and_bounds():
    amps = 1 << 28
    assert TP.stream_cost("copy", 28) == (16 * amps, 0)
    assert TP.stream_cost("phase", 28) == (16 * amps, 6 * amps)
    assert TP.stream_cost("read", 28) == (8 * amps, 2 * amps)
    assert TP.stream_cost("write", 28) == (8 * amps, 0)
    ms, by = TP.bound(*TP.stream_cost("copy", 28))
    assert by == "bytes" and ms == pytest.approx(16 * amps / 3.35e12 * 1e3)
    assert ms == pytest.approx(1.282, abs=5e-4)
    assert TP.bound(*TP.stream_cost("write", 28))[0] == pytest.approx(ms / 2)
    row, lane = torch.ones(2048, dtype=torch.complex64), torch.ones(2048, dtype=torch.complex64)
    assert TP.pair_cost(28) == (16 * amps, (32 + 6) * amps // 2)
    assert TP.pair_cost(28, row, lane) == (16 * amps + 2 * 2048 * 8, (32 + 12) * amps // 2)
    # the lane probe: 128 complex multiply-adds per amplitude at the fp32 peak
    ms, by = TP.bound(16 * amps, amps * 128 * 8)
    assert by == "operations" and ms == pytest.approx(4.103, abs=5e-4)


def test_every_variant_builds_and_its_library_call_agrees(monkeypatch):
    """Each variant built at n = 21 on the CPU: one pass, its bytes, and
    where there is a library call, the same result as the plain pass."""
    n = 21

    def once(fn):
        fn()
        return 1.0

    monkeypatch.setattr(TB, "time_pass", once)
    for name, build in TB.VARIANTS.items():
        probe = build(n, "cpu")
        probe.run()
        line = TB.measure(name, n, "cpu")
        assert line["kernel"] == probe.kernel
        assert line["ms_per_pass"] == 1.0 and line["bound_ms"] > 0
        assert line["gbps"] == pytest.approx(probe.nbytes / 1e6)
        assert (line["plain_ms"] is None) == (probe.kernel is None)
        if probe.library is None:
            continue
        x = probe.state.clone()
        want = probe.plain().clone()
        probe.state.copy_(x)  # the same input for the library call
        got = probe.library()
        if name.startswith("read"):  # relative to the sum of magnitudes
            scale = float(torch.view_as_real(x).abs().sum())
            assert abs(float(got) - float(want[0])) <= 1e-5 * scale, name
        else:
            assert torch.allclose(got.reshape(want.shape), want, rtol=1e-5, atol=1e-6), name


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **kw):
        raise AssertionError("ran without a card")

    monkeypatch.setattr(TB, "run", never)
    assert TB.main([]) == 2
    assert TB.main(["24", "phase_256x4"]) == 2
    assert TB.main(["canon"]) == 2
    assert "needs a CUDA GPU" in capsys.readouterr().err
    assert TB.main(["12"]) == 2  # the state would fit in the L2
    assert TB.main(["28", "no_such_variant"]) == 2
