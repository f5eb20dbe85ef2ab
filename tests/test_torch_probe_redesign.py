"""The host side of the bandwidth probe's copy and read kernels
(csrc/probe_copy_read.cu), on the CPU.

* A numpy walker replays the partition that ``probes.partition`` hands the
  kernels, index for index as the kernels compute it: the copy's blocks
  take the tiles b, b + G, b + 2G, ... (one each unless the grid is capped),
  the read's blocks contiguous runs of tiles; inside a tile access j of
  thread t is float4 j * T + t; the float4s past the last full tile are the
  last block's. Every float4 is read (and written) exactly once, for every
  copy and read geometry of the probe at n = 1 .. 40, the read with 132
  SMs and 1.
  Up to 2^22 float4s the walk is enumerated; past that, its two maps
  (block and step -> tile, thread and access -> float4 of the tile) are
  checked one by one.
* A numpy replay of the read kernel's arithmetic (VEC float32 lanes per
  thread, added in a fixed order, a shuffle tree per warp and over the
  warps, one partial per block, the partials added in float64 by the last
  block the same way) agrees with ``stream_plain(..., "read")`` to 1e-6 of
  the sum of magnitudes (float32 partial sums), and two replays agree bit
  for bit.
* Through a stand-in for the kernel library (a meta tensor takes the
  kernel path), the wrappers hand the kernels that partition, keep the
  read's scratch between calls and never call the older stream entry for
  copy or read.
* On CPU tensors, ``copy``, ``read`` and ``stream`` equal the
  JAX ``make_pallas_copy`` / ``make_pallas_read_only`` in interpret mode
  (copy exactly, the sum to 1e-5 relative, as tests/test_torch_bw_probe.py).
"""

import ctypes
import functools
import importlib.util
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
from qubism_torch.ops import build as TBuild  # noqa: E402
from qubism_torch.ops import kernels as TK  # noqa: E402
from qubism_torch.ops import probes as TP  # noqa: E402

REF_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "experiments", "bw_probe.py")
#: the largest walk enumerated float4 by float4
ENUMERATE_MAX = 1 << 22
#: a tile of 96 x 2 float4s (not a power of two: a tail at every size)
ODD = (96, 2)


def _geometries(mode):
    """The probe's geometries for a mode: its variants' names, and ODD."""
    found = {tuple(int(v) for v in m.groups())
             for name in TB.VARIANTS if name.startswith(mode + "_")
             for m in [re.search(r"_(\d+)x(\d+)", name)] if m}
    return sorted(found | {ODD})


COPY_GEOMETRIES = _geometries("copy")
READ_GEOMETRIES = _geometries("read") + [(1024, 4), (256, 1)]
NS = (1, 2, 3, 9, 12, 28, 40)


def test_geometries_cover_the_probe():
    assert {(256, 1), (256, 4), (1024, 4)} <= set(COPY_GEOMETRIES)
    assert (256, 4) in READ_GEOMETRIES


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------


def counts_of(blocks, per, extra, which):
    which = np.asarray(which, dtype=np.int64)
    return per + (which < extra)


def block_tiles(kind, b, blocks, per, extra):
    """The tiles block b walks, in order, as the kernel computes them."""
    k = np.arange(per + (b < extra), dtype=np.int64)
    if kind == "copy":
        return b + k * blocks
    return b * per + min(b, extra) + k


def tile_lanes(threads, vec):
    """(thread t, access j) -> float4 j * T + t of the tile, as [j, t]."""
    return np.arange(vec)[:, None] * threads + np.arange(threads)[None, :]


def tail(n, threads, vec):
    """The last block's float4s past the last full tile: thread t takes
    full + t, full + t + T, ..."""
    items = (1 << n) // 2
    start = items // (threads * vec) * threads * vec
    return np.concatenate([np.arange(start + t, items, threads, dtype=np.int64)
                           for t in range(threads)])


def walk(kind, n, threads, vec, blocks, per, extra):
    """Every float4 index the kernel's blocks access, in block order."""
    lanes = tile_lanes(threads, vec).ravel()
    tile = threads * vec
    parts = [(block_tiles(kind, b, blocks, per, extra)[:, None] * tile + lanes).ravel()
             for b in range(blocks)]
    return np.concatenate(parts + [tail(n, threads, vec)])


def check_partition(kind, n, threads, vec, max_blocks):
    items = (1 << n) // 2
    tile = threads * vec
    tiles = items // tile
    blocks, per, extra = TP.partition(n, threads, vec, max_blocks)
    assert blocks == max(1, min(max_blocks, tiles))
    assert 0 <= extra < blocks and blocks * per + extra == tiles
    if items <= ENUMERATE_MAX:
        idx = walk(kind, n, threads, vec, blocks, per, extra)
        assert idx.min() >= 0 and idx.max() < items
        assert np.array_equal(np.bincount(idx, minlength=items), np.ones(items, dtype=np.int64))
        return
    # thread and access -> float4 of the tile: onto 0 .. tile - 1
    assert np.array_equal(np.sort(tile_lanes(threads, vec).ravel()), np.arange(tile))
    # the tail: every float4 past the last full tile, once
    t = tail(n, threads, vec)
    assert np.array_equal(np.sort(t), np.arange(tiles * tile, items))
    # block and step -> tile
    if kind == "read":
        b = np.arange(blocks, dtype=np.int64)
        first = b * per + np.minimum(b, extra)
        end = first + counts_of(blocks, per, extra, b)
        assert first[0] == 0 and np.array_equal(first[1:], end[:-1]) and end[-1] == tiles
        return
    # the copy: block b holds exactly the tiles t < tiles with t = b (mod G)
    rng = np.random.default_rng(n)
    sample = {0, 1, extra - 1, extra, blocks - 2, blocks - 1} | set(
        rng.integers(0, blocks, 64).tolist())
    for b in sorted(x for x in sample if 0 <= x < blocks):
        got = block_tiles("copy", b, blocks, per, extra)
        assert len(got) == len(range(b, tiles, blocks))
        assert np.all(got % blocks == b) and np.all(got < tiles)


@pytest.mark.parametrize("geometry", COPY_GEOMETRIES)
@pytest.mark.parametrize("n", NS)
def test_copy_partition_moves_every_float4_once(n, geometry):
    """The copy's grid as the wrapper makes it: one block a tile up to
    COPY_MAX_BLOCKS blocks (at n = 40, 256x1: two tiles a block)."""
    check_partition("copy", n, *geometry, TP.COPY_MAX_BLOCKS)


@pytest.mark.parametrize("resident", [1, 2, 8])
@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("geometry", READ_GEOMETRIES)
@pytest.mark.parametrize("n", NS)
def test_read_partition_reads_every_float4_once(n, geometry, sms, resident):
    check_partition("read", n, *geometry, sms * resident)


def test_copy_grid_is_one_block_a_tile():
    blocks, per, extra = TP.partition(28, 256, 1, TP.COPY_MAX_BLOCKS)
    assert (blocks, per, extra) == (1 << 19, 1, 0)
    # past 2^30 tiles the grid is capped and blocks take two
    assert TP.partition(40, 256, 1, TP.COPY_MAX_BLOCKS) == (1 << 30, 2, 0)
    assert TP.partition(3, 256, 4, TP.COPY_MAX_BLOCKS) == (1, 0, 0)


# ---------------------------------------------------------------------------
# the read kernel's sum, replayed
# ---------------------------------------------------------------------------


def block_tree(v):
    """The kernel's block_sum over the last axis (threads, a multiple of
    32), in v's dtype: a shuffle-down tree in each warp, lane 0's results
    padded to 32 lanes, the same tree."""
    def warp_tree(w):
        w = w.copy()
        for o in (16, 8, 4, 2, 1):
            w[..., :o] = w[..., :o] + w[..., o:2 * o]
        return w[..., 0]

    lead = v.shape[:-1]
    firsts = warp_tree(v.reshape(*lead, -1, 32))
    padded = np.zeros((*lead, 32), dtype=v.dtype)
    padded[..., :firsts.shape[-1]] = firsts
    return warp_tree(padded)


def read_replay(x, n, threads, vec, blocks, per, extra):
    """The read kernel's sum of x (float32 (items, 4)), in its order."""
    items = (1 << n) // 2
    tile = threads * vec
    b = np.arange(blocks)
    count = per + (b < extra)
    first = b * per + np.minimum(b, extra)
    lanes = tile_lanes(threads, vec)  # [j, t]
    acc = np.zeros((blocks, vec, threads), dtype=np.float32)
    for k in range(per + (extra > 0)):
        on = k < count
        idx = (first[on] + k)[:, None, None] * tile + lanes[None]
        v = x[idx]
        acc[on] = acc[on] + ((v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3]))
    start = items // tile * tile
    for i0 in range(start, items, threads):
        t = np.arange(threads)
        on = i0 + t < items
        v = x[(i0 + t)[on]]
        acc[-1, 0, on] = acc[-1, 0, on] + ((v[:, 0] + v[:, 1]) + (v[:, 2] + v[:, 3]))
    lane_sum = acc[:, 0]
    for j in range(1, vec):
        lane_sum = lane_sum + acc[:, j]
    partial = block_tree(lane_sum)  # float32, one a block
    a = np.zeros(threads, dtype=np.float64)
    for i0 in range(0, blocks, threads):
        chunk = partial[i0:i0 + threads].astype(np.float64)
        a[:len(chunk)] = a[:len(chunk)] + chunk
    return np.float32(block_tree(a))


@pytest.mark.parametrize("sms,resident", [(132, 8), (1, 2)])
@pytest.mark.parametrize("geometry", READ_GEOMETRIES)
@pytest.mark.parametrize("n", [1, 3, 9, 14, 20])
def test_read_replay_matches_plain(n, geometry, sms, resident):
    rng = np.random.default_rng(n + geometry[0])
    planes = rng.normal(size=(2, 1 << n)).astype(np.float32) + np.float32(0.5)
    state = TA.state_from_planes(planes[0], planes[1])
    x = torch.view_as_real(state).numpy().reshape(-1, 4)
    part = TP.partition(n, *geometry, sms * resident)
    got = read_replay(x, n, *geometry, *part)
    again = read_replay(x.copy(), n, *geometry, *part)
    assert got.tobytes() == again.tobytes()
    want = float(TP.stream_plain(state, "read", n)[0])
    scale = float(np.abs(x.astype(np.float64)).sum())
    assert abs(float(got) - want) <= 1e-6 * scale


# ---------------------------------------------------------------------------
# the wrappers' host side, through a stand-in library
# ---------------------------------------------------------------------------


class FakeLib:
    """Records the copy and read entries' arguments; the stream entry must
    not be reached from copy or read."""

    def __init__(self, sms=132, resident=8):
        self.calls = []
        self.occupancy = (sms, resident)

    def qk_probe_read_occupancy(self, threads, vec, dev, out):
        out[0], out[1] = self.occupancy
        self.calls.append(("occupancy", threads, vec))
        return 0

    def qk_probe_copy(self, src, dst, n, threads, vec, blocks, per, extra, kib, dev, st):
        self.calls.append(("copy", n, threads, vec, blocks, per, extra, kib))
        return 0

    def qk_probe_read(self, src, n, threads, vec, blocks, per, extra, partial, plen, counter,
                      out, dev, st):
        self.calls.append(("read", n, threads, vec, blocks, per, extra, partial.value, plen,
                           counter.value))
        return 0

    def qk_probe_stream(self, *args):
        raise AssertionError("copy or read went to the older stream kernel")


@pytest.fixture
def fake(monkeypatch):
    lib = FakeLib()

    def launch(state, name, call, counts=None):
        assert state.device.type == "meta"
        rc = call(lib, 0, ctypes.c_void_p(None))
        assert rc == 0
        counts[name] += 1
        return state

    monkeypatch.setattr(TK, "_launch", launch)
    # meta tensors have no storage, so the copy's check that out is a second
    # buffer cannot tell two of them apart (it is held on CPU tensors below)
    check_out = TP._check_out
    monkeypatch.setattr(TP, "_check_out", lambda out, state, mode=None: check_out(
        out, state, None if state.device.type == "meta" else mode))
    monkeypatch.setattr(TP, "_read_slots", {})
    monkeypatch.setattr(TP, "_read_scratch", {})
    monkeypatch.setattr(TBuild, "library", lambda: lib)
    TP.reset_launches()
    yield lib
    TP.reset_launches()


@pytest.mark.parametrize("geometry", COPY_GEOMETRIES)
def test_copy_hands_the_kernel_its_partition(fake, geometry):
    n = 20
    s = torch.empty(1 << n, dtype=torch.complex64, device="meta")
    out = torch.empty_like(s)
    assert TP.copy(s, n, out, geometry=geometry) is out
    assert TP.stream(s, "copy", n, out, geometry=geometry) is out
    want = ("copy", n, *geometry, *TP.partition(n, *geometry, TP.COPY_MAX_BLOCKS),
            TP.COPY_INFLIGHT_KIB)
    assert fake.calls == [want] * 2
    assert TP.launches["probe_copy"] == len(fake.calls) and TP.launches["probe_stream"] == 0


@pytest.mark.parametrize("geometry", READ_GEOMETRIES)
def test_read_hands_the_kernel_its_partition_and_keeps_its_scratch(fake, geometry):
    n = 22
    s = torch.empty(1 << n, dtype=torch.complex64, device="meta")
    totals = [TP.read(s, n, geometry=geometry), TP.stream(s, "read", n, geometry=geometry)]
    assert all(t.shape == (1,) and t.dtype == torch.float32 for t in totals)
    assert totals[0] is not totals[1]  # a new result each call
    reads = [c for c in fake.calls if c[0] == "read"]
    blocks, per, extra = TP.partition(n, *geometry, 132 * 8)
    assert [c[1:7] for c in reads] == [(n, *geometry, blocks, per, extra)] * 2
    assert reads[0][7:] == reads[1][7:] and reads[0][8] >= blocks  # the same scratch
    # the occupancy is asked once per device and geometry
    assert [c for c in fake.calls if c[0] == "occupancy"] == [("occupancy", *geometry)]
    partial, counter = TP._read_scratch[0]
    assert counter.dtype == torch.int32 and counter.shape == (1,)
    assert TP.launches["probe_read"] == 2 and TP.launches["probe_stream"] == 0


def test_read_scratch_grows_with_the_grid(fake):
    s = torch.empty(1 << 22, dtype=torch.complex64, device="meta")
    TP.read(s, 22, geometry=(1024, 4))
    small = TP._read_scratch[0][0].numel()
    TP.read(s, 22, geometry=(256, 1))
    assert TP._read_scratch[0][0].numel() > small


def test_copy_refuses_a_missing_or_aliased_out():
    s = torch.zeros(1 << 6, dtype=torch.complex64)
    with pytest.raises(ValueError, match="second buffer"):
        TP.copy(s, 6, None)
    with pytest.raises(ValueError, match="second buffer"):
        TP.copy(s, 6, s)


# ---------------------------------------------------------------------------
# against the JAX probes, on CPU tensors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("jax_bw_probe_redesign", REF_PATH)
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
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=1 << n) + 0.5).astype(np.float32) for _ in range(2))


_JAX = {}


def jax_output(ref, outputs, key, make):
    """The JAX probe's output for ``key``, run once per module: the copy's
    planes, or the read's accumulator tile."""
    if key not in _JAX:
        kind, n, BR, C = key
        re_, im_ = planes(n, 100 + n)
        out = make(n, BR, C)((jnp.asarray(re_), jnp.asarray(im_)))
        _JAX[key] = ((re_, im_), np.asarray(out[0]) + 1j * np.asarray(out[1])
                     if kind == "copy" else np.asarray(outputs[-1]))
    return _JAX[key]


@pytest.mark.parametrize("geometry", COPY_GEOMETRIES)
@pytest.mark.parametrize("n,BR,C", [(9, 1, 128), (12, 8, 128)])
def test_copy_matches_pallas_copy(ref, outputs, n, BR, C, geometry):
    (re_, im_), want = jax_output(ref, outputs, ("copy", n, BR, C), ref.make_pallas_copy)
    s = TA.state_from_planes(re_, im_)
    before = dict(TP.launches)
    got = TP.copy(s, n, torch.empty_like(s), geometry=geometry)
    assert np.array_equal(got.numpy(), want.astype(np.complex64))
    assert np.array_equal(TP.stream(s, "copy", n, torch.empty_like(s), geometry=geometry).numpy(),
                          want.astype(np.complex64))
    assert TP.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("geometry", READ_GEOMETRIES)
@pytest.mark.parametrize("n,BR,C", [(9, 1, 128), (12, 8, 128), (12, 2, 256)])
def test_read_matches_pallas_accumulator(ref, outputs, n, BR, C, geometry):
    (re_, im_), acc = jax_output(ref, outputs, ("read", n, BR, C), ref.make_pallas_read_only)
    assert acc.shape == (BR, C)
    want = float(np.sum(acc, dtype=np.float64))
    s = TA.state_from_planes(re_, im_)
    for got in (TP.read(s, n, geometry=geometry), TP.stream(s, "read", n, geometry=geometry)):
        assert got.dtype == torch.float32 and got.shape == (1,)
        assert abs(float(got[0]) - want) <= 1e-5 * abs(want)
