"""The host side of the port's tensor-core lane kernel and vectorised diag
kernel (csrc/lane.cu, csrc/diag.cu), on the CPU.

* A numpy interpreter of the diag kernel's pass operands (tables, descriptors,
  thread bits: what ``qk_diag`` / ``qk_diag1`` read) walks the state the way
  the kernel's threads do; it is held against ``diag_plain`` and against the
  JAX ``diag_layer`` in interpret mode. Tolerance: relative L2 <= 1e-6 (the
  tables are complex64; the interpreter multiplies in complex128).
* The lane operands of ``lane_prepare`` rebuild U exactly, and the real matrix
  of the interleaved product reproduces x . U^T.
* A numpy emulation of the kernel's arithmetic on those operands (TF32's 10
  mantissa bits, three products per k8 step, each chunk of four steps summed
  from zero, the chunks added in float32) stays within 1e-6 of the complex128
  product where one TF32 product does not.
* On CPU tensors the wrappers still equal the JAX ``lane_gate`` /
  ``diag_layer`` (relative L2 <= 1e-6 here) and count no launch.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
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


def rand_state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return (v / np.linalg.norm(v)).astype(np.complex64)


def unitary(k, rng):
    m = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0]


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def phases(rng, k):
    return np.exp(1j * rng.uniform(0, 2 * math.pi, 1 << k))


# ---------------------------------------------------------------------------
# diag: the pass operands, interpreted the way the kernel's threads read them
# ---------------------------------------------------------------------------


def open_bit(v, p):
    return ((v >> p) << (p + 1)) | (v & ((1 << p) - 1))


def gather(d, base):
    idx = np.full(base.shape, int(d[1]), dtype=np.int64)
    for r in range(int(d[0])):
        w = int(d[TK._DESC_RUN + r])
        idx += ((base >> (w & 63)) & ((w >> 8) & 127)) << (w >> 16)
    return idx


def mask_hit(d, base):
    u = d.view(np.uint32).astype(np.int64)
    return (base & (u[2] | (u[3] << 32))) == (u[4] | (u[5] << 32))


def interpret_pass(state, p, n):
    """One launch of the diag kernel on ``state`` (complex128, in place)."""
    if p.single is not None:  # qk_diag1
        pos, table = p.single
        i = np.arange(1 << n)
        idx = np.zeros(1 << n, dtype=np.int64)
        for q in pos:
            idx = (idx << 1) | ((i >> int(q)) & 1)
        state *= table[idx]
        return
    tables, desc, own = p.tables, p.desc, p.own
    assert desc.dtype == np.int32 and desc.shape[1] == TK._DESC_WORDS
    assert tables.dtype == np.complex64
    assert tables.size * 8 + desc.size * 4 <= 48 * 1024
    nfac = desc.shape[0]
    if n == 0:  # diag_scalar_kernel
        for d in desc:
            if d[0] >= 0 or mask_hit(d, np.zeros(1, dtype=np.int64))[0]:
                state *= tables[d[1]]
        return
    assert list(own) == sorted(set(own)) and all(1 <= q < n for q in own)
    base = np.arange((1 << n) >> (1 + len(own)), dtype=np.int64) << 1
    for q in own:
        base = open_bit(base, q)
    offs = [(c & 1) + sum(((c >> (b + 1)) & 1) << q for b, q in enumerate(own))
            for c in range(2 << len(own))]
    common = np.ones(base.shape, dtype=np.complex128)
    for d in desc[:p.ninv]:
        if d[0] >= 0:
            common *= tables[gather(d, base)]
        else:
            common *= np.where(mask_hit(d, base), tables[d[1]], 1)
    a = [common.copy() for _ in offs]
    for d in desc[p.ninv:nfac]:
        if d[0] >= 0:
            idx = gather(d, base)
            for c in range(len(offs)):
                delta = (int(d[TK._DESC_DELTA + (c >> 2)]) >> (8 * (c & 3))) & 255
                a[c] *= tables[idx + delta]
        else:
            hit = mask_hit(d, base)
            for c in range(len(offs)):
                if (int(d[6]) >> c) & 1:
                    a[c] *= np.where(hit, tables[d[1]], 1)
    seen = np.zeros(1 << n, dtype=np.int64)
    for c, off in enumerate(offs):
        state[base + off] *= a[c]
        seen[base + off] += 1
    assert (seen == 1).all()  # every amplitude is owned by exactly one thread


def diag_case(name, n, rng):
    """The factor lists of chip_smoke.py's diag checks, at n qubits."""
    hi = n - 1
    cu1 = lambda lam: np.array([1, 1, 1, np.exp(1j * lam)])  # noqa: E731
    if name.startswith("one1q"):  # bit 0, a thread bit, the top bit
        q = {"one1q_bit0": hi, "one1q_thread": hi - 6, "one1q_high": 0}[name]
        return [(phases(rng, 1), (q,))]
    if name.startswith("one2q"):
        t = {"one2q_bit0": (2, hi), "one2q_thread": (hi - 7, hi - 6), "one2q_high": (1, 0)}[name]
        return [(phases(rng, 2), t)]
    if name == "sixtyfour":
        return [(phases(rng, 1 + f % 2), ((f * 5) % n,) if f % 2 == 0
                 else ((f * 5) % n, (f * 5 + 3) % n)) for f in range(64)]
    if name == "low4":  # every factor holds the last qubit: nothing to hoist
        return [(phases(rng, 3), (hi - 3 + f % 3, hi - 4 - f, hi)[::1 if f % 2 else -1])
                for f in range(5)] + [(phases(rng, 4), (hi - 3, hi - 2, hi - 1, hi))]
    if name == "ladder":  # the mesh path's shape: two-qubit factors sharing one qubit
        return [(cu1(math.pi / (1 << j)), (0, j)) for j in range(1, n)]
    if name == "split":  # 4224 table entries: two launches
        return [(phases(rng, 7), tuple(sorted(rng.choice(n, 7, replace=False))))
                for _ in range(33)]
    if name == "onepoint":
        d = np.ones(256, dtype=complex)
        d[int(rng.integers(256))] = -1
        return [(d, (0, 2, 3, n - 8, n - 6, n - 4, n - 2, hi))]
    if name == "wide_generic":  # 8 qubits, no common value: the exact phase split
        return [(phases(rng, 8), tuple(range(1, 9)))]
    if name == "mixed":
        return [(np.array([1, 1, 1, -1], dtype=complex), (0, hi)),
                (phases(rng, 3), (2, n // 2, hi - 1)),
                (phases(rng, 4), (n - 9, n - 8, n - 7, n - 6)),
                (phases(rng, 7), tuple(range(n - 7, n))),
                (phases(rng, 2), (hi, 1))]
    if name == "eight_by_four":  # the timed case, folded to n = 12 qubits
        return [(phases(rng, 4), (q, q + 3, q + 6, hi - q)) for q in range(3)]
    raise ValueError(name)


DIAG_CASES = [
    (11, "one1q_bit0"), (11, "one1q_thread"), (11, "one1q_high"),
    (12, "one2q_bit0"), (12, "one2q_thread"), (12, "one2q_high"),
    (12, "sixtyfour"), (11, "low4"), (12, "ladder"), (9, "ladder"), (12, "split"),
    (12, "onepoint"), (10, "wide_generic"), (12, "mixed"), (12, "eight_by_four"),
    (3, "ladder"), (12, "low4"),
]


def _fix_case(name, n, rng):
    factors = diag_case(name, n, rng)
    assert all(len(set(t)) == len(t) and max(t) < n and len(d) == 1 << len(t)
               for d, t in factors)
    return factors


@pytest.mark.parametrize("n,name", DIAG_CASES)
def test_diag_pass_operands_match_plain(n, name):
    factors = _fix_case(name, n, np.random.default_rng(n * 31 + len(name)))
    x = rand_state(n, n + 5)
    want = torch.from_numpy(x.copy())
    TK.diag_plain(want, factors, n)
    got = x.astype(np.complex128)
    passes = TK._diag_passes(factors, n)
    for p in passes:
        interpret_pass(got, p, n)
    assert rel(got, want.numpy().astype(np.complex128)) <= TOL
    assert passes
    if name == "split":
        assert len(passes) == 2
    if name.startswith(("one1q", "one2q")):
        assert len(passes) == 1 and passes[0].single is not None


@pytest.mark.parametrize("n,name", [
    (12, "sixtyfour"), (11, "low4"), (12, "ladder"), (12, "onepoint"), (12, "mixed"),
    (12, "one2q_thread"),
])
def test_diag_pass_operands_match_pallas_diag_layer(n, name):
    factors = _fix_case(name, n, np.random.default_rng(n * 31 + len(name)))
    x = rand_state(n, n + 6)
    want = JK.diag_layer((jnp.asarray(x.real), jnp.asarray(x.imag)), factors, n)
    want = np.asarray(want[0], np.float64).ravel() + 1j * np.asarray(want[1], np.float64).ravel()
    got = x.astype(np.complex128)
    for p in TK._diag_passes(factors, n):
        interpret_pass(got, p, n)
    assert rel(got, want) <= TOL


def test_diag_hoists_what_a_thread_shares():
    """Thread bits avoid the factors' targets where they can: of the timed
    case's 8 factors at n = 28 only those on bit 0 or a thread bit are
    evaluated per amplitude."""
    rng = np.random.default_rng(1)
    n = 28
    factors = [(phases(rng, 4), (q, q + 5, q + 11, 27 - q)) for q in range(8)]
    (p,) = TK._diag_passes(factors, n)
    assert len(p.own) == 3 and all(q >= TK._THREAD_BIT_FLOOR for q in p.own)
    assert p.desc.shape == (8, TK._DESC_WORDS) and p.ninv >= 5
    # a lone factor far from the low bits: nothing is evaluated per amplitude
    (p,) = TK._diag_passes([(phases(rng, 3), (0, 1, 2)), (phases(rng, 1), (4,))], n)
    assert p.ninv == 2 and p.own == (6, 7, 8)
    # neighbouring targets gather as one run
    assert p.desc[0, 0] == 1 and p.desc[1, 0] == 1


def test_diag_scalar_state_and_scalar_factor():
    x = np.array([0.6 + 0.8j], dtype=np.complex128)
    for p in TK._diag_passes([(np.array([1j]), ())], 0):
        interpret_pass(x, p, 0)
    assert abs(x[0] - (0.6 + 0.8j) * 1j) <= 1e-7
    y = rand_state(5, 3).astype(np.complex128)
    want = y * np.exp(0.4j)
    for p in TK._diag_passes([(np.array([np.exp(0.4j)]), ()), (np.ones(2), (1,))], 5):
        interpret_pass(y, p, 5)
    assert rel(y, want) <= TOL


# ---------------------------------------------------------------------------
# lane: operands and the arithmetic of the three TF32 products
# ---------------------------------------------------------------------------


def lane_matrix_case(kind, rng):
    if kind == "unitary":
        return unitary(7, rng)
    if kind == "permutation":  # a CX chain over the lane block
        u = np.eye(128)
        cx = np.eye(4)[[0, 1, 3, 2]]
        for q in range(6):
            u = TA._expand_np(cx, (q, q + 1), tuple(range(7))) @ u
        return u.astype(complex)
    if kind == "magnitudes":  # entries spanning 1e-4 .. 1
        mag = 10.0 ** rng.uniform(-4, 0, (128, 128))
        return mag * np.exp(1j * rng.uniform(0, 2 * math.pi, (128, 128)))
    raise ValueError(kind)


LANE_KINDS = ["unitary", "permutation", "magnitudes"]


def lane_real_matrix(u: np.ndarray) -> np.ndarray:
    """The real (2L, 2L) matrix W of the product the kernel runs on the
    interleaved (re, im, ...) rows: row . W = the interleaved row . U^T."""
    w = np.empty((2 * u.shape[0],) * 2, dtype=u.real.dtype)
    w[0::2, 0::2] = u.real.T
    w[0::2, 1::2] = u.imag.T
    w[1::2, 0::2] = -u.imag.T
    w[1::2, 1::2] = u.real.T
    return w


def lane_parts_matrix(parts: np.ndarray) -> np.ndarray:
    """The matrix whose ``lane_parts`` are ``parts``."""
    a = np.asarray(parts, dtype=np.float32).reshape(2, 2, 32, 8, 2, 8, 4)
    a = (a[:, 0] + a[:, 1]).reshape(2, 16, 2, 8, 2, 8, 4)  # h, s, c, ng, w, r, cc
    a = a.transpose(4, 0, 3, 5, 1, 6, 2).reshape(2, 128, 128)
    return (a[0] + 1j * a[1]).astype(np.complex64)


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_lane_operands_rebuild_u(kind):
    u = lane_matrix_case(kind, np.random.default_rng(7))
    plan = TK.lane_prepare(u, 9, "cpu")
    assert plan.dev is None and plan.u is not None
    parts = TK.lane_parts(u)
    assert parts.dtype == np.float32 and parts.shape == (2, 2, 32, 8, 2, 8, 4)
    assert parts.flags["C_CONTIGUOUS"] and parts[0].nbytes == 128 * 1024
    # big + small is U exactly, big lies on the TF32 grid, small is a residual
    np.testing.assert_array_equal(lane_parts_matrix(parts), u.astype(np.complex64))
    big, small = parts[:, 0], parts[:, 1]
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(small) <= np.abs(big) * 2.0 ** -11).all()
    # block h, k8 step 2 s + c, output group ng, row r, column cc of Ur / Ui
    h, s, c, ng, r, cc = 1, 5, 1, 3, 6, 2
    want = np.complex64(u[64 * h + 8 * ng + r, 8 * s + 2 * cc + c])
    assert parts[h, :, 2 * s + c, ng, 0, r, cc].sum(dtype=np.float32) == want.real
    assert parts[h, :, 2 * s + c, ng, 1, r, cc].sum(dtype=np.float32) == want.imag
    # the real matrix of the interleaved product
    x = rand_state(9, 1).reshape(-1, 128)
    xi = x.view(np.float32).astype(np.float64)
    got = (xi @ lane_real_matrix(u)).view(np.complex128)
    assert rel(got, x.astype(np.complex128) @ u.T) <= 1e-12


def trunc_tf32(x):
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    return (np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def emulate_lane(x, u, products):
    """x (R, 128) complex64 times U^T with the kernel's arithmetic, operand by
    operand as the kernel reads them: for block h of a pair and k8 step
    2 s + c, A = (re, -im) and (im, re) of complex columns 8 s + 2 cc + c
    (split into TF32 parts), B = the core matrices of ``lane_parts``;
    ``products`` (3 or 1) products per step, each chunk of 4 steps summed from
    zero (float64 stands for the tensor core's wide sum) and added to the
    running sum in float32."""
    parts = TK.lane_parts(u)
    xb = TK.round_tf32(x.real), TK.round_tf32(x.imag)
    xs = trunc_tf32(x.real - xb[0]), trunc_tf32(x.imag - xb[1])
    out = np.zeros((x.shape[0], 128), dtype=np.complex64)
    for h in range(2):
        run = np.zeros((2, x.shape[0], 64), dtype=np.float32)
        for chunk in range(8):
            tmp = np.zeros((2, x.shape[0], 64), dtype=np.float64)
            for step in range(4 * chunk, 4 * chunk + 4):
                cols = 8 * (step // 2) + 2 * np.arange(4) + step % 2
                # [Ur slots 0-3, Ui slots 4-7][output] of the big and the small part
                b = [trunc_tf32(parts[h, p, step].transpose(1, 3, 0, 2).reshape(8, 64))
                     .astype(np.float64) for p in range(2)]
                for xp, bp in ([(xs, 0), (xb, 1), (xb, 0)] if products == 3 else [(xb, 0)]):
                    re, im = (v[:, cols].astype(np.float64) for v in xp)
                    tmp[0] += np.concatenate([re, -im], axis=1) @ b[bp]
                    tmp[1] += np.concatenate([im, re], axis=1) @ b[bp]
            run += tmp.astype(np.float32)
        out[:, 64 * h:64 * h + 64] = run[0] + 1j * run[1]
    return out


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_three_tf32_products_keep_fp32_accuracy(kind):
    u = lane_matrix_case(kind, np.random.default_rng(11))
    x = rand_state(12, 2).reshape(-1, 128)
    want = x.astype(np.complex128) @ u.astype(np.complex64).astype(np.complex128).T
    assert rel(emulate_lane(x, u, 3), want) <= TOL
    one = rel(emulate_lane(x, u, 1), want)
    assert one > 50 * TOL  # one TF32 product is not enough


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", LANE_KINDS[:2])
def test_lane_wrapper_on_cpu_matches_pallas_lane_gate(kind):
    n = 10
    u = lane_matrix_case(kind, np.random.default_rng(13))
    x = rand_state(n, 4)
    want = JK.lane_gate((jnp.asarray(x.real), jnp.asarray(x.imag)), u, n)
    want = np.asarray(want[0], np.float64).ravel() + 1j * np.asarray(want[1], np.float64).ravel()
    TK.reset_launches()
    state = torch.from_numpy(x.copy())
    assert TK.lane(state, TK.lane_prepare(u, n, "cpu"), n) is state
    assert rel(state.numpy().astype(np.complex128), want) <= TOL
    assert TK.launches["lane"] == 0


@pytest.mark.parametrize("n,name", [(12, "ladder"), (12, "mixed"), (11, "one1q_bit0")])
def test_diag_wrapper_on_cpu_matches_pallas_diag_layer(n, name):
    factors = _fix_case(name, n, np.random.default_rng(n))
    x = rand_state(n, 8)
    want = JK.diag_layer((jnp.asarray(x.real), jnp.asarray(x.imag)), factors, n)
    want = np.asarray(want[0], np.float64).ravel() + 1j * np.asarray(want[1], np.float64).ravel()
    TK.reset_launches()
    state = torch.from_numpy(x.copy())
    plan = TK.diag_prepare(factors, n, "cpu")
    assert plan.passes == () and TK.diag(state, plan, n) is state
    assert rel(state.numpy().astype(np.complex128), want) <= TOL
    assert TK.launches["diag"] == 0


def test_kernels_refuse_an_unaligned_state():
    state = torch.zeros(1 << 8, dtype=torch.complex64)
    TK._check_aligned("lane", state)
    with pytest.raises(ValueError, match="16 bytes"):
        TK._check_aligned("diag", state[1:129])
