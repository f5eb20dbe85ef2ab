"""The kernel adjoint engine of the port (models/adjoint_engine.py) on the
CPU, where every kernel wrapper runs its plain version, against the JAX
package's Pallas engine (interpret mode) and its ``"xla"`` sweep on the
cases of tests/test_variational.py (QAOA rings with chords, the HEA with
its CNOT ring, n = 12 rings whose flips fall in every part of the JAX
layout), the non-diagonal head (the TFIM HVA), the op-class rule of
``supports``, the unit plan against the JAX one, and the launches that
``predicted_launches`` gives against counting wrappers. Energies to 1e-4,
gradients to 5e-4."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import qubism_torch.models.adjoint_engine as TE  # noqa: E402
import qubism_torch.models.variational as TV  # noqa: E402
import qubism_tpu.models.adjoint_engine as JE  # noqa: E402
import qubism_tpu.models.variational as JV  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.models.hamiltonians import tfim  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import kernels  # noqa: E402
from qubism_torch.ops import measure as TM  # noqa: E402

_CNOT = np.eye(4, dtype=complex)[[0, 1, 3, 2]]


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def thetas(k, seed):
    return np.random.default_rng(seed).uniform(-math.pi, math.pi, k).astype(np.float32)


def close(a, b, e_tol=1e-4, g_tol=5e-4):
    (ea, ga), (eb, gb) = a, b
    assert abs(float(ea) - float(eb)) < e_tol, (float(ea), float(eb))
    assert np.abs(np.asarray(ga) - np.asarray(gb)).max() < g_tol, (np.asarray(ga),
                                                                   np.asarray(gb))


def zz_terms(n, edges):
    return [(1.0, "".join("Z" if q in (i, j) else "I" for q in range(n))) for i, j in edges]


def test_qaoa_with_chords_matches_jax_pallas_and_xla():
    """H prims (fixed 1q), rzz cost layers (one diag unit each), rx mixers
    (1q units) at n = 6: every qubit in the lane block."""
    n = 6
    edges = [(i, (i + 1) % n) for i in range(n)] + [(0, 3), (1, 4)]
    tans, jans = TV.qaoa_maxcut_ansatz(n, edges, 2), JV.qaoa_maxcut_ansatz(n, edges, 2)
    assert TE.supports(tans) and JE.supports(jans)
    terms = zz_terms(n, edges)
    theta = thetas(tans.num_params, 5)
    vg = TV.adjoint_value_and_grad_fn(tans, terms, constant=0.25, engine="kernels")
    assert vg._engine == "kernels"
    got = vg(theta)
    jt = jax.numpy.asarray(theta)
    close(got, JV.adjoint_value_and_grad_fn(jans, terms, constant=0.25, engine="pallas")(jt))
    close(got, JV.adjoint_value_and_grad_fn(jans, terms, constant=0.25, engine="xla")(jt))


def test_hea_matches_jax_xla():
    """Disjoint ry+rz runs and the CNOT ring's dense prims, non-diagonal H."""
    tans, jans = TV.hea_ansatz(4, 2), JV.hea_ansatz(4, 2)
    assert TE.supports(tans)
    terms = [(0.7, "ZZII"), (-0.4, "IXXI"), (0.3, "IIYZ"), (0.2, "XIIX")]
    theta = thetas(tans.num_params, 9)
    got = TE.kernel_adjoint_value_and_grad_fn(tans, terms)(theta)
    close(got, JV.adjoint_value_and_grad_fn(jans, terms, engine="xla")(jax.numpy.asarray(theta)))


def test_units_per_chunk_changes_nothing():
    ans = TV.hea_ansatz(4, 2)
    terms = [(0.7, "ZZII"), (-0.4, "IXXI"), (0.3, "IIYZ")]
    theta = thetas(ans.num_params, 9)
    e0, g0 = TE.kernel_adjoint_value_and_grad_fn(ans, terms)(theta)
    for upc in (1, 3, 100):
        e1, g1 = TE.kernel_adjoint_value_and_grad_fn(ans, terms, units_per_chunk=upc)(theta)
        assert torch.equal(e0, e1) and torch.equal(g0, g1)


def test_wide_ring_n12_matches_jax_pallas():
    """n = 12: flips on row, lane-group and in-tile bits of the JAX layout;
    on the port, qubits 0-4 are rows (layer1q) and 5-11 the lane block."""
    n = 12
    edges = [(i, (i + 1) % n) for i in range(n)]
    tans, jans = TV.qaoa_maxcut_ansatz(n, edges, 1), JV.qaoa_maxcut_ansatz(n, edges, 1)
    terms, const = TV.maxcut_terms(n, edges)
    neg = [(-c, s) for c, s in terms]
    theta = thetas(tans.num_params, 11)
    got = TV.adjoint_value_and_grad_fn(tans, neg, constant=-const, engine="kernels")(theta)
    close(got, JV.adjoint_value_and_grad_fn(jans, neg, constant=-const, engine="pallas")(
        jax.numpy.asarray(theta)))
    close(got, TV.adjoint_value_and_grad_fn(tans, neg, constant=-const, engine="plain")(theta))


def test_hea_n12_rows_match_plain_and_jax_xla():
    """The HEA at n = 12: 1q units split into layer1q passes (rows) and a
    lane kron, CNOTs between row qubits (K1) and inside the lane block (K3)."""
    tans, jans = TV.hea_ansatz(12, 1), JV.hea_ansatz(12, 1)
    terms = [(0.5, "XZ" + "I" * 8 + "YX"), (-0.7, "Z" * 12), (0.3, "I" * 5 + "XX" + "I" * 5)]
    theta = thetas(tans.num_params, 12)
    got = TE.kernel_adjoint_value_and_grad_fn(tans, terms, constant=0.1)(theta)
    close(got, TV.adjoint_value_and_grad_fn(tans, terms, constant=0.1, engine="plain")(theta))
    close(got, JV.adjoint_value_and_grad_fn(jans, terms, constant=0.1, engine="xla")(
        jax.numpy.asarray(theta)))


def test_tfim_hva_pauli_head_matches_jax_xla():
    """The non-diagonal head (H phi by apply_pauli_sum) on the TFIM HVA."""
    n = 6
    tans, jans = TV.tfim_hva_ansatz(n, 2), JV.tfim_hva_ansatz(n, 2)
    terms, _ = tfim(n, j=1.0, h=0.7)
    theta = thetas(tans.num_params, 3)
    got = TE.kernel_adjoint_value_and_grad_fn(tans, terms)(theta)
    close(got, JV.adjoint_value_and_grad_fn(jans, terms, engine="xla")(jax.numpy.asarray(theta)))


def test_chunked_walks_match_unchunked(monkeypatch):
    """With the expectation walk cut to chunks of 2^5 (so the diagonal
    head's weight table and every gradient group cross chunks) the engine
    gives the same numbers as with one chunk."""
    n = 9
    edges = [(i, (i + 1) % n) for i in range(n)] + [(0, 5)]
    ans = TV.qaoa_maxcut_ansatz(n, edges, 2)
    for terms in (zz_terms(n, edges), tfim(n)[0]):
        theta = thetas(ans.num_params, 8)
        want = TE.kernel_adjoint_value_and_grad_fn(ans, terms)(theta)
        with monkeypatch.context() as m:
            m.setattr(TM, "_EXP_CHUNK", 5)
            m.setattr(TE, "_HEAD_CHUNK", 5)
            m.setattr(TM, "_EXP_COLS", 3)
            got = TE.kernel_adjoint_value_and_grad_fn(ans, terms)(theta)
        close(got, want, 1e-5, 1e-5)


def test_diag_head_matches_pauli_head(monkeypatch):
    monkeypatch.setattr(TM, "_EXP_CHUNK", 6)
    monkeypatch.setattr(TE, "_HEAD_CHUNK", 6)
    n = 8
    rng = np.random.default_rng(4)
    v = (rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)).astype(np.complex64)
    phi = torch.from_numpy(v / np.linalg.norm(v))
    terms = [(0.3, "ZZIIIIII"), (-1.2, "IIIZIIZZ"), (0.7, "ZIIIIIIZ"), (0.2, "IIIIIIII")]
    e1, lam1 = TE.diag_head(phi, n, terms, 0.5)
    e2, lam2 = TE.pauli_head(phi, n, terms, 0.5)
    assert abs(e1 - e2) < 1e-5
    assert float((lam1 - lam2).abs().max()) < 1e-6


@pytest.mark.parametrize("case", ["cry", "u3", "rxx", "wide_prim", "wide_prim_in_lane",
                                  "hea", "qaoa", "hva", "fixed_diag"])
def test_supports_op_classes(case):
    """The op-class rule of the JAX engine: no parameterized dense gate on
    >= 2 qubits, no multi-parameter gate; a fixed dense prim needs K1
    (<= 4 qubits) or K3 (all in the lane block). No straddle cap."""
    wide = np.eye(32, dtype=complex)[::-1]
    ans = {
        "cry": TV.Ansatz(3, (TV.PGate("ry", (0,), (0,)), TV.PGate("cry", (0, 2), (1,))), 2),
        "u3": TV.Ansatz(2, (TV.PGate("u3", (0,), (0, 1, 2)),), 3),
        "rxx": TV.Ansatz(2, (TV.PGate("rxx", (0, 1), (0,)),), 1),
        "wide_prim": TV.Ansatz(12, (TPrim(wide, (0, 1, 2, 3, 9)),), 0),
        "wide_prim_in_lane": TV.Ansatz(12, (TPrim(wide, (5, 6, 7, 8, 9)),), 0),
        "hea": TV.hea_ansatz(5, 2),
        "qaoa": TV.qaoa_maxcut_ansatz(5, [(0, 4), (1, 3)], 2),
        "hva": TV.tfim_hva_ansatz(5, 2, periodic=True),
        "fixed_diag": TV.Ansatz(12, (TPrim(np.exp(1j * np.arange(512.0)), tuple(range(9)),
                                           diag=True), TV.PGate("crz", (0, 11), (0,))), 1),
    }[case]
    want = case not in ("cry", "u3", "rxx", "wide_prim")
    assert TE.supports(ans) is want
    if not want:
        with pytest.raises(ValueError, match="kernel lowering"):
            TV.adjoint_value_and_grad_fn(ans, [(1.0, "Z" * ans.n)], engine="kernels")


def test_auto_routes_unsupported_to_plain_sweep():
    """``"auto"`` sends an ansatz without a kernel lowering to the plain
    sweep at any n (a routing decision, as in JAX), and a supported one to
    the kernels from n = 14."""
    ops = (TV.PGate("ry", (0,), (0,)), TV.PGate("cry", (0, 2), (1,)), TV.PGate("rzz", (1, 2), (2,)))
    ans = TV.Ansatz(14, ops, 3)
    terms = [(1.0, "ZZ" + "I" * 12), (0.4, "X" + "I" * 12 + "Y")]
    theta = thetas(3, 3)
    vg = TV.adjoint_value_and_grad_fn(ans, terms)
    assert vg._engine == "plain"
    close(vg(theta), TV.value_and_grad_fn(ans, terms)(theta), 1e-5, 2e-4)
    edges = [(i, (i + 1) % 14) for i in range(14)]
    assert TV.adjoint_value_and_grad_fn(TV.qaoa_maxcut_ansatz(14, edges, 1),
                                        zz_terms(14, edges))._engine == "kernels"
    assert TV.adjoint_value_and_grad_fn(TV.qaoa_maxcut_ansatz(13, edges[:12], 1),
                                        zz_terms(13, edges[:12]))._engine == "plain"


@pytest.mark.parametrize("case", ["qaoa", "hea"])
def test_plan_units_match_jax(case):
    if case == "qaoa":
        edges = [(i, (i + 1) % 10) for i in range(10)] + [(2, 7)]
        tans, jans = TV.qaoa_maxcut_ansatz(10, edges, 2), JV.qaoa_maxcut_ansatz(10, edges, 2)
    else:
        tans, jans = TV.hea_ansatz(10, 2), JV.hea_ansatz(10, 2)
    got = [(k, [(type(op).__name__, op.targets) for op in ops])
           for k, ops in TE.plan_units(tans.ops, tans.n)]
    want = [(k, [(type(op).__name__, op.targets) for op in ops])
            for k, ops in JE.plan_units(jans.ops, jans.n)]
    assert got == want


class _Counting:
    """Counting stand-ins for the four wrappers: one launch per call, a diag
    call one per pass of its operands."""

    def __init__(self, monkeypatch, n):
        self.counts = {}
        for name in ("gate", "diag", "lane", "layer1q"):
            real = getattr(kernels, name)

            def wrapped(state, *args, _name=name, _real=real):
                k = len(kernels._diag_passes(args[0].factors, n)) if _name == "diag" else 1
                self.counts[_name] = self.counts.get(_name, 0) + k
                return _real(state, *args)

            monkeypatch.setattr(kernels, name, wrapped)


@pytest.mark.parametrize("case", ["qaoa28_shape", "hea", "hva"])
def test_launches_match_plan(monkeypatch, case):
    """One engine call launches what predicted_launches says. The QAOA case
    has the bench's p = 2 ring shape at n = 12: per sweep 5 units (an H
    layer, two rzz layers, two rx layers)."""
    if case == "qaoa28_shape":
        n = 12
        edges = [(i, (i + 1) % n) for i in range(n)]
        ans = TV.qaoa_maxcut_ansatz(n, edges, 2)
        terms = zz_terms(n, edges)
    elif case == "hea":
        n = 12
        ans = TV.hea_ansatz(n, 1)
        terms = [(1.0, "X" * n)]
    else:
        n = 9
        ans = TV.tfim_hva_ansatz(n, 2)
        terms = tfim(n)[0]
    want = TE.predicted_launches(ans)
    counting = _Counting(monkeypatch, n)
    TE.kernel_adjoint_value_and_grad_fn(ans, terms)(thetas(ans.num_params, 1))
    assert counting.counts == want
    if case == "qaoa28_shape":
        # 5 row qubits: one layer1q pass and one lane kron per 1q unit
        assert want == {"layer1q": 9, "lane": 9, "diag": 6}
    if case == "hea":
        assert want["gate"] > 0 and want["lane"] > 0 and want["layer1q"] > 0


def test_engine_leaves_no_grad_and_matches_state_fn():
    """The forward sweep of the engine gives state_fn's state (checked
    through the head's energy against energy_fn)."""
    n = 10
    edges = [(i, (i + 1) % n) for i in range(n)]
    ans = TV.qaoa_maxcut_ansatz(n, edges, 2)
    terms, const = TV.maxcut_terms(n, edges)
    theta = thetas(ans.num_params, 2)
    e, g = TE.kernel_adjoint_value_and_grad_fn(ans, terms, const)(theta)
    assert not e.requires_grad and not g.requires_grad
    assert abs(float(e) - float(TV.energy_fn(ans, terms, const)(theta))) < 1e-5
    psi = TA.zero_state(n)
    for unit in TE.plan_units(ans.ops, n):
        TE.apply_unit(psi, unit, theta.astype(np.float64), n)
    with torch.no_grad():
        assert float((psi - TV.state_fn(ans)(theta)).abs().max()) < 1e-6
