"""Differentiable variational circuits of the port (models/variational.py,
models/hamiltonians.py, ops/measure.apply_pauli_sum) against the JAX
package: the same theta, made from a numpy seed, through both packages'
builders, states, energies, autodiff and adjoint gradients, optimizer
histories and exporters, plus the exact parameter-shift rule and a dense
numpy oracle. States to 1e-5, energies to 1e-5, autodiff gradients to
1e-4, adjoint gradients to 5e-4, VQE histories and theta to 1e-4."""

import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402

import qubism_torch.models.hamiltonians as TH  # noqa: E402
import qubism_torch.models.variational as TV  # noqa: E402
import qubism_tpu.models.hamiltonians as JH  # noqa: E402
import qubism_tpu.models.variational as JV  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import measure as TM  # noqa: E402
from qubism_torch.utils.stats import chi2_test  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.ops.apply import complex_from_planes, planes_from_complex  # noqa: E402
from qubism_tpu.ops.measure import apply_pauli_sum_traced  # noqa: E402

_PAULI = {"I": np.eye(2, dtype=complex), "X": np.array([[0, 1], [1, 0]], dtype=complex),
          "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
          "Z": np.array([[1, 0], [0, -1]], dtype=complex)}
_CNOT = np.eye(4, dtype=complex)[[0, 1, 3, 2]]


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def dense_h(terms, n):
    h = np.zeros((1 << n, 1 << n), dtype=complex)
    for c, p in terms:
        m = np.array([[1.0 + 0j]])
        for ch in p:
            m = np.kron(m, _PAULI[ch])
        h += c * m
    return h


def both(ops, n, num_params):
    """The same ansatz in both packages (fixed prims rebuilt per package)."""
    def conv(op, P, G):
        if op[0] == "prim":  # ("prim", u, targets, diag)
            return P(op[1], op[2], diag=op[3])
        return G(*op)

    t = TV.Ansatz(n, tuple(conv(op, TPrim, TV.PGate) for op in ops), num_params)
    j = JV.Ansatz(n, tuple(conv(op, JPrim, JV.PGate) for op in ops), num_params)
    return t, j


def thetas(k, seed, lo=-math.pi, hi=math.pi):
    return np.random.default_rng(seed).uniform(lo, hi, k).astype(np.float32)


def jstate(ans, theta):
    return complex_from_planes(JV.state_fn(ans)(jax.numpy.asarray(theta)))


def tstate(ans, theta):
    with torch.no_grad():
        return TA.complex_from_state(TV.state_fn(ans)(theta))


#: an ansatz touching every builder: row and lane targets, unsorted 2q
#: targets, a shared and a scaled parameter, fixed dense and diagonal prims
EVERY = [("ry", (0,), (0,)), ("rx", (1,), (1,)), ("rz", (2,), (2,)),
         ("phase", (1,), (3,)), ("u3", (2,), (4, 5, 6)), ("cphase", (0, 2), (7,)),
         ("crz", (2, 0), (8,)), ("crx", (1, 2), (9,)), ("cry", (0, 1), (10,)),
         ("rzz", (2, 1), (11,), 2.0), ("rxx", (0, 1), (12,)), ("ryy", (1, 2), (13,)),
         ("prim", _CNOT, (2, 0), False), ("rz", (0,), (0,)),
         ("prim", np.array([1, 1, 1, -1], dtype=complex), (1, 2), True)]


# -- builders -------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TV.BUILDERS))
def test_builder_matches_jax_and_torch(name):
    """The float64 numpy builder, the torch builder (float32 tensors) and
    the JAX builder give one matrix at the same arguments."""
    builder, arity = TV.BUILDERS[name]
    assert arity == JV.BUILDERS[name][1]
    args = thetas(arity, 40 + arity + len(name))
    kind, u = builder(*args)
    jkind, ja, jb = JV.BUILDERS[name][0](*[jax.numpy.float32(a) for a in args])
    tkind, tu = TV.TORCH_BUILDERS[name](*[torch.tensor(a) for a in args])
    assert kind == jkind == tkind == TV._KIND[name] == JV._KIND[name]
    assert np.abs(u - (np.asarray(ja) + 1j * np.asarray(jb))).max() < 1e-6
    assert tu.dtype == torch.complex64
    assert np.abs(u - tu.numpy()).max() < 1e-6
    assert TV._GEN.get(name) == JV._GEN.get(name)


def test_bad_pgate_name_and_arity():
    with pytest.raises(ValueError):
        TV.PGate("nope", (0,), (0,))
    with pytest.raises(ValueError):
        TV.PGate("u3", (0,), (0,))
    with pytest.raises(ValueError):
        TV.Ansatz(2, (TV.PGate("rx", (0,), (5,)),), 2)
    with pytest.raises(ValueError):
        TV.Ansatz(1, (TV.PGate("rx", (3,), (0,)),), 1)


# -- states and energies --------------------------------------------------------


def test_every_builder_state_matches_jax():
    tans, jans = both(EVERY, 3, 14)
    theta = thetas(14, 5)
    got = tstate(tans, theta)
    assert np.linalg.norm(got - jstate(jans, theta)) < 1e-5
    # and a dense numpy oracle
    psi = np.zeros(8, dtype=complex)
    psi[0] = 1
    for op in tans.ops:
        if isinstance(op, TV.PGate):
            kind, u = TV.BUILDERS[op.name][0](*[op.scale * theta[j] for j in op.pidx])
            u = np.diag(u) if kind == "diag" else u
        else:
            u = np.diag(op.u) if op.diag else op.u
        k = len(op.targets)
        full = np.kron(u, np.eye(1 << (3 - k)))
        cur = list(op.targets) + [q for q in range(3) if q not in op.targets]
        perm = [cur.index(q) for q in range(3)]
        psi = full.reshape((2,) * 6).transpose(perm + [3 + p for p in perm]).reshape(8, 8) @ psi
    assert np.linalg.norm(got - psi) < 1e-5


@pytest.mark.parametrize("family", ["hea", "qaoa", "tfim_hva"])
def test_family_state_matches_jax(family):
    """The ansatz families at widths that put qubits above the lane block."""
    if family == "hea":
        tans, jans = TV.hea_ansatz(9, 2), JV.hea_ansatz(9, 2)
    elif family == "qaoa":
        edges = [(i, (i + 1) % 9) for i in range(9)] + [(0, 4), (8, 2)]
        tans, jans = TV.qaoa_maxcut_ansatz(9, edges, 2), JV.qaoa_maxcut_ansatz(9, edges, 2)
    else:
        tans, jans = TV.tfim_hva_ansatz(8, 2, periodic=True), JV.tfim_hva_ansatz(8, 2, True)
    assert tans.num_params == jans.num_params and len(tans.ops) == len(jans.ops)
    theta = thetas(tans.num_params, 11)
    assert np.linalg.norm(tstate(tans, theta) - jstate(jans, theta)) < 1e-5


TERMS3 = [(0.7, "ZZI"), (-0.4, "XIY"), (1.1, "IZI"), (0.25, "YXZ"), (0.3, "YYI"), (-0.2, "III")]


def test_energy_matches_jax_and_dense():
    tans, jans = TV.hea_ansatz(3, 1), JV.hea_ansatz(3, 1)
    theta = thetas(tans.num_params, 2, -2, 2)
    e = float(TV.energy_fn(tans, TERMS3, constant=0.3)(theta))
    want = float(JV.energy_fn(jans, TERMS3, constant=0.3)(jax.numpy.asarray(theta)))
    psi = tstate(tans, theta)
    dense = float(np.real(psi.conj() @ dense_h(TERMS3, 3) @ psi)) + 0.3
    assert abs(e - want) < 1e-5 and abs(e - dense) < 1e-5


@pytest.mark.parametrize("case", ["hea", "qaoa"])
def test_value_and_grad_matches_jax(case):
    if case == "hea":
        tans, jans = TV.hea_ansatz(4, 2), JV.hea_ansatz(4, 2)
        terms, const = [(0.7, "ZZII"), (-0.4, "IXXI"), (0.3, "IIYZ"), (0.2, "XIIX")], 0.2
    else:
        edges = [(i, (i + 1) % 5) for i in range(5)]
        tans, jans = TV.qaoa_maxcut_ansatz(5, edges, 2), JV.qaoa_maxcut_ansatz(5, edges, 2)
        terms, const = TV.maxcut_terms(5, edges)
    theta = thetas(tans.num_params, 7)
    e, g = TV.value_and_grad_fn(tans, terms, const)(theta)
    je, jg = JV.value_and_grad_fn(jans, terms, const)(jax.numpy.asarray(theta))
    assert e.dtype == g.dtype == torch.float32 and g.shape == (tans.num_params,)
    assert abs(float(e) - float(je)) < 1e-5
    assert np.abs(g.numpy() - np.asarray(jg)).max() < 1e-4


def test_grad_matches_parameter_shift():
    """ry/rz have generator eigenvalues +-1/2, so the parameter-shift rule
    (E(t + pi/2) - E(t - pi/2)) / 2 is exact."""
    ans = TV.hea_ansatz(3, 1)
    terms = [(0.8, "ZIZ"), (-0.5, "XXI"), (0.3, "IYZ")]
    theta = thetas(ans.num_params, 7)
    efn = TV.energy_fn(ans, terms)
    _, g = TV.value_and_grad_fn(ans, terms)(theta)
    for j in range(ans.num_params):
        tp, tm = theta.copy(), theta.copy()
        tp[j] += math.pi / 2
        tm[j] -= math.pi / 2
        shift = (float(efn(tp)) - float(efn(tm))) / 2.0
        assert abs(float(g[j]) - shift) < 5e-5, (j, float(g[j]), shift)


def test_qaoa_ansatz_matches_compiled_qaoa():
    from qubism_torch.core.statevec import StateVec
    from qubism_torch.models.circuits import qaoa_maxcut_energy, qaoa_prims
    from qubism_torch.ops.fusion import CompiledCircuit

    n, edges = 5, [(i, (i + 1) % 5) for i in range(5)]
    gammas, betas = [0.37, 0.81], [1.02, 0.44]
    circ = CompiledCircuit(n, qaoa_prims(n, edges, gammas, betas))
    ref = qaoa_maxcut_energy(StateVec(n, circ(circ.init_state())), n, edges)
    terms, const = TV.maxcut_terms(n, edges)
    got = float(TV.energy_fn(TV.qaoa_maxcut_ansatz(n, edges, 2), terms, const)(
        np.array(gammas + betas, dtype=np.float32)))
    assert abs(got - ref) < 1e-5


# -- adjoint sweep ----------------------------------------------------------------


def test_apply_pauli_sum_matches_jax():
    n = 4
    rng = np.random.default_rng(9)
    v = rng.normal(size=16) + 1j * rng.normal(size=16)
    v /= np.linalg.norm(v)
    terms = [(0.7, "XIZY"), (-0.3, "YYYY"), (1.2, "IZIX"), (0.5, "IIII")]
    got = TA.complex_from_state(TM.apply_pauli_sum(TA.state_from_planes(
        *planes_from_complex(v)), terms, n))
    want = complex_from_planes(apply_pauli_sum_traced(
        tuple(jax.numpy.asarray(p) for p in planes_from_complex(v)), terms, n))
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(got - dense_h(terms, n) @ v).max() < 1e-6
    assert not TM.apply_pauli_sum(TA.state_from_planes(*planes_from_complex(v)), [], n).any()


MIXED = [("ry", (0,), (0,)), ("rx", (1,), (1,)), ("u3", (2,), (2, 3, 4)),
         ("prim", _CNOT, (0, 3), False), ("rzz", (1, 3), (5,), 2.0),
         ("cphase", (0, 2), (6,)), ("rz", (3,), (0,)),
         ("prim", np.array([1, 1, 1, -1], dtype=complex), (2, 3), True), ("cry", (3, 1), (7,))]


@pytest.mark.parametrize("case", ["mixed", "every_builder"])
def test_plain_adjoint_matches_jax_xla(case):
    """The plain adjoint sweep (Pauli-generator shortcut for one-parameter
    gates, the dense derivative for u3) against the JAX ``"xla"`` sweep and
    the port's autodiff."""
    if case == "mixed":
        (tans, jans), n = both(MIXED, 4, 8), 4
        terms = [(0.9, "ZIZI"), (-0.6, "XXII"), (0.4, "IYIY"), (0.2, "ZYXI")]
    else:
        (tans, jans), n = both(EVERY, 3, 14), 3
        terms = [(0.8, "ZXI"), (-0.5, "IYZ"), (0.3, "ZZZ")]
    theta = thetas(tans.num_params, 21)
    vg = TV.adjoint_value_and_grad_fn(tans, terms, constant=0.3, engine="plain")
    assert vg._engine == "plain"
    e, g = vg(theta)
    je, jg = JV.adjoint_value_and_grad_fn(jans, terms, constant=0.3, engine="xla")(
        jax.numpy.asarray(theta))
    ae, ag = TV.value_and_grad_fn(tans, terms, constant=0.3)(theta)
    assert abs(float(e) - float(je)) < 1e-5 and abs(float(e) - float(ae)) < 1e-5
    assert np.abs(g.numpy() - np.asarray(jg)).max() < 5e-4
    assert np.abs(g.numpy() - ag.numpy()).max() < 5e-4


def test_adjoint_engine_argument():
    ans = TV.hea_ansatz(3, 1)
    assert TV.adjoint_value_and_grad_fn(ans, [(1.0, "ZZI")])._engine == "plain"  # n < 14
    with pytest.raises(ValueError, match="engine"):
        TV.adjoint_value_and_grad_fn(ans, [(1.0, "ZZI")], engine="xla")
    with pytest.raises(ValueError, match="Pauli string"):
        TV.adjoint_value_and_grad_fn(ans, [(1.0, "ZZ")], engine="plain")


# -- optimization ------------------------------------------------------------------


@pytest.mark.parametrize("grad", ["auto", "adjoint"])
def test_vqe_minimize_matches_jax(grad):
    """25 Adam steps: torch.optim.Adam(lr=0.1) against optax.adam(0.1)."""
    tans, jans = TV.hea_ansatz(3, 1), JV.hea_ansatz(3, 1)
    terms = [(1.0, "ZZI"), (0.4, "XIX"), (-0.3, "IYZ"), (0.5, "IIZ")]
    theta0 = np.full(tans.num_params, 0.15, dtype=np.float32)
    theta0[::3] = -0.2
    t, h = TV.vqe_minimize(tans, terms, theta0, steps=25, grad=grad, constant=0.1)
    jt, jh = JV.vqe_minimize(jans, terms, theta0, steps=25, grad=grad, constant=0.1)
    assert t.dtype == h.dtype == torch.float32 and h.shape == (25,)
    assert np.abs(h.numpy() - np.asarray(jh)).max() < 1e-4
    assert np.abs(t.numpy() - np.asarray(jt)).max() < 1e-4
    assert float(h[-1]) < float(h[0])


def test_vqe_optimizer_callable_matches_optax_sgd():
    tans, jans = TV.hea_ansatz(2, 1), JV.hea_ansatz(2, 1)
    terms = [(1.0, "ZZ"), (0.4, "XI")]
    theta0 = np.full(tans.num_params, 0.2, dtype=np.float32)
    t, h = TV.vqe_minimize(tans, terms, theta0, steps=20,
                           optimizer=lambda p: torch.optim.SGD(p, lr=0.05))
    jt, jh = JV.vqe_minimize(jans, terms, theta0, steps=20, optimizer=optax.sgd(0.05))
    assert np.abs(h.numpy() - np.asarray(jh)).max() < 1e-5
    assert np.abs(t.numpy() - np.asarray(jt)).max() < 1e-5


def test_scan_and_segment_size_change_nothing():
    """The JAX compile controls are accepted and change no number."""
    ans = TV.hea_ansatz(2, 1)
    terms = [(1.0, "ZZ"), (0.4, "XI"), (0.4, "IX")]
    theta0 = np.full(ans.num_params, 0.2, dtype=np.float32)
    for grad in ("auto", "adjoint"):
        t1, h1 = TV.vqe_minimize(ans, terms, theta0, steps=10, grad=grad)
        t2, h2 = TV.vqe_minimize(ans, terms, theta0, steps=10, grad=grad, scan=False,
                                 segment_size=3)
        assert torch.equal(t1, t2) and torch.equal(h1, h2)
    a = TV.adjoint_value_and_grad_fn(ans, terms)(theta0)
    b = TV.adjoint_value_and_grad_fn(ans, terms, segment_size=1)(theta0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_vqe_h2_ground_energy():
    """VQE on the reduced H2 Hamiltonian reaches the dense ground energy."""
    terms, const = TH.h2_minimal()
    exact = float(np.linalg.eigvalsh(dense_h(terms, 2)).min()) + const
    ans = TV.hea_ansatz(2, 2)
    theta0 = np.random.default_rng(3).uniform(-0.3, 0.3, ans.num_params).astype(np.float32)
    theta, hist = TV.vqe_minimize(ans, terms, theta0, steps=300, constant=const)
    final = float(TV.energy_fn(ans, terms, constant=const)(theta))
    assert final < float(hist[0])
    assert abs(final - exact) < 2e-3, (final, exact)


def test_vqe_adjoint_converges():
    terms = [(1.0, "ZZ"), (0.4, "XI"), (0.4, "IX")]
    exact = float(np.linalg.eigvalsh(dense_h(terms, 2)).min())
    ans = TV.hea_ansatz(2, 1)
    theta, _ = TV.vqe_minimize(ans, terms, np.full(ans.num_params, 0.15, np.float32),
                               steps=250, grad="adjoint")
    assert abs(float(TV.energy_fn(ans, terms)(theta)) - exact) < 5e-3


def test_vqe_rejects_bad_grad():
    with pytest.raises(ValueError, match="grad"):
        TV.vqe_minimize(TV.hea_ansatz(2, 1), [(1.0, "ZZ")], np.zeros(8), steps=1, grad="fd")


def test_mesh_is_not_ported():
    """The five entry points take ``mesh=`` (a sequence of devices, here
    two shards of the CPU device) and give what they give on one device;
    an int in place of the devices is refused."""
    from qubism_torch.parallel import make_mesh

    ans = TV.hea_ansatz(2, 1)
    terms = [(1.0, "ZZ"), (0.5, "XY")]
    theta = thetas(ans.num_params, 4)
    mesh = make_mesh(2)
    with torch.no_grad():
        psi = tstate(ans, theta)
        shards = TV.state_fn(ans, mesh=mesh)(theta)
    assert len(shards) == 2
    assert np.abs(torch.cat(shards).numpy() - psi).max() < 1e-6
    e0 = float(TV.energy_fn(ans, terms)(theta))
    assert abs(float(TV.energy_fn(ans, terms, mesh=mesh)(theta)) - e0) < 1e-6
    for fn in (TV.value_and_grad_fn, TV.adjoint_value_and_grad_fn):
        want = fn(ans, terms)(theta)
        got = fn(ans, terms, mesh=mesh)(theta)
        assert abs(float(got[0]) - float(want[0])) < 1e-6
        assert np.abs(got[1].numpy() - want[1].numpy()).max() < 1e-5
    th0, h0 = TV.vqe_minimize(ans, terms, theta, steps=3)
    th1, h1 = TV.vqe_minimize(ans, terms, theta, steps=3, mesh=mesh)
    assert np.abs(h0.numpy() - h1.numpy()).max() < 1e-5
    calls = [lambda: TV.state_fn(ans, mesh=8), lambda: TV.energy_fn(ans, terms, mesh=8),
             lambda: TV.value_and_grad_fn(ans, terms, mesh=8),
             lambda: TV.adjoint_value_and_grad_fn(ans, terms, mesh=8),
             lambda: TV.vqe_minimize(ans, terms, np.zeros(8), steps=1, mesh=8)]
    for call in calls:
        with pytest.raises(TypeError, match="make_mesh"):
            call()


# -- export and readout ---------------------------------------------------------------


def _tokens(text):
    return re.findall(r"-?\d+\.\d+|[A-Za-z_]+\w*|\S", text)


def test_bind_and_ansatz_qasm_match_jax():
    """bind gives the JAX package's prims (the port's builders are float64,
    the JAX package's float32: matrices to 1e-6), and ansatz_qasm its text,
    token for token with each angle to 1e-6."""
    edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
    pairs = [(TV.qaoa_maxcut_ansatz(4, edges, 2), JV.qaoa_maxcut_ansatz(4, edges, 2)),
             (TV.hea_ansatz(3, 1), JV.hea_ansatz(3, 1)),
             both([op for op in EVERY if op[0] not in ("u3", "crx", "cry", "rxx", "ryy")], 3, 14)]
    for tans, jans in pairs:
        theta = thetas(tans.num_params, 13)
        tp, jp = TV.bind(tans, theta), JV.bind(jans, theta)
        assert [(p.targets, p.diag) for p in tp] == [(p.targets, p.diag) for p in jp]
        assert max(np.abs(np.asarray(a.u) - np.asarray(b.u)).max() for a, b in zip(tp, jp)) < 1e-6
        got, want = _tokens(TV.ansatz_qasm(tans, theta, measure=True)), _tokens(
            JV.ansatz_qasm(jans, theta, measure=True))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if re.fullmatch(r"-?\d+\.\d+", a):
                assert abs(float(a) - float(b)) < 1e-6, (a, b)
            else:
                assert a == b


def test_sample_fn_deterministic_and_chi2():
    """rx(pi) on every qubit gives |1..1> on every shot; a hea state's
    counts pass chi-squared against its Born probabilities."""
    n = 3
    ans = TV.Ansatz(n, tuple(TV.PGate("rx", (q,), (0,)) for q in range(n)), 1)
    counts = TV.sample_fn(ans)(np.array([math.pi], np.float32), 500,
                              gen=torch.Generator().manual_seed(1))
    assert counts == {"111": 500}
    ans = TV.hea_ansatz(4, 1)
    theta = thetas(ans.num_params, 4)
    counts = TV.sample_fn(ans)(theta, 4000, gen=torch.Generator().manual_seed(2))
    probs = np.abs(jstate(JV.hea_ansatz(4, 1), theta)) ** 2
    hist = np.zeros(16)
    for bits, c in counts.items():
        hist[int(bits, 2)] = c
    assert bool(chi2_test(hist, probs / probs.sum()))


# -- Hamiltonians -----------------------------------------------------------------


@pytest.mark.parametrize("case", ["tfim", "tfim_periodic", "xxz", "xxz_field", "h2", "maxcut"])
def test_hamiltonians_match_jax(case):
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]
    calls = {"tfim": lambda m: m.tfim(5, j=0.9, h=0.6),
             "tfim_periodic": lambda m: m.tfim(4, periodic=True),
             "xxz": lambda m: m.heisenberg_xxz(4, jxy=0.8, jz=0.5),
             "xxz_field": lambda m: m.heisenberg_xxz(3, field=0.3, periodic=True),
             "h2": lambda m: m.h2_minimal(),
             "maxcut": lambda m: m.maxcut(4, edges)}
    assert calls[case](TH) == calls[case](JH)
