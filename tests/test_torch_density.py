"""The exact density engine of the port (core/density.py, run/noisy.py)
against the JAX package and a dense numpy Kraus oracle: the ten cases of
tests/test_density.py on both packages (rho to 1e-6 against the oracle and
the JAX value), the superoperator pass against the term-by-term form, every
noise-spec error message, ``DensityProgram`` on the example programs with
noise (the JAX package's own uniforms injected into the port's mid-circuit
measurements), and the ``--backend density`` lines of the CLI. Sampled
counts are compared by distribution (chi-squared), not index for index: the
two packages seed numpy from different generators."""

import io
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import qubism_torch.core.density as TD  # noqa: E402
import qubism_tpu.core.density as JD  # noqa: E402
import qubism_tpu.models.circuits as JC  # noqa: E402
from qubism_torch import cli as tcli  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.core.gates import u3_matrix  # noqa: E402
from qubism_torch.core.statevec import StateVec as TStateVec  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm as t_parse  # noqa: E402
from qubism_torch.run import noisy as TN  # noqa: E402
from qubism_torch.utils.stats import chi2_test  # noqa: E402
from qubism_tpu import cli as jcli  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.ops.apply import planes_from_complex  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm as j_parse  # noqa: E402
from qubism_tpu.run import noisy as JN  # noqa: E402

TOL = 1e-6
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
CHANNELS = ("depolarizing", "depolarizing2", "amplitude_damping", "phase_damping", "bit_flip",
            "phase_flip")

_H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)
_CNOT = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
_PAULI = {"I": np.eye(2, dtype=complex), "X": np.array([[0, 1], [1, 0]], dtype=complex),
          "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
          "Z": np.array([[1, 0], [0, -1]], dtype=complex)}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def embed(u, targets, n):
    k = len(targets)
    full = np.kron(u, np.eye(1 << (n - k), dtype=complex))
    cur = list(targets) + [q for q in range(n) if q not in targets]
    perm = [cur.index(q) for q in range(n)]
    return (full.reshape((2,) * (2 * n)).transpose(perm + [n + p for p in perm])
            .reshape(1 << n, 1 << n))


def dense_pauli(pauli):
    m = np.array([[1.0]], dtype=complex)
    for c in pauli:
        m = np.kron(m, _PAULI[c])
    return m


def kraus_sum(rho, kraus, targets, n):
    return sum(embed(k, targets, n) @ rho @ embed(k, targets, n).conj().T for k in kraus)


class Pair:
    """The same operations on a DensityMatrix of each package."""

    def __init__(self, n):
        self.n, self.t, self.j = n, TD.DensityMatrix(n), JD.DensityMatrix(n)

    def apply(self, prims):
        prims = [prims] if not isinstance(prims, (list, tuple)) else prims
        self.t.apply([TPrim(u, t, d) for u, t, d in prims])
        self.j.apply([JPrim(u, t, d) for u, t, d in prims])
        return self

    def channel(self, kraus, targets):
        self.t.apply_channel(kraus, targets)
        self.j.apply_channel(kraus, targets)
        return self

    def agree(self, want=None):
        got = self.t.matrix()
        assert np.abs(got - self.j.matrix()).max() < TOL
        if want is not None:
            assert np.abs(got - want).max() < TOL
        assert abs(self.t.trace() - self.j.trace()) < TOL
        assert abs(self.t.purity() - self.j.purity()) < 1e-5
        return got


def gates(jprims):
    return [(p.u, p.targets, p.diag) for p in jprims]


BELL = [(_H, (0,), False), (_CNOT, (0, 1), False)]


@pytest.mark.parametrize("name", CHANNELS)
def test_channel_factories_equal(name):
    for p in (0.0, 0.2, 0.75):
        tk, jk = getattr(TD, name)(p), getattr(JD, name)(p)
        assert len(tk) == len(jk) and all(np.array_equal(a, b) for a, b in zip(tk, jk))
        d = tk[0].shape[0]
        assert np.abs(sum(k.conj().T @ k for k in tk) - np.eye(d)).max() < 1e-12


def test_unitary_evolution_matches_dense():
    n = 3
    prims = gates(JC.brickwork_prims(n, depth=2, seed=3))
    pair = Pair(n).apply(prims)
    rho = np.zeros((8, 8), dtype=complex)
    rho[0, 0] = 1
    for u, targets, diag in prims:
        m = embed(np.diag(u) if diag else u, targets, n)
        rho = m @ rho @ m.conj().T
    pair.agree(rho)
    assert abs(pair.t.purity() - 1.0) < 1e-5 and abs(pair.t.trace() - 1.0) < 1e-5


def test_from_statevec_matches_projector():
    rng = np.random.default_rng(0)
    psi = rng.normal(size=8) + 1j * rng.normal(size=8)
    psi /= np.linalg.norm(psi)
    psi = psi.astype(np.complex64)
    sv = TStateVec.from_amplitudes(psi)
    for src in (sv, sv.state):
        dm = TD.DensityMatrix.from_statevec(src)
        assert dm.n == 3
        assert np.abs(dm.matrix() - np.outer(psi, psi.conj())).max() < TOL
    jdm = JD.DensityMatrix.from_statevec(planes_from_complex(psi))
    assert np.abs(dm.matrix() - jdm.matrix()).max() < TOL
    # a rho crosses through the state-vector boundary functions unchanged
    re, im = (np.asarray(p).reshape(-1) for p in jdm.planes)
    assert float((TA.state_from_planes(re, im) - dm.state).abs().max()) < 1e-7


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("name,p", [("depolarizing", 0.2), ("amplitude_damping", 0.35),
                                    ("phase_damping", 0.5), ("bit_flip", 0.1),
                                    ("phase_flip", 0.25)])
def test_channels_match_dense_kraus(name, p, q):
    n = 2
    pair = Pair(n).apply(BELL)
    rho = pair.t.matrix()
    chan = getattr(TD, name)(p)
    pair.channel(chan, q)
    pair.agree(kraus_sum(rho, chan, (q,), n))
    assert abs(pair.t.trace() - 1.0) < 1e-5


def test_depolarizing_kills_purity_and_parity():
    pair = Pair(2).apply(BELL)
    for dm in (pair.t, pair.j):
        assert abs(dm.expectation("ZZ") - 1.0) < 1e-5 and abs(dm.expectation("XX") - 1.0) < 1e-5
    pair.channel(TD.depolarizing(0.75), 0)
    for dm in (pair.t, pair.j):
        assert abs(dm.expectation("ZZ")) < 1e-5 and abs(dm.expectation("XX")) < 1e-5
        assert abs(dm.purity() - 0.25) < 1e-5
    pair.agree(np.eye(4) / 4)


def test_amplitude_damping_decay():
    pair = Pair(1).apply([(_PAULI["X"], (0,), False)])
    for _ in range(3):
        pair.channel(TD.amplitude_damping(0.3), 0)
    assert abs(pair.t.prob_one(0) - 0.7 ** 3) < TOL
    assert abs(pair.t.prob_one(0) - pair.j.prob_one(0)) < TOL


def test_expectation_matches_dense_and_statevec():
    n = 3
    prims = gates(JC.brickwork_prims(n, depth=2, seed=11))
    pair = Pair(n).apply(prims).channel(TD.depolarizing(0.1), 1)
    rho = pair.agree()
    for pauli in ("ZZI", "XIY", "IZX", "YYZ", "yyy", "III"):
        want = float(np.real(np.trace(dense_pauli(pauli.upper()) @ rho.astype(np.complex128))))
        assert abs(pair.t.expectation(pauli) - want) < TOL
        assert abs(pair.t.expectation(pauli) - pair.j.expectation(pauli)) < 1e-5
    terms = [(0.5, "ZZI"), (-1.2, "XIY")]
    assert abs(pair.t.expectation_sum(terms) - pair.j.expectation_sum(terms)) < 1e-5
    # a pure rho agrees with the state vector's own expectation
    pure = TD.DensityMatrix(n).apply([TPrim(u, t, d) for u, t, d in prims])
    sv = TStateVec.zero(n)
    for u, t, d in prims:
        (TA.apply_diag if d else TA.apply_gate)(sv.state, u, t, n)
    for pauli in ("ZZI", "XIY", "YYZ"):
        assert abs(pure.expectation(pauli) - sv.expectation(pauli)) < 1e-5
    with pytest.raises(ValueError) as te:
        pair.t.expectation("ZZ")
    with pytest.raises(ValueError) as je:
        pair.j.expectation("ZZ")
    assert str(te.value) == str(je.value)


def jax_draws(key, k):
    """The uniforms of k key splits, as the JAX package's measure_qubit
    takes them."""
    out = []
    for _ in range(k):
        key, sub = jax.random.split(key)
        out.append(float(jax.random.uniform(sub)))
    return out


def test_measure_qubit_collapses_ghz():
    counts = {0: 0, 1: 0}
    for seed in range(12):
        pair = Pair(2).apply(BELL)
        key = jax.random.PRNGKey(seed)
        jout, _ = pair.j.measure_qubit(0, key)
        out = pair.t.measure_qubit(0, uniform=jax_draws(key, 1)[0])
        assert out == jout
        counts[out] += 1
        assert abs(pair.t.prob_one(1) - out) < 1e-5 and abs(pair.t.trace() - 1.0) < 1e-5
        pair.agree()
    assert counts[0] > 1 and counts[1] > 1
    # its own generator: both outcomes, reproducible from the seed
    outs = [TD.DensityMatrix(2).apply([TPrim(*g) for g in BELL])
            .measure_qubit(0, torch.Generator().manual_seed(s)) for s in range(24)]
    again = [TD.DensityMatrix(2).apply([TPrim(*g) for g in BELL])
             .measure_qubit(0, torch.Generator().manual_seed(s)) for s in range(24)]
    assert outs == again and 3 < sum(outs) < 21


def test_zero_trace_projection_stays_zero():
    dm = TD.DensityMatrix(1)
    dm._project(0, 1)  # |0><0| onto outcome 1
    assert dm.trace() == 0.0 and not torch.isnan(torch.view_as_real(dm.state)).any()


def test_noisy_circuit_probs_stay_normalized():
    n = 4
    rng = np.random.default_rng(5)
    pair = Pair(n)
    rho = np.zeros((16, 16), dtype=complex)
    rho[0, 0] = 1
    for layer in range(3):
        for q in range(n):
            u = u3_matrix(*rng.uniform(0, 2 * math.pi, 3), reference_bug=False)
            pair.apply([(u, (q,), False)])
            rho = embed(u, (q,), n) @ rho @ embed(u, (q,), n).conj().T
        pair.apply([(_CNOT, (layer % n, (layer + 1) % n), False)])
        c = embed(_CNOT, (layer % n, (layer + 1) % n), n)
        rho = c @ rho @ c.conj().T
        chan = TD.depolarizing(0.1)
        pair.channel(chan, layer % n)
        rho = kraus_sum(rho, chan, (layer % n,), n)
    assert np.abs(pair.t.probs() - np.real(np.diag(rho))).max() < TOL
    assert np.abs(pair.t.probs() - pair.j.probs()).max() < TOL
    assert abs(pair.t.probs().sum() - 1.0) < 1e-5
    pair.agree(rho)


def test_sample_noisy_bell():
    pair = Pair(2).apply(BELL).channel(TD.bit_flip(0.2), 1)
    shots = 20000
    counts = pair.t.sample(shots, torch.Generator().manual_seed(3))
    assert sum(counts.values()) == shots
    observed = np.array([counts.get(format(i, "02b"), 0) for i in range(4)], dtype=float)
    assert chi2_test(observed, np.array([0.4, 0.1, 0.1, 0.4]))
    jcounts = pair.j.sample(shots, jax.random.PRNGKey(3))
    jobs = np.array([jcounts.get(format(i, "02b"), 0) for i in range(4)], dtype=float)
    assert chi2_test(jobs, pair.t.probs() / pair.t.probs().sum())
    assert counts == pair.t.sample(shots, torch.Generator().manual_seed(3))
    assert abs(pair.t.trace() - 1.0) < 1e-5  # sampling is non-destructive


def test_two_qubit_kraus_channel():
    p = 0.3
    kraus = [math.sqrt(1 - p) * np.eye(4, dtype=complex)] + [
        math.sqrt(p / 3) * np.kron(_PAULI[a], _PAULI[a]) for a in ("X", "Y", "Z")]
    pair = Pair(3).apply([(_H, (0,), False), (_CNOT, (0, 2), False)])
    rho = pair.t.matrix()
    pair.channel(kraus, (0, 2))
    pair.agree(kraus_sum(rho, kraus, (0, 2), 3))
    assert abs(pair.t.trace() - 1.0) < 1e-5


@pytest.mark.parametrize("name,targets", [("depolarizing", 4), ("amplitude_damping", (0,)),
                                          ("phase_damping", 2), ("bit_flip", 5),
                                          ("depolarizing2", (1, 4)), ("depolarizing2", (5, 0))])
def test_superoperator_equals_term_by_term(name, targets):
    """One pass of S = sum K (x) conj(K) against the JAX package's form: K
    and conj(K) on a copy per term, the terms added. n = 6, so the column
    targets fall in the lane block and the row targets outside it."""
    n = 6
    prims = gates(JC.brickwork_prims(n, depth=2, seed=4))
    a = TD.DensityMatrix(n).apply([TPrim(u, t, d) for u, t, d in prims])
    a.apply_channel(TD.depolarizing(0.05), 3)
    b = TD.DensityMatrix(n, a.state.clone())
    j = JD.DensityMatrix(n, tuple(jax.numpy.asarray(p) for p in TA.planes_from_state(a.state)))
    kraus = getattr(TD, name)(0.3)
    a.apply_channel(kraus, targets)
    b.apply_channel_plain(kraus, targets)
    j.apply_channel(kraus, targets)
    assert np.abs(a.matrix() - b.matrix()).max() < TOL
    assert np.abs(a.matrix() - j.matrix()).max() < TOL
    assert abs(a.trace() - 1.0) < 1e-5
    s = TD.superoperator(kraus)
    assert s.shape == (kraus[0].shape[0] ** 2,) * 2


def test_matrix_refused_past_12_qubits():
    dm = TD.DensityMatrix(13, torch.zeros(4, dtype=torch.complex64))  # no 2^26 allocation
    with pytest.raises(ValueError, match="n > 12"):
        dm.matrix()


# -- noise specs ----------------------------------------------------------------

LAYOUT, SIZES = {"q": 0, "anc": 3}, {"q": 3, "anc": 2}


def both_raise(call_t, call_j):
    with pytest.raises(ValueError) as te:
        call_t()
    with pytest.raises(ValueError) as je:
        call_j()
    assert str(te.value) == str(je.value)
    return str(te.value)


@pytest.mark.parametrize("spec", ["wat:0.1", "dep", "dep:0.1,ad", "dep:0.1@", "dep:0.1@ "])
def test_parse_noise_spec_errors(spec):
    both_raise(lambda: TN.parse_noise_spec(spec), lambda: JN.parse_noise_spec(spec))


@pytest.mark.parametrize("spec", ["ro", "ro:0.1@q[0]", "readout:0.2@anc"])
def test_readout_spec_errors(spec):
    both_raise(lambda: TN.split_readout_spec(spec), lambda: JN.split_readout_spec(spec))
    if "@" in spec:
        both_raise(lambda: TN.noise_spec_targets(spec), lambda: JN.noise_spec_targets(spec))


@pytest.mark.parametrize("tspec", ["q[5]", "nope", "nope[0]", "7", "q[", "q[x]", "q[1", "q++anc",
                                   "", "anc[2]"])
def test_resolve_noise_targets_errors(tspec):
    both_raise(lambda: TN.resolve_noise_targets(tspec, LAYOUT, SIZES, 5),
               lambda: JN.resolve_noise_targets(tspec, LAYOUT, SIZES, 5))


def test_noise_spec_values_equal():
    spec = "depolarizing:0.01, ad:0.05@q[2]+anc ,pd:0.02,dep2:0.1@q,bf:0.3@4,pf:0.2,ro:0.01"
    assert TN.split_readout_spec(spec) == JN.split_readout_spec(spec)
    rest = TN.split_readout_spec(spec)[0]
    assert TN.noise_spec_targets(spec) == JN.noise_spec_targets(spec)
    tp, jp = TN.parse_noise_spec(rest), JN.parse_noise_spec(rest)
    assert [l for l, _ in tp] == [l for l, _ in jp]
    assert all(np.array_equal(a, b) for (_, ta), (_, ja) in zip(tp, jp) for a, b in zip(ta, ja))
    for tspec in ("q", "q[2]+anc", "4", "anc[1]+0+q[1]"):
        assert TN.resolve_noise_targets(tspec, LAYOUT, SIZES, 5) == \
            JN.resolve_noise_targets(tspec, LAYOUT, SIZES, 5)
    assert TN.split_channel_target("dep:0.01@q[2]+anc") == ("dep:0.01", "q[2]+anc")
    assert set(TN.NOISE_CHANNELS) == set(JN.NOISE_CHANNELS)
    tc, tt = TN._normalize_noise([("a", TD.bit_flip(0.1)), ("b", TD.bit_flip(0.2), [3, 1])],
                                 LAYOUT, SIZES, 5)
    assert tt == [None, frozenset({1, 3})] and [c[0] for c in tc] == ["a", "b"]
    both_raise(lambda: TN._normalize_noise([("b", TD.bit_flip(0.2), [9])], LAYOUT, SIZES, 5),
               lambda: JN._normalize_noise([("b", JD.bit_flip(0.2), [9])], LAYOUT, SIZES, 5))


# -- DensityProgram ----------------------------------------------------------------


def programs(name, noise, seed, mesh=None):
    """The example through both packages' DensityProgram; the port's
    measurements take the JAX package's own uniforms."""
    path = os.path.join(EXAMPLES, f"{name}.qasm")
    with open(path) as f:
        src = f.read()
    jrho, jcregs = JN.DensityProgram(j_parse(path, src), noise=noise).run(seed=seed)
    tprog = TN.DensityProgram(t_parse(path, src), noise=noise, mesh=mesh)
    trho, tcregs = tprog.run(seed=seed, uniforms=jax_draws(jax.random.PRNGKey(seed), 16))
    return tprog, trho, tcregs, jrho, jcregs


@pytest.mark.parametrize("name,noise", [
    ("teleportation", None), ("teleportation", "dep:0.02,ad:0.05,pd:0.03,dep2:0.04"),
    ("teleportation", "bf:0.1@q[2],pf:0.05@0+1"), ("errorCorrection", "dep:0.01,dep2:0.03@q"),
    ("errorCorrection", "ad:0.04@a,pd:0.02")])
def test_density_program_on_the_examples(name, noise):
    for seed in (0, 3):
        tprog, trho, tcregs, jrho, jcregs = programs(name, noise, seed)
        assert {k: str(v) for k, v in tcregs.items()} == {k: str(v) for k, v in jcregs.items()}
        assert np.abs(trho.matrix() - jrho.matrix()).max() < TOL
        assert abs(trho.trace() - 1.0) < 1e-5
        jprog = JN.DensityProgram(j_parse("<t>", "qreg q[1];"), noise=noise) if not noise else None
        assert jprog is None or jprog.noise == []
    assert [l for l, *_ in tprog.noise] == ([] if noise is None else
                                            [l for l, _ in JN.parse_noise_spec(noise)])


def test_density_program_own_generator_is_seeded():
    path = os.path.join(EXAMPLES, "teleportation.qasm")
    ast = t_parse(path, open(path).read())
    runs = [TN.DensityProgram(ast, noise="dep:0.05").run(seed=s) for s in (1, 1, 2, 3, 4, 5)]
    bits = ["".join(str(c[k]) for k in sorted(c)) for _, c in runs]
    assert bits[0] == bits[1] and len(set(bits)) > 1
    assert torch.equal(runs[0][0].state, runs[1][0].state)


def test_a_run_leaves_no_cycle_holding_its_state():
    """The event loop is a recursive closure; were it left as a reference
    cycle, a 2 GiB rho would stay allocated until the next garbage
    collection. With the collector off, dropping the result frees it."""
    import gc
    import weakref

    from qubism_torch.run.compiler import CompiledProgram

    ast = t_parse("<t>", "qreg q[2]; creg c[1]; U(1,2,3) q[0]; measure q[0] -> c[0];\n"
                         "if(c==1) U(1,1,1) q[1];")
    gc.collect()
    gc.disable()
    try:
        rho, _ = TN.DensityProgram(ast, noise="dep:0.1").run(seed=0)
        state, _, _ = CompiledProgram(ast).run(seed=0)
        sim, _, _ = CompiledProgram(ast).run_sharded(mesh=1, seed=0)
        refs = [weakref.ref(rho), weakref.ref(state), weakref.ref(sim)]
        del rho, state, sim
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()


def test_density_program_errors():
    for src, kw in (("qreg q[15];", {}), ("qreg q[2];", {"noise": "ro:0.1"}),
                    ("qreg q[2];", {"noise": "dep:0.1@r"}), ("qreg q[2];", {"noise": "zz:0.1"})):
        both_raise(lambda: TN.DensityProgram(t_parse("<t>", src), **kw),
                   lambda: JN.DensityProgram(j_parse("<t>", src), **kw))
    # one buffer's cap follows the device: on the CPU it is the JAX package's
    assert TN.single_buffer_cap(torch.device("cpu")) == TN.DensityProgram.MAX_N
    assert TN.DensityProgram.MAX_N == JN.DensityProgram.MAX_N == 14
    TN.DensityProgram(t_parse("<t>", "qreg q[16];"), mesh=8)  # validates, does not allocate


@pytest.mark.parametrize("total, cap", [(24e9, 15), (80e9, 16), (85_520_809_984, 16),
                                        (16e9, 14), (4e9, 13)])
def test_single_buffer_cap_follows_the_card(monkeypatch, total, cap):
    """On a CUDA card the widest rho in one buffer is the largest n whose
    8 * 4^n bytes fill at most half of the card's memory (a stubbed card:
    24 GB holds 15, an 80 GB H100 16); past it the error names the card."""
    from types import SimpleNamespace

    card = SimpleNamespace(total_memory=int(total), name="Stub GPU")
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: card)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: card.name)
    cuda = torch.device("cuda", 0)
    n = TN.single_buffer_cap(cuda)
    assert n == cap and 8 * 4 ** n <= total / 2 < 8 * 4 ** (n + 1)
    which = f", the widest rho in half of the {total / 1e9:.1f} GB of Stub GPU"
    monkeypatch.setattr(TN.A, "device", lambda: cuda)
    TN.DensityProgram(t_parse("<t>", f"qreg q[{cap}];"))  # validates, does not allocate
    with pytest.raises(ValueError) as e:
        TN.DensityProgram(t_parse("<t>", f"qreg q[{cap + 1}];"))
    assert f"n={cap + 1} > {cap}{which}. Shard over a mesh" in str(e.value)


# -- the CLI ----------------------------------------------------------------------


def run_both(path, **kw):
    out = []
    for mod in (tcli, jcli):
        buf = io.StringIO()
        out.append((mod.eval_file(str(path), out=buf, **kw), buf.getvalue()))
    return out


def dump_probs(text):
    return {m.group(1): float(m.group(2)) for m in re.finditer(r"\|([01]+)>  p=([0-9.]+)", text)}


BELL_QASM = ("qreg q[2]; creg c[2];\nU(1.5707963267948966, 0, 3.141592653589793) q[0];\n"
             "CX q[0], q[1];\n")


def test_density_backend_flag(tmp_path):
    f = tmp_path / "open.qasm"
    f.write_text(BELL_QASM)
    (rc, out), (jrc, jout) = run_both(f, seed=0, backend="density", noise="depolarizing:0.05",
                                      shots=512, dump_state=True)
    assert rc == jrc == 0 and out.rstrip().endswith("Done.")
    assert "purity=" in out and "noise=depolarizing:0.05" in out
    assert "|00>:" in out and "|11>:" in out and ("|01>:" in out or "|10>:" in out)
    probs, jprobs = dump_probs(out), dump_probs(jout)
    assert probs.keys() == jprobs.keys() and len(probs) == 4
    assert all(abs(probs[k] - jprobs[k]) < 2e-6 for k in probs)
    # every line but the sampled counts is the JAX package's
    strip = [ln for ln in out.splitlines() if not ln.startswith("  |") or "p=" in ln]
    jstrip = [ln for ln in jout.splitlines() if not ln.startswith("  |") or "p=" in ln]
    assert strip == jstrip
    counts = np.array([int(re.search(rf"\|{b}>: (\d+)", out).group(1)) if f"|{b}>:" in out else 0
                       for b in ("00", "01", "10", "11")], dtype=float)
    assert counts.sum() == 512 and chi2_test(counts, np.array([probs[b] for b in
                                                               ("00", "01", "10", "11")]))


def test_density_backend_errors(tmp_path):
    f = tmp_path / "p.qasm"
    f.write_text("qreg q[1]; creg c[1]; measure q -> c;")
    g = tmp_path / "big.qasm"
    g.write_text("qreg q[20]; creg c[1];")
    for path, kw, word in ((f, {"mesh": 2}, "shards"), (g, {}, "4^n"),
                           (g, {"mesh": 2}, "single-buffer"), (f, {"noise": "wat:1"}, "unknown"),
                           (f, {"noise": "ro:0.1"}, "readout"), (f, {"compile_mode": True}, "exact")):
        (rc, out), (jrc, jout) = run_both(path, backend="density", **kw)
        assert rc == jrc == 2 and word in out
        if word != "shards":  # the port's ShardedSim words its own shape error
            assert out == jout


def test_observable_flag_density(tmp_path):
    f = tmp_path / "bell.qasm"
    f.write_text(BELL_QASM)
    (rc, out), (jrc, jout) = run_both(f, seed=0, backend="density", noise="dep:0.1",
                                      observables=["ZZ", "xx", "ZI"])
    assert rc == jrc == 0 and out == jout
    exact = float(re.search(r"<ZZ> = (-?\d+\.\d+)", out).group(1))
    assert abs(exact - (1 - 4 * 0.1 / 3) ** 2) < 1e-5  # each qubit's dep shrinks Z by 1 - 4p/3
    (rc, out), (jrc, jout) = run_both(f, backend="density", observables=["ZZZ"])
    assert rc == jrc == 2 and out == jout and "I/X/Y/Z" in out
