"""Pauli expectations of the port against the JAX package and a float64 numpy
oracle: the same state, made from a numpy seed, goes through
``qubism_tpu.ops.measure.expectation_pauli`` / ``expectation_pauli_sum`` and
their counterparts in ``qubism_torch.ops.measure``; ``StateVec``, ``Session``,
``qaoa_maxcut_energy`` and ``ShardedSim`` (after swaps have permuted the
qubits) likewise. Tolerances: 1e-5 absolute against the JAX value, 1e-6
against the oracle. The port walks a state in chunks; the chunk is made small
here so that every case crosses chunk, row and column boundaries."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qubism_torch as tq  # noqa: E402
import qubism_torch.models.circuits as TC  # noqa: E402
import qubism_tpu as jq  # noqa: E402
import qubism_tpu.models.circuits as JC  # noqa: E402
import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import measure as TM  # noqa: E402
from qubism_torch.parallel import ShardedSim, make_mesh  # noqa: E402
from qubism_tpu.ops import measure as JM  # noqa: E402
from qubism_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from qubism_tpu.parallel.sharded import ShardedSim as JaxShardedSim  # noqa: E402

TOL_JAX, TOL_ORACLE = 1e-5, 1e-6
N = 10  # qubits 0-2 index the chunk, 3-9 are the lane block

_PAULI = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
          "Y": np.array([[0, -1j], [1j, 0]]), "Z": np.diag([1.0, -1.0])}


@pytest.fixture(autouse=True)
def modes(monkeypatch):
    JK.INTERPRET = True
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(TM, "_EXP_CHUNK", 7)
    monkeypatch.setattr(TM, "_EXP_COLS", 4)
    yield
    JK.INTERPRET = False


def rand_planes(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    return v.real.astype(np.float32), v.imag.astype(np.float32)


def oracle(psi, pauli):
    """<psi|P|psi> in float64: P applied letter by letter as 2x2 matrices."""
    n = len(pauli)
    psi = np.asarray(psi, dtype=np.complex128)
    out = psi.reshape((2,) * n)
    for q, c in enumerate(pauli.upper()):
        if c != "I":
            out = np.moveaxis(np.tensordot(_PAULI[c], out, axes=(1, q)), 0, q)
    return float(np.real(np.vdot(psi, out.reshape(-1))))


def both(re, im, n):
    """One state in both packages, and its float64 amplitudes."""
    planes = (jnp.asarray(re), jnp.asarray(im))
    state = TA.state_from_planes(re, im)
    return planes, state, re.astype(np.complex128) + 1j * im.astype(np.complex128)


def at(n, letters):
    p = ["I"] * n
    for q, c in letters.items():
        p[q] = c
    return "".join(p)


@pytest.mark.parametrize("where,q", [("top", 0), ("middle", 2), ("lane", N - 1)])
@pytest.mark.parametrize("letter", "XYZ")
def test_one_letter_at_each_position_class(letter, where, q):
    planes, state, psi = both(*rand_planes(N, 10 + q), N)
    pauli = at(N, {q: letter})
    got = TM.expectation_pauli(state, N, pauli)
    assert abs(got - JM.expectation_pauli(planes, N, pauli)) < TOL_JAX
    assert abs(got - oracle(psi, pauli)) < TOL_ORACLE


@pytest.mark.parametrize("n_y", range(5))
def test_number_of_y(n_y):
    planes, state, psi = both(*rand_planes(N, 20 + n_y), N)
    letters = {0: "X", 5: "Z"}
    letters.update({q: "Y" for q in (1, 3, 6, 9)[:n_y]})
    pauli = at(N, letters)
    got = TM.expectation_pauli(state, N, pauli)
    assert abs(got - JM.expectation_pauli(planes, N, pauli)) < TOL_JAX
    assert abs(got - oracle(psi, pauli)) < TOL_ORACLE


@pytest.mark.parametrize("n", [1, 2, 3, 8, 12])
def test_random_strings_against_the_oracle(n):
    """Every width class: below a chunk, one chunk, many chunks."""
    rng = np.random.default_rng(n)
    _, state, psi = both(*rand_planes(n, 30 + n), n)
    for _ in range(8):
        pauli = "".join(rng.choice(list("IXYZ"), size=n))
        assert abs(TM.expectation_pauli(state, n, pauli) - oracle(psi, pauli)) < TOL_ORACLE, pauli
        applied = TA.complex_from_state(TM.apply_pauli(state, pauli, n))
        want = psi.reshape((2,) * n)
        for q, c in enumerate(pauli):
            want = np.moveaxis(np.tensordot(_PAULI[c], want, axes=(1, q)), 0, q)
        assert np.abs(applied - want.reshape(-1)).max() < TOL_ORACLE, pauli


def test_apply_pauli_equals_jax():
    planes, state, _ = both(*rand_planes(N, 41), N)
    for pauli in ("XYZIIIZYXI", "IIIYIIIIIY", "ZIIIIIIIIZ"):
        jr, ji = JM.apply_pauli_traced(planes, pauli, N)
        got = TA.complex_from_state(TM.apply_pauli(state, pauli, N))
        want = np.asarray(jr).reshape(-1) + 1j * np.asarray(ji).reshape(-1)
        assert np.abs(got - want).max() < 1e-6


def test_lowercase_and_bad_strings():
    planes, state, psi = both(*rand_planes(4, 42), 4)
    assert abs(TM.expectation_pauli(state, 4, "xyzi") - oracle(psi, "XYZI")) < TOL_ORACLE
    for bad in ("XYZ", "XYZII", "XQZI", ""):
        with pytest.raises(ValueError) as te:
            TM.expectation_pauli(state, 4, bad)
        with pytest.raises(ValueError) as je:
            JM.expectation_pauli(planes, 4, bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="I/X/Y/Z"):
        TM.expectation_pauli_sum(state, 4, [(1.0, "ZZII"), (0.5, "ZZ")])


SUMS = {
    "shared flip masks": [(0.5, at(N, {0: "X", 9: "X"})), (-1.2, at(N, {0: "Y", 9: "Y"})),
                          (0.8, at(N, {0: "X", 9: "X", 4: "Z"})), (0.3, at(N, {0: "Y", 9: "X", 2: "Z"}))],
    "distinct flip masks": [(0.7, at(N, {1: "X"})), (-0.3, at(N, {8: "Y"})),
                            (1.1, at(N, {2: "X", 3: "Y", 7: "Z"})), (0.25, "X" * N)],
    "all diagonal": [(-0.5, at(N, {i: "Z", (i + 1) % N: "Z"})) for i in range(N)] + [(0.4, "Z" * N)],
    "mixed": [(0.5, at(N, {0: "Z", 1: "Z"})), (2.0, at(N, {4: "X", 5: "Z"})),
              (0.75, at(N, {0: "Y", 9: "Y"})), (-1.0, at(N, {})), (0.1, at(N, {4: "X", 6: "Z"}))],
}


@pytest.mark.parametrize("name", list(SUMS))
def test_sums(name):
    terms = SUMS[name]
    planes, state, psi = both(*rand_planes(N, 50), N)
    got = TM.expectation_pauli_sum(state, N, terms)
    assert abs(got - JM.expectation_pauli_sum(planes, N, terms)) < TOL_JAX
    assert abs(got - sum(c * oracle(psi, p) for c, p in terms)) < TOL_ORACLE
    groups = TM.group_terms([p for _, p in terms])
    assert sum(len(g) for g in groups.values()) == len(terms)
    if name == "all diagonal":
        assert list(groups) == [0]
    if name == "shared flip masks":
        assert len(groups) == 1


def test_a_group_reads_its_partner_once(monkeypatch):
    """Terms of one flip mask go through one pauli_pair_sums call."""
    calls = []
    real = TM.pauli_pair_sums
    monkeypatch.setattr(TM, "pauli_pair_sums",
                        lambda a, b, n, f, zs: calls.append((f, len(zs))) or real(a, b, n, f, zs))
    _, state, _ = both(*rand_planes(N, 51), N)
    TM.expectation_pauli_sum(state, N, SUMS["all diagonal"] + SUMS["shared flip masks"])
    assert calls == [(0, N + 1), ((1 << (N - 1)) | 1, 4)]


def test_statevec_and_session():
    """The expectation cases of tests/test_models.py on both packages: GHZ
    correlators through StateVec, a Bell pair through Session."""
    n = 10
    tg = tq.on_just(0, tq.hadamard(), n)
    jg = jq.on_just(0, jq.hadamard(), n)
    for i in range(n - 1):
        tg, jg = tg.then(tq.cnot(i, i + 1, n)), jg.then(jq.cnot(i, i + 1, n))
    tsv, jsv = tg(tq.mk_state_vec(n)), jg(jq.mk_state_vec(n))
    for pauli, want in (("ZZ" + "I" * (n - 2), 1.0), ("Z" + "I" * (n - 1), 0.0), ("X" * n, 1.0),
                        ("YY" + "X" * (n - 2), -1.0)):
        assert abs(tsv.expectation(pauli) - want) < TOL_JAX
        assert abs(tsv.expectation(pauli) - jsv.expectation(pauli)) < TOL_JAX
    terms = [(0.5, "ZZ" + "I" * (n - 2)), (-2.0, "X" * n)]
    assert abs(tsv.expectation_sum(terms) - jsv.expectation_sum(terms)) < TOL_JAX
    ts, js = tq.Session(tq.mk_state_vec(2), seed=0), jq.Session(jq.mk_state_vec(2), seed=0)
    ts.gate(tq.on_just(0, tq.hadamard(), 2)).gate(tq.cnot(0, 1, 2))
    js.gate(jq.on_just(0, jq.hadamard(), 2)).gate(jq.cnot(0, 1, 2))
    for pauli in ("ZZ", "XX", "YY", "ZI"):
        assert abs(ts.expectation(pauli) - js.expectation(pauli)) < TOL_JAX
    assert abs(ts.expectation_sum([(1.0, "ZZ"), (1.0, "XX")]) - 2.0) < TOL_JAX
    assert abs(js.expectation_sum([(1.0, "ZZ"), (1.0, "XX")]) - 2.0) < TOL_JAX


def test_qaoa_maxcut_energy():
    n = 8
    edges = TC.ring_edges(n) + [(0, 4)]
    gammas, betas = [0.4, 0.7], [0.3, 0.2]
    tprims = TC.qaoa_prims(n, edges, gammas, betas)
    jprims = JC.qaoa_prims(n, edges, gammas, betas)
    tstate = tq.Gate(n, tuple(tprims))(tq.mk_state_vec(n))
    jstate = jq.Gate(n, tuple(jprims))(jq.mk_state_vec(n))
    got = TC.qaoa_maxcut_energy(tstate, n, edges)
    assert abs(got - JC.qaoa_maxcut_energy(jstate, n, edges)) < TOL_JAX
    assert abs(got - TC.qaoa_maxcut_energy(tstate.state, n, edges)) < 1e-12
    psi = tstate.amps
    want = sum(0.5 * (1 - oracle(psi, at(n, {i: "Z", j: "Z"}))) for i, j in edges)
    assert abs(got - want) < TOL_ORACLE
    sim = ShardedSim(n, make_mesh(2), banks=1).apply(tprims)
    assert abs(TC.qaoa_maxcut_energy(sim, n, edges) - want) < TOL_ORACLE


SHARDED_STRINGS = ["ZIIIIIII", "XIIZIIII", "IIIYXIII", "ZXYIIIIZ", "yIIIIIIy", "XXXXXXXX"]


@pytest.mark.parametrize("shards,banks", [(1, 0), (2, 1), (4, 2), (8, 0)])
def test_sharded_sim(shards, banks):
    """Strings that cross the device, bank and local bits, after the dense
    gates of a brickwork circuit have permuted the qubits."""
    n = 8
    jprims = JC.brickwork_prims(n, 2, seed=7)
    prims = [TPrim(p.u, p.targets, p.diag) for p in jprims]
    ts = ShardedSim(n, make_mesh(shards), banks=banks).apply(prims)
    js = JaxShardedSim(n, jax_make_mesh(shards), banks=banks).apply(jprims)
    assert ts.perm == js.perm
    if shards == 8:
        assert ts.perm != list(range(n))
    psi = ts.amplitudes()
    for pauli in SHARDED_STRINGS:
        got = ts.expectation(pauli)
        assert abs(got - js.expectation(pauli)) < TOL_JAX, pauli
        assert abs(got - oracle(psi, pauli)) < TOL_ORACLE, pauli
    terms = [(0.5, "ZZIIIIII"), (-1.25, "IXYIIIII"), (2.0, "IIIIXZII"), (0.75, "YIIIIIIY"),
             (0.3, "IXXIIIII"), (-0.6, "ZIIIIIIZ")]
    got = ts.expectation_sum(terms)
    assert abs(got - js.expectation_sum(terms)) < TOL_JAX
    assert abs(got - sum(c * oracle(psi, p) for c, p in terms)) < TOL_ORACLE
    with pytest.raises(ValueError) as te:
        ts.expectation("ZZ")
    with pytest.raises(ValueError) as je:
        js.expectation("ZZ")
    assert str(te.value) == str(je.value)


def test_sharded_sim_after_a_relabelling_swap():
    """tests/test_sharded.py's case: a CX on a device bit moves qubit 0."""
    n = 6
    h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    cx = np.eye(4)[[0, 1, 3, 2]]
    sim = ShardedSim(n, make_mesh(8)).apply([TPrim(h, (q,)) for q in range(n)])
    sim.apply([TPrim(cx, (0, 3))])
    assert sim.perm != list(range(n))
    psi = sim.amplitudes()
    for pauli in ("ZIIIII", "XZIIII", "IIYIIX"):
        assert abs(sim.expectation(pauli) - oracle(psi, pauli)) < TOL_ORACLE, pauli


def test_partner_on_another_shard_is_read_in_chunks():
    """A device-bit flip pairs two shards: the result equals the one-state
    value, and no tensor of a whole shard is made beside the state."""
    n = 9
    rng = np.random.default_rng(3)
    prims = [TPrim(np.linalg.qr(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))[0], (q,))
             for q in range(n)]
    sim = ShardedSim(n, make_mesh(4), banks=0).apply(prims)
    pauli = "X" + "I" * (n - 2) + "Y"
    psi = sim.amplitudes()
    assert abs(sim.expectation(pauli) - oracle(psi, pauli)) < TOL_ORACLE
