"""The port's TrajectoryProgram (qubism_torch/run/noisy.py, the vmapped
engine) against the JAX package's: with the JAX package's own uniforms
injected (``jax.random.uniform(fold_in(split(key, T)[t], site))``, site
numbered as its ``_site`` counter numbers them) the example programs give the
same outcome bits index for index and the same final states to 1e-5;
feed-forward, errorCorrection, reset, readout error, targeted ``@`` channels
and dep2 after a descending ``cx`` included. A batch split over 8 CPU shards
gives the unsplit run's results bit for bit. Also the batched and device-side
measurement functions of ops/measure.py against their JAX counterparts."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qubism_torch.config import config  # noqa: E402
from qubism_torch.ops import measure as TM  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm as tparse  # noqa: E402
from qubism_torch.run import noisy as TN  # noqa: E402
from qubism_tpu.ops import measure as JM  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm as jparse  # noqa: E402
from qubism_tpu.run import noisy as JN  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
PI = 3.141592653589793
H_GATE = f"U(1.5707963267948966, 0, {PI})"
X_GATE = f"U({PI}, 0, {PI})"

RESET_SRC = f"""qreg q[3]; creg a[1]; creg b[2];
{H_GATE} q[0];
CX q[0], q[1];
measure q[0] -> a[0];
reset q[0];
if (a == 1) {X_GATE} q[2];
U(0.7, 0.1, 0.2) q[0];
CX q[1], q[0];
reset q[1];
measure q[0] -> b[0];
measure q[2] -> b[1];
"""
DESC_SRC = f"""qreg q[4]; creg c[4];
U(0.9, 0.3, 0.1) q[3];
CX q[3], q[1];
CX q[2], q[0];
{H_GATE} q[2];
measure q -> c;
"""

CASES = {
    "teleportation ff": ("teleportation.qasm", "dep:0.05,ad:0.1"),
    "teleportation none": ("teleportation.qasm", None),
    "errorCorrection ro": ("errorCorrection.qasm", "dep:0.02,ro:0.05"),
    "errorCorrection targeted": ("errorCorrection.qasm", "bf:0.1@q+a[1],pd:0.2@2"),
    "reset": (RESET_SRC, "ad:0.2,dep:0.05"),
    "dep2 descending": (DESC_SRC, "dep2:0.3,pf:0.1"),
    "dep2 kraus descending": (DESC_SRC, "dep2:0.2,ad:0.3"),
}


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def programs(case):
    src, noise = CASES[case]
    path = os.path.join(EXAMPLES, src) if src.endswith(".qasm") else "<test>.qasm"
    text = open(path).read() if src.endswith(".qasm") else src
    return (TN.TrajectoryProgram(tparse(path, text), noise=noise),
            JN.TrajectoryProgram(jparse(path, text), noise=noise))


def jax_uniforms(key, ntraj, sites, padded=None):
    keys = jax.random.split(key, padded or ntraj)
    return np.array([[float(jax.random.uniform(jax.random.fold_in(keys[t], s)))
                      for s in range(sites)] for t in range(ntraj)])


def jax_states(js, ntraj):
    return (np.asarray(js[0]).reshape(ntraj, -1)
            + 1j * np.asarray(js[1]).reshape(ntraj, -1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_injected_uniforms_give_the_jax_outcomes(case):
    tp, jp = programs(case)
    ntraj = 12
    # the site count is the JAX program's site counter after one trace
    jp._run_one(jax.random.PRNGKey(0))
    assert tp.sites == jp._site
    key = jax.random.PRNGKey(7)
    u = jax_uniforms(key, ntraj, tp.sites)
    tv, ts = tp.run_vals(ntraj, uniforms=u, return_states=True)
    jv, js = jp.run_vals(ntraj, key=key, return_states=True)
    assert sorted(tv) == sorted(jv)
    for c in tv:
        assert tv[c].dtype == np.int32 and np.array_equal(tv[c], np.asarray(jv[c])), c
    assert np.abs(ts.numpy() - jax_states(js, ntraj)).max() < 1e-5


@pytest.mark.parametrize("case", ["teleportation ff", "reset", "dep2 kraus descending"])
def test_mesh_split_is_bit_identical(case):
    tp, _ = programs(case)
    ntraj = 24
    vals, states = tp.run_vals(ntraj, seed=5, return_states=True)
    for mesh in (8, 3):
        mv, ms = tp.run_vals(ntraj, seed=5, return_states=True, mesh=mesh)
        assert all(np.array_equal(mv[c], vals[c]) for c in vals)
        assert torch.equal(ms, states)
    # batches of the live-state cap: the same results
    bv, bs = tp.run_vals(ntraj, seed=5, return_states=True,
                         max_live_words=5 * tp._traj_live_cost())
    assert all(np.array_equal(bv[c], vals[c]) for c in vals)
    assert torch.equal(bs, states)


@pytest.mark.parametrize("entry", ["run_vals", "expectations"])
def test_batch_states_are_freed_before_the_next_batch(monkeypatch, entry):
    """Only one batch's final states are alive at a time: a batch is reduced
    to host values, and its states dropped, before the next batch runs."""
    import gc
    import weakref

    tp, _ = programs("reset")
    alive, refs, run_batch = [], [], tp._run_batch

    def watched(u):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))
        cregs, psi = run_batch(u)
        refs.append(weakref.ref(psi))
        return cregs, psi

    want = (tp.run_vals(6, seed=2) if entry == "run_vals"
            else tp.expectations(["ZZZ"], 6, seed=2))
    monkeypatch.setattr(tp, "_run_batch", watched)
    monkeypatch.setattr(tp, "_MAX_LIVE", 2 * tp._traj_live_cost())
    if entry == "run_vals":
        got = tp.run_vals(6, seed=2)
        assert all(np.array_equal(got[c], want[c]) for c in want)
    else:
        assert tp.expectations(["ZZZ"], 6, seed=2) == want
    assert alive == [0, 0, 0]


def test_mesh_estimators_bit_identical_and_match_jax():
    tp, jp = programs("teleportation ff")
    ntraj = 16
    key = jax.random.PRNGKey(9)
    u = jax_uniforms(key, ntraj, tp.sites)
    got = tp.expectations(["ZZI", "XIX", "IYZ"], ntraj, uniforms=u)
    want = jp.expectations(["ZZI", "XIX", "IYZ"], ntraj, key=key)
    assert np.allclose(got, want, atol=1e-6)
    assert got == tp.expectations(["ZZI", "XIX", "IYZ"], ntraj, uniforms=u, mesh=4)
    assert tp.expectation("ZZI", ntraj, uniforms=u) == pytest.approx(got[0], rel=1e-12)
    terms = [(0.5, "ZZI"), (-2.0, "IIX")]
    assert np.allclose(tp.expectation_sum(terms, ntraj, uniforms=u),
                       jp.expectation_sum(terms, ntraj, key=key), atol=1e-6)
    # one trajectory: stderr 0 (the JAX convention of _mc_estimate)
    assert tp.expectation("ZZI", 1, seed=0)[1] == 0.0


def test_counts_render_as_jax():
    tp, jp = programs("errorCorrection ro")
    key = jax.random.PRNGKey(1)
    u = jax_uniforms(key, 20, tp.sites)
    assert tp.counts(20, uniforms=u) == jp.counts(20, key=key)


def test_seeded_stream_repeats():
    tp, _ = programs("teleportation ff")
    a = tp.run_vals(32, seed=3)
    assert all(np.array_equal(a[c], tp.run_vals(32, seed=3)[c]) for c in a)
    b = tp.run_vals(32, seed=4)
    assert any(not np.array_equal(a[c], b[c]) for c in a)


def test_sqrt_born_threshold_matches_jax(monkeypatch):
    from qubism_tpu.config import config as jconfig

    tp, jp = programs("teleportation none")
    key = jax.random.PRNGKey(2)
    u = jax_uniforms(key, 16, tp.sites)
    monkeypatch.setattr(config, "reference_sqrt_born", True)
    monkeypatch.setattr(jconfig, "reference_sqrt_born", True)
    tv, jv = tp.run_vals(16, uniforms=u), jp.run_vals(16, key=key)
    assert all(np.array_equal(tv[c], np.asarray(jv[c])) for c in tv)


def test_errors_match_jax(monkeypatch):
    tp, jp = programs("teleportation ff")
    for prog in (tp, jp):
        with pytest.raises(ValueError, match="unknown engine"):
            prog.run_vals(4, engine="xla")
        with pytest.raises(ValueError, match="does not support return_states or mesh"):
            prog.run_vals(4, engine="fused", return_states=True)
    with pytest.raises(ValueError, match="only 8 device"):
        JN.resolve_traj_mesh(16)
    assert TN.resolve_traj_mesh(None) is None and TN.resolve_traj_mesh(1) is None
    assert TN.resolve_traj_mesh(4) == (torch.device("cpu"),) * 4
    monkeypatch.setattr(config, "device", "cuda")
    with pytest.raises(ValueError, match=r"--mesh 16: only \d+ device\(s\) visible"):
        TN.resolve_traj_mesh(16)


def test_engine_auto_takes_vmap_when_fused_refuses(monkeypatch):
    tp, _ = programs("teleportation none")
    monkeypatch.setattr(config, "reference_sqrt_born", True)
    auto = tp.run_vals(16, seed=2, engine="auto")
    vmap = tp.run_vals(16, seed=2)
    assert all(np.array_equal(auto[c], vmap[c]) for c in vmap)


# -- ops/measure.py: batched and device-side ------------------------------------------


def rand_batch(t, n, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(t, 1 << n)) + 1j * rng.normal(size=(t, 1 << n))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return z.astype(np.complex64)


@pytest.mark.parametrize("n,q", [(3, 0), (5, 2), (9, 1), (9, 8)])
def test_batched_prob_one_and_collapse(n, q):
    z = rand_batch(6, n, n + q)
    z[1] = 0  # the zero-vector convention
    psi = torch.from_numpy(z)
    outcome = np.array([0, 1, 1, 0, 1, 0], dtype=np.int32)
    p1 = TM.prob_one_batch(psi, q, n).numpy()
    col = TM.collapse_batch(psi, torch.from_numpy(outcome), q, n).numpy()
    for t in range(6):
        planes = (jnp.asarray(z[t].real), jnp.asarray(z[t].imag))
        assert abs(p1[t] - float(JM.prob_one_traced(planes, q, n))) < 1e-6
        jr, ji = JM.collapse_traced(planes, int(outcome[t]), q, n)
        assert np.abs(col[t] - (np.asarray(jr) + 1j * np.asarray(ji))).max() < 1e-6
    assert not col[1].any()
    assert np.array_equal(TM.collapse_batch(psi, 1, q, n).numpy(),
                          TM.collapse_batch(psi, torch.ones(6, dtype=torch.int32), q, n).numpy())


@pytest.mark.parametrize("n,qubits", [(4, (2, 0)), (9, (1, 3, 8)), (12, (0, 5, 6, 11, 10))])
def test_device_marginal_draws_and_projection(n, qubits):
    z = rand_batch(1, n, n)[0]
    state = torch.from_numpy(z.copy())
    table = TM.marginal_table_dev(state, n, qubits)
    jt = JM._marginal_table_traced((jnp.asarray(z.real), jnp.asarray(z.imag)), n, qubits)
    assert table.dtype == torch.float32
    assert np.abs(table.numpy() - np.asarray(jt)).max() < 1e-6
    u = np.array([0.3, 0.8, 0.5, 0.1, 0.95][:len(qubits)], dtype=np.float32)
    outs, mask = TM.ancestral_draws_dev(table, qubits, torch.from_numpy(u),
                                        TM.bit_table(len(qubits), "cpu"))
    want = TM.ancestral_draws(table.double().numpy(), qubits, u.astype(np.float64))
    assert [int(o) for o in outs] == want
    mass = float((table * mask).sum())
    proj = TM.Projector(qubits, n, "cpu")
    scale = torch.tensor(1.0 / np.sqrt(mass), dtype=torch.float32)
    got = proj.apply(state, *proj.vectors(outs, scale))
    ref = TM.project(torch.from_numpy(z.copy()), n, qubits, want, 1.0 / np.sqrt(mass))
    assert np.abs(got.numpy() - ref.numpy()).max() < 1e-6
    assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-5
