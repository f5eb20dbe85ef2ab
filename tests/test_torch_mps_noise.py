"""The port's noisy MPS trajectories (qubism_torch/mps/noise.py) against the
JAX package's on the CPU.

* The tapes: the same rows, noise-slot indices, CDF rows and K rows as
  the JAX ``_tape`` builds, event by event (operands equal as float32).
* The outcomes: with the JAX package's own uniforms injected (its
  ``uniform(fold_in(split(key, T)[t], site), (k,))`` per slot group, site
  numbered as its ``_site`` counter numbers them, laid out as the port's
  columns) a program gives the JAX outcome bits index for index, and the
  same Monte-Carlo expectations to 1e-5.
* The laws: sampled distributions against the exact ``DensityProgram`` of
  the JAX package within 5 sigma (+ 1e-3), as tests/test_mps.py,
  tests/test_noisy.py and tests/test_noise_targeting.py hold the JAX
  engine; the reference's own tolerances are kept.

Every trajectory case of tests/test_mps.py, the MPS cases of
tests/test_noisy.py and both of tests/test_noise_targeting.py have their
counterpart here."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qubism_torch.config import config  # noqa: E402
from qubism_torch.mps import MPSSim, MPSTrajectoryProgram  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm as tparse  # noqa: E402
from qubism_torch.run.noisy import TrajectoryProgram  # noqa: E402
from qubism_tpu.mps.noise import MPSTrajectoryProgram as JProgram  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm as jparse  # noqa: E402
from qubism_tpu.run.noisy import DensityProgram  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
PI = "3.141592653589793"
H = f"U(1.5707963267948966, 0, {PI})"
X = f"U({PI}, 0, {PI})"


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _ast(src):
    return tparse("<test>", src)


def exact_probs(src, noise):
    """The JAX package's exact DensityProgram distribution of ``src``
    without its final ``measure q -> c;``."""
    rho, _ = DensityProgram(jparse("<test>", src.replace("measure q -> c;", "")),
                            noise=noise).run(seed=0)
    return np.asarray(rho.probs(), np.float64)


def assert_law(bits, exact, ntraj, slack=1e-3):
    """2-qubit outcome frequencies within 5 sigma + slack of ``exact``."""
    n = bits.shape[1]
    idx = (bits.astype(np.int64) * (1 << np.arange(n - 1, -1, -1))).sum(1)
    got = np.bincount(idx, minlength=1 << n) / ntraj
    assert np.all(np.abs(got - exact) < 5 * np.sqrt(exact * (1 - exact) / ntraj) + slack), (
        got, exact)


# -- the tapes and the JAX outcomes ---------------------------------------------

RESET_SRC = f"""qreg q[3]; creg a[1]; creg b[2];
{H} q[0];
CX q[0], q[1];
measure q[0] -> a[0];
reset q[0];
if (a == 1) {X} q[2];
U(0.7, 0.1, 0.2) q[0];
CX q[2], q[0];
reset q[1];
measure q[0] -> b[0];
measure q[2] -> b[1];
"""
ROUTED_SRC = f"""qreg q[4]; qreg r[1]; creg c[5];
U(0.9, 0.3, 0.1) q[3];
CX q[3], q[0];
{H} r[0];
CX q[1], r[0];
U(0.2, 1.1, 0.4) q[2];
CX q[0], q[2];
measure q[3] -> c[3]; measure q[0] -> c[0]; measure r[0] -> c[4];
measure q[1] -> c[1]; measure q[2] -> c[2];
"""

CASES = {
    "teleportation ff": ("teleportation.qasm", "dep:0.05,ad:0.1"),
    "teleportation none": ("teleportation.qasm", None),
    "errorCorrection ro": ("errorCorrection.qasm", "dep:0.02,ro:0.05"),
    "errorCorrection targeted": ("errorCorrection.qasm", "bf:0.1@q+a[1],pd:0.2@2"),
    "reset": (RESET_SRC, "ad:0.2,dep:0.05"),
    "routed dep2": (ROUTED_SRC, "dep2:0.3,pf:0.1,ad:0.15@q[0]+r"),   # measured out of order
}


def programs(case, chi=4):
    src, noise = CASES[case]
    path = os.path.join(EXAMPLES, src) if src.endswith(".qasm") else "<test>.qasm"
    text = open(path).read() if src.endswith(".qasm") else src
    return (MPSTrajectoryProgram(tparse(path, text), noise=noise, chi=chi),
            JProgram(jparse(path, text), noise=noise, chi=chi))


@pytest.mark.parametrize("case", list(CASES))
def test_tape_noise_slots_match_jax(case):
    """Event by event: the same codes and sites, operands equal as float32,
    the same Pauli slot, dep2 pair and K rows with the same CDFs; and the
    stochastic sites counted from the tapes."""
    from qubism_torch.run.compiler import EvCond, EvMeasure
    from qubism_tpu.run import compiler as JC

    tp, jp = programs(case)
    tapes, sites = tp._tapes()
    jp._center = 0
    gates = []

    def walk(events):
        for ev in events:
            if isinstance(ev, JC.EvGates):
                gates.append(ev.prims)
            elif isinstance(ev, JC.EvCond):
                walk(ev.body)

    walk(jp.events)
    assert len(tapes) == len(gates)
    count = 0
    for t, prims in zip(tapes, gates):
        codes, qs, us, rows, cdf, r2a, r2b, cdf2, krows = t
        jcodes, jqs, urs, uis, jrows, jcdf, jr2a, jr2b, jcdf2, jk = jp._tape(prims)
        assert np.array_equal(codes, jcodes) and np.array_equal(qs, jqs)
        assert np.array_equal(us.real, urs) and np.array_equal(us.imag, uis)
        for a, b in ((rows, jrows), (cdf, jcdf), (r2a, jr2a), (r2b, jr2b), (cdf2, jcdf2),
                     (krows, jk)):
            assert np.array_equal(a, b)
        count += len(rows) + len(r2a) + len(krows)

    def measured(events):
        return sum(len(ev.qubits) if isinstance(ev, EvMeasure)
                   else measured(ev.body) if isinstance(ev, EvCond) else 0 for ev in events)

    assert sites == count + measured(tp.events) * (2 if tp.readout_p else 1)


def jax_uniforms(tprog, key, ntraj):
    """The uniform table that makes the port draw what the JAX package
    draws from ``key``: one JAX site per slot group (K rows, Pauli slots,
    dep2 pairs) of a gate event and per measured qubit and readout flip."""
    from qubism_torch.run.compiler import EvCond, EvGates, EvMeasure

    tapes = iter(tprog._tapes()[0])
    groups = []

    def walk(events):
        for ev in events:
            if isinstance(ev, EvGates):
                t = next(tapes)
                groups.extend(k for k in (len(t[8]), len(t[3]), len(t[5])) if k)
            elif isinstance(ev, EvMeasure):
                groups.extend([0] * len(ev.qubits) * (2 if tprog.readout_p else 1))
            elif isinstance(ev, EvCond):
                walk(ev.body)

    walk(tprog.events)

    def one(k):
        cols = [jax.random.uniform(jax.random.fold_in(k, s), (g,)) if g
                else jax.random.uniform(jax.random.fold_in(k, s))[None]
                for s, g in enumerate(groups)]
        return jnp.concatenate(cols) if cols else jnp.zeros(0)

    table = np.asarray(jax.vmap(one)(jax.random.split(key, ntraj)), np.float64)
    assert table.shape == (ntraj, tprog.sites)
    return table


@pytest.mark.parametrize("case", list(CASES))
def test_injected_uniforms_give_the_jax_outcomes(case):
    tp, jp = programs(case)
    key = jax.random.PRNGKey(11)
    ntraj = 48
    u = jax_uniforms(tp, key, ntraj)
    got = tp.run_vals(ntraj, uniforms=u)
    want = jp.run_vals(ntraj, key=key)
    for c in want:
        assert np.array_equal(got[c], np.asarray(want[c])), c
    # the same outcomes give the same Monte-Carlo estimates
    pauli = ["Z" * tp.n, "X" + "I" * (tp.n - 1)]
    te = tp.expectations(pauli, ntraj, uniforms=u)
    je = jp.expectations(pauli, ntraj, key=key)
    assert np.allclose(te, je, atol=1e-5, rtol=0)


def test_return_states_last_leaf_is_the_discarded_weight():
    """(sites, disc) for the JAX (re, im, disc): with chi too small the
    per-trajectory discarded weight is the JAX package's to a relative
    1e-3; the final states give its <Z...Z> per trajectory to 1e-5."""
    src = "qreg q[4]; creg c[4];\n" + "\n".join(
        f"U({0.3 + k}, {0.2 * k}, 0.1) q[{k}];" for k in range(4)) + "\n" + \
        "CX q[0], q[1]; CX q[2], q[3]; CX q[1], q[2]; CX q[0], q[3];\n" + \
        "U(0.4, 0.1, 0.9) q[1]; CX q[3], q[1]; CX q[0], q[2];\n"
    tp = MPSTrajectoryProgram(_ast(src), noise="dep:0.1", chi=2)
    jp = JProgram(jparse("<test>", src), noise="dep:0.1", chi=2)
    key = jax.random.PRNGKey(3)
    u = jax_uniforms(tp, key, 16)
    _, (sites, disc) = tp.run_vals(16, uniforms=u, return_states=True)
    _, jstates = jp.run_vals(16, key=key, return_states=True)
    jdisc = np.asarray(jstates[2])
    assert sites.shape == (16, 4, 2, 2, 2) and sites.dtype == torch.complex64
    assert disc.shape == (16,) and (jdisc > 1e-4).all()
    assert np.all(np.abs(disc.numpy() - jdisc) <= 1e-3 * jdisc)
    tz = tp._final_values((sites, disc), ["ZZZZ"])[:, 0]
    jz = np.asarray(jax.vmap(lambda r, i, d: jp._expect_final((r, i, d), "ZZZZ"))(*jstates))
    assert np.allclose(tz, jz, atol=1e-5)


# -- tests/test_mps.py's trajectory cases -------------------------------------------


def test_mps_trajectories_deterministic():
    prog = MPSTrajectoryProgram(_ast(f"qreg q[2]; creg c[2];\n{X} q[0];\nmeasure q -> c;"),
                                chi=4)
    bits = prog.run_vals(16, seed=0)["c"]
    assert (bits[:, 0] == 1).all() and (bits[:, 1] == 0).all()


def test_mps_trajectories_bitflip_rate():
    p = 0.25
    prog = MPSTrajectoryProgram(_ast(f"qreg q[1]; creg c[1];\n{X} q[0];\nmeasure q -> c;"),
                                noise=f"bitflip:{p}", chi=2)
    bits = prog.run_vals(4096, seed=1)["c"][:, 0]
    sigma = np.sqrt(p * (1 - p) / 4096)
    assert abs(float((bits == 0).mean()) - p) < 5 * sigma


GHZ2 = f"qreg q[2]; creg c[2];\n{H} q[0];\nCX q[0], q[1];\nmeasure q -> c;"


def test_mps_trajectories_match_exact_density():
    """GHZ-2 + depolarizing: marginals against the exact density matrix."""
    p = 0.15
    bits = MPSTrajectoryProgram(_ast(GHZ2), noise=f"depolarizing:{p}", chi=4).run_vals(
        8192, seed=2)["c"]
    assert_law(bits, exact_probs(GHZ2, f"depolarizing:{p}"), 8192)


def test_mps_trajectories_nonclifford_noise_match_density():
    """Non-Clifford gates (a T rotation) under Pauli noise, the regime only
    this engine covers at large n, pinned at small n."""
    src = (f"qreg q[1]; creg c[1];\n{H} q[0];\nU(0, 0, 0.7853981633974483) q[0];\n"
           f"{H} q[0];\nmeasure q -> c;")
    p = 0.1
    exact_p1 = exact_probs(src, f"depolarizing:{p}")[1]
    ntraj = 8192
    bits = MPSTrajectoryProgram(_ast(src), noise=f"depolarizing:{p}", chi=2).run_vals(
        ntraj, seed=4)["c"][:, 0]
    assert abs(float(bits.mean()) - exact_p1) < 5 * np.sqrt(exact_p1 * (1 - exact_p1) / ntraj)


def test_mps_trajectories_feed_forward_and_reset():
    prog = MPSTrajectoryProgram(_ast(f"""
        qreg q[2]; creg c[1]; creg d[1];
        {H} q[0];
        measure q[0] -> c[0];
        if (c == 0) {X} q[1];
        measure q[1] -> d[0];
    """), chi=4)
    vals = prog.run_vals(128, seed=3)
    c, d = vals["c"][:, 0], vals["d"][:, 0]
    assert (d == 1 - c).all()
    assert 0 < c.mean() < 1
    prog2 = MPSTrajectoryProgram(_ast(f"qreg q[1]; creg c[1];\n{H} q[0];\nreset q[0];\n"
                                      "measure q -> c;"), chi=2)
    assert (prog2.run_vals(64, seed=4)["c"] == 0).all()


def test_mps_trajectories_routed_cx_and_trunc_error():
    """A non-adjacent CX rides SWAP routing inside the tape; the noiseless
    GHZ across it stays exactly correlated and discards nothing."""
    prog = MPSTrajectoryProgram(_ast(f"qreg q[4]; creg c[4];\n{H} q[0];\nCX q[0], q[3];\n"
                                     "measure q -> c;"), chi=4)
    vals, states = prog.run_vals(256, seed=5, return_states=True)
    bits = vals["c"]
    assert (bits[:, 0] == bits[:, 3]).all()
    assert (bits[:, 1:3] == 0).all()
    assert 0 < bits[:, 0].mean() < 1
    disc = states[-1].numpy()              # per-trajectory discarded weight
    assert disc.shape == (256,) and np.all(disc == 0.0)


def ghz_lines(n):
    return ([f"qreg q[{n}]; creg c[{n}];", f"{H} q[0];"]
            + [f"CX q[{q}], q[{q + 1}];" for q in range(n - 1)] + ["measure q -> c;"])


@pytest.mark.slow
def test_mps_trajectories_forty_qubits():
    """40-qubit noisy GHZ at chi=4: no dense trajectory program reaches it."""
    prog = MPSTrajectoryProgram(_ast("\n".join(ghz_lines(40))), noise="depolarizing:0.002",
                                chi=4)
    bits = prog.run_vals(32, seed=6)["c"]
    clean = float((bits == bits[:, :1]).all(axis=1).mean())
    # 79 noise sites; Z errors invisible: clean fraction ~ (1 - 2p/3)^79 ~ 0.90
    assert 0.6 < clean <= 1.0
    assert 0 < bits[:, 0].mean() < 1


def test_mps_trajectories_unknown_channel_rejected():
    """Unknown channel names get the parser's error, as in the JAX package;
    ad/pd construct and carry K slots."""
    with pytest.raises(ValueError, match="unknown noise channel") as te:
        MPSTrajectoryProgram(_ast("qreg q[1];"), noise="nope:0.05")
    with pytest.raises(ValueError) as je:
        JProgram(jparse("<t>", "qreg q[1];"), noise="nope:0.05")
    assert str(te.value) == str(je.value)
    prog = MPSTrajectoryProgram(_ast("qreg q[1];"), noise="ad:0.05,pd:0.1")
    assert len(prog.kraus4s) == 2
    jprog = JProgram(jparse("<t>", "qreg q[1];"), noise="ad:0.05,pd:0.1")
    assert all(np.array_equal(a, b) for a, b in zip(prog.kraus4s, jprog.kraus4s))


DAMP_SRC = f"""
    qreg q[2]; creg c[2];
    {H} q[0];
    CX q[0], q[1];
    U(0, 0, 0.7853981633974483) q[1];
    U(1.2, 0.3, 0.5) q[0];
    measure q -> c;
"""


@pytest.mark.slow
def test_mps_trajectories_amplitude_damping_match_density():
    """Amplitude damping (state-DEPENDENT branching: the K1Q rows) on an
    entangled non-Clifford circuit against the exact density matrix."""
    g = 0.25
    bits = MPSTrajectoryProgram(_ast(DAMP_SRC), noise=f"ad:{g}", chi=4).run_vals(
        8192, seed=6)["c"]
    assert_law(bits, exact_probs(DAMP_SRC, f"ad:{g}"), 8192)


def test_mps_trajectories_mixed_pauli_and_damping():
    """dep + pd together: Pauli slots and K1Q rows in one tape."""
    spec = "dep:0.05,pd:0.2"
    bits = MPSTrajectoryProgram(_ast(GHZ2), noise=spec, chi=4).run_vals(8192, seed=8)["c"]
    assert_law(bits, exact_probs(GHZ2, spec), 8192)


@pytest.mark.slow
def test_mps_damping_estimator_large_n_sane():
    """ad at 24 qubits, chi=4: <Z...Z> on a GHZ line stays in [-1, 1]."""
    prog = MPSTrajectoryProgram(_ast("\n".join(ghz_lines(24))), noise="ad:0.02", chi=4)
    mean, err = prog.expectation("Z" * 24, 96, seed=1)
    assert -1.0 - 1e-6 <= mean <= 1.0 + 1e-6
    assert np.isfinite(err)


# -- tests/test_noisy.py's MPS cases ----------------------------------------------------


def test_entangled_reset_projects_partner():
    """Reset is a projection onto |0>: resetting half of a Bell pair
    leaves the partner at |0> in every run, in the trajectories and in
    MPSSim; a |1>-certain qubit falls back to the X flip."""
    src = f"qreg q[2]; creg c[2];\n{H} q[0];\nCX q[0], q[1];\nreset q[0];\nmeasure q -> c;"
    assert (MPSTrajectoryProgram(_ast(src), chi=4).run_vals(64, seed=5)["c"] == 0).all()
    h = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    cx = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
    for k in range(4):
        m = MPSSim(2, chi=4, seed=k).apply([TPrim(h, (0,)), TPrim(cx, (0, 1))])
        m.reset(0)
        assert m.prob_one(1) < 1e-6
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    m = MPSSim(1, chi=2, seed=0).apply([TPrim(x, (0,))])
    m.reset(0)
    assert m.prob_one(0) < 1e-6


def test_trajectory_expectation_matches_density():
    """<ZZ>/<XX> on noisy GHZ-2: the Monte-Carlo estimator agrees with the
    exact density matrix within 5 stderr + 1e-3."""
    p = 0.1
    src = f"qreg q[2];\n{H} q[0];\nCX q[0], q[1];\n"
    rho, _ = DensityProgram(jparse("<test>", src), noise=f"depolarizing:{p}").run(seed=0)
    prog = MPSTrajectoryProgram(_ast(src), noise=f"dep:{p}", chi=4)
    for pauli, ntraj in [("ZZ", 4096), ("XX", 2048)]:
        mean, stderr = prog.expectation(pauli, ntraj, seed=7)
        exact = rho.expectation(pauli)
        assert abs(mean - exact) < 5 * stderr + 1e-3, (pauli, mean, exact)
        assert stderr < 0.05
    mean, stderr = prog.expectation_sum([(1.0, "ZZ"), (0.5, "XX")], 2048, seed=9)
    want = rho.expectation("ZZ") + 0.5 * rho.expectation("XX")
    assert abs(mean - want) < 5 * stderr + 1e-3


def test_readout_error():
    """ro:p flips each REPORTED bit with probability p; the state stays."""
    p = 0.25
    bits = MPSTrajectoryProgram(_ast("qreg q[2]; creg c[2];\nmeasure q -> c;"),
                                noise=f"ro:{p}", chi=2).run_vals(4096, seed=1)["c"]
    sigma = np.sqrt(p * (1 - p) / 4096)
    assert np.all(np.abs(bits.mean(axis=0) - p) < 5 * sigma)


def test_seed_reproducible():
    make = lambda: MPSTrajectoryProgram(  # noqa: E731
        _ast(f"qreg q[3]; creg c[3];\n{H} q[0];\nCX q[0], q[1]; CX q[1], q[2];\n"
             "measure q -> c;"), noise="bf:0.05,ro:0.02", chi=4)
    assert (make().run_vals(256, seed=5)["c"] == make().run_vals(256, seed=5)["c"]).all()


def test_dep2_matches_density():
    """dep2 (one JOINT 16-outcome draw after every 2q gate)."""
    p = 0.3
    bits = MPSTrajectoryProgram(_ast(GHZ2), noise=f"dep2:{p}", chi=4).run_vals(
        8192, seed=2)["c"]
    assert_law(bits, exact_probs(GHZ2, f"dep2:{p}"), 8192)


def test_channel_order_matches_density():
    """dep and ad compose in SPEC ORDER: the two orders are different
    channels (> 4% apart here) and each is tracked."""
    e1, e2 = exact_probs(GHZ2, "dep:0.1,ad:0.3"), exact_probs(GHZ2, "ad:0.3,dep:0.1")
    assert np.abs(e1 - e2).max() > 0.04
    for spec, ex in (("dep:0.1,ad:0.3", e1), ("ad:0.3,dep:0.1", e2)):
        bits = MPSTrajectoryProgram(_ast(GHZ2), noise=spec, chi=4).run_vals(8192, seed=2)["c"]
        assert_law(bits, ex, 8192)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_noisy_engines_vs_density(seed):
    """A random non-Clifford circuit (u3 + CX, descending targets included)
    under a random ordered channel mix from {dep, bf, pf, ad, pd, dep2}:
    the MPS trajectories converge to the exact distribution (5 sigma +
    3e-3 per basis state, the reference's)."""
    rng = np.random.default_rng(seed + 77)
    n = 3
    lines = [f"qreg q[{n}]; creg c[{n}];"]
    for _ in range(8):
        if rng.random() < 0.45:
            a, b = rng.choice(n, size=2, replace=False)
            lines.append(f"CX q[{a}], q[{b}];")
        else:
            th, ph, la = (float(v) for v in rng.uniform(0, 2 * np.pi, 3))
            lines.append(f"U({th}, {ph}, {la}) q[{rng.integers(n)}];")
    body = "\n".join(lines)
    chans = list(rng.choice(["dep", "bf", "pf", "ad", "pd", "dep2"],
                            size=rng.integers(2, 4), replace=False))
    spec = ",".join(f"{c}:{rng.uniform(0.05, 0.2):.3f}" for c in chans)
    exact = exact_probs(body, spec)
    ntraj = 8192
    bits = MPSTrajectoryProgram(_ast(body + "\nmeasure q -> c;"), noise=spec,
                                chi=8).run_vals(ntraj, seed=seed)["c"]
    got = np.bincount((bits * (1 << (n - 1 - np.arange(n)))).sum(axis=1),
                      minlength=1 << n) / ntraj
    tol = 5 * np.sqrt(np.maximum(exact * (1 - exact), 1e-4) / ntraj) + 3e-3
    assert np.all(np.abs(got - exact) < tol), (spec, body, got, exact)


def test_mesh_split_is_bit_identical():
    """A batch split over 8 CPU shards gives the unsplit outcomes bit for
    bit (12 trajectories: a padded split), feed-forward included."""
    src = f"""qreg q[2]; creg c[1]; creg d[1];
        {H} q[0];
        measure q[0] -> c[0];
        if (c == 1) {X} q[1];
        measure q[1] -> d[0];"""
    a = MPSTrajectoryProgram(_ast(src), noise="dep:0.05", chi=4)
    b = MPSTrajectoryProgram(_ast(src), noise="dep:0.05", chi=4)
    va = a.run_vals(12, seed=7)
    vb = b.run_vals(12, seed=7, mesh=8)
    for c in va:
        assert (va[c] == vb[c]).all()
    ea = a.expectations(["ZZ", "XI"], 12, seed=4)
    assert ea == b.expectations(["ZZ", "XI"], 12, seed=4, mesh=8)


def test_fused_engine_refused_and_live_cost():
    prog = MPSTrajectoryProgram(_ast(GHZ2), chi=8)
    with pytest.raises(ValueError, match="not MPSTrajectoryProgram"):
        prog.run_vals(4, engine="fused")
    with pytest.raises(ValueError, match="not MPSTrajectoryProgram"):
        prog.counts(4, engine="fused")
    assert prog._traj_live_cost() == 4 * 2 * 8 * 8 + 2 * 2
    # the live-state cap splits the batch; the outcomes do not change
    a = prog.run_vals(10, seed=1)
    b = prog.run_vals(10, seed=1, max_live_words=3 * prog._traj_live_cost())
    assert (a["c"] == b["c"]).all()
    assert isinstance(prog, TrajectoryProgram)


# -- tests/test_noise_targeting.py's MPS cases ---------------------------------------


def test_mps_targeted_noise_follows_logical_qubit():
    """bf:1.0@q[2] with a ROUTED CX q[0],q[2]: the slot lands on logical
    qubit 2 (parked at site 1 when the slots are emitted)."""
    src = f"qreg q[3]; creg c[3];\nU({PI},0,{PI}) q[1];\nCX q[0], q[2];\nmeasure q -> c;"
    c = MPSTrajectoryProgram(_ast(src), noise="bf:1.0@q[2]", chi=4).run_vals(8, seed=0)["c"]
    assert (c[:, 0] == 0).all()
    assert (c[:, 1] == 1).all()
    assert (c[:, 2] == 1).all()


def test_mps_targeted_matches_density():
    x2 = f"qreg q[2]; creg c[2];\nU({PI},0,{PI}) q[0];\nU({PI},0,{PI}) q[1];\nmeasure q -> c;"
    noise = "dep:0.2@q[1]"
    rho, _ = DensityProgram(jparse(None, x2.split("measure")[0]), noise=noise).run(seed=0)
    p1 = float(rho.prob_one(1))
    c = MPSTrajectoryProgram(_ast(x2), noise=noise, chi=4).run_vals(1024, seed=5)["c"]
    assert (c[:, 0] == 1).all()   # q0 untargeted: stays |1> exactly
    assert abs(c[:, 1].mean() - p1) < 4 * np.sqrt(p1 * (1 - p1) / 1024)


@pytest.mark.parametrize("spec", [
    "dep:0.01", "bf:0.2,pf:0.1", "dep2:0.3", "ad:0.05,pd:0.1", "dep:0.1,ad:0.3@q[1]+2",
    "dep2:0.2@q,ad:0.15,bitflip:0.05"])
def test_split_mps_noise_matches_jax(spec):
    """Spec order, kinds, CDFs (equal as float32), Kraus blocks and the
    unresolved '@' targets are the JAX package's."""
    from qubism_torch.mps.noise import split_mps_noise
    from qubism_tpu.mps.noise import split_mps_noise as jsplit

    got, want = split_mps_noise(spec), jsplit(spec)
    assert [(k, t) for k, _, t in got] == [(k, t) for k, _, t in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))
