"""The port's fused trajectory engine (qubism_torch/run/traj_fused.py)
against the JAX package's: the same plan (step kinds, targets, deferred-Kraus
bookkeeping, ``total_sites``, every ``FusedUnsupported`` message), the same
realized operands for a seed, and each trajectory's final state equal to
the JAX steps run with their Pallas kernels in interpret mode (to 1e-5).
The Born draws differ (their streams are each engine's own), so counts are
held against the vmapped engine by ``chi2_test``. Also the device-operand
modes of the kernel wrappers (ops/kernels.py), which run their plain
versions on the CPU, and the per-trajectory sample of ops/sample.py."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.ops import kernels as K  # noqa: E402
from qubism_torch.ops import sample as TS  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm as tparse  # noqa: E402
from qubism_torch.run import traj_fused as TF  # noqa: E402
from qubism_torch.run.noisy import TrajectoryProgram as TP  # noqa: E402
from qubism_torch.utils.stats import chi2_test  # noqa: E402
from qubism_tpu.config import config as jconfig  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm as jparse  # noqa: E402
from qubism_tpu.run import traj_fused as JF  # noqa: E402
from qubism_tpu.run.noisy import TrajectoryProgram as JP  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
PI = 3.141592653589793
H_GATE = f"U(1.5707963267948966, 0, {PI})"
X_GATE = f"U({PI}, 0, {PI})"
# a non-monomial channel with diagonal K^dag K: the per-site MCWF step
HAD_BRANCH = [np.sqrt(0.7) * np.eye(2),
              np.sqrt(0.3) * np.array([[1, 1], [1, -1]]) / np.sqrt(2)]


def ghz_src(n):
    lines = [f"qreg q[{n}]; creg c[{n}];", f"{H_GATE} q[0];"]
    lines += [f"CX q[{q}], q[{q + 1}];" for q in range(n - 1)]
    return "\n".join(lines + ["measure q -> c;"])


WIDE_SRC = "\n".join(
    ["qreg q[10]; creg c[10];"]
    + [f"U(0.{q + 1}, 0.2, 0.3) q[{q}];" for q in range(10)]
    + ["CX q[8], q[2];", "CX q[9], q[7];", "CX q[4], q[5];"]
    + [f"{H_GATE} q[{q}];" for q in (0, 3, 8, 9)]
    + ["measure q -> c;"])
FF_SRC = f"""qreg q[4]; creg a[1]; creg b[2]; creg d[4];
{H_GATE} q[0];
CX q[0], q[1];
measure q[0] -> a[0];
if (a == 1) {X_GATE} q[2];
if (a == 1) CX q[2], q[3];
reset q[0];
{H_GATE} q[0];
measure q[0] -> b[0];
measure q[1] -> b[1];
if (b == 3) {X_GATE} q[0];
if (b == 2) U(0.3, 0.2, 0.1) q[1];
measure q -> d;
"""

CASES = {
    "teleportation dep ad": ("teleportation.qasm", "dep:0.05,ad:0.1"),
    "errorCorrection dep2 pd ro": ("errorCorrection.qasm", "dep2:0.05,pd:0.1,ro:0.1"),
    "ghz8 dep": (ghz_src(8), "depolarizing:0.2"),
    "ghz9 ad many": (ghz_src(9), "ad:0.2,pd:0.1,ad:0.05"),
    "wide dep2 ad dep": (WIDE_SRC, "dep2:0.1,ad:0.2,dep:0.05"),
    "wide targeted": (WIDE_SRC, "pd:0.1,ad:0.2@q[9]+q[3]"),
    "feed-forward": (FF_SRC, "dep:0.03,ad:0.05"),
    "non-monomial": (ghz_src(4), [("had", HAD_BRANCH), ("ad", None)]),
}


@pytest.fixture(autouse=True)
def modes(monkeypatch):
    JK.INTERPRET = True
    monkeypatch.setattr(config, "device", "cpu")
    yield
    JK.INTERPRET = False


def _noise(noise):
    if isinstance(noise, list):
        from qubism_torch.core.density import amplitude_damping

        return [(lbl, ks if ks is not None else amplitude_damping(0.3)) for lbl, ks in noise]
    return noise


def programs(case):
    src, noise = CASES[case]
    path = os.path.join(EXAMPLES, src) if src.endswith(".qasm") else "<test>.qasm"
    text = open(path).read() if src.endswith(".qasm") else src
    return (TP(tparse(path, text), noise=_noise(noise)),
            JP(jparse(path, text), noise=_noise(noise)))


def describe(step):
    """What the planner decided for a step, in terms both packages share."""
    d = {"kind": type(step).__name__, "sites": step.n_sites}
    for attr in ("absorb", "absorb_row", "absorb_lane", "tableqs", "pend_qs", "row_qs",
                 "lane_qs", "qubits", "q", "cid", "creg", "value", "path", "pure_lane"):
        if hasattr(step, attr):
            d[attr] = getattr(step, attr)
    if hasattr(step, "slot"):
        d["targets"] = step.slot.targets
        d["cond"] = step.slot.cond_path
    if hasattr(step, "row"):
        d["row"] = [s.targets for s in step.row]
        d["lane"] = [s.targets for s in step.lane]
    if hasattr(step, "sites") and not isinstance(step.sites, int):
        d["group"] = [(q, p) for q, _, p in step.sites]
    return d


def as_complex(b):
    """A JAX realized operand as the port holds it: (.., 2, d, d) re/im
    float32 stacks -> complex64."""
    b = np.asarray(b)
    if b.ndim == 4:
        return (b[:, 0] + 1j * b[:, 1]).astype(np.complex64)
    if b.ndim == 3:
        return (b[0] + 1j * b[1]).astype(np.complex64)
    return b


def jax_final_state(plan, ops):
    """The JAX engine's steps for one trajectory, eagerly (Pallas kernels in
    interpret mode): the final state, flat complex."""
    R, C = JK.canon_shape(plan.n)
    planes = (jnp.zeros((R, C), jnp.float32).at[0, 0].set(1.0), jnp.zeros((R, C), jnp.float32))
    it = iter([jnp.asarray(o) for o in ops])
    ctx = JF._TraceCtx({c: jnp.zeros(plan.tprog.creg_sizes[c], jnp.int32)
                        for c in plan.tprog.creg_names})
    pend = {}
    for st in plan.steps:
        planes = st.traced(planes, it, pend, ctx)
    return np.asarray(planes[0]).reshape(-1) + 1j * np.asarray(planes[1]).reshape(-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plan_matches_jax(case):
    tp, jp = programs(case)
    tf, jf = TF.FusedTrajectories(tp), JF.FusedTrajectories(jp)
    assert [describe(s) for s in tf.steps] == [describe(s) for s in jf.steps]
    assert tf.total_sites == jf.total_sites
    assert tf.has_mid == jf.has_mid
    assert [ev.qubits for ev in tf.measures] == [ev.qubits for ev in jf.measures]


@pytest.mark.parametrize("case", ["teleportation dep ad", "wide dep2 ad dep", "feed-forward",
                                  "non-monomial", "errorCorrection dep2 pd ro"])
def test_realized_operands_and_final_states_match_jax(case):
    tp, jp = programs(case)
    tf, jf = TF.FusedTrajectories(tp), JF.FusedTrajectories(jp)
    for seed in (1, 2):
        to = [o for ops in tf._realize_operands(np.random.default_rng(seed)) for o in ops]
        jo = [o for ops in jf._realize_operands(np.random.default_rng(seed)) for o in ops]
        assert len(to) == len(jo)
        for a, b in zip(to, jo):
            want = as_complex(b)
            assert np.asarray(a).dtype == want.dtype and np.array_equal(np.asarray(a), want)
        got = tf.final_state(to).numpy()
        assert np.abs(got - jax_final_state(jf, jo)).max() < 1e-5


UNSUPPORTED = [
    ("3-target primitive", "qreg q[3]; creg c[3]; CX q[0], q[1];", None),
    ("mid-circuit measurement of 13 qubits",
     "qreg q[14]; creg c[13]; measure q[0] -> c[0];" + "".join(
         f" measure q[{i}] -> c[{i}];" for i in range(1, 13)) + " U(0.1,0,0) q[13];", None),
    ("re-measurement", f"qreg q[2]; creg c[2]; {H_GATE} q[0]; measure q[0] -> c[0]; "
     "measure q[0] -> c[1]; U(0.1,0,0) q[1];", None),
    ("2q Kraus", "qreg q[2]; creg c[2]; CX q[0], q[1]; measure q -> c;", "dep2kraus"),
    ("non-diagonal", "qreg q[2]; creg c[2]; CX q[0], q[1]; measure q -> c;", "nondiag"),
    ("one qubit", "qreg q[1]; creg c[1]; measure q -> c;", None),
]


def _unsupported_noise(tag):
    if tag == "dep2kraus":  # a two-qubit decay |11> -> |00>
        k0 = np.diag([1, 1, 1, np.sqrt(0.8)]).astype(complex)
        k1 = np.zeros((4, 4), dtype=complex)
        k1[0, 3] = np.sqrt(0.2)
        return [("k2", [k0, k1])]
    if tag == "nondiag":
        a = np.array([[np.sqrt(0.5), 0], [0, 1]])
        b = np.array([[0.5, 0.5], [0, 0]])
        rest = np.eye(2) - a.T @ a - b.T @ b
        w, v = np.linalg.eigh(rest)
        return [("nd", [a, b, v @ np.diag(np.sqrt(np.clip(w, 0, None))) @ v.T])]
    return None


@pytest.mark.parametrize("label,src,tag", UNSUPPORTED, ids=[u[0] for u in UNSUPPORTED])
def test_unsupported_messages_match_jax(label, src, tag):
    if label == "3-target primitive":  # QASM has none: put one in front of the events
        from qubism_torch.core.gates import Prim as TPrim
        from qubism_tpu.core.gates import Prim as JPrim

        tp = TP(tparse("<t>.qasm", src))
        jp = JP(jparse("<t>.qasm", src))
        from qubism_torch.run.compiler import EvGates as TEv
        from qubism_tpu.run.compiler import EvGates as JEv

        tp.events = [TEv((TPrim(np.eye(8), (0, 1, 2)),))] + list(tp.events)
        jp.events = [JEv((JPrim(np.eye(8), (0, 1, 2)),))] + list(jp.events)
    else:
        tp = TP(tparse("<t>.qasm", src), noise=_unsupported_noise(tag))
        jp = JP(jparse("<t>.qasm", src), noise=_unsupported_noise(tag))
    with pytest.raises(TF.FusedUnsupported) as te:
        TF.FusedTrajectories(tp)
    with pytest.raises(JF.FusedUnsupported) as je:
        JF.FusedTrajectories(jp)
    assert str(te.value) == str(je.value)


def test_sqrt_born_is_refused_with_the_jax_message(monkeypatch):
    tp, jp = programs("ghz8 dep")
    monkeypatch.setattr(config, "reference_sqrt_born", True)
    monkeypatch.setattr(jconfig, "reference_sqrt_born", True)
    with pytest.raises(TF.FusedUnsupported) as te:
        tp.run_vals(8, engine="fused")
    with pytest.raises(JF.FusedUnsupported) as je:
        JF.FusedTrajectories(jp)
    assert str(te.value) == str(je.value)


def pooled_chi2(a_rows, b_rows, alpha=1e-3):
    """Counts of engine a against the pooled frequencies of both engines (a
    two-sample homogeneity check on ``chi2_test``)."""
    keys = sorted(set(a_rows) | set(b_rows))
    ca = np.array([a_rows.get(k, 0) for k in keys], dtype=np.float64)
    cb = np.array([b_rows.get(k, 0) for k in keys], dtype=np.float64)
    return chi2_test(ca, (ca + cb) / (ca.sum() + cb.sum()), alpha=alpha)


@pytest.mark.parametrize("case", ["ghz8 dep", "feed-forward", "teleportation dep ad"])
def test_counts_agree_with_the_vmapped_engine(case):
    tp, _ = programs(case)
    fused = tp.counts(600, seed=11, engine="fused")
    vmap = tp.counts(1200, seed=12)
    assert sum(fused.values()) == 600
    res = pooled_chi2(fused, vmap)
    assert res, res


def test_batches_do_not_change_results():
    tp, _ = programs("ghz9 ad many")
    plan = TF.FusedTrajectories(tp)
    a = plan.run_vals(40, seed=7)
    assert plan.dispatch_count == 1
    plan2 = TF.FusedTrajectories(tp)
    b = plan2.run_vals(40, seed=7, batch=16)
    assert plan2.dispatch_count == 3
    assert np.array_equal(a["c"], b["c"])
    with pytest.raises(ValueError, match="batch must be >= 1"):
        plan.run_vals(4, batch=0)
    # the plan is kept on the program
    tp.run_vals(4, seed=1, engine="fused")
    assert isinstance(tp._fused_plan, TF.FusedTrajectories)


def test_amplitude_damping_populations():
    n, gamma, T = 5, 0.3, 800
    src = "\n".join([f"qreg q[{n}]; creg c[{n}];"] + [f"{X_GATE} q[{q}];" for q in range(n)]
                    + ["measure q -> c;"])
    tp = TP(tparse("<t>.qasm", src), noise=f"ad:{gamma}")
    bits = tp.run_vals(T, seed=3, engine="fused")["c"]
    p1 = bits.mean(axis=0)
    assert np.all(np.abs(p1 - (1 - gamma)) < 4 * np.sqrt(gamma * (1 - gamma) / T) + 0.01)


def test_feed_forward_and_reset_semantics():
    src = (f"qreg q[2]; creg c[1]; creg d[1];\n{H_GATE} q[0];\nmeasure q[0] -> c[0];\n"
           f"if (c == 1) {X_GATE} q[1];\nmeasure q[1] -> d[0];")
    out = TP(tparse("<t>.qasm", src)).run_vals(64, seed=0, engine="fused")
    assert (out["c"] == out["d"]).all() and 5 < out["c"].sum() < 59
    # resetting a qubit certain to be |1> annihilates the state: all-zero
    # bits, on both engines
    src = f"qreg q[2]; creg c[2];\n{X_GATE} q[0];\nreset q[0];\nmeasure q -> c;"
    assert not TP(tparse("<t>.qasm", src)).run_vals(8, seed=0, engine="fused")["c"].any()
    assert not TP(tparse("<t>.qasm", src)).run_vals(8, seed=1)["c"].any()
    # an exact |1> (an always-X channel), so the projection leaves no mass
    src = "qreg q[2]; creg c[2];\nU(0, 0, 0) q[0];\nreset q[0];\nmeasure q -> c;"
    x_always = [("x!", [np.array([[0, 1], [1, 0]])])]
    for engine in ("fused", "vmap"):
        out = TP(tparse("<t>.qasm", src), noise=x_always).run_vals(8, seed=0, engine=engine)
        assert not out["c"].any(), engine
    # a program of mid-circuit measurements only
    src = f"qreg q[2]; creg c[1];\n{X_GATE} q[1];\nmeasure q[1] -> c[0];\n{H_GATE} q[0];"
    assert TP(tparse("<t>.qasm", src)).run_vals(8, seed=0, engine="fused")["c"].all()


def test_readout_flip_rate():
    src = f"qreg q[2]; creg c[2];\n{X_GATE} q[0];\nmeasure q -> c;"
    bits = TP(tparse("<t>.qasm", src), noise="readout:0.25").run_vals(
        2000, seed=5, engine="fused")["c"]
    assert abs((1 - bits[:, 0]).mean() - 0.25) < 0.05
    assert abs(bits[:, 1].mean() - 0.25) < 0.05


def test_seeded_runs_repeat():
    tp, _ = programs("ghz8 dep")
    a = tp.run_vals(32, seed=9, engine="fused")["c"]
    assert np.array_equal(a, tp.run_vals(32, seed=9, engine="fused")["c"])
    assert not np.array_equal(a, tp.run_vals(32, seed=10, engine="fused")["c"])


# -- the device-operand modes and the per-trajectory sample ---------------------------


def rand_state(n, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return torch.from_numpy((z / np.linalg.norm(z)).astype(np.complex64))


def rand_u(k, rng):
    q, _ = np.linalg.qr(rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k)))
    return q.astype(np.complex64)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_gate_dev_equals_the_parameter_mode(k):
    rng = np.random.default_rng(k)
    n = 9
    targets = tuple(sorted(rng.choice(n, k, replace=False).tolist()))
    u = rand_u(k, rng)
    s = rand_state(n, k)
    want = K.gate(s.clone(), u, targets, n)
    got = K.gate_dev(s.clone(), torch.from_numpy(u), targets, n)
    assert torch.allclose(got, want, atol=1e-6)
    with pytest.raises(ValueError, match="targets"):
        K.gate_dev(s, torch.from_numpy(u), tuple(reversed(targets)) if k > 1 else (0, 0), n)


@pytest.mark.parametrize("m", [1, 3, 6])
def test_layer1q_and_lane_dev_equal_the_parameter_modes(m):
    rng = np.random.default_rng(10 + m)
    n = 10
    qs = rng.choice(n, m, replace=False).tolist()
    us = np.stack([rand_u(1, rng) for _ in range(m)])
    s = rand_state(n, m)
    want = K.layer1q(s.clone(), tuple(zip(us, qs)), n)
    got = K.layer1q_dev(s.clone(), torch.from_numpy(us), qs, n)
    assert torch.allclose(got, want, atol=1e-6)
    big = rand_u(7, rng)
    assert torch.allclose(K.lane_dev(s.clone(), torch.from_numpy(big), n),
                          K.lane(s.clone(), big, n), atol=1e-6)
    with pytest.raises(ValueError, match="distinct"):
        K.layer1q_dev(s, torch.from_numpy(us[:1].repeat(2, 0)), [0, 0], n)


def test_device_operand_checks():
    s = rand_state(5, 0)
    good = torch.eye(4, dtype=torch.complex64)
    for bad in (good.to(torch.complex128), good.T, torch.eye(2, dtype=torch.complex64), "u"):
        with pytest.raises(ValueError, match="device operand"):
            K._check_operand("gate", bad, (4, 4), s)
    K._check_operand("gate", good, (4, 4), s)


def test_lane_parts_dev_is_bit_equal_to_the_host_parts():
    rng = np.random.default_rng(4)
    u = (rng.normal(size=(128, 128)) + 1j * rng.normal(size=(128, 128))).astype(np.complex64)
    u.real[0, :8] = [0.0, -0.0, 1e-40, -1e-40, 3.4e38, -3.4e38, 1.0 + 2 ** -12, -(1 + 2 ** -13)]
    host = K.lane_parts(u)
    dev = K.lane_parts_dev(torch.from_numpy(u)).numpy()
    assert dev.dtype == np.float32 and dev.shape == host.shape
    assert np.array_equal(dev.view(np.uint32), host.view(np.uint32))


def test_sample_into_matches_the_search():
    n = 13
    s = rand_state(n, 3)
    out = torch.full((4,), -1, dtype=torch.int64)
    for i, u in enumerate((0.0, 0.25, 0.5, 0.999)):
        TS.sample_into(s, n, torch.tensor([u], dtype=torch.float64), out[i:i + 1])
    want = TS.sample_indices(s, n, 4, uniforms=[0.0, 0.25, 0.5, 0.999])
    assert np.array_equal(out.numpy(), want)
    TS.sample_into(s, n, torch.tensor([0.7], dtype=torch.float64), out[:1],
                   alive=torch.tensor(False))
    assert int(out[0]) == 0
