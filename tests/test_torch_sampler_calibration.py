"""Sampler calibration of the port's engines, with the thresholds and the
mutation check of tests/test_sampler_calibration.py.

Each Born sampler of qubism_torch (dense, mesh-sharded, stabilizer, MPS,
vmapped and fused trajectories) passes a chi-square goodness-of-fit test
(``utils/stats.chi2_test``) at alpha = 1e-3 against the exact distribution
of the JAX package on the same circuit, and the SAME test at the same shot
count rejects a tilted sampler (``_mutant_counts``: p * (1 +- 0.15) on
alternating support bins, renormalised). The port's threshold functions
equal the JAX package's and scipy's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qubism_torch.config import config  # noqa: E402
from qubism_torch.utils.stats import chi2_quantile, chi2_test, normal_quantile  # noqa: E402
from qubism_tpu.utils import stats as jstats  # noqa: E402

ALPHA = 1e-3          # acceptance significance for every engine check
DELTA = 0.15          # mutation tilt: q ~ p * (1 +- DELTA) (normalized)


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _mutant_counts(probs, shots, seed=123, delta=DELTA):
    """A wrong-but-normalized sampler: tilt the distribution by +-delta on
    alternating support bins (a power bias would be a no-op on the
    uniform-support distributions of the stabilizer case)."""
    p = np.asarray(probs, np.float64)
    sup = np.flatnonzero(p > 0)
    tilt = np.ones_like(p)
    tilt[sup[::2]] += delta
    tilt[sup[1::2]] -= delta
    q = p * tilt
    q /= q.sum()
    idx = np.random.default_rng(seed).choice(q.size, size=shots, p=q)
    return np.bincount(idx, minlength=q.size)


def _assert_pass_and_mutant_fails(counts, probs, label):
    res = chi2_test(counts, probs, alpha=ALPHA)
    assert res.ok, (label, res)
    shots = int(np.asarray(counts).sum())
    mut = chi2_test(_mutant_counts(probs, shots), probs, alpha=ALPHA)
    assert not mut.ok, (label, "mutation NOT rejected", mut)


def _index(bits, n):
    """(shots, n) bit rows, column q = qubit q (qubit 0 the MSB) -> indices."""
    return (np.asarray(bits).astype(np.int64) << (n - 1 - np.arange(n))[None, :]).sum(axis=1)


# -- threshold machinery --------------------------------------------------------


def test_quantiles_match_scipy():
    pytest.importorskip("scipy")
    from scipy import stats as ss

    for p in (1e-6, 0.025, 0.5, 0.975, 1 - 1e-6):
        assert abs(normal_quantile(p) - ss.norm.ppf(p)) < 1e-7
        assert normal_quantile(p) == jstats.normal_quantile(p)
    for dof in (1, 2, 3, 7, 15, 63, 255):
        for alpha in (1e-2, 1e-3, 1e-6):
            want = ss.chi2.ppf(1 - alpha, dof)
            got = chi2_quantile(dof, alpha)
            assert abs(got - want) / want < 1e-6, (dof, alpha, got, want)
            assert got == jstats.chi2_quantile(dof, alpha)


def test_chi2_test_pools_small_bins():
    probs = np.asarray([0.5, 0.5 - 1e-6] + [2.5e-7] * 4)
    counts = np.asarray([2050, 2046, 0, 0, 0, 0])
    res = chi2_test(counts, probs)
    assert res.pooled_bins == 4 and res.ok
    jres = jstats.chi2_test(counts, probs)
    for field in ("stat", "dof", "threshold", "ok", "pooled_bins"):
        assert getattr(res, field) == getattr(jres, field), field


def test_chi2_test_rejects_impossible_outcomes():
    probs = np.asarray([1.0, 0.0])
    assert not chi2_test(np.asarray([4095, 1]), probs).ok


# -- per-engine calibration -----------------------------------------------------


def _dense_state(n, depth=4, seed=7):
    """The port's brickwork prims, its CompiledCircuit state, and the exact
    probabilities from the JAX package's CompiledCircuit (to 1e-5 of the
    port's)."""
    from qubism_torch.models.circuits import brickwork_prims
    from qubism_torch.ops.fusion import CompiledCircuit
    from qubism_tpu.models.circuits import brickwork_prims as jbrickwork
    from qubism_tpu.ops.apply import complex_from_planes, zero_state
    from qubism_tpu.ops.fusion import CompiledCircuit as JCircuit

    prims = brickwork_prims(n, depth=depth, seed=seed)
    circ = CompiledCircuit(n, prims)
    st = circ(circ.init_state())
    jprobs = np.abs(complex_from_planes(
        JCircuit(n, jbrickwork(n, depth=depth, seed=seed))(zero_state(n))).reshape(-1)) ** 2
    assert np.abs(np.abs(circ.state_to_complex(st)) ** 2 - jprobs).max() < 1e-5
    return prims, st, jprobs


def test_dense_sampler_calibrated():
    from qubism_torch.ops.sample import sample_indices

    n, shots = 8, 8192
    _, st, probs = _dense_state(n)
    idx = sample_indices(st, n, shots, torch.Generator().manual_seed(3))
    _assert_pass_and_mutant_fails(np.bincount(idx, minlength=1 << n), probs, "dense")


def test_mesh_sharded_sampler_calibrated():
    from qubism_torch.parallel.mesh import make_mesh
    from qubism_torch.parallel.sharded import ShardedSim

    n, shots = 8, 8192
    prims, _, probs = _dense_state(n)
    sim = ShardedSim(n, make_mesh(8)).apply(prims)
    idx = sim.sample(shots, torch.Generator().manual_seed(5))
    _assert_pass_and_mutant_fails(np.bincount(idx, minlength=1 << n), probs, "mesh")


def test_stabilizer_sampler_calibrated():
    from qubism_torch.core.gates import Prim
    from qubism_torch.stabilizer import StabilizerSim
    from qubism_tpu.core.gates import Prim as JPrim
    from qubism_tpu.ops.apply import complex_from_planes, zero_state
    from qubism_tpu.ops.fusion import CompiledCircuit as JCircuit

    n, shots = 6, 8192
    h = (np.array([[1, 1], [1, -1]]) / np.sqrt(2)).astype(complex)
    s_gate = np.diag([1.0, 1j])
    cx = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
    gates = ([(h, (q,)) for q in (0, 2, 4)] + [(cx, (q, q + 1)) for q in range(n - 1)]
             + [(s_gate, (1,)), (h, (1,))])
    probs = np.abs(complex_from_planes(JCircuit(n, [JPrim(u, t) for u, t in gates],
                                                optimize=False)(zero_state(n))).reshape(-1)) ** 2
    bits = StabilizerSim(n, seed=0).apply([Prim(u, t) for u, t in gates]).sample(shots)
    _assert_pass_and_mutant_fails(np.bincount(_index(bits, n), minlength=1 << n), probs,
                                  "stabilizer")


def test_mps_sampler_calibrated():
    from qubism_torch.mps import MPSSim

    n, shots = 8, 8192
    prims, _, probs = _dense_state(n)
    m = MPSSim(n, chi=16, seed=0).apply(prims)
    assert m.trunc_error == 0.0
    bits = m.sample(shots)
    _assert_pass_and_mutant_fails(np.bincount(_index(bits, n), minlength=1 << n), probs, "mps")


def _traj_setup(n):
    """A noisy GHZ-like program for both packages and the JAX package's
    exact DensityProgram distribution of it."""
    from qubism_torch.qasm.parser import parse_openqasm
    from qubism_tpu.qasm.parser import parse_openqasm as jparse
    from qubism_tpu.run.noisy import DensityProgram

    lines = [f"qreg q[{n}]; creg c[{n}];",
             "U(1.5707963267948966, 0, 3.141592653589793) q[0];",
             "U(0.7, 0.2, 0.4) q[2];"]
    lines += [f"CX q[{q}], q[{q + 1}];" for q in range(n - 1)]
    src_nomeas = "\n".join(lines)
    ast = parse_openqasm("<cal>", src_nomeas + "\nmeasure q -> c;")
    rho, _ = DensityProgram(jparse("<cal>", src_nomeas), noise="dep:0.03").run(seed=0)
    probs = np.clip(np.asarray(rho.probs(), np.float64), 0, None)
    return ast, probs / probs.sum()


@pytest.mark.parametrize("engine,seed", [("vmap", 1), ("fused", 2)])
def test_trajectory_sampler_calibrated(engine, seed):
    """The vmapped and the fused trajectory engines (the fused one through
    its kernels' plain versions here)."""
    from qubism_torch.run.noisy import TrajectoryProgram

    n, shots = 5, 8192
    ast, probs = _traj_setup(n)
    bits = TrajectoryProgram(ast, noise="dep:0.03").run_vals(shots, seed=seed, engine=engine)["c"]
    # creg bits are LSB-first columns: column k = qubit k outcome
    _assert_pass_and_mutant_fails(np.bincount(_index(bits, n), minlength=1 << n), probs,
                                  f"traj-{engine}")


def test_mps_trajectory_sampler_calibrated():
    """The MPS trajectories on the same noisy program."""
    from qubism_torch.mps import MPSTrajectoryProgram

    n, shots = 5, 8192
    ast, probs = _traj_setup(n)
    bits = MPSTrajectoryProgram(ast, noise="dep:0.03", chi=8).run_vals(shots, seed=3)["c"]
    _assert_pass_and_mutant_fails(np.bincount(_index(bits, n), minlength=1 << n), probs,
                                  "traj-mps")
