"""The mesh-sharded density matrix of the port (parallel/density.py): the
cases of tests/test_density_mesh.py that need no ``models.dynamics``, on 2,
4 and 8 shards of the CPU device against the port's ``DensityMatrix`` (1e-6)
and the JAX package's ``ShardedDensityMatrix`` on its 8 virtual devices
(1e-5)."""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch import cli as tcli  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.density import (DensityMatrix, amplitude_damping, depolarizing,  # noqa: E402
                                       depolarizing2)
from qubism_torch.core.gates import Prim  # noqa: E402
from qubism_torch.parallel import make_mesh  # noqa: E402
from qubism_torch.parallel.density import ShardedDensityMatrix  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm  # noqa: E402
from qubism_torch.run.noisy import DensityProgram  # noqa: E402
from qubism_torch.utils.stats import chi2_test  # noqa: E402
from qubism_tpu import cli as jcli  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.parallel.density import ShardedDensityMatrix as JSharded  # noqa: E402
from qubism_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402

TOL = 1e-6
SHARDS = [2, 4, 8]


@pytest.fixture(autouse=True)
def modes(monkeypatch):
    JK.INTERPRET = True
    monkeypatch.setattr(config, "device", "cpu")
    yield
    JK.INTERPRET = False


def rand_u(k, rng):
    a = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(a)[0]


def pair(shards, n=4):
    return ShardedDensityMatrix(n, make_mesh(shards)), DensityMatrix(n)


def sharded_matrix(rs):
    d = 1 << rs.n
    return rs.sim.amplitudes().reshape(d, d)


def circuit(rng):
    return [(rand_u(1, rng), (0,), False), (rand_u(2, rng), (1, 3), False),
            (np.array([1, 1j, 1, -1]), (0, 2), True), (rand_u(1, rng), (2,), False)]


@pytest.mark.parametrize("shards", SHARDS)
def test_unitaries_and_channels_match_dense(shards):
    rs, rd = pair(shards)
    prims = [Prim(u, t, d) for u, t, d in circuit(np.random.default_rng(3))]
    rs.apply(prims)
    rd.apply(prims)
    for ch, tg in ((depolarizing(0.1), 1), (amplitude_damping(0.3), (3,)),
                   (depolarizing2(0.2), (0, 2))):
        rs.apply_channel(ch, tg)
        rd.apply_channel(ch, tg)
    assert np.abs(sharded_matrix(rs) - rd.matrix()).max() < TOL
    assert abs(rs.trace() - rd.trace()) < TOL and abs(rs.purity() - rd.purity()) < TOL
    assert np.abs(rs.probs() - rd.probs()).max() < TOL
    for p in ("ZIII", "XYIZ", "IXXI", "YZXZ", "IIII", "yyyy"):
        assert abs(rs.expectation(p) - rd.expectation(p)) < TOL, p
    assert abs(rs.prob_one(1) - rd.prob_one(1)) < TOL
    terms = [(0.5, "ZIII"), (-0.2, "IXXI")]
    assert abs(rs.expectation_sum(terms) - rd.expectation_sum(terms)) < TOL
    with pytest.raises(ValueError, match="4 chars of I/X/Y/Z"):
        rs.expectation("ZZ")


def test_equals_the_jax_sharded_density_matrix():
    rng = np.random.default_rng(3)
    gates = circuit(rng)
    rs = ShardedDensityMatrix(4, make_mesh(8)).apply([Prim(u, t, d) for u, t, d in gates])
    js = JSharded(4, jax_make_mesh(8)).apply([JPrim(u, t, d) for u, t, d in gates])
    for ch, tg in ((depolarizing(0.1), 1), (amplitude_damping(0.3), (3,)),
                   (depolarizing2(0.2), (0, 2))):
        rs.apply_channel(ch, tg)
        js.apply_channel(ch, tg)
    assert rs.sim.perm == js.sim.perm
    assert np.abs(rs.probs() - js.probs()).max() < 1e-5
    assert abs(rs.trace() - js.trace()) < 1e-5 and abs(rs.purity() - js.purity()) < 1e-5
    for p in ("ZIII", "XYIZ", "YZXZ"):
        assert abs(rs.expectation(p) - js.expectation(p)) < 1e-5, p
    assert np.abs(sharded_matrix(rs).reshape(-1) - js.sim.amplitudes()).max() < 1e-5


@pytest.mark.parametrize("shards", SHARDS)
def test_gathers_respect_relabeling(shards):
    """A channel on a device-bit qubit forces a relabelling swap; the
    gathers must translate through sim.perm."""
    rs, rd = pair(shards)
    rng = np.random.default_rng(9)
    prims = [Prim(rand_u(1, rng), (q,)) for q in range(4)]
    rs.apply(prims)
    rd.apply(prims)
    rs.apply_channel(amplitude_damping(0.4), 0)  # row q0 AND col q4
    rd.apply_channel(amplitude_damping(0.4), 0)
    assert rs.sim.perm != list(range(8))
    assert np.abs(rs.probs() - rd.probs()).max() < TOL
    for p in ("ZIII", "XIII", "YZIX"):
        assert abs(rs.expectation(p) - rd.expectation(p)) < TOL, p
    assert np.abs(sharded_matrix(rs) - rd.matrix()).max() < TOL


@pytest.mark.parametrize("shards", SHARDS)
def test_reset_projection_semantics(shards):
    rs, rd = pair(shards)
    h = (np.array([[1, 1], [1, -1]]) / np.sqrt(2)).astype(complex)
    prims = [Prim(h, (0,)), Prim(np.eye(4, dtype=complex)[[0, 1, 3, 2]], (0, 1))]
    rs.apply(prims).reset(0)
    rd.apply(prims).reset(0)
    assert np.abs(rs.probs() - rd.probs()).max() < TOL
    assert abs(rs.trace() - 1.0) < 1e-5
    # projecting onto an outcome of probability 0 leaves the zero matrix
    rs._project(0, 1)
    assert rs.trace() == 0.0 and rs.purity() == 0.0


@pytest.mark.parametrize("shards", SHARDS)
def test_measure_and_sample(shards):
    rs, rd = pair(shards)
    rng = np.random.default_rng(11)
    prims = [Prim(rand_u(1, rng), (q,)) for q in range(4)] + [Prim(rand_u(2, rng), (0, 3))]
    rs.apply(prims).apply_channel(depolarizing(0.2), 2)
    rd.apply(prims).apply_channel(depolarizing(0.2), 2)
    for q, u in ((0, 0.3), (3, 0.9), (1, 0.05)):  # a device-bit qubit first
        assert rs.measure_qubit(q, uniform=u) == rd.measure_qubit(q, uniform=u)
        assert abs(rs.prob_one(q) - rd.prob_one(q)) < TOL
    assert np.abs(sharded_matrix(rs) - rd.matrix()).max() < TOL
    gen = torch.Generator().manual_seed(5)
    assert rs.measure_qubit(2, gen) in (0, 1) and abs(rs.trace() - 1.0) < 1e-5
    rs2, rd2 = pair(shards)
    rs2.apply(prims)
    rd2.apply(prims)
    counts = rs2.sample(4096, torch.Generator().manual_seed(2))
    assert counts == rd2.sample(4096, torch.Generator().manual_seed(2))
    observed = np.array([counts.get(format(i, "04b"), 0) for i in range(16)], dtype=float)
    assert chi2_test(observed, rd2.probs() / rd2.probs().sum())


def test_rejects_oversized_local_block():
    # 1 shard, n = 16 -> 32 local qubits > LOCAL_MAX: refused before any allocation
    with pytest.raises(ValueError, match="single-buffer") as te:
        ShardedDensityMatrix(16, make_mesh(1), allocate=False)
    with pytest.raises(ValueError) as je:
        JSharded(16, jax_make_mesh(1), allocate=False)
    assert str(te.value) == str(je.value)


PROGRAM = ("qreg q[3]; creg c[1];\nU(1.5707963267948966, 0, 3.141592653589793) q[0];\n"
           "CX q[0], q[1];\nU(0.7, 0.2, 0.4) q[2];\nreset q[1];\nmeasure q[2] -> c[0];\n")


@pytest.mark.parametrize("shards", SHARDS)
def test_density_backend_mesh_cli_matches_dense(shards, tmp_path):
    """--backend density --mesh D runs the whole program (gates, targeted
    channels, reset, mid-circuit measurement) on the sharded rho and prints
    the dense backend's dump and observables at a seed."""
    f = tmp_path / "d.qasm"
    f.write_text(PROGRAM)
    outs = []
    for mesh in (None, shards):
        buf = io.StringIO()
        rc = tcli.eval_file(str(f), seed=4, backend="density", noise="dep:0.05,ad:0.1@q[2]",
                            dump_state=True, observables=("ZZI", "IXI"), shots=256, mesh=mesh,
                            out=buf)
        assert rc == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "<ZZI> = " in outs[0] and "p=" in outs[0]
    if shards == 8:  # and the JAX package's own --mesh 8 run prints the same values
        buf = io.StringIO()
        assert jcli.eval_file(str(f), seed=4, backend="density", noise="dep:0.05,ad:0.1@q[2]",
                              dump_state=True, observables=("ZZI", "IXI"), mesh=8, out=buf) == 0
        jax_lines = [x for x in buf.getvalue().splitlines() if x.startswith("<")]
        assert jax_lines and all(x.split(" = ")[0] in outs[1] for x in jax_lines)


def test_density_program_mesh_lifts_cap():
    ast = parse_openqasm("<t>", "qreg q[16];\n")
    with pytest.raises(ValueError, match="mesh"):
        DensityProgram(ast)
    DensityProgram(ast, mesh=8)  # constructs; run() would shard
    small = DensityProgram(parse_openqasm("<t>", "qreg q[1];"), mesh=2)
    with pytest.raises(ValueError, match="shards"):
        small.run()  # 2 qubits of rho over 2 shards leave 1 local qubit


# -- lindblad_evolve on the sharded rho (tests/test_density_mesh.py's two cases) ----

_X = np.array([[0, 1], [1, 0]], dtype=complex)
_SM = np.array([[0, 1], [0, 0]], dtype=complex)


def test_lindblad_evolve_on_mesh_matches_dense():
    """models.dynamics.lindblad_evolve on 8 shards: the observables of every
    step against the port's DensityMatrix (1e-6) and the JAX package's
    lindblad_evolve on its DensityMatrix (2e-5, the JAX file's tolerance);
    the trace stays 1 (exact CPTP factors)."""
    from qubism_torch.models.dynamics import lindblad_evolve
    from qubism_tpu.core.density import DensityMatrix as JDensity
    from qubism_tpu.models.dynamics import lindblad_evolve as jax_lindblad

    n = 3
    h = [(0.7, "XII"), (0.4, "ZZI"), (0.3, "IXZ")]
    collapse = [(0.5, _SM, 0), (0.3, _SM, 2)]
    obs = ["ZII", "IIZ", "XII"]
    prep = [Prim(_X, (q,)) for q in (0, 2)]
    _, vd = lindblad_evolve(DensityMatrix(n).apply(prep), h, collapse, t=0.8, steps=16,
                            observables=obs)
    rs, vs = lindblad_evolve(ShardedDensityMatrix(n, make_mesh(8)).apply(prep), h, collapse,
                             t=0.8, steps=16, observables=obs)
    _, vj = jax_lindblad(JDensity(n).apply([JPrim(_X, (q,)) for q in (0, 2)]), h, collapse,
                         t=0.8, steps=16, observables=obs)
    assert np.abs(np.asarray(vd) - np.asarray(vs)).max() < TOL
    assert np.abs(np.asarray(vj) - np.asarray(vs)).max() < 2e-5
    assert abs(rs.trace() - 1.0) < 1e-5


def test_lindblad_mesh_vs_mcwf():
    """The sharded exact integration (4 shards) against the port's MCWF
    unraveling, lindblad_mcwf with 600 trajectories: the final values
    within 5 standard errors + 0.02, the JAX file's bound."""
    from qubism_torch.models.dynamics import lindblad_evolve, lindblad_mcwf

    n = 2
    h = [(0.6, "XI"), (0.35, "ZZ")]
    collapse = [(0.4, _SM, 1)]
    obs = ["ZI", "IZ"]
    prep = [Prim(_X, (0,)), Prim(_X, (1,))]
    rs = ShardedDensityMatrix(n, make_mesh(4)).apply(prep)
    _, vs = lindblad_evolve(rs, h, collapse, t=1.0, steps=20, observables=obs)
    _, est = lindblad_mcwf(n, prep, h, collapse, t=1.0, steps=20, ntraj=600,
                           observables=obs, seed=1)
    for j, (m, se) in enumerate(est):
        assert abs(m - vs[-1][j]) < 5 * se + 0.02, (obs[j], m, vs[-1][j])
