"""The port's variational path on an amplitude mesh (models/adjoint_mesh.py
and ``mesh=`` of models/variational.py) on 1, 2, 4 and 8 shards of the
CPU device, where every kernel wrapper runs its plain version, against the
JAX package's single-device ``"xla"`` adjoint sweep, ``value_and_grad`` and
``vqe_minimize``: the cases of tests/test_adjoint_mesh.py and the mesh
cases of tests/test_variational.py. Energies to 1e-5, gradients to 5e-4
(1e-3 at n = 14, as the JAX file holds them there), VQE histories to 2e-4.
The JAX references are computed once per module. In place of the JAX
file's check of GSPMD's HLO (no all-gather), a test records which shards
each shard's update reads: a gate on a device bit reads its partner
only."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import qubism_torch.models.adjoint_engine as TE  # noqa: E402
import qubism_torch.models.variational as TV  # noqa: E402
import qubism_tpu.models.variational as JV  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.models.adjoint_mesh import (mesh_adjoint_value_and_grad_fn,  # noqa: E402
                                              supports_mesh)
from qubism_torch.ops import kernels  # noqa: E402
from qubism_torch.parallel import make_mesh  # noqa: E402

E_TOL, G_TOL = 1e-5, 5e-4


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def close(got, want, e_tol=E_TOL, g_tol=G_TOL):
    assert abs(float(got[0]) - float(want[0])) < e_tol, (float(got[0]), float(want[0]))
    assert np.abs(np.asarray(got[1]) - np.asarray(want[1])).max() < g_tol, (
        np.asarray(got[1]), np.asarray(want[1]))


def negated_maxcut(mod, n, edges):
    terms, const = mod.maxcut_terms(n, edges)
    return [(-c, s) for c, s in terms], -const


def ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


def jax_xla(jans, terms, const, theta):
    e, g = JV.adjoint_value_and_grad_fn(jans, terms, constant=const, engine="xla")(theta)
    return float(e), np.asarray(g)


# -- the JAX references, once per module ------------------------------------------


CHORDS8 = ring(8) + [(0, 4), (2, 6)]


@pytest.fixture(scope="module")
def qaoa8():
    """QAOA-8 p = 2 with chords: H prims and rx mixers on device bits, rzz
    factors on device bits only, across device and local bits, and local."""
    n = 8
    terms, const = negated_maxcut(TV, n, CHORDS8)
    theta = np.random.default_rng(7).uniform(-math.pi, math.pi, 4).astype(np.float32)
    want = jax_xla(JV.qaoa_maxcut_ansatz(n, CHORDS8, 2), terms, const, theta)
    return TV.qaoa_maxcut_ansatz(n, CHORDS8, 2), terms, const, theta, want


def rz_ladder(mod):
    n = 6
    ops = (tuple(mod.PGate("rz", (q,), (0,)) for q in range(n))
           + tuple(mod.PGate("rzz", (q, q + 1), (1,)) for q in range(n - 1))
           + tuple(mod.PGate("rx", (q,), (2,)) for q in range(n)))
    return mod.Ansatz(n, ops, 3)


RZ_TERMS = [(0.5 + 0.1 * i, "".join("Z" if q in (i, (i + 2) % 6) else "I" for q in range(6)))
            for i in range(6)]
RZ_THETA = np.asarray([0.37, -0.81, 1.13], np.float32)


@pytest.fixture(scope="module")
def rz_ref():
    return jax_xla(rz_ladder(JV), RZ_TERMS, 0.0, RZ_THETA)


@pytest.fixture(scope="module")
def qaoa6():
    n = 6
    terms, const = negated_maxcut(TV, n, ring(n))
    theta = np.asarray([0.3, -0.7], np.float32)
    return (TV.qaoa_maxcut_ansatz(n, ring(n), 1), terms, const, theta,
            jax_xla(JV.qaoa_maxcut_ansatz(n, ring(n), 1), terms, const, theta))


HEA_TERMS = [(0.7, "ZZIII"), (-0.4, "XIYII"), (0.3, "IIZXI"), (0.2, "IIIZZ")]


@pytest.fixture(scope="module")
def hea5():
    theta = np.random.default_rng(9).uniform(-math.pi, math.pi, 30).astype(np.float32)
    return theta, jax_xla(JV.hea_ansatz(5, 2), HEA_TERMS, 0.2, theta)


# -- the cases of tests/test_adjoint_mesh.py --------------------------------------


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_qaoa_matches_jax_every_mesh_size(qaoa8, D):
    ans, terms, const, theta, want = qaoa8
    vg = mesh_adjoint_value_and_grad_fn(ans, terms, make_mesh(D), constant=const)
    assert vg._engine == "kernels-mesh"
    got = vg(theta)
    assert got[0].dtype == torch.float32 and got[1].device.type == "cpu"
    close(got, want)


def test_device_bit_rz_and_shared_params(rz_ref):
    """rz on device bits (a scalar per shard), one parameter shared by many
    qubits, and an rzz ladder across the device and local bits."""
    got = mesh_adjoint_value_and_grad_fn(rz_ladder(TV), RZ_TERMS, make_mesh(8))(RZ_THETA)
    close(got, rz_ref)


def test_units_per_chunk_changes_nothing(qaoa6):
    ans, terms, const, theta, want = qaoa6
    for upc in (1, 2, 100):
        close(mesh_adjoint_value_and_grad_fn(ans, terms, make_mesh(4), constant=const,
                                             units_per_chunk=upc)(theta), want)


def test_auto_router_uses_mesh_engine_at_scale():
    """n >= 14 with a diagonal H and a mesh: "auto" returns the mesh kernel
    engine."""
    n = 14
    terms, const = negated_maxcut(TV, n, ring(n))
    ans = TV.qaoa_maxcut_ansatz(n, ring(n), 1)
    vg = TV.adjoint_value_and_grad_fn(ans, terms, constant=const, mesh=make_mesh(8))
    assert vg._engine == "kernels-mesh"
    theta = np.asarray([0.25, 0.4], np.float32)
    close(vg(theta), jax_xla(JV.qaoa_maxcut_ansatz(n, ring(n), 1), terms, const, theta),
          1e-3, 1e-3)


def test_auto_router_falls_back_below_threshold_and_on_plain_request(qaoa6):
    ans, terms, const, theta, want = qaoa6
    vg = TV.adjoint_value_and_grad_fn(ans, terms, constant=const, mesh=make_mesh(8))
    assert vg._engine == "plain-mesh"
    close(vg(theta), want)
    vg = TV.adjoint_value_and_grad_fn(ans, terms, constant=const, mesh=make_mesh(8),
                                      engine="plain")
    assert vg._engine == "plain-mesh"
    # at n = 14 "auto" falls back only where the mesh engine refuses
    n = 14
    hea = TV.hea_ansatz(n, 1)
    assert not supports_mesh(hea, make_mesh(8)) and supports_mesh(hea, make_mesh(1))
    assert TV.adjoint_value_and_grad_fn(hea, [(1.0, "Z" * n)],
                                        mesh=make_mesh(8))._engine == "plain-mesh"
    assert TV.adjoint_value_and_grad_fn(hea, [(1.0, "X" * n)],
                                        mesh=make_mesh(1))._engine == "plain-mesh"
    assert TV.adjoint_value_and_grad_fn(hea, [(1.0, "Z" * n)],
                                        mesh=make_mesh(1))._engine == "kernels-mesh"


# -- the mesh cases of tests/test_variational.py ----------------------------------


def test_mesh_energy_and_grad_match_single_device():
    """value_and_grad_fn(mesh=...) differentiates the sharded pipeline and
    gives the JAX package's value and gradient."""
    n, p = 8, 2
    terms, const = negated_maxcut(TV, n, ring(n))
    theta = np.random.default_rng(3).uniform(-1, 1, 2 * p).astype(np.float32)
    e0, g0 = jax.value_and_grad(JV.energy_fn(JV.qaoa_maxcut_ansatz(n, ring(n), p), terms,
                                             constant=const))(jax.numpy.asarray(theta))
    got = TV.value_and_grad_fn(TV.qaoa_maxcut_ansatz(n, ring(n), p), terms, constant=const,
                               mesh=make_mesh(8))(theta)
    close(got, (float(e0), np.asarray(g0)), E_TOL, 1e-5)


def test_mesh_shards_and_energy_match_jax():
    """state_fn(mesh=...) gives D shards whose concatenation is the JAX
    package's state, and energy_fn(mesh=...) its energy, at 2 and 8 shards
    (the device bits then fall in a CNOT of the ring)."""
    from qubism_tpu.ops.apply import complex_from_planes

    theta = np.random.default_rng(5).uniform(-math.pi, math.pi, 30).astype(np.float32)
    want = complex_from_planes(JV.state_fn(JV.hea_ansatz(5, 2))(jax.numpy.asarray(theta)))
    e0 = float(JV.energy_fn(JV.hea_ansatz(5, 2), HEA_TERMS, 0.2)(jax.numpy.asarray(theta)))
    for D in (2, 8):
        mesh = make_mesh(D)
        with torch.no_grad():
            shards = TV.state_fn(TV.hea_ansatz(5, 2), mesh=mesh)(theta)
            e1 = float(TV.energy_fn(TV.hea_ansatz(5, 2), HEA_TERMS, 0.2, mesh=mesh)(theta))
        assert len(shards) == D and all(s.numel() == 32 // D for s in shards)
        assert np.abs(torch.cat(shards).numpy() - want).max() < 1e-5
        assert abs(e1 - e0) < E_TOL


def test_mesh_adjoint_matches_single_device(hea5):
    """The plain adjoint sweep on the shards (phi and lam both sharded), a
    CNOT ring across the device bits and X/Y terms on them."""
    theta, want = hea5
    for seg in (None, 7):
        vg = TV.adjoint_value_and_grad_fn(TV.hea_ansatz(5, 2), HEA_TERMS, constant=0.2,
                                          segment_size=seg, mesh=make_mesh(8))
        assert vg._engine == "plain-mesh"
        close(vg(theta), want, E_TOL, 1e-4)


def test_mesh_vqe_minimize_matches_single_device():
    """A sharded VQE (8 shards of 2 amplitudes) tracks the JAX package's
    unsharded energy history, by autodiff and by the adjoint sweep."""
    ans = TV.hea_ansatz(4, 1)
    terms = [(0.6, "ZZII"), (0.4, "IZZI"), (-0.3, "XIIX")]
    theta0 = np.full(ans.num_params, 0.15, dtype=np.float32)
    _, h0 = JV.vqe_minimize(JV.hea_ansatz(4, 1), terms, theta0, steps=30)
    for grad in ("auto", "adjoint"):
        _, h1 = TV.vqe_minimize(ans, terms, theta0, steps=30, grad=grad, mesh=make_mesh(8))
        assert np.abs(np.asarray(h0) - h1.numpy()).max() < 2e-4, grad


def test_device_bit_gate_reads_its_partner_only(monkeypatch):
    """Every read of one shard by another's update goes through
    ``variational._peer``: an rx on device qubit 1 of 8 shards reads shard
    i ^ 2 (and i itself) in the plain sweep and the kernel engine; a
    diagonal on device bits and a gate on local bits read no other shard."""
    reads = []
    real = TV._peer

    def peer(shards, i, j):
        reads.append((i, j))
        return real(shards, i, j)

    monkeypatch.setattr(TV, "_peer", peer)
    import qubism_torch.models.adjoint_mesh as TM

    monkeypatch.setattr(TM, "_peer", peer)
    n, mesh = 6, make_mesh(8)
    theta = np.asarray([0.3, -0.4, 0.9], np.float32)
    ops = (TV.PGate("rzz", (0, 2), (0,)), TV.PGate("rz", (1,), (1,)),
           TV.PGate("rx", (4,), (2,)))
    with torch.no_grad():
        TV.state_fn(TV.Ansatz(n, ops, 3), mesh=mesh)(theta)
    assert all(i == j for i, j in reads), reads
    reads.clear()
    ans = TV.Ansatz(n, (TV.PGate("rx", (1,), (0,)),), 1)
    with torch.no_grad():
        TV.state_fn(ans, mesh=mesh)(theta[:1])
    assert {i ^ j for i, j in reads} == {0, 2} and len({i for i, _ in reads}) == 8
    reads.clear()
    mesh_adjoint_value_and_grad_fn(ans, [(1.0, "ZIIIII")], mesh)(theta[:1])
    assert reads and all(i ^ j == 2 for i, j in reads), reads


def test_mesh_engine_launches_match_plan_on_one_shard(monkeypatch):
    """On one shard the mesh engine makes the single-buffer engine's kernel
    calls (``adjoint_engine.predicted_launches``); on 4 shards the local
    units' calls repeat per shard."""
    n = 12
    ans = TV.qaoa_maxcut_ansatz(n, ring(n), 2)
    terms, _ = negated_maxcut(TV, n, ring(n))
    counts = {}
    for name in ("gate", "diag", "lane", "layer1q"):
        real = getattr(kernels, name)

        def wrapped(state, *args, _name=name, _real=real):
            m = state.numel().bit_length() - 1
            k = len(kernels._diag_passes(args[0].factors, m)) if _name == "diag" else 1
            counts[_name] = counts.get(_name, 0) + k
            return _real(state, *args)

        monkeypatch.setattr(kernels, name, wrapped)
    theta = np.asarray([0.2, -0.3, 0.5, 0.1], np.float32)
    mesh_adjoint_value_and_grad_fn(ans, terms, make_mesh(1))(theta)
    assert counts == TE.predicted_launches(ans)
    counts.clear()
    mesh_adjoint_value_and_grad_fn(ans, terms, make_mesh(4))(theta)
    assert counts["diag"] > 0 and counts["lane"] > 0 and counts["layer1q"] > 0


def test_kernels_with_mesh_unsupported_shapes_raise():
    """engine="kernels" with a mesh runs the mesh engine; what it cannot
    lower raises, and the plain sweep never runs in its place."""
    with pytest.raises(ValueError, match="shards need"):
        TV.adjoint_value_and_grad_fn(TV.hea_ansatz(3, 1), [(1.0, "ZZI")], mesh=make_mesh(8),
                                     engine="kernels")
    ans5 = TV.qaoa_maxcut_ansatz(5, ring(5), 1)
    with pytest.raises(ValueError, match="diagonal"):
        TV.adjoint_value_and_grad_fn(ans5, [(1.0, "XIIII")], mesh=make_mesh(8),
                                     engine="kernels")
    with pytest.raises(ValueError, match="device-bit"):
        TV.adjoint_value_and_grad_fn(TV.hea_ansatz(5, 1), [(1.0, "ZZIII")],
                                     mesh=make_mesh(8), engine="kernels")
    with pytest.raises(ValueError, match="not a power of two"):
        mesh_adjoint_value_and_grad_fn(ans5, [(1.0, "ZIIII")], make_mesh(1) * 3)
    with pytest.raises(ValueError, match="single-buffer"):
        mesh_adjoint_value_and_grad_fn(TV.qaoa_maxcut_ansatz(31, ring(31), 1),
                                       [(1.0, "Z" * 31)], make_mesh(1))
    u3 = TV.Ansatz(4, (TV.PGate("u3", (2,), (0, 1, 2)),), 3)
    with pytest.raises(ValueError, match="without a kernel lowering"):
        mesh_adjoint_value_and_grad_fn(u3, [(1.0, "ZIII")], make_mesh(2))
