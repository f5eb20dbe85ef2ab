"""The port's noisy Clifford trajectories and Pauli-frame executors against
the JAX package's: the engine each program takes (``used_frames``) is the
JAX package's on every program here; the noise-spec CDFs, the layering of a
QEC round, ``_gf2_mbits`` and the clean record of a deterministic program
are equal; outcomes, drawn from each package's own generator, are held by
the program's closed-form law, by the exact density matrix, or against the
JAX package's histogram within 5 sigma. The tableau batch's counts are
the same with its batch split over a mesh of CPU shards."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm as tparse  # noqa: E402
from qubism_torch.run.compiler import EvGates, EvMeasure, EvReset  # noqa: E402
from qubism_torch.run.noisy import DensityProgram  # noqa: E402
from qubism_torch.stabilizer import frames as F  # noqa: E402
from qubism_torch.stabilizer.noise import (NotPauliChannelError,  # noqa: E402
                                           StabilizerTrajectoryProgram, pauli_channel_cdfs)
from qubism_torch.utils.stats import chi2_test  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm as jparse  # noqa: E402
from qubism_tpu.stabilizer import frames as JF  # noqa: E402
from qubism_tpu.stabilizer import noise as JN  # noqa: E402

H = "U(1.5707963267948966, 0, 3.141592653589793)"
X = "U(3.141592653589793, 0, 3.141592653589793)"
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
_CX = np.eye(4, dtype=np.complex128)[[0, 1, 3, 2]]
_I2 = np.eye(2, dtype=np.complex128)


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def progs(src, noise=None):
    """The same program in both packages: (port, JAX)."""
    return (StabilizerTrajectoryProgram(tparse("<t>", src), noise=noise),
            JN.StabilizerTrajectoryProgram(jparse("<t>", src), noise=noise))


def same_engine(src, noise, ntraj=32):
    """Run both; the engine each took must be the same. Returns the port's
    program and values."""
    tp, jp = progs(src, noise)
    vals = tp.run_vals(ntraj, seed=0)
    jp.run_vals(ntraj, seed=0)
    assert tp.used_frames == jp.used_frames, src
    return tp, vals


def hist(bits):
    n = bits.shape[1]
    return np.bincount((bits * (1 << np.arange(n))).sum(axis=1), minlength=1 << n) / len(bits)


def close_hist(a, b, ntraj):
    return np.all(np.abs(a - b) < 5 * np.sqrt(np.maximum(b * (1 - b), 1e-4) / ntraj) + 2e-2)


def force_tableaux(prog):
    prog._frame_plan = lambda: None
    prog._frame_plan_midcircuit = lambda: None
    return prog


def ghz_src(n):
    return "\n".join([f"qreg q[{n}]; creg c[{n}];", f"{H} q[0];"]
                     + [f"CX q[{q}], q[{q + 1}];" for q in range(n - 1)] + ["measure q -> c;"])


# -- noise specs and the engine choice ----------------------------------------------


def test_pauli_cdfs_equal_and_non_pauli_refused():
    spec = "depolarizing:0.3,bitflip:0.1,dep2:0.2,pf:0.05"
    for a, b in zip(pauli_channel_cdfs(spec), JN.pauli_channel_cdfs(spec)):
        np.testing.assert_array_equal(a, b)
    c1, c2 = pauli_channel_cdfs("depolarizing:0.3,bitflip:0.1,dep2:0.2")
    assert c1.shape == (2, 4) and c2.shape == (1, 16)
    for bad, msg in (("ad:0.1", "not a Pauli channel"), ("pd:0.1", "not a Pauli channel"),
                     ("dep", "needs a parameter")):
        with pytest.raises(NotPauliChannelError, match=msg):
            pauli_channel_cdfs(bad)
        with pytest.raises(JN.NotPauliChannelError, match=msg):
            JN.pauli_channel_cdfs(bad)


def test_targeted_noise_refused_as_jax():
    for mod in (pauli_channel_cdfs, JN.pauli_channel_cdfs):
        with pytest.raises(ValueError, match="per-qubit noise targeting"):
            mod("dep:0.1@q[0]")


@pytest.mark.parametrize("src", [
    ghz_src(3),
    f"qreg q[3]; creg c[1]; creg m[3];\n{H} q[0];\nCX q[0], q[1];\nmeasure q[1] -> c[0];\n"
    "reset q[1];\nCX q[0], q[2];\nmeasure q -> m;",
    f"qreg q[2]; creg c[1]; creg d[1];\n{H} q[0];\nmeasure q[0] -> c[0];\n"
    f"if (c == 0) {X} q[1];\nmeasure q[1] -> d[0];",
    f"qreg q[1]; creg c[1];\n{H} q[0];\nreset q[0];\nmeasure q[0] -> c[0];",
    f"qreg q[2]; creg c[2];\nreset q[1];\n{H} q[0];\nmeasure q -> c;\nreset q;\nmeasure q -> c;",
    f"qreg q[2]; creg c[2];\n{H} q[0];\nmeasure q -> c;\n{X} q[1];",
])
def test_engine_choice_is_jax(src):
    same_engine(src, "bf:0.05")


# -- the cases of tests/test_stabilizer.py (trajectories and frames) ----------------


def test_stab_trajectories_deterministic():
    src = f"qreg q[2]; creg c[2];\n{X} q[0];\nmeasure q -> c;"
    tp, tb = progs(src)[0], force_tableaux(progs(src)[0])
    for p in (tb, tp):
        b = p.run_vals(16, seed=0)["c"]
        assert (b[:, 0] == 1).all() and (b[:, 1] == 0).all()
    assert tp.used_frames and not tb.used_frames


@pytest.mark.parametrize("frames", [False, True])
def test_bitflip_rate(frames):
    p, ntraj = 0.25, 4096
    tp, _ = progs(f"qreg q[1]; creg c[1];\n{X} q[0];\nmeasure q -> c;", f"bitflip:{p}")
    if not frames:
        force_tableaux(tp)
    b = tp.run_vals(ntraj, seed=1)["c"][:, 0]
    assert tp.used_frames == frames
    assert abs(float((b == 0).mean()) - p) < 5 * np.sqrt(p * (1 - p) / ntraj)


def test_stab_trajectories_match_exact_density():
    p, ntraj = 0.15, 4096
    src = f"qreg q[2]; creg c[2];\n{H} q[0];\nCX q[0], q[1];\nmeasure q -> c;"
    rho, _ = DensityProgram(tparse("<t>", src.replace("measure q -> c;", "")),
                            noise=f"depolarizing:{p}").run(seed=0)
    exact = np.asarray(rho.probs())
    tp, _ = progs(src, f"depolarizing:{p}")
    b = force_tableaux(tp).run_vals(ntraj, seed=2)["c"]
    got = np.bincount(2 * b[:, 0] + b[:, 1], minlength=4)
    assert chi2_test(got, exact)


def test_stab_trajectories_feed_forward_and_reset():
    tp, jp = progs(f"qreg q[2]; creg c[1]; creg d[1];\n{H} q[0];\nmeasure q[0] -> c[0];\n"
                   f"if (c == 0) {X} q[1];\nmeasure q[1] -> d[0];")
    vals = tp.run_vals(128, seed=3)
    assert not tp.used_frames
    c, d = vals["c"][:, 0], vals["d"][:, 0]
    assert (d == 1 - c).all() and chi2_test(np.bincount(c, minlength=2), [0.5, 0.5])
    jvals = jp.run_vals(128, seed=3)
    assert (jvals["d"][:, 0] == 1 - jvals["c"][:, 0]).all()
    tp2, _ = progs(f"qreg q[1]; creg c[1];\n{H} q[0];\nreset q[0];\nmeasure q -> c;")
    assert (tp2.run_vals(64, seed=4)["c"] == 0).all() and not tp2.used_frames


def test_stab_trajectories_wide_creg_ghz():
    n = 60
    tp, _ = progs(ghz_src(n))
    for p in (tp, force_tableaux(progs(ghz_src(n))[0])):
        b = p.run_vals(32, seed=5)["c"]
        assert b.shape == (32, n) and (b == b[:, :1]).all() and 0 < b[:, 0].mean() < 1


def test_frames_match_tableau_distribution():
    src = f"qreg q[3]; creg c[3];\n{H} q[0];\nCX q[0], q[1]; CX q[1], q[2];\nmeasure q -> c;"
    p, ntraj = 0.1, 4096
    fr, jfr = progs(src, f"dep:{p}")
    fb = fr.run_vals(ntraj, seed=2)["c"]
    assert fr.used_frames
    tb = force_tableaux(progs(src, f"dep:{p}")[0])
    tbits = tb.run_vals(ntraj, seed=3)["c"]
    assert not tb.used_frames
    jb = jfr.run_vals(ntraj, seed=4)["c"]
    assert close_hist(hist(fb), hist(tbits), ntraj)
    assert close_hist(hist(fb), hist(jb), ntraj)


def test_frames_scale_smoke():
    """300-qubit noisy GHZ on frames: the clean fraction against
    (1 - 2p/3)^599 (Z errors are invisible in the Z basis)."""
    n, ntraj, p = 300, 2048, 0.001
    tp, _ = progs(ghz_src(n), f"depolarizing:{p}")
    b = tp.run_vals(ntraj, seed=5)["c"]
    assert tp.used_frames
    clean = float((b == b[:, :1]).all(axis=1).mean())
    want = (1 - 2 * p / 3) ** (2 * n - 1)
    assert abs(clean - want) < 4 * np.sqrt(want * (1 - want) / ntraj) + 0.005
    assert 0 < b[:, 0].mean() < 1


def test_frames_expectation_matches_density():
    p = 0.1
    src = f"qreg q[2];\n{H} q[0];\nCX q[0], q[1];"
    rho, _ = DensityProgram(tparse("<t>", src), noise=f"depolarizing:{p}").run(seed=0)
    tp, jp = progs(src, f"dep:{p}")
    for pauli in ("ZZ", "XX", "ZI"):
        mean, se = tp.expectation(pauli, 8192, seed=7)
        assert tp.used_frames
        jp.expectation(pauli, 64, seed=7)
        assert jp.used_frames
        assert abs(mean - rho.expectation(pauli)) < 5 * se + 1e-3, pauli
    tp2, _ = progs(src + "creg c[2]; measure q -> c;", f"dep:{p}")
    mean, se = tp2.expectation("ZZ", 256, seed=8)
    assert not tp2.used_frames
    assert abs(mean - rho.expectation("ZZ")) < 5 * se + 1e-3


def test_frames_expectation_sum_matches_density():
    p = 0.1
    src = f"qreg q[2];\n{H} q[0];\nCX q[0], q[1];"
    terms = [(1.0, "ZZ"), (0.5, "XX"), (-0.25, "II")]
    rho, _ = DensityProgram(tparse("<t>", src), noise=f"depolarizing:{p}").run(seed=0)
    tp, _ = progs(src, f"dep:{p}")
    mean, se = tp.expectation_sum(terms, 8192, seed=9)
    assert tp.used_frames
    assert abs(mean - rho.expectation_sum(terms)) < 5 * se + 1e-3


def test_frames_expectations_batch_matches_singles():
    src = f"qreg q[2];\n{H} q[0];\nCX q[0], q[1];"
    tp, _ = progs(src, "dep:0.1")
    batch = tp.expectations(["ZZ", "XX", "ZI"], 4096, seed=7)
    assert tp.used_frames
    for pauli, (bm, bs) in zip(("ZZ", "XX", "ZI"), batch):
        sm, ss = tp.expectation(pauli, 4096, seed=7)
        assert abs(bm - sm) < 5 * (bs + ss) + 1e-3


@pytest.mark.parametrize("seed", [21, 22])
def test_frames_fuzz_random_clifford_vs_tableau(seed):
    from qubism_torch.models.circuits import prims_qasm

    rng = np.random.default_rng(seed)
    n, ntraj = 4, 4096
    ones = [np.array([[1, 1], [1, -1]]) / np.sqrt(2), np.diag([1, 1j]),
            np.array([[0, 1], [1, 0]])]
    prims = []
    for _ in range(30):
        if rng.random() < 0.4:
            a, b = rng.choice(n, 2, replace=False)
            prims.append(TPrim(_CX, (int(a), int(b))))
        else:
            prims.append(TPrim(np.asarray(ones[rng.integers(3)], complex), (int(rng.integers(n)),)))
    src = prims_qasm(n, prims) + "creg c[4];\nmeasure q -> c;\n"
    ast = tparse(os.path.join(EXAMPLES, "<fuzz>"), src)
    fr = StabilizerTrajectoryProgram(ast, noise="dep:0.08")
    fbits = fr.run_vals(ntraj, seed=seed)["c"]
    assert fr.used_frames
    tb = force_tableaux(StabilizerTrajectoryProgram(ast, noise="dep:0.08"))
    tbits = tb.run_vals(ntraj, seed=seed + 100)["c"]
    assert close_hist(hist(fbits), hist(tbits), ntraj)


def test_repetition_code_example_scaling():
    """The code-capacity memory of examples/repetition_code_frames.py (one
    idle round under bit flips, majority vote): d=3 at p=0.05 matches
    3p^2 - 2p^3 and beats d=5's rate."""
    def rate(d, p, shots=40000):
        lines = [f"qreg q[{d}]; creg c[{d}];"] + [f"U(0, 0, 0) q[{k}];" for k in range(d)]
        prog = StabilizerTrajectoryProgram(tparse("<rep>", "\n".join(lines + ["measure q -> c;"])),
                                           noise=f"bitflip:{p}")
        b = prog.run_vals(shots, seed=0)["c"]
        assert prog.used_frames
        return float((b.sum(axis=1) > d // 2).mean())

    r3, r5 = rate(3, 0.05), rate(5, 0.05)
    assert abs(r3 - (3 * 0.05 ** 2 - 2 * 0.05 ** 3)) < 0.003
    assert r5 < r3


def test_trajectory_mesh_split_gives_the_same_counts():
    """The tableau batch takes row t of the uniform table for trajectory t,
    so splitting it over 2 or 4 shards (or batching it) changes nothing."""
    src = (f"qreg q[3]; creg c[1]; creg d[2];\n{H} q[0];\nCX q[0], q[1];\n"
           f"measure q[0] -> c[0];\nif (c == 1) {X} q[1];\nmeasure q[1] -> d[0];\n"
           "measure q[2] -> d[1];")
    tp, _ = progs(src, "dep:0.05,ro:0.02")
    base = tp.run_vals(24, seed=6)
    assert not tp.used_frames
    for mesh in (2, 4):
        got = tp.run_vals(24, seed=6, mesh=mesh)
        assert all((got[k] == base[k]).all() for k in base)
    small = tp.run_vals(24, seed=6, max_live_words=tp._traj_live_cost() * 5)
    assert all((small[k] == base[k]).all() for k in base)
    vals, tabs = tp.run_vals(24, seed=6, return_states=True)
    assert tabs.x.shape == (24, 6, 1) and (vals["d"] == base["d"]).all()


def test_fused_engine_refused():
    tp, _ = progs(ghz_src(2))
    with pytest.raises(ValueError, match="not StabilizerTrajectoryProgram"):
        tp.run_vals(4, engine="fused")


# -- the layered executor's host side -----------------------------------------------


def qec_events(d, rounds):
    n = 2 * d - 1
    events = []
    for _ in range(rounds):
        events.append(EvGates(tuple(TPrim(_I2, (q,)) for q in range(d))))
        events.append(EvGates(tuple(TPrim(_CX, (i, d + i)) for i in range(d - 1))))
        events.append(EvGates(tuple(TPrim(_CX, (i + 1, d + i)) for i in range(d - 1))))
        events.append(EvMeasure(tuple(range(d, n)), (("s", None, d - 1),)))
        events.append(EvReset(tuple(range(d, n))))
    events.append(EvMeasure(tuple(range(d)), (("m", None, d),)))
    return n, events


def test_frame_layering_packs_qec_round_into_few_layers():
    d = 11
    n, events = qec_events(d, 2)
    layers, meas_slots, rows = F._build_layers(events, n, identity_noise_only=True)
    assert len(layers) == 2 * 5 + 1
    assert len(meas_slots) == 2 * (d - 1) + d
    assert rows == 2 * (d + 2 * (d - 1) + 2 * (d - 1)) + d
    from qubism_tpu.core.gates import Prim as JPrim
    from qubism_tpu.run.compiler import EvGates as JG, EvMeasure as JM, EvReset as JR

    jevents = []
    for ev in events:
        if isinstance(ev, EvGates):
            jevents.append(JG(tuple(JPrim(p.u, p.targets) for p in ev.prims)))
        else:
            jevents.append((JM if isinstance(ev, EvMeasure) else JR)(*ev.__dict__.values()))
    jl = JF._build_layers(jevents, n, identity_noise_only=True)
    assert (layers, meas_slots, rows) == jl
    for a, b in zip(F._pack_layers(layers, n), JF._pack_layers(jl[0], n)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(F._pack_frame_tape(events, n, True)[:7], JF._pack_frame_tape(jevents, n, True)[:7]):
        np.testing.assert_array_equal(a, b)


def test_gf2_mbits_identity_and_cx():
    assert F._gf2_mbits(np.eye(4, dtype=np.complex128)) == F._IDENT_MBITS
    mb = F._gf2_mbits(_CX)
    m = np.array([[(mb >> (i * 4 + j)) & 1 for j in range(4)] for i in range(4)])
    np.testing.assert_array_equal(m, [[1, 0, 0, 0], [0, 1, 0, 1], [1, 0, 1, 0], [0, 0, 0, 1]])
    swap = np.eye(4, dtype=np.complex128)[[0, 2, 1, 3]]
    for u in (_CX, swap, np.kron(_I2, np.array([[1, 1], [1, -1]]) / np.sqrt(2))):
        assert F._gf2_mbits(u) == JF._gf2_mbits(u)


def test_clean_record_of_a_qec_memory_equals_jax():
    """A deterministic program (syndromes of |0..0> with an X error) reads
    the same clean record in both packages, by the batched readout."""
    import jax

    from qubism_tpu.core.gates import Prim as JPrim
    from qubism_tpu.run.compiler import EvGates as JG, EvMeasure as JM, EvReset as JR

    d = 5
    n, events = qec_events(d, 2)
    events.insert(0, EvGates((TPrim(np.array([[0, 1], [1, 0]], complex), (2,)),)))
    jevents = [JG(tuple(JPrim(p.u, p.targets) for p in ev.prims)) if isinstance(ev, EvGates)
               else (JM if isinstance(ev, EvMeasure) else JR)(*ev.__dict__.values())
               for ev in events]
    rec = F._clean_record(n, events, torch.Generator().manual_seed(0), torch.device("cpu"))
    jrec = JF._clean_record(n, jevents, jax.random.PRNGKey(0))
    assert [r.tolist() for r in rec] == [np.asarray(r).tolist() for r in jrec]
    assert rec[0].tolist() == [0, 1, 1, 0]


def test_rows_fallback_matches_layered_law():
    """The row scan (taken when layering would pad badly) keeps the
    semantics: a QEC memory through it obeys the same law."""
    from qubism_torch.models.qec import _FrameProg, repetition_logical_rate

    d, rounds, p, ntraj = 3, 3, 0.1, 4000
    n, events = qec_events(d, rounds)
    events = [EvMeasure(e.qubits, ((f"s{k // 5}", None, d - 1),))
              if isinstance(e, EvMeasure) and e.qubits[0] == d else e
              for k, e in enumerate(events)]
    sizes = {f"s{k}": d - 1 for k in range(rounds)} | {"m": d}
    prog = _FrameProg(n, np.cumsum(np.float32([1 - p, p, 0, 0]))[None], sizes)
    vals = F._frame_run_vals_events_rows(prog, events, ntraj, seed=1)
    data = vals["m"]
    assert ((vals[f"s{rounds - 1}"] == data[:, :-1] ^ data[:, 1:])).all()
    rate = float((data.sum(1) > d // 2).mean())
    want = repetition_logical_rate(d, rounds, p)
    assert abs(rate - want) < 5 * np.sqrt(want * (1 - want) / ntraj) + 0.005
