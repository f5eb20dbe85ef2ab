"""The exact density backend on the benchmark's noisy random circuits
(``qbench/circuits/noisy_boixo.py``) against the benchmark's plain matrix
reference (``qbench/reference/density.py``): the port's rho through
``eval_file(backend="density")``, the family's vec(rho) gate list through
the state-vector reference ``qbench.reference.simulate``, the
superoperator's layout against the port's row-in-top-bits convention, and
the harness's ``noisyrcs15.density`` cell at 2 x 3 on the CPU with its TF32
control."""

import io
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from qbench import control, harness  # noqa: E402
from qbench.check import parse_counts  # noqa: E402
from qbench.circuits import boixo, noisy_boixo  # noqa: E402
from qbench.reference import density as ref  # noqa: E402
from qbench.reference import simulate  # noqa: E402
from qbench.reference.statevec import _apply_dense  # noqa: E402
from qubism_torch.cli import eval_file  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core import density as TD  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.run.noisy import group_runs  # noqa: E402
from qubism_torch.utils import profiling  # noqa: E402

#: Sycamore's gate errors (the configuration's), and a noise 30x stronger
NOISES = ("depolarizing:0.0016,dep2:0.0062", "depolarizing:0.05,dep2:0.2")
#: a file of qbench/, so that the text's include finds qbench/qelib1.inc
PATH = str(ROOT / "qbench" / "program.qasm")
TOL = 1e-5
SEED = 2**35 + 17


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setenv("QUBISM_TORCH_DEVICE", "cpu")


def _cfg(lattice, depth, noise=NOISES[0]):
    q = lattice[0] * lattice[1]
    return {"lattice": list(lattice), "qubits": q, "num_qubits": 2 * q, "cz_depth": depth,
            "noise": noise}


def _reference(cfg, p) -> np.ndarray:
    ops = ref.noisy_ops(noisy_boixo.elaborated(cfg, p), ref.parse_noise(cfg["noise"]))
    return ref.evolve(cfg["qubits"], ops).numpy()


def _port(cfg, p, seed=1):
    box = {}
    out = io.StringIO()
    rc = eval_file(PATH, source=noisy_boixo.text(cfg, p), seed=seed, shots=256, out=out,
                   backend="density", noise=cfg["noise"],
                   inspect=lambda result: box.update(rho=result[0]))
    assert rc == 0, out.getvalue()
    return box["rho"], out.getvalue()


CASES = [(lattice, depth, noise) for lattice in ((2, 2), (2, 3)) for depth in (4, 8)
         for noise in NOISES]


@pytest.mark.parametrize("lattice, depth, noise", CASES)
def test_port_rho_against_the_plain_reference(lattice, depth, noise):
    cfg = _cfg(lattice, depth, noise)
    p = noisy_boixo.draw(cfg, SEED + depth)
    rho, out = _port(cfg, p)
    want = _reference(cfg, p)
    np.testing.assert_allclose(rho.matrix(), want, atol=TOL, rtol=0)
    assert abs(np.trace(want) - 1) < TOL and "Done." in out
    # the noise shows: the state is mixed, more so under the stronger noise
    purity = float(np.vdot(want, want).real)
    assert purity < (0.99 if noise == NOISES[0] else 0.6)


@pytest.mark.parametrize("lattice, depth, noise", CASES)
def test_family_gate_list_through_simulate_against_the_plain_reference(lattice, depth, noise):
    cfg = _cfg(lattice, depth, noise)
    p = noisy_boixo.draw(cfg, SEED + 1)
    n = cfg["qubits"]
    vec = simulate(cfg["num_qubits"], noisy_boixo.gates(cfg, p), torch.device("cpu"))
    np.testing.assert_allclose(vec.numpy().reshape(1 << n, 1 << n), _reference(cfg, p),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("lattice, seed", [((2, 2), 5), ((2, 3), 11)])
def test_port_shots_follow_the_reference_diagonal(lattice, seed):
    """The counts the density backend prints are drawn from the plain
    reference's diagonal, the printed bit string read as the row index:
    nearer to it in total variation than to the same diagonal with its bit
    order reversed or with any one qubit flipped (the check compares rho,
    not the shots, so their order is held here)."""
    cfg = _cfg(lattice, 8)
    p = noisy_boixo.draw(cfg, SEED + seed)
    n, shots = cfg["qubits"], 1 << 15
    out = io.StringIO()
    rc = eval_file(PATH, source=noisy_boixo.text(cfg, p), seed=seed, shots=shots, out=out,
                   backend="density", noise=cfg["noise"])
    assert rc == 0, out.getvalue()
    counts = parse_counts(out.getvalue())
    assert sum(counts.values()) == shots
    seen = np.zeros(1 << n)
    for bits, c in counts.items():
        seen[int(bits, 2)] = c / shots
    diag = np.real(np.diag(_reference(cfg, p)))
    x = np.arange(1 << n)
    rev = sum(((x >> b) & 1) << (n - 1 - b) for b in range(n))
    tv = 0.5 * np.abs(seen - diag).sum()
    assert tv < 0.03
    for other in [rev] + [x ^ (1 << b) for b in range(n)]:
        assert tv < 0.5 * np.abs(seen - diag[other]).sum()


def _random_rho(n, rng):
    a = rng.normal(size=(1 << n, 1 << n)) + 1j * rng.normal(size=(1 << n, 1 << n))
    rho = a @ a.conj().T
    return rho / np.trace(rho)


def _explicit(kraus, targets, rho, n):
    """sum_i K_i rho K_i^dag with each K_i embedded on ``targets`` by its
    action on basis states (qubit q = bit n-1-q)."""
    k = len(targets)
    dim = 1 << n
    out = np.zeros_like(rho)
    for K in kraus:
        full = np.zeros((dim, dim), dtype=complex)
        for col in range(dim):
            sub = sum(((col >> (n - 1 - t)) & 1) << (k - 1 - j) for j, t in enumerate(targets))
            for row_sub in range(1 << k):
                row = col
                for j, t in enumerate(targets):
                    bit = (row_sub >> (k - 1 - j)) & 1
                    row = (row & ~(1 << (n - 1 - t))) | (bit << (n - 1 - t))
                full[row, col] += K[row_sub, sub]
        out += full @ rho @ full.conj().T
    return out


@pytest.mark.parametrize("kraus, targets", [
    (ref.depolarizing(0.3), (1,)),
    (TD.amplitude_damping(0.4), (2,)),
    (ref.depolarizing2(0.5), (0, 2)),
    (ref.depolarizing2(0.5), (2, 1)),
    ([np.kron(TD.amplitude_damping(0.3)[i], TD.phase_damping(0.2)[j])
      for i in range(2) for j in range(2)], (2, 0)),
])
def test_superoperator_layout_is_the_ports(kraus, targets):
    """The family's superoperator on (T, T + n) of vec(rho), the row index
    in the top n bits, is the channel: by the reference's dense pass, by the
    port's gate pass and against the port's own superoperator."""
    n = 3
    rho = _random_rho(n, np.random.default_rng(len(kraus) + sum(targets)))
    want = _explicit([np.asarray(k) for k in kraus], targets, rho, n)
    s = noisy_boixo.superoperator(kraus)
    np.testing.assert_allclose(s, TD.superoperator(kraus), atol=1e-12)
    wide = tuple(targets) + tuple(t + n for t in targets)
    vec = torch.from_numpy(rho.reshape(-1).astype(np.complex64))
    _apply_dense(vec, s, wide, 2 * n, False)
    np.testing.assert_allclose(vec.numpy().reshape(1 << n, 1 << n), want, atol=1e-5)
    port = torch.from_numpy(rho.reshape(-1).astype(np.complex64))
    TA.apply_gate(port, s, wide, 2 * n)
    np.testing.assert_allclose(port.numpy().reshape(1 << n, 1 << n), want, atol=1e-5)


def test_a_cz_elaborates_as_qelib1_has_it():
    cfg = _cfg((2, 2), 1)
    p = noisy_boixo.draw(cfg, 3)
    gates = noisy_boixo.elaborated(cfg, p)
    names = [g for ops in boixo.moments(cfg, p) for g, *_ in ops]
    assert len(gates) == len(names) + 2 * names.count("cz")
    h = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
    # U(pi/2, 0, pi) is h exactly, and cz is h b; cx a,b; h b
    np.testing.assert_allclose(noisy_boixo.U["h"], h, atol=1e-15)
    i = [j for j, (u, t) in enumerate(gates) if len(t) == 2][0]
    (h1, t1), (cx, t2), (h2, t3) = gates[i - 1:i + 2]
    assert t1 == t3 == (t2[1],) and np.array_equal(cx, noisy_boixo.CX)
    full = np.kron(np.eye(2), h) @ cx @ np.kron(np.eye(2), h)
    np.testing.assert_allclose(full, np.diag([1, 1, 1, -1]), atol=1e-15)


OVERRIDES = {"lattice": [2, 3], "qubits": 6, "num_qubits": 12}


@pytest.mark.parametrize("trace", [False, True])
def test_cell_correct_on_cpu(trace):
    cell = harness.load_cell("noisyrcs15.density", overrides=OVERRIDES)
    r = harness.run_cell(cell, SEED, 0.5, trace, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"state_err", "amps_err"}
    if trace:
        # 2 x 3 at depth 8: 31 single-qubit gates and 9 cz (h, cx, h), 58
        # elaborated gates in runs on at most two qubits, one a cx, each run
        # with its channels one pass, over the window's programs (every draw
        # has the same targets); launches count CUDA kernels alone, so
        # passes_per_program reads 0 on the CPU
        cfg = cell.cfg
        targets = {tuple(t for _, t in noisy_boixo.elaborated(cfg, noisy_boixo.draw(cfg, s)))
                   for s in (0, 1, SEED)}
        (targets,) = targets
        assert len(targets) == 31 + 3 * 9
        c = profiling.counters
        assert len(group_runs(targets)) == 9
        assert c["rho_fused_passes"] == 9 * r["attempted"]
        assert c["rho_fused_prims"] == len(targets) * r["attempted"]
        assert c.get("rho_unitary_passes", 0) + c.get("rho_channel_passes", 0) == 0
        assert r["metrics"]["passes_per_program"]["value"] == 0
        assert r["metrics"]["syncs_per_program"]["value"] == 0
        assert r["metrics"]["rho_host_ms"]["value"] > 0
    else:
        assert {"setup_s", "program_ms"} <= set(r["metrics"])


@pytest.mark.parametrize("seed", [31, 2**40 + 7])
def test_cell_control_is_not_correct(seed):
    r = control.run(harness.load_cell("noisyrcs15.density", overrides=OVERRIDES), seed,
                    "tf32", "cpu")
    assert not r["correct"], r["checks"]
    assert all(c["value"] > c["limit"] for c in r["checks"].values())
