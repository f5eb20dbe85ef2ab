"""The plain reference: QFT against its closed form, random circuits against
a gate-by-gate product of dense matrices, the random circuits' rules, the
control's precision, and what the benchmark's modules import."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from qbench.check import amps_err
from qbench.circuits import boixo, qft
from qbench.reference import simulate


@pytest.mark.parametrize("n", [1, 2, 5, 9])
def test_qft_closed_form(n):
    cfg = {"num_qubits": n}
    for seed in range(4):
        p = qft.draw(cfg, seed)
        got = simulate(n, qft.gates(cfg, p), "cpu").numpy()
        want = qft.closed_form(cfg, p, np.arange(1 << n))
        np.testing.assert_allclose(got, want, atol=2e-7)


def _dense(n, gates):
    """The state by full 2^n x 2^n matrices in complex128."""
    state = np.zeros(1 << n, dtype=np.complex128)
    state[0] = 1
    for u, targets, diag in gates:
        u = np.diag(u) if diag else np.asarray(u)
        k = len(targets)
        full = np.zeros((1 << n, 1 << n), dtype=np.complex128)
        for col in range(1 << n):
            sub = sum(((col >> (n - 1 - t)) & 1) << (k - 1 - i) for i, t in enumerate(targets))
            for row_sub in range(1 << k):
                row = col
                for i, t in enumerate(targets):
                    bit = (row_sub >> (k - 1 - i)) & 1
                    row = (row & ~(1 << (n - 1 - t))) | (bit << (n - 1 - t))
                full[row, col] += u[row_sub, sub]
        state = full @ state
    return state


def _rcs(rows, cols, depth):
    return {"lattice": [rows, cols], "num_qubits": rows * cols, "cz_depth": depth}


@pytest.mark.parametrize("rows,cols,depth", [(1, 2, 3), (2, 3, 9), (2, 4, 12)])
def test_rcs_against_dense_product(rows, cols, depth):
    cfg = _rcs(rows, cols, depth)
    gates = boixo.gates(cfg, boixo.draw(cfg, 99))
    n = rows * cols
    np.testing.assert_allclose(simulate(n, gates, "cpu").numpy(), _dense(n, gates), atol=1e-6)


def test_swap_against_dense_product():
    rng = np.random.default_rng(4)
    u = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))[0]
    gates = [(boixo.MATRICES["h"][0], (q,), False) for q in range(5)]
    gates += [(qft._SWAP, (4, 0), False), (boixo.MATRICES["t"][0], (0,), True),
              (u, (3, 1), False), (qft._SWAP, (1, 2), False)]
    np.testing.assert_allclose(simulate(5, gates, "cpu").numpy(), _dense(5, gates), atol=1e-6)


@pytest.mark.parametrize("rows,cols", [(5, 6), (4, 8), (7, 7), (2, 3)])
def test_rcs_patterns_tile_the_lattice(rows, cols):
    """The eight patterns are disjoint pairs of neighbours, and together
    hold every edge of the lattice once."""
    edges = {(r * cols + c, r * cols + c + 1) for r in range(rows) for c in range(cols - 1)}
    edges |= {(r * cols + c, (r + 1) * cols + c) for r in range(rows - 1) for c in range(cols)}
    seen = []
    for i in range(8):
        pairs = boixo.cz_pattern(rows, cols, i)
        qubits = [q for pair in pairs for q in pair]
        assert len(qubits) == len(set(qubits)) and set(pairs) <= edges
        assert {b - a for a, b in pairs} <= ({1} if i % 2 == 0 else {cols})
        seen += pairs
    assert sorted(seen) == sorted(edges)


def test_rcs_rules():
    """H first and last; CZ patterns in turn; outside a cycle's CZs, T in
    the first cycle, sqrt(X) or sqrt(Y) after a CZ, T after those, else
    nothing."""
    cfg = _rcs(5, 6, 40)
    m = boixo.moments(cfg, boixo.draw(cfg, 7))
    assert len(m) == 42 and m[0] == m[-1] == [("h", q) for q in range(30)]
    prev = {}
    for cycle, ops in enumerate(m[1:-1]):
        cz = [tuple(qs) for g, *qs in ops if g == "cz"]
        assert cz == boixo.cz_pattern(5, 6, cycle)
        now = {q: "cz" for pair in cz for q in pair}
        singles = {qs[0]: g for g, *qs in ops if g != "cz"}
        assert not set(singles) & set(now)
        for q in range(30):
            if q in now:
                continue
            want = ({"t"} if cycle == 0 else {"rx", "ry"} if prev.get(q) == "cz"
                    else {"t"} if prev.get(q) in ("rx", "ry") else {None})
            assert singles.get(q) in want
        prev = {**now, **singles}
    counts = {g: sum(op[0] == g for ops in m for op in ops) for g in ("rx", "ry")}
    assert min(counts.values()) > 0.4 * sum(counts.values())
    text = boixo.text(cfg, boixo.draw(cfg, 7))
    assert text.count("\n") == 4 + sum(map(len, m)) and "cz q[0],q[1];" in text


def test_reference_in_blocks(monkeypatch):
    """Blocks smaller than a gate's view give the state of one block, to
    float32 rounding (the CPU vectorises a block and a strided view apart)."""
    from qbench.reference import statevec

    cfg = _rcs(3, 3, 12)
    gates = boixo.gates(cfg, boixo.draw(cfg, 3)) + qft.gates({"num_qubits": 9}, {"x": 5})
    whole = simulate(9, gates, "cpu")
    monkeypatch.setattr(statevec, "_BLOCK", 8)
    torch.testing.assert_close(simulate(9, gates, "cpu"), whole, rtol=0, atol=1e-6)


def test_tf32_rounding():
    x = torch.tensor([1 + 2 ** -12, 1 + 2 ** -10, -3.0000001], dtype=torch.float32)
    from qbench.reference import round_tf32_

    assert round_tf32_(x.clone()).tolist() == [1.0, 1 + 2 ** -10, -3.0]


@pytest.mark.parametrize("family,cfg", [(qft, {"num_qubits": 10}), (boixo, _rcs(2, 5, 40))])
def test_control_is_one_precision_below(family, cfg):
    """TF32 in the program's place reads thousands of times the float32
    reference's own rounding."""
    p = family.draw(cfg, 5)
    gates = family.gates(cfg, p)
    ref = simulate(10, gates, "cpu").numpy()
    control = simulate(10, gates, "cpu", tf32=True).numpy()
    assert amps_err(control, ref, 10) > 1e-3
    if family is qft:
        exact = qft.closed_form(cfg, p, np.arange(1 << 10))
        assert amps_err(ref, exact, 10) < 1e-5


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ, "QUBISM_TORCH_DEVICE": "cpu"})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program(root):
    mods = _modules_after(f"import sys; sys.path.insert(0, {str(root)!r})\n"
                          "import qbench.reference, qbench.check, qbench.roofline\n"
                          "from qbench.circuits import qft, boixo")
    assert not [m for m in mods if m.split(".")[0] in ("qubism_torch", "qubism_tpu", "jax")]


def test_no_run_loads_jax(root):
    """Every cell run on the CPU at a small width, then no module whose
    top-level name is jax, jaxlib, flax or qubism_tpu is loaded."""
    mods = _modules_after(
        f"import sys, time; sys.path.insert(0, {str(root)!r})\n"
        "from qbench import harness\n"
        "for c in ('rcs30.file', 'qft30.compiled'):\n"
        "    cell = harness.load_cell(c, overrides={'num_qubits': 6, 'lattice': [2, 3]})\n"
        "    r = harness.run_cell(cell, 7, 0.05, True, 'cpu', time.perf_counter())\n"
        "    assert r['correct'], r\n")
    assert [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "qubism_tpu")] == []
    assert "qubism_torch" in mods
