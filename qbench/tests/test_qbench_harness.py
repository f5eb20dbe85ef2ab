"""The harness on the CPU at small widths: every cell comes out correct, a
cell, configuration and metric added as new files run without an edit, the
timed path broken underneath comes out not correct, and the control fails
the cells' limits."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from qbench import harness

CELLS = ("rcs30.file", "qft30.compiled")
SEED = 2**33 + 5


def small(n):
    """Overrides that make every configuration n qubits wide (a 2 x n/2
    lattice for the random circuits)."""
    return {"num_qubits": n, "lattice": [2, n // 2]}


def _run(name, n=8, seconds=0.2, trace=False, root=harness.ROOT, seed=SEED):
    cell = harness.load_cell(name, root=root, overrides=small(n))
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_cpu(cpu_device, name, trace):
    r = _run(name, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    want = {m["name"] for m in harness.load_cell(name).end_to_end} - {"peak_gib"}
    if not trace:
        assert want <= set(r["metrics"])


def test_seed_gives_the_same_programs(cpu_device):
    cell = harness.load_cell("rcs30.file", overrides=small(6))
    a = [cell.family.draw(cell.cfg, harness.seed_of(SEED, 2, i)) for i in range(5)]
    b = [cell.family.draw(cell.cfg, harness.seed_of(SEED, 2, i)) for i in range(5)]
    c = [cell.family.draw(cell.cfg, harness.seed_of(SEED + 1, 2, i)) for i in range(5)]
    assert a == b and a != c


def test_added_cell_config_and_metric_need_no_edit(cpu_device, tmp_path):
    """A throwaway configuration, cell and per-layer metric, each a new file
    beside copies of the benchmark's own, named only in BENCHMARK.json."""
    shutil.copytree(harness.ROOT / "qbench", tmp_path / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "qbench" / "configs" / "tiny.json").write_text(
        json.dumps({"name": "tiny", "family": "boixo", "lattice": [1, 5], "num_qubits": 5,
                    "cz_depth": 6}))
    (tmp_path / "qbench" / "cells" / "tiny.deep.json").write_text(json.dumps(
        {"config": "tiny", "entry": "compile", "traffic": {"shots": 64, "fuse_width": 3},
         "check": {"fingerprint": 16, "limits": {"state_err": 1e-3, "xeb_gap": 0.5}},
         "why": "throwaway"}))
    (tmp_path / "qbench" / "metrics" / "throwaway_programs.py").write_text(
        "def read(record):\n    return 1000.0 + record['programs']\n")
    bench["configs"].append({"name": "tiny", "source": "test", "file": "qbench/configs/tiny.json",
                             "reduced": [], "why": "throwaway"})
    bench["workloads"].append({"name": "tiny.deep", "config": "tiny", "traffic": "deep",
                               "chips": 1, "why": "throwaway"})
    bench["per_layer"].append({"name": "throwaway_programs", "unit": "programs",
                               "better": "higher", "source": "program_counter", "layer": "run",
                               "moves": "program_ms", "workloads": ["tiny.deep"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("tiny.deep", root=tmp_path)
    r = harness.run_cell(cell, 3, 0.1, True, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["metrics"]["throwaway_programs"]["value"] == 1000 + r["attempted"]


# -- the timed path broken underneath -------------------------------------------


def _break_kernels(monkeypatch, how):
    """Replace every kernel wrapper (module attribute and KERNEL_FNS entry)
    by a broken one."""
    from qubism_torch.ops import kernels

    def broken(fn):
        calls = [0]

        def wrapper(state, *args, **kwargs):
            calls[0] += 1
            if how == "unchanged":  # every other step returns its state as it was
                return state if calls[0] % 2 else fn(state, *args, **kwargs)
            if how == "half":  # the step's update reaches half of the amplitudes
                before = state.clone()
                fn(state, *args, **kwargs)
                state[state.numel() // 2:] = before[state.numel() // 2:]
                return state
            out = fn(state, *args, **kwargs)  # "altered": one amplitude of each step's output
            state[0] = -state[0]
            return out
        return wrapper

    originals = {}
    for attr in ("gate", "layer1q", "lane", "diag", "stage_block"):
        originals[getattr(kernels, attr)] = broken(getattr(kernels, attr))
        monkeypatch.setattr(kernels, attr, originals[getattr(kernels, attr)])
    table = dict(kernels.KERNEL_FNS)
    for key, (fn, plain) in kernels.KERNEL_FNS.items():
        if fn in originals:
            table[key] = (originals[fn], plain)
    monkeypatch.setattr(kernels, "KERNEL_FNS", table)


@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_step_is_not_correct(cpu_device, monkeypatch, name, how):
    _break_kernels(monkeypatch, how)
    r = _run(name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", ["rcs30.file"])
def test_altered_shots_are_not_correct(cpu_device, monkeypatch, name):
    """Each shot's first qubit flipped where the sampler produces it."""
    from qubism_torch.ops import sample

    orig = sample.sample_indices

    def flipped(state, n, shots, gen=None, uniforms=None):
        return orig(state, n, shots, gen, uniforms) ^ (1 << (n - 1))

    monkeypatch.setattr(sample, "sample_indices", flipped)
    r = _run(name, n=10)
    assert not r["correct"] and r["checks"]["xeb_gap"]["value"] > r["checks"]["xeb_gap"]["limit"]
    assert r["checks"]["state_err"]["value"] <= r["checks"]["state_err"]["limit"]


@pytest.mark.parametrize("fault", ["tf32", "flipped_shots"])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(cpu_device, name, fault):
    """The control in the program's place, through the harness's own run
    and check, comes out not correct (at 16 qubits here; on the card at the
    cell's own width by ``python3 -m qbench.control``)."""
    from qbench import control

    if fault == "flipped_shots" and not harness.load_cell(name).spec["traffic"].get("shots"):
        pytest.skip(f"{name} takes no shots")
    for seed in (1, 2, 3):
        cell = harness.load_cell(name, overrides=small(16))
        r = control.run(cell, seed, fault, "cpu")
        assert r["attempted"] == 1 and r["failed"] == 0
        assert not r["correct"], r["checks"]


def test_no_card_no_result(root):
    """Without a CUDA card the command exits 2 and prints no result."""
    out = subprocess.run([sys.executable, "-m", "qbench.run", "--workload", "qft30.compiled",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout == ""
