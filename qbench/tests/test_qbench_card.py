"""On the card: one short run of a cell through the command, and the
control at the cell's own width failing its limits."""

import json
import subprocess
import sys

import pytest


@pytest.mark.card
def test_command_runs_correct(card, root):
    out = subprocess.run([sys.executable, "-m", "qbench.run", "--workload", "qft30.compiled",
                          "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["metrics"]["kernels_roofline"]["value"] <= 105


@pytest.mark.card
def test_control_is_not_correct_at_full_width(card):
    from qbench import control, harness

    r = control.run(harness.load_cell("qft30.compiled"), 2147483661, "tf32", "cuda")
    assert r["attempted"] == 1 and not r["correct"], r["checks"]
