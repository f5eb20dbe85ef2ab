"""Runs the control of the check through the harness, in the program's
place, and prints whether each run came out correct.

    python3 -m qbench.control --workload <cell> --seeds 11,12,13 [--fault tf32,flipped_shots]

For each seed and fault, one run of the cell with that seed (the same
programs a run draws, at the cell's own width): the harness's set-up, a
window of one program, and the harness's own check. ``tf32``: the plain
reference with every product's inputs rounded to TF32 (``entries/control.py``);
``flipped_shots``: the float32 reference with each shot's first qubit
flipped. It prints one JSON line a run with ``correct`` and the numbers
compared, each with its limit: the upper readings the cell's limits sit
under. It exits 1 if any run came out correct. The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

FAULTS = {"tf32": {"tf32": True}, "flipped_shots": {"tf32": False, "flip_shots": True}}


def run(cell, seed: int, fault: str, device: str, seconds: float = 1e-3) -> dict:
    """One run of ``cell`` with the control of ``fault`` in the program's
    place; the result as the harness returns it."""
    from types import SimpleNamespace

    from .harness import plugin, run_cell

    mod = plugin(cell.root, "entries", "control")
    cell.entry = SimpleNamespace(make=lambda ctx: mod.Control(ctx, **FAULTS[fault]))
    return run_cell(cell, seed, seconds, False, device, time.perf_counter())


def main(argv=None) -> int:
    import torch

    from .harness import load_cell

    ap = argparse.ArgumentParser(prog="python3 -m qbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--fault", default="tf32", help="comma-separated: " + ", ".join(FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("qbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    passed = 0
    for fault in args.fault.split(","):
        for s in args.seeds.split(","):
            t0 = time.perf_counter()
            r = run(load_cell(args.workload), int(s), fault, "cuda")
            passed += r["correct"]
            print(json.dumps({"workload": args.workload, "seed": int(s), "fault": fault,
                              "correct": r["correct"], "seconds": time.perf_counter() - t0,
                              "checks": r["checks"]}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
