"""The benchmark's command: run one cell once and print one JSON line.

    python3 -m qbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs the CUDA cards the cell asks for: without them it exits 2 and prints
no result. It never runs on the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m qbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from qbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
