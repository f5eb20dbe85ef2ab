"""Where a compiled circuit's device time goes, on the card.

    python -m qubism_torch.experiments.profile_circuits [n]     (default n = 30)

For the n-qubit QFT and the depth-4 brickwork circuit as
``CompiledCircuit`` on one buffer, the QFT at n - 2 qubits, and the QFT as
``ShardedSim`` on one shard (2 banks at n = 30), it prints one JSON line:
the device milliseconds of one warm call (CUDA events around it), its wall
seconds, the device's idle share of the call (1 - the kernels' summed time
over the call's span, from ``torch.profiler``), and per kernel (by its name
in the library) the launches and the summed device milliseconds of that
call. Then, for the file path (``cli.eval_file``) on GHZ-n and the depth-4
brickwork circuit with 8192 shots, QFT-(n - 2) and the widest ripple-carry
adder within n - 2 qubits, one JSON line each with the wall seconds of four
runs in a row (the first pays for the process's first allocations; the
others are warm). Every line names the card and its power limit. Needs a
CUDA GPU: without one it exits 2.
"""

from __future__ import annotations

import io
import json
import re
import sys
import time
from pathlib import Path

import torch

from .. import cli
from ..models.circuits import (adder_qasm, brickwork_prims, brickwork_qasm, ghz_qasm,
                               qft_prims, qft_qasm)
from ..ops.fusion import CompiledCircuit
from . import bw_probe

N_DEFAULT = 30


def _short(name: str) -> str:
    """A kernel's name without its namespace, arguments and return type."""
    m = re.search(r"(\w+_kernel)\b(<[^(]*>)?", name)
    return (m.group(1) + (m.group(2) or "")) if m else name.split("(")[0][-60:]


def profile(label: str, call, n: int) -> dict:
    """``call()`` runs the circuit once on a prepared state (in place)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    device_ms = start.elapsed_time(end)

    # device activity only: host events are not read here, and a call of
    # many small host ops (the adjoint engine's contraction) makes them slow
    # to record and to walk
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels: dict = {}
    first, last = None, None
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = ev.time_range
        first = span.start if first is None else min(first, span.start)
        last = span.end if last is None else max(last, span.end)
        k = kernels.setdefault(_short(ev.name), {"launches": 0, "ms": 0.0})
        k["launches"] += 1
        k["ms"] += (span.end - span.start) / 1e3
    busy = sum(k["ms"] for k in kernels.values())
    span_ms = (last - first) / 1e3 if kernels else None
    return {"circuit": label, "n": n, "device_ms": device_ms, "wall_s": wall,
            "profiled_span_ms": span_ms, "kernel_ms": busy if kernels else None,
            "idle_share": 1 - busy / span_ms if kernels else None,
            "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"]))}


def compiled(prims, n: int):
    circ = CompiledCircuit(n, prims)
    state = circ.init_state()
    return lambda: circ(state)


def sharded(prims, n: int):
    from ..parallel import ShardedSim, make_mesh

    sim = ShardedSim(n, make_mesh(1))
    return lambda: sim.apply(prims)


def file_path_warm(n: int, examples=None, reps: int = 3) -> list:
    """``cli.eval_file`` on each of the four programs ``reps`` times in a
    row: [{"program", "n", "rc", "seconds": [...]}, ...]. ``examples`` is
    the directory whose ``qelib1.inc`` the programs include (default: the
    repository's)."""
    examples = Path(examples or Path(__file__).resolve().parents[2] / "examples")
    width = (n - 4) // 2  # the adder holds 2 width + 2 qubits
    programs = {
        f"ghz{n}": (n, ghz_qasm(n, measure=False), {"seed": 11, "shots": 8192}),
        f"brickwork{n}": (n, brickwork_qasm(n, 4, seed=7, measure=False),
                          {"seed": 12, "shots": 8192}),
        f"qft{n - 2}": (n - 2, qft_qasm(n - 2, measure=False), {"seed": 0}),
        f"adder{2 * width + 2}": (2 * width + 2, adder_qasm(width, (1 << width) - 3, 5),
                                  {"seed": 0}),
    }
    out = []
    for name, (qubits, source, kw) in programs.items():
        secs, rc = [], 0
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc |= cli.eval_file(str(examples / f"<{name}>.qasm"), source=source,
                                out=io.StringIO(), inspect=lambda ps: torch.cuda.synchronize(),
                                **kw)
            secs.append(time.perf_counter() - t0)
        out.append({"program": name, "n": qubits, "rc": rc, "seconds": secs})
    return out


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    n = int(args[0]) if args else N_DEFAULT
    if not torch.cuda.is_available():
        print("profile_circuits: needs a CUDA GPU", file=sys.stderr)
        return 2
    name, limit = bw_probe.card()
    cases = [
        (f"compiled qft{n}", lambda: compiled(qft_prims(n), n), n),
        (f"compiled qft{n - 2}", lambda: compiled(qft_prims(n - 2), n - 2), n - 2),
        (f"compiled brickwork{n} depth 4", lambda: compiled(brickwork_prims(n, 4, seed=7), n), n),
        (f"sharded qft{n} on one shard", lambda: sharded(qft_prims(n), n), n),
    ]
    for label, make, width in cases:
        line = profile(label, make(), width)
        print(json.dumps({**line, "device": name, "power_limit": limit}), flush=True)
        torch.cuda.empty_cache()
    for line in file_path_warm(n, reps=4):
        print(json.dumps({"path": "file", **line, "device": name, "power_limit": limit}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
