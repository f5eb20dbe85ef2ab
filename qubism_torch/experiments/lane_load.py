"""The lane kernel (K3) beside ``torch.matmul``, and under sustained load.

    python -m qubism_torch.experiments.lane_load [n]      (default n = 28)

One JSON line each for the kernel (``kernels.lane`` on prepared operands),
its plain version and one ``torch.matmul``: the relative L2 error against a
float64 product of the same rows (on the first 2^20 amplitudes) and the
milliseconds per pass at n qubits (``bw_probe.time_pass``), the kernel's
with its bound. A last line gives the kernel under sustained load: 3 s of
back-to-back passes, with the SM clock and the power draw that
``nvidia-smi`` reads meanwhile (the card lowers its clock at its power
limit, and the bound assumes the boost clock). Every line names the card
and its power limit. Needs a CUDA GPU: without one it exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ..ops import kernels, probes
from . import bw_probe

#: amplitudes of the state the error is taken on
CHECK = 1 << 20


def sustained(n: int, u: np.ndarray, seconds: float = 3.0, device="cuda") -> dict:
    """The kernel back to back for ``seconds``: ms per pass, and the SM
    clock (MHz) and power draw (W) sampled every 0.1 s after the first
    second."""
    s = bw_probe._state(n, device)
    plan = kernels.lane_prepare(u, n, device)
    kernels.lane(s, plan, n)
    torch.cuda.synchronize()
    samples, done = [], threading.Event()

    def sample():
        while not done.wait(0.1):
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout.split(",")
            if len(out) == 2:
                samples.append((time.perf_counter(), float(out[0]), float(out[1])))

    thread = threading.Thread(target=sample)
    thread.start()
    t0, passes = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            kernels.lane(s, plan, n)
        torch.cuda.synchronize()
        passes += 50
    elapsed = time.perf_counter() - t0
    done.set()
    thread.join()
    late = [(mhz, w) for t, mhz, w in samples if t - t0 >= 1.0]
    return {"what": "sustained", "n": n, "seconds": elapsed,
            "ms_per_pass": elapsed / passes * 1e3,
            "sm_mhz": [min(m for m, _ in late), max(m for m, _ in late)] if late else None,
            "sm_mhz_mean": sum(m for m, _ in late) / len(late) if late else None,
            "power_w_mean": sum(w for _, w in late) / len(late) if late else None}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    n = int(args[0]) if args else bw_probe.N_DEFAULT
    if not torch.cuda.is_available():
        print("lane_load: needs a CUDA GPU", file=sys.stderr)
        return 2
    name, limit = bw_probe.card()
    u = bw_probe._unitary(7, np.random.default_rng(7))
    s = bw_probe._state(n, "cuda")
    plan = kernels.lane_prepare(u, n, "cuda")
    ut = torch.from_numpy(np.ascontiguousarray(u.T, dtype=np.complex64)).to("cuda")
    buf = torch.empty_like(s).view(-1, 128)
    head = s[:CHECK].clone()
    want = head.view(-1, 128).to(torch.complex128) @ ut.to(torch.complex128)
    width = min(n, 20)
    amps = 1 << n
    bound_ms, bound_by = probes.bound(16 * amps + 8 * 128 * 128, 8 * 128 * amps, tf32x3=True)
    for what, fn, got in (
            ("lane", lambda: kernels.lane(s, plan, n),
             lambda: kernels.lane(head.clone(), plan, width)),
            ("lane_plain", lambda: kernels.lane_plain(s, u, n),
             lambda: kernels.lane_plain(head.clone(), u, width)),
            ("torch.matmul", lambda: torch.matmul(s.view(-1, 128), ut, out=buf),
             lambda: torch.matmul(head.view(-1, 128), ut))):
        diff = got().view(-1, 128) - want
        err = float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want))
        line = {"what": what, "n": n, "rel_l2_vs_float64": err,
                "ms_per_pass": bw_probe.time_pass(fn)}
        if what == "lane":
            line.update(bound_ms=bound_ms, bound_by=bound_by,
                        frac_bound=bound_ms / line["ms_per_pass"])
        print(json.dumps({**line, "device": name, "power_limit": limit}), flush=True)
    del s, buf, head, want
    print(json.dumps({**sustained(n, u), "device": name, "power_limit": limit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
