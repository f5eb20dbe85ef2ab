#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qubism_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA GPU and nvcc.
It builds the port's CUDA kernels from ``qubism_torch/csrc``, holds each
against its plain PyTorch version on the card (n = 20 and n = 30, relative
L2 <= 1e-5) and times both at n = 28, then drives the OpenQASM file path
through ``qubism_torch.cli.eval_file``: the example goldens, GHZ-30 and
brickwork-30 with 8192 shots, QFT-28 and a 28-qubit adder, each checked.
The launch counters show that the file path went through all four kernels;
the 30- and 28-qubit programs are then run again with every fused pass
also applied by the plain versions, and the states compared.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Any failed check exits non-zero without that line. No JAX is imported.
"""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "examples")
TOL = 1e-5  # relative L2 between a kernel and its plain version (complex64)
DEV = "cuda"
#: widths: kernel checks, timing, the 30-qubit GHZ/brickwork, QFT, adder operands
N_CHECK, N_WIDE, N_TIME, N_BIG, N_QFT, ADDER_WIDTH = 20, 30, 28, 30, 28, 13

#: kernel name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "gate": ("qubism_torch/csrc/gate.cu", "qubism_tpu/ops/kernels.py:256"),
    "diag": ("qubism_torch/csrc/diag.cu", "qubism_tpu/ops/kernels.py:819"),
    "lane": ("qubism_torch/csrc/lane.cu", "qubism_tpu/ops/kernels.py:894"),
    "layer1q": ("qubism_torch/csrc/layer1q.cu", "qubism_tpu/ops/kernels.py:483"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def rand_state(n, seed):
    """A random normalized complex64 state on the card from a numpy seed
    (numpy draws it up to 2^24 amplitudes; past that a CUDA generator
    seeded from the numpy stream does)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if n <= 24:
        v = (rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)).astype(np.complex64)
        s = torch.from_numpy(v).to(DEV)
    else:
        g = torch.Generator(device=DEV).manual_seed(int(rng.integers(2**31)))
        s = torch.randn(1 << n, dtype=torch.complex64, device=DEV, generator=g)
    return s.div_(torch.linalg.vector_norm(s))


def unitary(k, rng):
    import numpy as np

    m = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0]


def sync():
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


def rel_err(a, b):
    import torch

    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def kernel_cases(n, rng):
    """(kernel name, operand args) cases at n qubits: low, middle and high
    targets, permutation blocks, diagonals straddling the lane block and a
    one-point diagonal wide enough for the host split."""
    import numpy as np

    from qubism_torch.ops.apply import expand_for_view

    cx = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
    ccx = np.eye(8, dtype=complex)[[0, 1, 2, 3, 4, 5, 7, 6]]
    hi = n - 1
    cases = []
    for t in [(0,), (n // 2,), (hi,), (2, n - 5), (0, n // 2, hi), (1, 2, n - 9, n - 8)]:
        cases.append(("gate", (unitary(len(t), rng), t)))
    cases.append(("gate", (cx, (3, hi - 2))))
    cases.append(("gate", (ccx, (1, n // 2, hi))))
    one_point = np.ones(256, dtype=complex)
    one_point[int(rng.integers(256))] = -1
    cases.append(("diag", ((
        (np.array([1, 1, 1, -1], dtype=complex), (0, hi)),
        (np.exp(1j * rng.uniform(0, 2 * math.pi, 8)), (2, n // 2, hi - 1)),
        (np.exp(1j * rng.uniform(0, 2 * math.pi, 16)), (n - 9, n - 8, n - 7, n - 6)),
        (np.exp(1j * rng.uniform(0, 2 * math.pi, 128)), tuple(range(n - 7, n))),
    ),)))
    cases.append(("diag", (((one_point, (0, 3, n // 2, n - 8, n - 6, n - 4, n - 2, hi)),),)))
    for t in [(hi,), (n - 6, n - 2), tuple(range(n - 7, n))]:
        cases.append(("lane", (expand_for_view(unitary(len(t), rng), n, t),)))
    for qs in [(0, 1, 2, 3), (0, 3, n // 2, n - 9, n - 8), (1, 4, 7, n - 11, n - 9, n - 8)]:
        cases.append(("layer1q", (tuple((unitary(1, rng), q) for q in qs),)))
    return cases


def time_ms(fn, state, reps=5):
    """Device milliseconds per call (CUDA events over ``reps`` calls)."""
    import torch

    fn(state)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn(state)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels(report):
    """Each kernel against its plain version on the card, then timed."""
    import numpy as np
    import torch

    from qubism_torch.ops import kernels as K

    rng = np.random.default_rng(2024)
    for n in (N_CHECK, N_WIDE):
        cases = kernel_cases(n, rng)
        if n == N_WIDE:  # one case per kernel at full width
            seen, picked = set(), []
            for name, args in cases:
                if name not in seen:
                    seen.add(name)
                    picked.append((name, args))
            cases = picked
        for i, (name, args) in enumerate(cases):
            s = rand_state(n, 100 * n + i)
            ref = s.clone()
            getattr(K, name + "_plain")(ref, *args, n)
            getattr(K, name)(s, *args, n)
            sync()
            err = rel_err(s, ref)
            abs_err = float((s - ref).abs().max())
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], abs_err)
            log(f"kernel {name} n={n} case {i}: rel_l2={err:.3e} max_abs={abs_err:.3e}")
            check(err <= TOL, f"{name} disagrees with its plain version at n={n} "
                              f"case {i}: rel L2 {err:.3e} > {TOL}")
            del s, ref

    if DEV != "cuda":
        return
    n = N_TIME
    operands = {
        "gate": (unitary(4, rng), (2, 9, 15, 20)),
        "diag": (tuple((np.exp(1j * rng.uniform(0, 2 * math.pi, 16)),
                        (q, q + 5, q + 11, 27 - q)) for q in range(8)),),
        "lane": (unitary(7, rng),),
        "layer1q": (tuple((unitary(1, rng), q) for q in (0, 4, 8, 12, 16, 20)),),
    }
    gb = 16 * (1 << n) / 1e9
    s = rand_state(n, 7)
    for name, args in operands.items():
        kern = (lambda f, a: lambda st: f(st, *a, n))(getattr(K, name), args)
        plain = (lambda f, a: lambda st: f(st, *a, n))(getattr(K, name + "_plain"), args)
        # alternate plain, kernel, kernel, plain on the same card
        p1 = time_ms(plain, s)
        k1 = time_ms(kern, s)
        k2 = time_ms(kern, s)
        p2 = time_ms(plain, s)
        kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
        report[name]["ms"] = kms
        report[name]["plain_ms"] = pms
        log(f"time n={n} {name}: kernel {kms:.3f} ms ({gb / kms * 1e3:.1f} GB/s), "
            f"plain {pms:.3f} ms ({gb / pms * 1e3:.1f} GB/s)")
    del s
    torch.cuda.empty_cache()


def _counts(text):
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("|") and ">:" in line:
            bits, c = line[1:].split(">:")
            out[bits] = int(c)
    return out


def run_main_path():
    """The file path through cli.eval_file; returns per-program checks."""
    import numpy as np
    import torch

    from qubism_torch import cli
    from qubism_torch.models.circuits import adder_qasm, brickwork_qasm, ghz_qasm, qft_qasm
    from qubism_torch.ops.measure import marginal_table
    from qubism_torch.utils.stats import chi2_test

    on_cuda = []

    def run(name, path=None, source=None, **kw):
        """eval_file on an example file or, for generated text, on a
        virtual path inside examples/ (nothing is written there)."""
        path = path or os.path.join(EXAMPLES, f"<chip_smoke {name}>.qasm")
        got = {}
        buf = io.StringIO()
        t0 = time.perf_counter()

        def inspect(ps):
            sync()
            got["ps"] = ps
            on_cuda.extend(sv.state.device.type == DEV for sv in ps.stvecs.values())

        rc = cli.eval_file(path, source=source, out=buf, inspect=inspect, **kw)
        secs = time.perf_counter() - t0
        check(rc == 0 and buf.getvalue().rstrip().endswith("Done."),
              f"{name}: eval_file rc={rc}\n{buf.getvalue()[-2000:]}")
        log(f"main path {name}: {secs:.2f} s")
        return got["ps"], buf.getvalue()

    ps, _ = run("teleportation", os.path.join(EXAMPLES, "teleportation.qasm"), seed=3)
    check(set(ps.cregs) == {"c0", "c1", "c2"}
          and all(c.size == 1 for c in ps.cregs.values()), "teleportation cregs")
    for seed in range(2):
        ps, _ = run("errorCorrection", os.path.join(EXAMPLES, "errorCorrection.qasm"),
                    seed=seed)
        check(str(ps.cregs["c"]) == "000" and str(ps.cregs["syn"]) == "10",
              f"errorCorrection: c={ps.cregs['c']} syn={ps.cregs['syn']}")
    ps, _ = run("rippleCarryAdder", os.path.join(EXAMPLES, "rippleCarryAdder.qasm"), seed=1)
    check(str(ps.cregs["ans"]) == "00001", f"rippleCarryAdder ans={ps.cregs['ans']}")

    shots = 8192
    _, text = run("ghz30", source=ghz_qasm(N_BIG, measure=False), seed=11, shots=shots)
    counts = _counts(text)
    sigma = math.sqrt(shots * 0.25)
    check(set(counts) <= {"0" * N_BIG, "1" * N_BIG}, f"ghz30 outcomes {list(counts)[:4]}")
    for b in ("0" * N_BIG, "1" * N_BIG):
        check(abs(counts.get(b, 0) - shots / 2) <= 5 * sigma, f"ghz30 counts {counts}")
    log(f"ghz30 counts: {counts}")

    ps, text = run("brickwork30", source=brickwork_qasm(N_BIG, 4, seed=7, measure=False),
                   seed=12, shots=shots)
    sv = ps.stvecs["q"]
    probs = marginal_table(sv.state, sv.n, (0, 1, 2, 3))
    probs /= probs.sum()
    top = np.zeros(16)
    for bits, c in _counts(text).items():
        top[int(bits[:4], 2)] += c
    res = chi2_test(top, probs)
    log(f"brickwork30 top-4 chi2: {res}")
    check(bool(res), f"brickwork30 counts fail chi2 against the state's marginal: {res}")

    ps, _ = run("qft28", source=qft_qasm(N_QFT, measure=False), seed=0)
    st = ps.stvecs["q"].state
    dev = float((st.abs().square_().mul_(1 << N_QFT) - 1).abs().max())
    log(f"qft28 max | |a|^2 2^28 - 1 | = {dev:.3e}")
    check(dev <= 1e-3, f"qft28 amplitudes off uniform by {dev}")
    del ps, st

    a_val, b_val = (1 << ADDER_WIDTH) - 3, 5
    ps, _ = run("adder28", source=adder_qasm(ADDER_WIDTH, a_val, b_val), seed=0)
    ans = ps.cregs["ans"].to_natural()
    log(f"adder28: {a_val} + {b_val} = {ans}")
    check(ans == a_val + b_val, f"adder28 ans {ans} != {a_val + b_val}")
    check(on_cuda and all(on_cuda), f"a state tensor was not on {DEV}")


def phase_plain_compare():
    """The 30- and 28-qubit programs again, each queued run of gates applied
    by the kernels and, on a clone, by the plain versions."""
    import torch

    from qubism_torch.models.circuits import adder_qasm, brickwork_qasm, ghz_qasm, qft_qasm
    from qubism_torch.ops import fusion, kernels
    from qubism_torch.qasm.parser import parse_openqasm
    from qubism_torch.run.interpreter import Interpreter
    from qubism_torch.run.progstate import blank_state

    worst = {}

    class Checked(Interpreter):
        def _flush(self, target=None):
            for t in ([target] if target is not None else list(self._queue)):
                prims = self._queue.pop(t, None)
                if not prims:
                    continue
                sv = self.ps.stvecs[t]
                ref = sv.state.clone()
                for op in fusion.fuse(prims, sv.n):
                    name, args = fusion.plan(op, sv.n)
                    getattr(kernels, name + "_plain")(ref, *args, sv.n)
                fusion.apply_prims_fused(sv.state, prims, sv.n)
                sync()
                worst[self.label] = max(worst.get(self.label, 0.0), rel_err(sv.state, ref))
                del ref

    programs = {
        "ghz30": ghz_qasm(N_BIG, measure=False),
        "brickwork30": brickwork_qasm(N_BIG, 4, seed=7, measure=False),
        "qft28": qft_qasm(N_QFT, measure=False),
        "adder28": adder_qasm(ADDER_WIDTH, (1 << ADDER_WIDTH) - 3, 5),
    }
    for label, src in programs.items():
        t0 = time.perf_counter()
        ast = parse_openqasm(os.path.join(EXAMPLES, f"<chip_smoke {label}>.qasm"), src)
        interp = Checked(blank_state(0), dump_writer=lambda s: None)
        interp.label = label
        for stmt in ast:
            interp.run_stmt(stmt)
        interp.flush()
        del interp
        log(f"plain compare {label}: worst rel_l2 {worst[label]:.3e} "
            f"({time.perf_counter() - t0:.2f} s)")
        check(worst[label] <= TOL, f"{label}: kernels vs plain rel L2 {worst[label]:.3e}")


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "qubism_torch", "csrc")):
        print("chip_smoke: run from the root of a qubism-tpu checkout "
              "(qubism_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs a CUDA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
        else f"nvidia-smi unavailable (rc {smi.returncode})")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from qubism_torch.config import config
    from qubism_torch.ops import build, kernels

    check(config.device == "cuda", f"config.device is {config.device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build.library_path()})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    report = {name: {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                     "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None}
              for name, (src, tpu) in KERNELS.items()}

    t0 = time.perf_counter()
    phase_kernels(report)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kernels.reset_launches()
    run_main_path()
    launches = dict(kernels.launches)
    log(f"phase main path: {time.perf_counter() - t0:.1f} s, launches {launches}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for name in KERNELS:
        report[name]["launches"] = launches[name]
        check(launches[name] > 0, f"the main path never launched the {name} kernel")

    t0 = time.perf_counter()
    phase_plain_compare()
    log(f"phase plain compare: {time.perf_counter() - t0:.1f} s, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
