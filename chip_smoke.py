#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qubism_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA GPU and nvcc.
It builds the port's CUDA kernels from ``qubism_torch/csrc``, holds each
against its plain PyTorch version on the card (n = 20 and n = 30, relative
L2 <= 1e-5) and times both at n = 28. Then it drives three paths, each with
the launch counters set to 0 just before it and read just after:

* the OpenQASM file path through ``qubism_torch.cli.eval_file``: the example
  goldens, GHZ-30 and brickwork-30 with 8192 shots, QFT-28 and a 28-qubit
  adder, each checked;
* the compiled engine: ``CompiledCircuit`` on QFT-30 (uniform magnitudes,
  warm wall seconds and device ms), QFT-28 at stage groups 2 and 4,
  GHZ-30 and brickwork-30 with 8192 shots, and
  ``eval_file(..., compile_mode=True)`` on the goldens, QFT-28 and the adder,
  each against the file path;
* the DSL: teleportation through ``Session``, and a 20-qubit QFT built from
  ``hadamard`` / ``controlled(phase)``, applied gate by gate and through
  ``CompiledCircuit``.

The counters show which kernels each path went through. The 30- and
28-qubit programs are then run again with every fused pass also applied by
the plain versions, and the states compared.

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
#: widths: kernel checks, timing, the 30-qubit GHZ/brickwork/QFT, QFT, adder
#: operands, the DSL's QFT
N_CHECK, N_WIDE, N_TIME, N_BIG, N_QFT, ADDER_WIDTH, N_DSL = 20, 30, 28, 30, 28, 13, 20
SHOTS = 8192

#: kernel name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "gate": ("qubism_torch/csrc/gate.cu", "qubism_tpu/ops/kernels.py:256"),
    "diag": ("qubism_torch/csrc/diag.cu", "qubism_tpu/ops/kernels.py:819"),
    "lane": ("qubism_torch/csrc/lane.cu", "qubism_tpu/ops/kernels.py:894"),
    "layer1q": ("qubism_torch/csrc/layer1q.cu", "qubism_tpu/ops/kernels.py:483"),
    "stage": ("qubism_torch/csrc/stage.cu",
              "qubism_tpu/ops/kernels.py:256 (stage 1-4; stage_block_prepare :1041)"),
}
#: the kernels each driven path must launch
PATH_KERNELS = {
    "file path": ("gate", "diag", "lane", "layer1q"),
    "compiled path": ("gate", "diag", "lane", "layer1q", "stage"),
    "DSL": ("gate", "diag", "lane", "stage"),
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


def stage_stages(n, q0, k, rng, off_one=False, stride=1):
    """k QFT-like stages on q0..q0+k-1: a random 1q gate, then controlled
    phases to every ``stride``-th higher qubit, into the lane block; with
    ``off_one`` every third factor also has d[2] != 1."""
    import numpy as np

    stages = []
    for q in range(q0, q0 + k):
        ladder = []
        for j in range(q + 1, n, stride):
            d = np.array([1, 1, 1, np.exp(1j * rng.uniform(0, 2 * math.pi))])
            if off_one and (q + j) % 3 == 0:
                d[2] = np.exp(1j * rng.uniform(0, 2 * math.pi))
            ladder.append((d, (q, j)))
        stages.append((unitary(1, rng), q, tuple(ladder)))
    return tuple(stages)


def kernel_cases(n, rng):
    """(kernel name, operand args) cases at n qubits: low, middle and high
    targets, permutation blocks, diagonals straddling the lane block, a
    one-point diagonal wide enough for the host split, and stage blocks of
    k = 4, 1, 2, 3 stages (one with d[2] != 1, one with a sparse ladder)."""
    import numpy as np

    from qubism_torch.ops import kernels as K
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
    # k = 4 first (the one case at n = 30): at q0 = 1 its ladders reach
    # index bit n - 6, which takes the most table chunks
    for q0, k, opts in [(1 if n > N_CHECK else n - 11, 4, {}), (0, 1, {}),
                        (3, 2, {"off_one": True}), (5, 3, {"stride": 3})]:
        stages = stage_stages(n, q0, k, rng, **opts)
        cases.append(("stage", (K.stage_block_prepare(stages, n, DEV),)))
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
            K.KERNEL_FNS[name][1](ref, *args, n)
            K.KERNEL_FNS[name][0](s, *args, n)
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
    from qubism_torch.ops.fusion import STAGE_GROUP

    n = N_TIME
    # (label, kernel, operands); the stage kernel at k = 2 and k = 4 (QFT
    # stages on qubits 0..k-1, full ladders), reported at the default group
    timed = [
        ("gate", "gate", (unitary(4, rng), (2, 9, 15, 20))),
        ("diag", "diag", (tuple((np.exp(1j * rng.uniform(0, 2 * math.pi, 16)),
                                 (q, q + 5, q + 11, 27 - q)) for q in range(8)),)),
        ("lane", "lane", (unitary(7, rng),)),
        ("layer1q", "layer1q", (tuple((unitary(1, rng), q) for q in (0, 4, 8, 12, 16, 20)),)),
    ]
    for k in (2, 4):
        plan = K.stage_block_prepare(stage_stages(n, 0, k, rng), n, DEV)
        timed.append((f"stage k={k}", "stage", (plan,)))
    gb = 16 * (1 << n) / 1e9
    s = rand_state(n, 7)
    for label, name, args in timed:
        kern = (lambda f, a: lambda st: f(st, *a, n))(K.KERNEL_FNS[name][0], args)
        plain = (lambda f, a: lambda st: f(st, *a, n))(K.KERNEL_FNS[name][1], args)
        # alternate plain, kernel, kernel, plain on the same card
        p1 = time_ms(plain, s)
        k1 = time_ms(kern, s)
        k2 = time_ms(kern, s)
        p2 = time_ms(plain, s)
        kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
        if name != "stage" or label == f"stage k={STAGE_GROUP}":
            report[name]["ms"] = kms
            report[name]["plain_ms"] = pms
        log(f"time n={n} {label}: kernel {kms:.3f} ms ({gb / kms * 1e3:.1f} GB/s), "
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
    """The file path through cli.eval_file, each program checked."""
    from qubism_torch import cli
    from qubism_torch.models.circuits import adder_qasm, brickwork_qasm, ghz_qasm, qft_qasm

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

    _, text = run("ghz30", source=ghz_qasm(N_BIG, measure=False), seed=11, shots=SHOTS)
    check_ghz_counts("ghz30", _counts(text), N_BIG)

    ps, text = run("brickwork30", source=brickwork_qasm(N_BIG, 4, seed=7, measure=False),
                   seed=12, shots=SHOTS)
    check_top4_chi2("brickwork30", ps.stvecs["q"].state, N_BIG, _counts(text))

    ps, _ = run("qft28", source=qft_qasm(N_QFT, measure=False), seed=0)
    check_uniform("qft28", ps.stvecs["q"].state, N_QFT)
    del ps

    a_val, b_val = (1 << ADDER_WIDTH) - 3, 5
    ps, _ = run("adder28", source=adder_qasm(ADDER_WIDTH, a_val, b_val), seed=0)
    ans = ps.cregs["ans"].to_natural()
    log(f"adder28: {a_val} + {b_val} = {ans}")
    check(ans == a_val + b_val, f"adder28 ans {ans} != {a_val + b_val}")
    check(on_cuda and all(on_cuda), f"a state tensor was not on {DEV}")


def check_uniform(label, state, n):
    """QFT|0>: every |a|^2 within 1e-3 (relative) of 2^-n."""
    dev = float((state.abs().square_().mul_(1 << n) - 1).abs().max())
    log(f"{label} max | |a|^2 2^{n} - 1 | = {dev:.3e}")
    check(dev <= 1e-3, f"{label} amplitudes off uniform by {dev}")


def check_ghz_counts(label, counts, n):
    sigma = math.sqrt(SHOTS * 0.25)
    check(set(counts) <= {"0" * n, "1" * n}, f"{label} outcomes {list(counts)[:4]}")
    for b in ("0" * n, "1" * n):
        check(abs(counts.get(b, 0) - SHOTS / 2) <= 5 * sigma, f"{label} counts {counts}")
    log(f"{label} counts: {counts}")


def check_top4_chi2(label, state, n, counts):
    """Counts of the first four qubits against the state's marginal."""
    import numpy as np

    from qubism_torch.ops.measure import marginal_table
    from qubism_torch.utils.stats import chi2_test

    probs = marginal_table(state, n, (0, 1, 2, 3))
    probs /= probs.sum()
    top = np.zeros(16)
    for bits, c in counts.items():
        top[int(bits[:4], 2)] += c
    res = chi2_test(top, probs)
    log(f"{label} top-4 chi2: {res}")
    check(bool(res), f"{label} counts fail chi2 against the state's marginal: {res}")


def run_compiled_path():
    """The compiled engine: CompiledCircuit on the prim streams, then
    eval_file(compile_mode=True) against the file path."""
    import torch

    from qubism_torch import cli
    from qubism_torch.models.circuits import (adder_qasm, brickwork_prims, ghz_prims,
                                              qft_prims, qft_qasm)
    from qubism_torch.ops.fusion import CompiledCircuit
    from qubism_torch.ops.sample import sample_counts

    n = N_BIG
    t0 = time.perf_counter()
    circ = CompiledCircuit(n, qft_prims(n))
    log(f"compiled qft{n}: planned in {time.perf_counter() - t0:.2f} s, stats {circ.stats()}")
    check(circ.stats()["backend"] == ("cuda" if DEV == "cuda" else "plain"),
          f"compiled qft{n} backend {circ.stats()['backend']}")
    state = circ(circ.init_state())
    sync()
    check(state.device.type == DEV, f"compiled state on {state.device}")
    check_uniform(f"compiled qft{n}", state, n)
    t0 = time.perf_counter()
    circ(state)
    sync()
    log(f"compiled qft{n}: warm call {time.perf_counter() - t0:.4f} s wall")
    if DEV == "cuda":
        log(f"compiled qft{n}: {time_ms(circ, state, reps=3):.3f} device ms per call")
    del state, circ

    if DEV == "cuda":
        s = rand_state(N_QFT, 5)
        circs = {g: CompiledCircuit(N_QFT, qft_prims(N_QFT), stage_group=g) for g in (2, 4)}
        ms = {2: [], 4: []}
        for g in (2, 4, 4, 2):
            ms[g].append(time_ms(circs[g], s, reps=3))
        for g in (2, 4):
            log(f"compiled qft{N_QFT} stage_group={g}: {sum(ms[g]) / 2:.3f} device ms "
                f"({circs[g].num_passes} passes, {circs[g].stats()['fused_stage_blocks']} "
                f"stage blocks)")
        del s, circs

    gen = torch.Generator().manual_seed(11)
    circ = CompiledCircuit(n, ghz_prims(n))
    state = circ(circ.init_state())
    check_ghz_counts(f"compiled ghz{n}", sample_counts(state, n, SHOTS, gen), n)
    del state
    circ = CompiledCircuit(n, brickwork_prims(n, 4, seed=7))
    log(f"compiled brickwork{n}: stats {circ.stats()}")
    state = circ(circ.init_state())
    check_top4_chi2(f"compiled brickwork{n}", state, n, sample_counts(state, n, SHOTS, gen))
    del state, circ

    def both(label, path=None, source=None, seed=0):
        """The program through the file path and in compile mode: equal
        cregs, and equal states where both hold one state vector."""
        path = path or os.path.join(EXAMPLES, f"<chip_smoke {label}>.qasm")
        got = {}
        for mode in (False, True):
            buf = io.StringIO()
            t0 = time.perf_counter()

            def inspect(ps, mode=mode):
                got[mode] = ps

            rc = cli.eval_file(path, source=source, out=buf, seed=seed, compile_mode=mode,
                               inspect=inspect)
            sync()
            check(rc == 0 and buf.getvalue().rstrip().endswith("Done."),
                  f"{label} compile_mode={mode}: rc={rc}\n{buf.getvalue()[-2000:]}")
            if mode:
                log(f"compiled {label}: {time.perf_counter() - t0:.2f} s")
        plain, comp = got[False], got[True]
        cregs = {k: str(v) for k, v in comp.cregs.items()}
        check(cregs == {k: str(v) for k, v in plain.cregs.items()},
              f"{label}: compiled cregs {cregs} != file path {plain.cregs}")
        check(all(sv.state.device.type == DEV for sv in comp.stvecs.values()),
              f"{label}: compiled state not on {DEV}")
        if list(plain.stvecs) == list(comp.stvecs) and len(comp.stvecs) == 1:
            (name,) = comp.stvecs
            err = rel_err(comp.stvecs[name].state, plain.stvecs[name].state)
            log(f"compiled {label}: rel_l2 against the file path {err:.3e}")
            check(err <= TOL, f"{label}: compiled state differs from the file path by {err}")
        return comp

    for name, seed in (("teleportation", 3), ("errorCorrection", 0), ("rippleCarryAdder", 1)):
        both(name, os.path.join(EXAMPLES, f"{name}.qasm"), seed=seed)
    both(f"qft{N_QFT}", source=qft_qasm(N_QFT, measure=False))
    a_val, b_val = (1 << ADDER_WIDTH) - 3, 5
    ps = both("adder28", source=adder_qasm(ADDER_WIDTH, a_val, b_val))
    check(ps.cregs["ans"].to_natural() == a_val + b_val, f"compiled adder28 {ps.cregs['ans']}")


def run_dsl_path():
    """The DSL on the card: teleportation through Session, and a QFT built
    from hadamard / controlled(phase) applied gate by gate and compiled."""
    import qubism_torch as qt
    from qubism_torch.ops import kernels
    from qubism_torch.ops.fusion import CompiledCircuit

    alice = qt.StateVec.qubit(0.6, 0.8j)
    pair = (qt.cnot(0, 1, 2) @ qt.on_just(0, qt.hadamard(), 2))(qt.mk_state_vec(2))
    s = qt.Session(alice.tensor(pair), seed=42)
    s.gate(qt.cnot(0, 1, 3))
    s.gate(qt.on_just(0, qt.hadamard(), 3))
    c0 = s.measure_qubit(0)
    c1 = s.measure_qubit(1)
    s.gate(qt.if_bit(c0, qt.on_just(2, qt.pauli_z(), 3)))
    s.gate(qt.if_bit(c1, qt.on_just(2, qt.pauli_x(), 3)))
    p1 = s.state().prob_one(2)
    log(f"dsl teleportation: c0={c0} c1={c1} P(q2 = 1) = {p1:.6f}")
    check(s.state().state.device.type == DEV, f"dsl state on {s.state().state.device}")
    check(abs(p1 - 0.64) < 1e-5, f"dsl teleportation P(q2 = 1) = {p1} != 0.64")

    n = N_DSL
    g = qt.ident(n)
    for q in range(n):
        g = g.then(qt.on_just(q, qt.hadamard(), n))
        for j in range(q + 1, n):
            g = g.then(qt.controlled(j, qt.on_just(q, qt.phase(math.pi / (1 << (j - q))), n)))
    x = rand_state(n, 21)
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    sv = g(qt.StateVec(n, x))
    sync()
    delta = {k: kernels.launches[k] - before[k] for k in before}
    log(f"dsl qft{n} gate by gate ({len(g.prims)} prims): {time.perf_counter() - t0:.2f} s, "
        f"launches {delta}")
    check(delta["gate"] > 0 and delta["diag"] > 0 and delta["stage"] == 0,
          f"dsl qft{n} gate by gate launched {delta}")
    circ = CompiledCircuit(n, g.prims)
    before = dict(kernels.launches)
    y = circ(x.clone())
    sync()
    delta = {k: kernels.launches[k] - before[k] for k in before}
    log(f"dsl qft{n} compiled: stats {circ.stats()}, launches {delta}")
    check(delta["stage"] > 0, f"dsl qft{n} compiled launched no stage kernel: {delta}")
    err = rel_err(y, sv.state)
    log(f"dsl qft{n}: compiled against gate by gate rel_l2 {err:.3e}")
    check(err <= TOL, f"dsl qft{n}: compiled differs from gate by gate by {err}")


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
                    kernels.KERNEL_FNS[name][1](ref, *args, sv.n)
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


def phase_compiled_plain_compare():
    """Compiled QFT-30 on a random state, against every op of its ``ops``
    applied by the plain versions to a clone."""
    from qubism_torch.models.circuits import qft_prims
    from qubism_torch.ops import fusion, kernels

    n = N_BIG
    t0 = time.perf_counter()
    circ = fusion.CompiledCircuit(n, qft_prims(n))
    s = rand_state(n, 31)
    ref = s.clone()
    for op in circ.ops:
        name, args = fusion.plan(op, n)
        kernels.KERNEL_FNS[name][1](ref, *args, n)
    circ(s)
    sync()
    err = rel_err(s, ref)
    log(f"plain compare compiled qft{n}: rel_l2 {err:.3e} ({time.perf_counter() - t0:.2f} s)")
    check(err <= TOL, f"compiled qft{n}: kernels vs plain rel L2 {err:.3e}")


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

    # each path with the counters set to 0 just before it and read just after
    paths = {"file path": run_main_path, "compiled path": run_compiled_path,
             "DSL": run_dsl_path}
    for label, drive in paths.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kernels.reset_launches()
        drive()
        launches = dict(kernels.launches)
        log(f"phase {label}: {time.perf_counter() - t0:.1f} s, launches {launches}, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        for name in KERNELS:
            report[name]["launches"] += launches[name]
        for name in PATH_KERNELS[label]:
            check(launches[name] > 0, f"the {label} never launched the {name} kernel")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    phase_plain_compare()
    phase_compiled_plain_compare()
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
