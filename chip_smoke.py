#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qubism_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA GPU and nvcc.
It builds the port's CUDA kernels from ``qubism_torch/csrc``, holds each
against its plain PyTorch version on the card (n = 20 and n = 30, relative
L2 <= 1e-5; <= 1e-6 for the lane and diag kernels, every case of theirs at
both widths; the lane kernel also on a 5-qubit state (its small-state
path), on one row and on part of a tile (7 and 10 qubits); the diag kernel
also on states of 0 to 3 qubits, where a thread owns fewer amplitudes)
and times both at n = 28 (diag at three shapes: one 2-qubit factor, 8
factors of 4 qubits, a 27-factor controlled-phase ladder; lane beside one
``torch.matmul``, gate and layer1q beside one ``torch.einsum`` over the
target view, diag beside one ``mul_`` by its 2^n diagonal, each library
call first held against the plain version; a lane or diag call prepares
and uploads its operands, so
their lines also give the kernel on operands prepared once). Then it drives
fifteen paths, each with the launch counters set to 0 just before it and read
just after (a ``phase <path>: diag launches by (factors, widest k)`` line
gives the shapes of its diag passes). The device-operand modes of K1, K4
and K3 (``gate_dev``, ``layer1q_dev``, ``lane_dev``: the matrix read from
device memory) are held against their plain versions and their parameter
modes at n = 20 and 30 (K1 at k = 1..4, K4 at m = 1..6), the lane operand
formed on the card bit for bit against the host one, and both modes timed
at n = 28 (``time n=28 gate dev`` etc.). The paths:

* the OpenQASM file path through ``qubism_torch.cli.eval_file``: the example
  goldens, GHZ-30 and brickwork-30 with 8192 shots, brickwork-30 at depth
  40 (75,776 characters, past the lexer's 2^15: the native C++ lexer of
  ``qubism_torch/native``, built with g++ before the paths, must take it)
  with 8192 shots, QFT-28 and a 28-qubit adder, each checked (``main path
  <program>`` gives the seconds of that first run; after the paths the
  four wide programs run three times more, ``file path warm <program>``,
  and a ``parse brickwork30 depth ..`` line gives, at depths 40 and 100,
  the native and the Python lexer's host ms, their token lists equal, and
  ``parse_openqasm``'s);
* the compiled engine: ``CompiledCircuit`` on QFT-30 (uniform magnitudes,
  warm wall seconds and device ms), QFT-28 at stage groups 2 and 4,
  GHZ-30 and brickwork-30 with 8192 shots, and
  ``eval_file(..., compile_mode=True)`` on the goldens, QFT-28 and the adder,
  each against the file path;
* the DSL: teleportation through ``Session``, and a 20-qubit QFT built from
  ``hadamard`` / ``controlled(phase)``, applied gate by gate and through
  ``CompiledCircuit``.

* the bandwidth probe, ``qubism_torch.experiments.bw_probe``: every variant
  at n = 28 (lines ``probe {...}``), none reading above 105% of the card's
  published 3.35 TB/s;
* the mesh path: ``eval_file(..., mesh=1)`` on GHZ-30 with 8192 shots (one
  shard of two banks, so the H on qubit 0 runs through the butterfly
  kernel), ``ShardedSim`` on QFT-30 against ``CompiledCircuit`` (warm wall
  seconds of both), and a 4-shard mesh placed on the one card (2 device
  bits, 2 bank bits) against the single-device engine, with measurements on
  a device and a bank bit and 8192 shots.

* the observables: Pauli expectations at full width (GHZ-30, the compiled
  QFT-30 state, a brickwork-30 state: single strings and a sum of about 36
  terms, each against P applied to a copy by the gate kernels and an inner
  product in float64), through ``eval_file(..., observables=[...])`` on
  the file path, ``--compile`` and ``mesh=1``; reduced density matrices and
  entropies of GHZ-30; and a ``Repl`` session with a failing line, ``:obs``,
  ``:save`` of a 26-qubit register and ``:load`` in a second ``Repl``;
* the density path: noisy brickwork-14 and GHZ-14 (a 2^28 state) through
  ``eval_file(backend="density", noise=...)`` with observables, shots and a
  dump, against the same programs with every pass applied by the plain
  versions, and ``apply_channel`` against ``apply_channel_plain``;
* the mesh density path: n = 15 as 4 shards of 2^28 on the one card against
  ``DensityMatrix``, and n = 12 entry by entry; ``lindblad_evolve`` on
  ``ShardedDensityMatrix(14)`` (bench.py's damping from |1...1> at rate 0.8
  on qubits 0, 7 and 13 under a ZZ chain, t = 0.5 in 8 steps) on one shard
  and on 4, against the exact law 1 - 2 exp(-0.4) to 1e-3, trace to 1e-4;
* the variational trainer: the kernel adjoint engine against the plain
  sweep at n = 20 (QAOA with chords, the HEA under an XXZ chain; energies
  to 1e-4, gradients to 5e-4) and against float64 numpy at n = 12; QAOA
  MaxCut on a 28-qubit ring at p = 2 (launches per call against
  ``plan_units``, a central difference, device ms by kernel, the call split
  into its parts with the host time of building operands, the peak at p = 1
  and p = 2); two ``vqe_minimize`` steps; the TFIM HVA at n = 24 (the head
  for a non-diagonal H);
* the variational trainer on an amplitude mesh (``models/adjoint_mesh.py``,
  ``mesh=``): QAOA-28 p = 2 through the mesh kernel engine on one shard and
  on 4 shards of the card against the single-buffer engine (|dE|, max |dg|
  < 1e-3, bench.py's pin), warm seconds of the three, the host-timed share
  of the gradient contraction; QAOA-30 over 2 shards of 2^29 against the
  single-buffer engine at n = 30, with both peaks; device-bit rx on 4
  shards at n = 20 against the plain sweep on the shards; three
  ``vqe_minimize(mesh=...)`` steps;
* the dynamics: a TFIM quench at n = 28 through ``evolve_observed`` against
  the same run by the plain versions (to 1e-5; energy kept to 1e-3), and
  imaginary time at n = 12 down to the ground energy (to 1e-3);
* noisy trajectories: the fused engine (``engine="fused"``) on GHZ-28 under
  ``depolarizing:0.002`` and on 28 excited qubits under ``ad:0.05``, 256
  trajectories each after a short warm-up (bench.py's closed-form pins:
  the clean fraction against (1 - 2p/3)^55 and the clean split's chi2; the
  per-qubit chi2 of the decay), with its launches per trajectory, its peak
  against one state plus the batch's operands, and every batch run under
  ``torch.cuda.set_sync_debug_mode("error")`` (no synchronising call
  between a batch's upload and its read-back); a 26-qubit program with a
  mid-circuit measurement, an ``if`` correction and a reset through both
  engines (64 trajectories each; their counts by ``chi2_test``; the
  vmapped engine's peak at 64 trajectories no higher than at one batch);
  the vmapped engine on bench.py's GHZ-16 (512 trajectories, its two pins)
  and its ms per trajectory at n = 26 beside the fused engine's at 26 and
  28 (its peak again held to one batch's); ``eval_file`` in trajectory
  mode (teleportation, ``--observable ZZI`` as mean +- stderr); and
  ``lindblad_mcwf`` at n = 10 against ``lindblad_evolve`` within 4 stderr;
* the stabilizer backend (plain torch, no kernel), at the JAX package's
  bench.py shapes: S1 ``StabilizerSim(1000)`` with H and a CX chain (the
  planes against the same chain on the CPU word for word, 8192 shots all
  equal with a fair split, ``measure_qubits(range(1000))`` in 2 rounds,
  ``<Z0 Z999>`` and ``<X^1000>`` = +1); S2 GHZ-300 under
  ``depolarizing:0.001``, 8192 trajectories on Pauli frames (the clean
  fraction against (1 - 2p/3)^599, the clean split's chi2); S3
  ``repetition_memory(501, 8, 0.003, 4096)`` on 1001 qubits and
  ``repetition_memory(5, 8, 0.05, 4096)`` (consistent syndromes, the
  logical rate against its law); S4 a 1000-qubit program with a
  mid-circuit measurement and an ``if`` correction of every qubit under
  ``bitflip:0.01``, 64 trajectories on the tableau batch (the mean number
  of ones against the closed form of :func:`fallback_law`, and noiseless:
  all zero); and the CLI (``examples/errorCorrection.qasm`` and GHZ-1000
  with 8192 shots). Each of S1-S4 prints its warm seconds (best of 3 after
  a warm-up), its torch ops in total and per gate or layer step (the
  card's own count of kernels from ``torch.profiler`` beside S1's chain),
  its synchronising calls, measurement rounds and peak;
* the MPS backend (plain torch and ``torch.linalg.svd``, no kernel of
  K1-K6; the light-cone oracles run K1/K2), at the JAX package's bench.py
  shapes: GHZ-40 on ``MPSSim(40, chi=4)`` with 512 samples (trunc_error
  exactly 0.0, every row equal, the mean within 0.0663 of 0.5);
  brickwork-100 at depth 4 and chi 16 with 256 samples (trunc_error 0.0,
  ``<Z_0>`` within 1e-4 of a 12-qubit light-cone oracle on the card); 64
  noisy trajectories of it under ``depolarizing:0.001`` (P(q0 = 1) within
  3 sigma + 0.04 of the oracle's); adaptive chi on brickwork-60 at depth 6
  from chi 4 (budget 1e-6, max_chi 64; the final chi, its rollbacks,
  ``<Z_0>`` against the oracle); and the CLI (teleportation with
  ``--dump-state`` and shots, a 64-qubit GHZ on the stabilizer and mps
  backends). Each part prints its first-call and warm seconds, its tape
  rows by opcode, torch ops (per row of the tape replay), synchronising
  calls (``torch.cuda.set_sync_debug_mode("warn")``), SVDs by shape, the
  ops that left a tensor on the CPU (no SVD or product may) and its peak;
* the protocol models: linear XEB of brickwork-30 (8192 samples) against
  2^n sum p^2 - 1 summed on the card; grouped shot estimation on the
  QAOA-28 state (4096 shots a group) against ``expectation_pauli_sum``;
  classical shadows at n = 20; MLAE at n = 16; Shor's factors of 15 and 21
  and its order-finding circuits; quantum volume at m = 6 (density against
  trajectories); 2-qubit RB against the depolarizing law; simultaneous RB
  on 100 qubits (Pauli frames); ZNE on GHZ-12. Each line gives its seconds.

After the paths, the stream probes are timed beside their library call,
alternately in one window, three rounds (``probe beside library`` lines):
the copy kernel at 256x1, 256x4 and 1024x4 beside ``copy_``,
``read_256x4`` beside ``torch.sum``, the phase in place at 256x1, 256x4
and 1024x4 beside ``mul_``, ``phase_out_256x4`` beside ``torch.mul(...,
out=)`` and ``write_256x4`` beside ``fill_``.

The butterfly kernel (K6) is held against its plain version at 2^20 and
2^30 amplitudes in 2, 4 and 16 banks and timed at 2^28 beside one
``torch.matmul``. The probe kernels are held against their plain
versions like the others (copy and write exactly; the read probe's sum
within 1e-5 of the sum of magnitudes; copy, read, the phase in place and
into a second buffer, and write also on states of 2, 8 and 512
amplitudes, smaller than a tile, and with a tile of 96 x 2 float4s; three
reads of one state bit for bit equal; the read of a state
whose parts all lie in [0.25, 0.75) within 2e-7 of its float64 sum). The
counters show which kernels each path went through. The 30- and 28-qubit
programs are then run again with every fused pass also applied by the
plain versions, and the states compared.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``; the line before it lists the kernels,
each with its bound (the least time of one H100 SXM for the bytes and
float32 operations of the timed call; for the lane kernel, three TF32
products on the tensor cores) and, where one PyTorch call computes
the same function, that call's time; ``dev_ms`` is the device-operand
mode's time for gate, layer1q and lane (null for the others). Any failed
check exits non-zero without that line. No JAX is imported.
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
#: the same for the lane and diag kernels (the accuracy of the plain fp32
#: product, which the three TF32 products of the lane kernel must keep)
TOL_TIGHT = 1e-6
TIGHT = ("lane", "diag")
DEV = "cuda"
#: widths: kernel checks, timing, the 30-qubit GHZ/brickwork/QFT, QFT, adder
#: operands, the DSL's QFT
N_CHECK, N_WIDE, N_TIME, N_BIG, N_QFT, ADDER_WIDTH, N_DSL = 20, 30, 28, 30, 28, 13, 20
#: a state of fewer amplitudes than one lane block, and one of fewer rows
#: than a tile of the lane kernel
N_SMALL, N_PART = 5, 10
SHOTS = 8192
#: brickwork-30 depths whose text is past the lexer's native threshold (2^15
#: characters): the file path runs the first; the parse line times both
BW_DEEP, BW_DEEPER = 40, 100
#: the density engine's widths (one buffer; 4 shards; the entry-by-entry
#: check), the REPL's saved register, and the noise of the density programs
N_DENS, N_DENS_MESH, N_DENS_SMALL, N_REPL = 14, 15, 12, 26
NOISE = "dep:0.01,ad:0.02,pd:0.01,dep2:0.02"
#: device memory the expectation functions may take beside the state
OBS_SLACK_GIB = 1.5
MESH_DENS_PEAK_GIB = 12.0
#: the variational path's widths: the kernel engine against the plain one,
#: against float64 numpy, QAOA MaxCut on a ring (the JAX package's bench
#: config, p = 2), the TFIM HVA; and the Adam steps of vqe_minimize
N_VAR, N_VAR_REF, N_QAOA, N_HVA, VQE_STEPS = 20, 12, 28, 24, 2
#: tolerances of the engines against each other (tests/test_variational.py's)
#: and against the float64 reference (relative to the largest |value| where
#: that is above 1: a float32 state carries about 7 digits, so a gradient
#: entry of 11 holds to ~1e-5 and no closer)
VAR_E_TOL, VAR_G_TOL, VAR_REF_TOL = 1e-4, 5e-4, 1e-5
#: device memory the adjoint engine may take beside 4 states, and the most
#: its peak may grow from p = 1 to p = 2
VAR_SLACK_GIB, VAR_DEPTH_GIB = 1.5, 0.25
#: the dynamics path: a TFIM quench from |0...0> (width, time, Trotter
#: steps), and imaginary time from |+...+> (width, tau, steps)
N_DYN, DYN_T, DYN_STEPS = 28, 0.08, 4
#: the quench's observables by the kernels against the plain versions,
#: relative to max(1, |value|) (float32 states: about 7 digits of <H>)
DYN_TOL = 1e-5
N_ITE, ITE_TAU, ITE_STEPS = 12, 8.0, 100
#: the trajectory path: the fused engine's width, trajectories, depolarizing
#: and amplitude-damping rates (bench.py's cases at 28 qubits); the
#: feed-forward program's width and trajectories through each engine; the
#: vmapped engine's GHZ (bench.py's 16 qubits, 512 trajectories) and its
#: timed width and trajectories; lindblad_mcwf's width and trajectories
N_TRAJ, TRAJ_T, TRAJ_P, TRAJ_AD = 28, 256, 0.002, 0.05
N_TRAJ_FF, TRAJ_FF_T = 26, 64
N_TRAJ_VMAP, TRAJ_VMAP_T, N_TRAJ_VMAP_WIDE, TRAJ_VMAP_WIDE_T = 16, 512, 26, 8
N_LINDBLAD, LINDBLAD_T = 10, 256
#: the stabilizer path, at the JAX package's benchmark shapes (bench.py):
#: S1 the tableau's width and shots; S2 the frames' GHZ width, trajectories
#: and depolarizing rate; S3 the QEC memory's distance, rounds, bit-flip
#: rate and trajectories; S4 the tableau batch's width, trajectories and
#: bit-flip rate
N_STAB, STAB_SHOTS = 1000, 8192
N_FRAMES, FRAMES_T, FRAMES_P = 300, 8192, 0.001
QEC_D, QEC_ROUNDS, QEC_P, QEC_T = 501, 8, 0.003, 4096
N_FALLBACK, FALLBACK_T, FALLBACK_P = 1000, 64, 0.01
#: the mps path, at the JAX package's benchmark shapes (bench.py): GHZ-40's
#: chi and samples; brickwork-100's depth, chi and samples, the light-cone
#: oracle's width; the noisy trajectories and their noise; adaptive chi on
#: brickwork-60 at depth 6 (budget, ceiling); the CLI's GHZ width
N_MPS_GHZ, MPS_GHZ_CHI, MPS_GHZ_SHOTS = 40, 4, 512
N_MPS_BW, MPS_BW_DEPTH, MPS_BW_CHI, MPS_BW_SHOTS, MPS_CONE = 100, 4, 16, 256, 12
MPS_NOISY_T, MPS_NOISE = 64, "depolarizing:0.001"
N_MPS_ADAPT, MPS_ADAPT_DEPTH, MPS_BUDGET, MPS_MAX_CHI = 60, 6, 1e-6, 64
N_MPS_CLI = 64
#: device memory the fused engine may take beside one state and its batch's
#: operands (the lane operand, the sample's row masses, small tables); and
#: the most the vmapped engine's peak may grow from one batch to many
TRAJ_SLACK_GIB = 0.25
#: the variational mesh path: QAOA at n = N_MESH_WIDE over 2 shards of
#: 2^29 (the widest block without banks), device-bit rx gates on 4 shards at
#: n = N_MESH_RX, the Adam steps of vqe_minimize(mesh=...), and the mesh
#: engine against the single-buffer one (bench.py's pin)
N_MESH_WIDE, N_MESH_RX, VQE_MESH_STEPS, MESH_TOL = 30, 20, 3, 1e-3
#: the sharded Lindblad (bench.py's): width, damping rate, time, Trotter steps
N_LIND_MESH, LIND_RATE, LIND_T, LIND_STEPS = 14, 0.8, 0.5, 8
#: the protocols path: XEB's samples, the estimator's shots a group, the
#: shadows' width and snapshots, MLAE's width, quantum volume's width and
#: circuits, simultaneous RB's width, ZNE's width
XEB_SHOTS, EST_SHOTS = 8192, 4096
N_SHADOW, SHADOW_T, N_MLAE, QV_M, QV_CIRCUITS, N_SRB, N_ZNE = 20, 2048, 16, 6, 5, 100, 12
#: the stream probes timed beside their library call in one window: every
#: variant of the stream kernels (P1-P5, P11)
PROBE_LIBRARY_ROWS = ("phase_256x1", "phase_256x4", "phase_1024x4", "phase_out_256x4",
                      "copy_256x1", "copy_256x4", "copy_1024x4", "read_256x4", "write_256x4")

#: kernel name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "gate": ("qubism_torch/csrc/gate.cu", "qubism_tpu/ops/kernels.py:256"),
    "diag": ("qubism_torch/csrc/diag.cu", "qubism_tpu/ops/kernels.py:819"),
    "lane": ("qubism_torch/csrc/lane.cu",
             "qubism_tpu/ops/kernels.py:894; experiments/bw_probe.py:506 (P10)"),
    "layer1q": ("qubism_torch/csrc/layer1q.cu", "qubism_tpu/ops/kernels.py:483"),
    "stage": ("qubism_torch/csrc/stage.cu",
              "qubism_tpu/ops/kernels.py:256 (stage 1-4; stage_block_prepare :1041)"),
    "butterfly": ("qubism_torch/csrc/butterfly.cu", "qubism_tpu/ops/kernels.py:944"),
    "probe_stream": ("qubism_torch/csrc/probe_stream.cu",
                     "experiments/bw_probe.py:50, :157, :220, :573 (P1, P3, P5, P11)"),
    "probe_copy": ("qubism_torch/csrc/probe_stream.cu", "experiments/bw_probe.py:81 (P2)"),
    "probe_read": ("qubism_torch/csrc/probe_stream.cu", "experiments/bw_probe.py:189 (P4)"),
    "probe_pair": ("qubism_torch/csrc/probe.cu",
                   "experiments/bw_probe.py:258, :300, :351, :456 (P6-P9)"),
}
#: the kernels each driven path must launch
PATH_KERNELS = {
    "file path": ("gate", "diag", "lane", "layer1q"),
    "compiled path": ("gate", "diag", "lane", "layer1q", "stage"),
    "DSL": ("gate", "diag", "lane", "stage"),
    "bandwidth probe": ("probe_stream", "probe_copy", "probe_read", "probe_pair", "lane"),
    "mesh path": ("butterfly", "gate", "diag", "lane", "stage"),
    "observables": ("gate", "diag", "lane", "stage"),
    "density path": ("gate", "diag", "lane"),
    "mesh density path": ("gate", "diag"),
    "variational": ("gate", "diag", "lane", "layer1q"),
    "variational mesh": ("diag", "lane", "layer1q"),
    "dynamics": ("diag", "lane", "layer1q"),
    "trajectories": ("gate", "lane", "layer1q"),
    # plain torch, as the reference's stabilizer engine is plain XLA
    "stabilizer": (),
    # plain torch and the library SVD, as the reference's MPS engine is plain XLA
    "mps": (),
    "protocols": ("gate", "diag", "lane", "layer1q"),
}
#: the port's kernels of the variational path, by their names in the
#: library (device time of a profiled engine call is split by these)
ENGINE_KERNELS = ("gate_kernel", "diag_kernel", "diag1_kernel", "diag_scalar_kernel",
                  "lane_wgmma_kernel", "lane_small_kernel", "layer1q_kernel")
#: the PyTorch call each kernel's ``library_ms`` times (:func:`library_call`)
LIBRARY = {"gate": "torch.einsum", "layer1q": "torch.einsum", "diag": "mul_ by the diagonal",
           "lane": "torch.matmul"}
#: the butterfly kernel's bank counts, and the one whose time fills its row
#: (the mesh path's: one card holds 30 qubits as 2 banks of 2^29)
BFLY_SIZES, BFLY_ROW = (2, 4, 16), 2
#: the bandwidth probe's variants whose times fill the probe kernels' rows
PROBE_ROWS = {"probe_stream": "phase_256x4", "probe_copy": "copy_256x1",
              "probe_read": "read_256x4", "probe_pair": "pair_q5"}
#: states smaller than a tile of the stream kernels (all of the pass is the
#: predicated tail), and a tile that is not a power of two
N_TAILS = (1, 3, 9)
ODD_GEOMETRY = (96, 2)
#: the read of a state whose parts all lie in [0.25, 0.75) against its
#: float64 sum, relative: the float32 result rounds by up to 6e-8, and at
#: n = 30 one tile of 256x4 is 1.9e-6 of the sum, so a tile dropped or read
#: twice fails
READ_POSITIVE_TOL = 2e-7


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


def card_mesh(shards):
    """``shards`` shards placed on the one device (a device may repeat)."""
    import torch

    return (torch.device(DEV, 0) if DEV == "cuda" else torch.device(DEV),) * shards


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


def diag_cases(n, rng):
    """Factor lists for the diag kernel at n qubits: the mixed case first
    (low, middle and high targets and the full lane table), a one-point
    diagonal wide enough for the host split, one factor of 1 and of 2 qubits
    (on index bit 0, on a thread bit, on high bits: the kernel without
    descriptors), a 64-factor pass, factors that all hold the last qubit
    (nothing a thread can hoist), the mesh path's ladder (n - 1 two-qubit
    factors sharing qubit 0), and 33 seven-qubit tables (two launches)."""
    import numpy as np

    hi = n - 1

    def ph(k):
        return np.exp(1j * rng.uniform(0, 2 * math.pi, 1 << k))

    one_point = np.ones(256, dtype=complex)
    one_point[int(rng.integers(256))] = -1
    cases = [
        ((np.array([1, 1, 1, -1], dtype=complex), (0, hi)), (ph(3), (2, n // 2, hi - 1)),
         (ph(4), (n - 9, n - 8, n - 7, n - 6)), (ph(7), tuple(range(n - 7, n)))),
        ((one_point, (0, 3, n // 2, n - 8, n - 6, n - 4, n - 2, hi)),),
    ]
    cases += [((ph(len(t)), t),) for t in
              [(hi,), (hi - 6,), (0,), (2, hi), (hi - 7, hi - 6), (1, 0)]]
    cases.append(tuple((ph(1 + f % 2), ((f * 7) % n,) if f % 2 == 0
                        else ((f * 7) % n, (f * 7 + 3) % n)) for f in range(64)))
    cases.append(tuple((ph(3), (hi - 5 - f, hi - 3 + f % 3, hi)) for f in range(5))
                 + ((ph(4), (hi - 3, hi - 2, hi - 1, hi)),))
    cases.append(tuple((np.array([1, 1, 1, np.exp(1j * math.pi / (1 << min(j, 40)))]), (0, j))
                       for j in range(1, n)))
    cases.append(tuple((ph(7), tuple(sorted(int(q) for q in rng.choice(n, 7, replace=False))))
                       for _ in range(33)))
    return cases


def lane_matrices(n, rng):
    """Lane-block matrices at n >= 7 qubits: a dense 7-qubit unitary first, a
    1- and a 2-qubit gate expanded over the block, a permutation (a CX
    chain), and a matrix whose entries span magnitudes 1e-4 .. 1 (where one
    TF32 product would lose the small ones)."""
    import numpy as np

    from qubism_torch.ops.apply import expand_for_view

    out = [expand_for_view(unitary(len(t), rng), n, t)
           for t in [tuple(range(n - 7, n)), (n - 1,), (n - 6, n - 2)]]
    cx = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
    chain = np.eye(128, dtype=complex)
    for q in range(n - 7, n - 1):
        chain = expand_for_view(cx, n, (q, q + 1)) @ chain
    out.append(chain)
    out.append(10.0 ** rng.uniform(-4, 0, (128, 128))
               * np.exp(1j * rng.uniform(0, 2 * math.pi, (128, 128))))
    return out


def kernel_cases(n, rng):
    """(kernel name, operand args) cases at n qubits: gates on low, middle
    and high targets and permutation blocks, :func:`diag_cases`,
    :func:`lane_matrices`, 1q layers, and stage blocks of k = 4, 1, 2, 3
    stages (one with d[2] != 1, one with a sparse ladder)."""
    import numpy as np

    from qubism_torch.ops import kernels as K

    cx = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
    ccx = np.eye(8, dtype=complex)[[0, 1, 2, 3, 4, 5, 7, 6]]
    hi = n - 1
    cases = []
    for t in [(0,), (n // 2,), (hi,), (2, n - 5), (0, n // 2, hi), (1, 2, n - 9, n - 8)]:
        cases.append(("gate", (unitary(len(t), rng), t)))
    cases.append(("gate", (cx, (3, hi - 2))))
    cases.append(("gate", (ccx, (1, n // 2, hi))))
    cases += [("diag", (factors,)) for factors in diag_cases(n, rng)]
    cases += [("lane", (u,)) for u in lane_matrices(n, rng)]
    for qs in [(0, 1, 2, 3), (0, 3, n // 2, n - 9, n - 8), (1, 4, 7, n - 11, n - 9, n - 8)]:
        cases.append(("layer1q", (tuple((unitary(1, rng), q) for q in qs),)))
    # k = 4 first (the one case at n = 30): at q0 = 1 its ladders reach
    # index bit n - 6, which takes the most table chunks
    for q0, k, opts in [(1 if n > N_CHECK else n - 11, 4, {}), (0, 1, {}),
                        (3, 2, {"off_one": True}), (5, 3, {"stride": 3})]:
        stages = stage_stages(n, q0, k, rng, **opts)
        cases.append(("stage", (K.stage_block_prepare(stages, n, DEV),)))
    return cases


#: kernel launches made inside time_ms, and by the single-device engine
#: computing a mesh run's reference, per kernel (a path's launches less
#: these are the path's own work)
TIMED = {}
REFERENCE = {}


def tally(counts, fn):
    """Run ``fn()``, adding the kernel launches it makes to ``counts``."""
    from qubism_torch.ops import kernels

    before = dict(kernels.launches)
    out = fn()
    for k, v in kernels.launches.items():
        counts[k] = counts.get(k, 0) + v - before[k]
    return out


#: the largest device memory a :func:`peak_gib` call saw since the path began
PEAK = [0]


def peak_gib(fn):
    """(fn(), the peak device memory in GiB while it ran); the path's own
    peak is kept in PEAK across the reset."""
    import torch

    if DEV != "cuda":
        return fn(), 0.0
    PEAK[0] = max(PEAK[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    sync()
    peak = torch.cuda.max_memory_allocated()
    PEAK[0] = max(PEAK[0], peak)
    return out, peak / 2**30


def warm_ms(fn):
    """Host milliseconds of a second ``fn()`` call (the first, which
    :func:`peak_gib` made, paid for library start-up), synchronised."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def held_gib():
    import torch

    return torch.cuda.memory_allocated() / 2**30 if DEV == "cuda" else 0.0


def inner64(a, b):
    """<a|b> accumulated in float64, 2^24 amplitudes at a time."""
    import torch

    acc = torch.zeros((), dtype=torch.complex128, device=a.device)
    step = 1 << 24
    for i in range(0, a.numel(), step):
        acc += torch.sum(a[i:i + step].conj().to(torch.complex128) * b[i:i + step])
    return complex(acc.item())


def pauli_by_gates(state, pauli, n):
    """<psi|P|psi> a second way: P applied to a copy of the state letter by
    letter through the appliers (the gate, lane and diag kernels), then the
    inner product in float64. Its launches are counted in REFERENCE."""
    import numpy as np

    from qubism_torch.ops import apply as A

    mats = {"X": np.array([[0, 1], [1, 0]]), "Y": np.array([[0, -1j], [1j, 0]])}

    def run():
        psi = state.clone()
        for q, c in enumerate(pauli):
            if c == "Z":
                A.apply_diag(psi, np.array([1, -1]), (q,), n)
            elif c in mats:
                A.apply_gate(psi, mats[c], (q,), n)
        return inner64(state, psi).real

    return tally(REFERENCE, run)


class plain_kernels:
    """While active, the gate, lane, diag and layer1q wrappers run their
    plain versions, called by name or through ``KERNEL_FNS`` (for a whole
    run held against the kernels' run)."""

    NAMES = ("gate", "lane", "diag", "layer1q")

    def __enter__(self):
        from qubism_torch.ops import kernels

        self.saved = {k: getattr(kernels, k) for k in self.NAMES}
        self.saved_fns = dict(kernels.KERNEL_FNS)
        for k in self.NAMES:
            plain = kernels.KERNEL_FNS[k][1]
            setattr(kernels, k, plain)
            kernels.KERNEL_FNS[k] = (plain, plain)

    def __exit__(self, *exc):
        from qubism_torch.ops import kernels

        for k, f in self.saved.items():
            setattr(kernels, k, f)
        kernels.KERNEL_FNS.update(self.saved_fns)


class counted_plain:
    """While active, counts the calls of the plain versions of the gate,
    lane and diag kernels in ``calls`` (a kernel's run must make none on a
    CUDA tensor)."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        from qubism_torch.ops import kernels

        self.saved = {}
        for k in plain_kernels.NAMES:
            name = f"{k}_plain"
            self.saved[name] = getattr(kernels, name)

            def counting(*a, _f=self.saved[name], **kw):
                self.calls += 1
                return _f(*a, **kw)

            setattr(kernels, name, counting)
        return self

    def __exit__(self, *exc):
        from qubism_torch.ops import kernels

        for name, f in self.saved.items():
            setattr(kernels, name, f)


def device_ms(fn, reps=5):
    """Device milliseconds per ``fn()`` call: one warm-up call, then CUDA
    events around ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_ms(fn, state, reps=5):
    """:func:`device_ms` of ``fn(state)``; the launches it makes are added
    to TIMED."""
    return tally(TIMED, lambda: device_ms(lambda: fn(state), reps))


def kernel_cost(name, args, n):
    """(bytes, float32 operations) one call of kernel ``name`` needs on these
    operands: every amplitude read and written once plus the operands read
    once; a complex multiply-add is 8 operations, a complex product 6. (The
    lane kernel runs each of its operations as three TF32 products:
    ``probes.bound(..., tf32x3=True)``.)"""
    import numpy as np

    amps = 1 << n
    if name == "gate":
        d = 1 << len(args[1])
        return 16 * amps + 8 * d * d, 8 * d * amps
    if name == "layer1q":
        m = len(args[0])
        return 16 * amps + 32 * m, 16 * m * amps
    if name == "diag":  # each factor's product, then one into the amplitude
        factors = args[0]
        tables = sum(np.asarray(d).size for d, _ in factors)
        return 16 * amps + 8 * tables, 6 * (len(factors) + 1) * amps
    if name == "lane":
        lanes = 1 << min(n, 7)
        return 16 * amps + 8 * lanes * lanes, 8 * lanes * amps
    if name == "stage":  # per group of 2^k: C x, the phase lookups, the phases
        plan = args[0]
        k, d = len(plan.targets), 1 << len(plan.targets)
        groups = amps // d
        ops = 8 * d * d + 6 * k * plan.chunks + 6 * k * d // 2
        return 16 * amps + 8 * (d * d + plan.tables.size), ops * groups
    if name == "butterfly":  # 2^n amplitudes over S banks: S complex MACs each
        S = args[0].u.shape[0]
        return 16 * amps + 8 * S * S, 8 * S * amps
    raise ValueError(name)


def einsum_spec(n, targets, k_ops):
    """Index letters for one ``torch.einsum`` of gates over the target view
    of an n-qubit state: (the view's dims, the operands' subscripts, the
    state's subscript, the result's). ``k_ops`` = the qubits of each gate
    operand, in the order of ``targets``."""
    from qubism_torch.ops.apply import target_view

    dims, axes = target_view(n, tuple(targets))
    letters = iter("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
    state = [next(letters) for _ in dims]
    result = list(state)
    new = {a: next(letters) for a in axes}
    for a in axes:
        result[a] = new[a]
    subs, i = [], 0
    for k in k_ops:
        own = axes[i:i + k]
        subs.append("".join(new[a] for a in own) + "".join(state[a] for a in own))
        i += k
    return dims, subs, "".join(state), "".join(result)


def library_call(name, args, n):
    """``fn(state)``: one PyTorch call computing what kernel ``name``
    computes on these operands (the yardstick of ``library_ms``), returning
    the result, or None where no single call does (the stage kernel; the
    lane and butterfly rows time ``torch.matmul`` where they are timed).
    gate: one ``torch.einsum`` of U over the target view, into a new tensor;
    layer1q: one ``torch.einsum`` of the m 2 x 2 matrices over the m-target
    view; diag: one ``mul_`` by the 2^n diagonal, multiplied out beforehand,
    in place as the kernel."""
    import numpy as np
    import torch

    from qubism_torch.ops import kernels as K

    if name == "gate":
        u, targets = args
        k = len(targets)
        dims, (sub,), st, res = einsum_spec(n, targets, [k])
        ut = torch.from_numpy(np.asarray(u, dtype=np.complex64).reshape((2,) * 2 * k)).to(DEV)
        return lambda s: torch.einsum(f"{sub},{st}->{res}", ut, s.view(dims)).reshape(-1)
    if name == "layer1q":
        (gates,) = args
        order = sorted(range(len(gates)), key=lambda i: gates[i][1])
        dims, subs, st, res = einsum_spec(n, [gates[i][1] for i in order], [1] * len(gates))
        us = [torch.from_numpy(np.asarray(gates[i][0], dtype=np.complex64)).to(DEV)
              for i in order]
        spec = ",".join(subs) + f",{st}->{res}"
        return lambda s: torch.einsum(spec, *us, s.view(dims)).reshape(-1)
    if name == "diag":
        d = torch.ones(1 << n, dtype=torch.complex64, device=DEV)
        K.diag_plain(d, args[0], n)
        return lambda s: s.mul_(d)
    return None


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels(report):
    """Each kernel against its plain version on the card, then timed."""
    import numpy as np
    import torch

    from qubism_torch.ops import kernels as K
    from qubism_torch.ops import probes as P

    rng = np.random.default_rng(2024)

    def hold(name, args, n, seed, label):
        tol = TOL_TIGHT if name in TIGHT else TOL
        s = rand_state(n, seed)
        ref = s.clone()
        K.KERNEL_FNS[name][1](ref, *args, n)
        K.KERNEL_FNS[name][0](s, *args, n)
        sync()
        err = rel_err(s, ref)
        abs_err = float((s - ref).abs().max())
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], abs_err)
        log(f"kernel {name} n={n} {label}: rel_l2={err:.3e} max_abs={abs_err:.3e}")
        check(err <= tol, f"{name} disagrees with its plain version at n={n} "
                          f"{label}: rel L2 {err:.3e} > {tol}")

    for n in (N_CHECK, N_WIDE):
        cases = kernel_cases(n, rng)
        if n == N_WIDE:  # at full width: every lane and diag case, one of the others
            seen, picked = set(), []
            for name, args in cases:
                if name in TIGHT or name not in seen:
                    seen.add(name)
                    picked.append((name, args))
            cases = picked
        for i, (name, args) in enumerate(cases):
            hold(name, args, n, 100 * n + i, f"case {i}")
    # a state smaller than one lane block: the lane kernel's small-state
    # path; and 8 rows: one partly filled tile of the tensor-core kernel
    hold("lane", (unitary(N_SMALL, rng),), N_SMALL, 55, "small state")
    hold("lane", (unitary(7, rng),), N_PART, 56, "part of a tile")
    hold("lane", (unitary(7, rng),), 7, 57, "one row")
    # the diag kernel with 0, 1 and 2 thread bits (several factors on a state
    # of 1 to 3 qubits), and on a state of one amplitude
    for n in (1, 2, 3):
        factors = tuple((np.exp(1j * rng.uniform(0, 2 * math.pi, 1 << len(t))), t)
                        for t in [(0,), (n - 1,), (0, n - 1)[:n], tuple(range(n))])
        hold("diag", (factors,), n, 60 + n, f"{len(factors)} factors")
    hold("diag", (((np.exp(0.7j) * np.ones(1), ()), (np.exp(-0.2j) * np.ones(1), ())),), 0, 60,
         "scalar factors")

    if DEV != "cuda":
        return
    from qubism_torch.ops.fusion import STAGE_GROUP

    n = N_TIME
    # (label, kernel, operands); the stage kernel at k = 2 and k = 4 (QFT
    # stages on qubits 0..k-1, full ladders), reported at the default group
    cu1 = np.array([1, 1, 1, np.exp(0.3j)])
    timed = [
        ("gate", "gate", (unitary(4, rng), (2, 9, 15, 20))),
        ("diag", "diag", (tuple((np.exp(1j * rng.uniform(0, 2 * math.pi, 16)),
                                 (q, q + 5, q + 11, 27 - q)) for q in range(8)),)),
        ("diag 1 factor of 2 qubits", "diag", (((cu1, (3, 17)),),)),
        (f"diag ladder of {n - 1}", "diag", (tuple(
            (np.array([1, 1, 1, np.exp(1j * math.pi / (1 << j))]), (0, j))
            for j in range(1, n)),)),
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
        prepared = None
        if name in TIGHT:  # operands uploaded once, as a compiled circuit holds them
            held = (K.lane_prepare if name == "lane" else K.diag_prepare)(*args, n, DEV)
            prepared = time_ms(lambda st: K.KERNEL_FNS[name][0](st, held, n), s)
        bound_ms, bound_by = P.bound(*kernel_cost(name, args, n), tf32x3=name == "lane")
        lms = None
        if name == "lane":  # the same product as one torch.matmul
            ut = torch.from_numpy(np.ascontiguousarray(args[0].T, dtype=np.complex64)).to(DEV)
            buf = torch.empty_like(s).view(-1, 128)
            lms = time_ms(lambda st: torch.matmul(st.view(-1, 128), ut, out=buf), s)
            del buf
        elif label == name and (lib := library_call(name, args, n)) is not None:
            ref = s.clone()
            K.KERNEL_FNS[name][1](ref, *args, n)
            err = rel_err(lib(s.clone()), ref)
            del ref
            check(err <= TOL, f"{LIBRARY[name]} differs from the plain {name} by {err:.3e}")
            lms = time_ms(lib, s)
            del lib
        if label in (name, f"stage k={STAGE_GROUP}"):
            report[name].update(ms=kms, plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=lms)
        log(f"time n={n} {label}: kernel {kms:.3f} ms ({gb / kms * 1e3:.1f} GB/s), "
            f"plain {pms:.3f} ms ({gb / pms * 1e3:.1f} GB/s), bound {bound_ms:.3f} ms "
            f"({bound_by}; {bound_ms / kms:.1%} of it)"
            + (f", {LIBRARY[name]} {lms:.3f} ms" if lms is not None else "")
            + (f", kernel on prepared operands {prepared:.3f} ms" if prepared else ""))
    del s
    torch.cuda.empty_cache()


def phase_butterfly(report):
    """K6 against its plain version at 2^N_CHECK and 2^N_WIDE amplitudes
    split into S banks (contiguous views of one state), then timed at
    2^N_TIME with its plain version and one torch.matmul of U by the
    (S, 2^n / S) stack of the banks."""
    import numpy as np
    import torch

    from qubism_torch.ops import kernels as K
    from qubism_torch.ops import probes as P

    rng = np.random.default_rng(2026)
    for n in (N_CHECK, N_WIDE):
        for S in BFLY_SIZES:
            m = n - S.bit_length() + 1
            plan = K.shard_butterfly_prepare(unitary(S.bit_length() - 1, rng), DEV)
            s = rand_state(n, 900 + n + S)
            ref = s.clone()
            K.shard_butterfly_plain(list(ref.view(S, -1)), plan, m)
            K.shard_butterfly(list(s.view(S, -1)), plan, m)
            sync()
            err = rel_err(s, ref)
            abs_err = float((s - ref).abs().max())
            report["butterfly"]["max_abs_err"] = max(report["butterfly"]["max_abs_err"], abs_err)
            log(f"kernel butterfly n={n} S={S}: rel_l2={err:.3e} max_abs={abs_err:.3e}")
            check(err <= TOL, f"butterfly disagrees with its plain version at n={n} S={S}: "
                              f"rel L2 {err:.3e} > {TOL}")
            del s, ref
    if DEV != "cuda":
        return
    n = N_TIME
    s = rand_state(n, 77)
    buf = torch.empty_like(s)
    for S in BFLY_SIZES:
        m = n - S.bit_length() + 1
        plan = K.shard_butterfly_prepare(unitary(S.bit_length() - 1, rng), DEV)
        banks = list(s.view(S, -1))
        kern = lambda b, plan=plan, m=m: K.shard_butterfly(b, plan, m)  # noqa: E731
        plain = lambda b, plan=plan, m=m: K.shard_butterfly_plain(b, plan, m)  # noqa: E731
        p1 = time_ms(plain, banks)
        k1 = time_ms(kern, banks)
        k2 = time_ms(kern, banks)
        p2 = time_ms(plain, banks)
        kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
        u = torch.from_numpy(plan.coef).to(DEV)
        lms = time_ms(lambda x, u=u, S=S: torch.matmul(u, x.view(S, -1), out=buf.view(S, -1)), s)
        bound_ms, bound_by = P.bound(*kernel_cost("butterfly", (plan,), n))
        if S == BFLY_ROW:
            report["butterfly"].update(ms=kms, plain_ms=pms, bound_ms=bound_ms,
                                       bound_by=bound_by, library_ms=lms)
        log(f"time n={n} butterfly S={S}: kernel {kms:.3f} ms "
            f"({16 * (1 << n) / 1e9 / kms * 1e3:.1f} GB/s), plain {pms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}; {bound_ms / kms:.1%} of it), "
            f"torch.matmul {lms:.3f} ms")
    del s, buf
    torch.cuda.empty_cache()


def probe_cases(n, rng):
    """(kernel, label, kernel call, plain call, exact) cases of the probe
    kernels at n qubits; each call takes a fresh copy of the state and
    returns what it wrote (read: the sum). Every stream mode (the phase in
    place and into a second buffer) in four tiles at every n; the pair
    probe from N_CHECK on, in full below N_WIDE."""
    import numpy as np
    import torch

    from qubism_torch.experiments.bw_probe import STREAM_KERNEL
    from qubism_torch.ops import probes as P

    def stream_case(mode, second, geometry):
        def call(fn, **kw):
            return lambda x: fn(x, mode, n, torch.empty_like(x) if second else None, **kw)

        label = f"{mode}{' out' if second else ''} {geometry[0]}x{geometry[1]}"
        return (STREAM_KERNEL[mode], label, call(P.stream, geometry=geometry),
                call(P.stream_plain), mode in ("copy", "write"))

    def table(size):
        t = np.exp(1j * rng.uniform(0, 2 * math.pi, size)).astype(np.complex64)
        return torch.from_numpy(t).to(DEV)

    def pair_case(q, coef, tables="", phase=P.PHASE, cols=2048, second=False,
                  geometry=P.DEFAULT_GEOMETRY):
        tail = 1 << (n - 1 - q)
        C = min(cols, tail)
        kw = dict(phase=phase, cols=cols, row=table(tail // C) if "row" in tables else None,
                  lane=table(C) if "lane" in tables else None)

        def call(fn, **extra):
            return lambda x: fn(x, q, coef, n, out=torch.empty_like(x) if second else None,
                                **kw, **extra)

        label = f"pair q={q} {tables or 'const'}{' out' if second else ''} " \
                f"{geometry[0]}x{geometry[1]}"
        return ("probe_pair", label, call(P.pair, geometry=geometry), call(P.pair_plain), False)

    tiled = [stream_case(mode, second, g)
             for mode, second in (("copy", True), ("read", False), ("phase", False),
                                  ("phase", True), ("write", False))
             for g in ((256, 1), (256, 4), (1024, 4), ODD_GEOMETRY)]
    if n in N_TAILS:
        return tiled
    h = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
    cases = [pair_case(5, unitary(1, rng), "row lane")]
    if n < N_WIDE:
        cases += [stream_case("write", True, (128, 2)),
                  pair_case(0, h, cols=64, tables="row lane", geometry=(512, 4)),
                  pair_case(n // 2, h), pair_case(n - 10, h, phase=1, geometry=(256, 1)),
                  pair_case(n - 2, unitary(1, rng), "lane", geometry=(128, 2)),
                  pair_case(n - 1, unitary(1, rng), "row", second=True)]
    return tiled + cases


def phase_probe_kernels(report):
    """The probe kernels against their plain versions on the card: copy
    and write exactly, phase and pair to TOL in relative L2, the read sum to
    TOL times the sum of magnitudes; the stream kernels also on states
    smaller than a tile (N_TAILS). Three reads of one state back to back
    must give the same sum bit for bit (the read kernel's ticket counter is
    reset by each call, and its partials are added in a fixed order). A random
    state's sum is near 0 against its sum of magnitudes, so the read is
    also held to READ_POSITIVE_TOL of the float64 sum of a state whose
    parts all lie in [0.25, 0.75), where any part left out or added twice
    shows."""
    import numpy as np
    import torch

    from qubism_torch.ops import probes as P

    rng = np.random.default_rng(2025)
    for n in N_TAILS + (N_CHECK, N_WIDE):
        for i, (name, label, kern, plain, exact) in enumerate(probe_cases(n, rng)):
            s = rand_state(n, 500 + 10 * n + i)
            got = kern(s.clone())
            want = plain(s.clone())
            sync()
            if label.startswith("read"):
                abs_err = abs(float(got[0]) - float(want[0]))
                scale = float(torch.view_as_real(s).abs().sum())
                ok, err = abs_err <= TOL * scale, abs_err / scale
            else:
                abs_err = float((got - want).abs().max())
                err = rel_err(got, want)
                ok = torch.equal(got, want) if exact else err <= TOL
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], abs_err)
            log(f"kernel {name} n={n} {label}: rel={err:.3e} max_abs={abs_err:.3e}")
            check(ok, f"{name} {label} disagrees with its plain version at n={n}: "
                      f"rel {err:.3e}, max abs {abs_err:.3e}" + (" (must be exact)" if exact else ""))
            del s, got, want
    for n in (N_CHECK, N_WIDE):
        s = rand_state(n, 900 + n)
        sums = [P.stream(s, "read", n) for _ in range(3)]
        sync()
        log(f"kernel probe_read n={n} three reads back to back: "
            f"{[float(x[0]).hex() for x in sums]}")
        check(all(torch.equal(x, sums[0]) for x in sums),
              f"probe_read at n={n}: three reads of one state differ: {sums}")
        g = torch.Generator(device=DEV).manual_seed(700 + n)
        torch.view_as_real(s).uniform_(0.25, 0.75, generator=g)
        for geometry in ((256, 4), (1024, 4), (256, 1), ODD_GEOMETRY):
            got = float(P.stream(s, "read", n, geometry=geometry)[0])
            want = float(torch.view_as_real(s).sum(dtype=torch.float64))
            err = abs(got - want) / want
            log(f"kernel probe_read n={n} parts in [0.25, 0.75) {geometry[0]}x{geometry[1]}: "
                f"{got!r} against the float64 sum {want!r}, rel {err:.3e}")
            check(err <= READ_POSITIVE_TOL,
                  f"probe_read {geometry} at n={n}: {got!r} against the float64 sum {want!r}, "
                  f"rel {err:.3e} > {READ_POSITIVE_TOL}")
        del s


def run_bw_probe(report):
    """Every variant of the bandwidth probe at n = N_TIME through its own
    functions; the probe kernels' rows take their times from PROBE_ROWS."""
    from qubism_torch.experiments import bw_probe

    lines = bw_probe.run(N_TIME, list(bw_probe.VARIANTS), device=DEV,
                         emit=lambda s: log(f"probe {s}"))
    bad = [(x["variant"], round(x["gbps"], 1)) for x in lines
           if x["frac_peak"] > bw_probe.MAX_FRAC_PEAK]
    check(not bad, f"bandwidth probe readings above {bw_probe.MAX_FRAC_PEAK:.0%} of "
                   f"{bw_probe.PEAK_GBPS:.0f} GB/s: {bad}")
    by_name = {x["variant"]: x for x in lines}
    for name, variant in PROBE_ROWS.items():
        x = by_name[variant]
        report[name].update(ms=x["ms_per_pass"], plain_ms=x["plain_ms"], bound_ms=x["bound_ms"],
                            bound_by=x["bound_by"], library_ms=x["library_ms"])


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
    from qubism_torch import cli, native
    from qubism_torch.models.circuits import adder_qasm, brickwork_qasm, ghz_qasm, qft_qasm
    from qubism_torch.qasm import lexer

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
    del ps

    label = f"brickwork30_d{BW_DEEP}"
    src = brickwork_qasm(N_BIG, BW_DEEP, seed=7, measure=False)
    before = dict(lexer.routes)
    ps, text = run(label, source=src, seed=13, shots=SHOTS)
    routes = {k: v - before[k] for k, v in lexer.routes.items()}
    log(f"{label}: {len(src)} characters, lexer routes {routes}, "
        f"native build_error {native.build_error}")
    check(native.build_error is None, f"{label}: the native lexer did not build: "
          f"{native.build_error}")
    check(routes["native"] >= 1, f"{label}: the lexer never took its native route ({routes})")
    check_top4_chi2(label, ps.stvecs["q"].state, N_BIG, _counts(text))

    ps, _ = run("qft28", source=qft_qasm(N_QFT, measure=False), seed=0)
    check_uniform("qft28", ps.stvecs["q"].state, N_QFT)
    del ps

    a_val, b_val = (1 << ADDER_WIDTH) - 3, 5
    ps, _ = run("adder28", source=adder_qasm(ADDER_WIDTH, a_val, b_val), seed=0)
    ans = ps.cregs["ans"].to_natural()
    log(f"adder28: {a_val} + {b_val} = {ans}")
    check(ans == a_val + b_val, f"adder28 ans {ans} != {a_val + b_val}")
    check(on_cuda and all(on_cuda), f"a state tensor was not on {DEV}")


def time_file_path_warm():
    """The file path's four wide programs again, three warm runs each."""
    from qubism_torch.experiments.profile_circuits import file_path_warm

    for line in file_path_warm(N_BIG, EXAMPLES):
        check(line["rc"] == 0, f"{line['program']} (warm): eval_file rc={line['rc']}")
        log(f"file path warm {line['program']}: best {min(line['seconds']):.3f} s of "
            f"{', '.join(f'{t:.3f}' for t in line['seconds'])}")


def time_parse():
    """Host time of the parse of brickwork-30 at depths 40 and 100: the
    native route and the Python one of the lexer (equal token lists), and
    the whole ``parse_openqasm``, which takes the native route; best of 3."""
    from qubism_torch import native
    from qubism_torch.models.circuits import brickwork_qasm
    from qubism_torch.qasm import lexer
    from qubism_torch.qasm.parser import parse_openqasm

    def best_ms(fn):
        best, out = float("inf"), None
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        return out, best * 1e3

    for depth in (BW_DEEP, BW_DEEPER):
        src = brickwork_qasm(N_BIG, depth, seed=7, measure=False)
        path = os.path.join(EXAMPLES, f"<chip_smoke brickwork30_d{depth}>.qasm")
        nat, nat_ms = best_ms(lambda: native.native_tokenize(src, path))
        py, py_ms = best_ms(lambda: lexer._tokenize_py(src, path))
        before = lexer.routes["native"]
        _, parse_ms = best_ms(lambda: parse_openqasm(path, src))
        check(native.build_error is None and nat is not None,
              f"parse depth {depth}: no native lexer ({native.build_error})")
        check(lexer.routes["native"] - before == 3,
              f"parse depth {depth}: parse_openqasm did not take the native route")
        check(nat == py, f"parse depth {depth}: the native and Python token lists differ")
        log(f"parse brickwork30 depth {depth}: {len(src)} characters, {len(nat)} tokens; "
            f"native {nat_ms:.1f} ms, python {py_ms:.1f} ms ({py_ms / nat_ms:.2f}x), "
            f"parse_openqasm {parse_ms:.1f} ms (best of 3); token lists equal")


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


def physical_order(ref, n, inv):
    """``ref`` (logical qubit order) with logical qubit inv[p] moved to
    position p, by SWAP gates (the gate kernel) in place: the layout of a
    ShardedSim whose ``inv`` this is, read as one state."""
    import numpy as np

    from qubism_torch.ops import kernels

    swap = np.eye(4)[[0, 2, 1, 3]]
    at = list(range(n))  # the logical qubit at each position of ref
    for p in range(n):
        if at[p] != inv[p]:
            r = at.index(inv[p])
            kernels.gate(ref, swap, (min(p, r), max(p, r)), n)
            at[p], at[r] = at[r], at[p]
    return ref


def sharded_err(sim, ref):
    """Relative L2 between a ShardedSim's banks and ``ref``, a single-device
    state of the same circuit (permuted in place to the sim's layout)."""
    import torch

    physical_order(ref, sim.n, sim.inv)
    S, width = 1 << sim.w, 1 << sim.m
    diff = 0.0
    for i in range(sim.D):
        for s in range(S):
            off = (i * S + s) * width
            diff += float(torch.linalg.vector_norm(sim.banks[s][i] - ref[off:off + width])) ** 2
    return math.sqrt(diff) / float(torch.linalg.vector_norm(ref))


def mesh_prims(n, rng, inv=None):
    """A circuit for a 4-shard, 4-bank layout (positions 0-1 device bits,
    2-3 bank bits). Without ``inv``: H on every qubit and a random 2q gate
    on a device bit (relabelling swaps), gates on bank bits (the butterfly
    kernel with S = 2 and 4), and CXs and a random 2q gate between bank and
    local bits (the block decomposition). With ``inv`` (the sim's position
    -> logical qubit after that): diagonals on the qubits then at device
    bits, with a bank and a local bit, and a last dense gate on a device
    bit."""
    import numpy as np

    from qubism_torch.core.gates import Prim

    h = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
    cx = np.eye(4)[[0, 1, 3, 2]]
    if inv is None:
        return [Prim(h, (q,)) for q in range(n)] + [
            Prim(unitary(2, rng), (1, 5)), Prim(cx, (0, n - 1)),
            Prim(unitary(1, rng), (2,)), Prim(unitary(1, rng), (3,)),
            Prim(unitary(2, rng), (2, 3)),
            Prim(cx, (3, 10)), Prim(cx, (12, 2)), Prim(unitary(2, rng), (2, n - 3)),
            Prim(unitary(2, rng), (n - 9, n - 2)),
        ]
    g0, g1, b, loc = inv[0], inv[1], inv[2], inv[n - 1]
    return [
        Prim(np.array([1, 1, 1, -1]), (g0, loc), diag=True),
        Prim(np.exp(1j * rng.uniform(0, 2 * math.pi, 8)), (g1, b, loc), diag=True),
        Prim(np.array([1, np.exp(0.3j)]), (g0,), diag=True),
        Prim(unitary(1, rng), (b,)), Prim(unitary(1, rng), (g1,)),
        Prim(unitary(2, rng), (7, 8)),
    ]


def run_mesh_path():
    """The mesh path: eval_file(mesh=1) on GHZ-30 with shots; ShardedSim
    on QFT-30 against CompiledCircuit; a 4-shard mesh on the one card
    against the single-device engine, then measurements and shots. The
    single-device runs and the swaps that lay out their states are counted
    in REFERENCE."""
    import numpy as np
    import torch

    from qubism_torch import cli
    from qubism_torch.models.circuits import ghz_qasm, qft_prims
    from qubism_torch.ops.fusion import CompiledCircuit
    from qubism_torch.parallel import ShardedSim, make_mesh
    from qubism_torch.utils.stats import chi2_test

    n = N_BIG
    buf = io.StringIO()
    t0 = time.perf_counter()
    rc = cli.eval_file(os.path.join(EXAMPLES, "<chip_smoke mesh ghz30>.qasm"),
                       source=ghz_qasm(n, measure=False), out=buf, seed=11, shots=SHOTS, mesh=1)
    sync()
    check(rc == 0 and buf.getvalue().rstrip().endswith("Done."),
          f"mesh ghz{n}: eval_file rc={rc}\n{buf.getvalue()[-2000:]}")
    log(f"mesh ghz{n} --mesh 1: {time.perf_counter() - t0:.2f} s")
    check_ghz_counts(f"mesh ghz{n}", _counts(buf.getvalue()), n)

    prims = qft_prims(n)
    sim = ShardedSim(n, make_mesh(1))
    check((sim.D, sim.w, sim.m) == (1, 1, n - 1), f"mesh qft{n}: layout {sim.D, sim.w, sim.m}")
    t0 = time.perf_counter()
    sim.apply(prims)
    sync()
    log(f"mesh qft{n}: ShardedSim(mesh=1, 2 banks) first run {time.perf_counter() - t0:.2f} s "
        f"(lowering included), {sim.dispatch_count} segments")
    circ = tally(REFERENCE, lambda: CompiledCircuit(n, prims))
    state = tally(REFERENCE, lambda: circ(circ.init_state()))
    err = tally(REFERENCE, lambda: sharded_err(sim, state))
    log(f"mesh qft{n}: ShardedSim against CompiledCircuit rel_l2 {err:.3e}")
    check(err <= TOL, f"mesh qft{n}: sharded state differs from the compiled one by {err}")
    wall = {"sharded": [], "compiled": []}
    per_call = {}
    for which in ("sharded", "compiled", "compiled", "sharded"):
        t0 = time.perf_counter()
        if which == "sharded":
            tally(per_call, lambda: sim.apply(prims))
        else:
            tally(REFERENCE, lambda: circ(state))
        sync()
        wall[which].append(time.perf_counter() - t0)
    log(f"mesh qft{n}: warm wall ShardedSim {sum(wall['sharded']) / 2:.4f} s, "
        f"CompiledCircuit {sum(wall['compiled']) / 2:.4f} s "
        f"({wall['sharded']}, {wall['compiled']}); ShardedSim launches per call "
        f"{ {k: v // 2 for k, v in per_call.items() if v} }")
    if DEV == "cuda":
        sharded_ms = time_ms(lambda _: sim.apply(prims), None, reps=3)
        compiled_ms = tally(REFERENCE, lambda: device_ms(lambda: circ(state), reps=3))
        log(f"mesh qft{n}: device ms per call ShardedSim {sharded_ms:.3f}, "
            f"CompiledCircuit {compiled_ms:.3f}")
    del sim, circ, state
    torch.cuda.empty_cache()

    rng = np.random.default_rng(404)
    sim = ShardedSim(n, card_mesh(4), banks=2)
    check((sim.D, sim.w, sim.m) == (4, 2, n - 4), f"4-shard layout {sim.D, sim.w, sim.m}")
    t0 = time.perf_counter()
    prims = mesh_prims(n, rng)
    sim.apply(prims)
    more = mesh_prims(n, rng, sim.inv)
    sim.apply(more)
    sync()
    kinds = {step[0] for steps in sim._lowered.values() for step in steps}
    log(f"mesh 4 shards x 4 banks on one card: {time.perf_counter() - t0:.2f} s, "
        f"{sim.dispatch_count} segments and swaps, perm {sim.perm}, steps {sorted(kinds)}")
    check(kinds == {"banks", "bfly", "crossmix", "gdiag"} and sim.perm != list(range(n)),
          f"4-shard run: steps {kinds}, perm {sim.perm}")
    circ = tally(REFERENCE, lambda: CompiledCircuit(n, prims + more))
    ref = tally(REFERENCE, lambda: circ(circ.init_state()))
    err = tally(REFERENCE, lambda: sharded_err(sim, ref))
    log(f"mesh 4 shards: against the single-device engine rel_l2 {err:.3e}")
    check(err <= TOL, f"4-shard mesh differs from the single-device engine by {err}")
    del circ, ref
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(23)
    for where, q in (("device", sim.inv[0]), ("bank", sim.inv[2])):
        p1 = sim.prob_one(q)
        (bit,) = sim.measure_qubits([q], gen)
        after = sim.prob_one(q)
        mass = sum(float(torch.linalg.vector_norm(t)) ** 2 for row in sim.banks for t in row)
        log(f"mesh 4 shards: measured qubit {q} on a {where} bit: P(1) {p1:.4f} -> {bit}, "
            f"then P(1) {after:.2e}, mass {mass:.6f}")
        check(abs(after - bit) <= 1e-5 and abs(mass - 1) <= 1e-4,
              f"4-shard measurement of qubit {q}: P(1) {after} after outcome {bit}, mass {mass}")
    probs = sim.marginal([0, 1, 2, 3])
    idx = sim.sample(SHOTS, gen)
    top = np.bincount(idx >> (n - 4), minlength=16).astype(float)
    res = chi2_test(top, probs / probs.sum())
    log(f"mesh 4 shards: {SHOTS} shots, top-4 chi2: {res}")
    check(bool(res), f"4-shard shots fail chi2 against the marginal: {res}")
    check(all(t.device.type == DEV for row in sim.banks for t in row), "a bank left the card")


def obs_lines(text):
    """{pauli: value} of the ``<P> = value`` lines of a CLI transcript."""
    out = {}
    for line in text.splitlines():
        if line.startswith("<") and "> = " in line:
            p, v = line[1:].split("> = ")
            out[p] = float(v)
    return out


def mixed_pauli(n, letters):
    p = ["I"] * n
    for q, c in letters.items():
        p[q] = c
    return "".join(p)


def run_observables_path():
    """Pauli expectations at full width, reduced density matrices, and the
    REPL with a checkpoint."""
    import torch

    from qubism_torch import cli
    from qubism_torch.core.statevec import StateVec
    from qubism_torch.models.circuits import (brickwork_prims, ghz_prims, ghz_qasm,
                                              qaoa_maxcut_energy, qft_prims, ring_edges)
    from qubism_torch.ops import measure as M
    from qubism_torch.ops import rdm
    from qubism_torch.ops.fusion import CompiledCircuit

    n = N_BIG
    lane0 = max(n - 7, 0)
    zz = mixed_pauli(n, {1: "Z", n - 2: "Z"})
    circ = CompiledCircuit(n, ghz_prims(n))
    ghz = circ(circ.init_state())
    del circ
    sync()
    base = held_gib()
    for pauli, label in ((zz, f"Z1 Z{n - 2}"), ("X" * n, f"X^{n}")):
        val, peak = peak_gib(lambda p=pauli: M.expectation_pauli(ghz, n, p))
        ms = warm_ms(lambda p=pauli: M.expectation_pauli(ghz, n, p))
        log(f"observables ghz{n} <{label}> = {val:.7f}: {ms:.1f} ms, "
            f"peak {peak:.2f} GiB (state {base:.2f})")
        check(abs(val - 1) <= 1e-5, f"ghz{n} <{label}> = {val} != 1")
        check(DEV != "cuda" or peak <= base + OBS_SLACK_GIB,
              f"<{label}> took {peak:.2f} GiB beside a state of {base:.2f}")

    # reduced density matrices of the GHZ state: one qubit, six scattered
    for subset in ((n // 2,), (0, 3, n // 2, lane0 - 1, lane0 + 2, n - 1)):
        rho, peak = peak_gib(lambda sub=subset: rdm.reduced_density_matrix(ghz, n, sub))
        ms = warm_ms(lambda sub=subset: rdm.reduced_density_matrix(ghz, n, sub))
        ent = rdm.entanglement_entropy(ghz, n, subset)
        tr = float(rho.trace().real)
        log(f"rdm ghz{n} subset {subset}: {ms:.1f} ms, trace {tr:.7f}, entropy {ent:.7f} "
            f"(ln 2 = {math.log(2):.7f}), peak {peak:.2f} GiB")
        check(abs(tr - 1) <= 1e-5 and abs(ent - math.log(2)) <= 1e-4,
              f"rdm ghz{n} {subset}: trace {tr}, entropy {ent}")
    del ghz

    single = mixed_pauli(n, {0: "X", 1: "Z", n // 2 - 1: "Y", n // 2: "X", lane0 - 1: "Z",
                             lane0 + 1: "Y", n - 3: "Z", n - 1: "X"})
    edges = ring_edges(n)
    extra = [(0.7, single), (-0.4, mixed_pauli(n, {0: "Y", 1: "Y", n // 2 - 1: "X", n // 2: "Z",
                                                   lane0 + 1: "X", n - 1: "Y", 5: "Z"})),
             (0.3, mixed_pauli(n, {2: "X", n - 2: "X"})), (1.1, mixed_pauli(n, {2: "Y", n - 2: "Y"})),
             (-0.6, mixed_pauli(n, {2: "X", n - 2: "X", 7: "Z", n - 4: "Z"})),
             (0.2, mixed_pauli(n, {n - 1: "Y"}))]
    cut_terms = [(-0.5, mixed_pauli(n, {i: "Z", j: "Z"})) for i, j in edges]
    terms = cut_terms + extra
    states = {f"qft{n}": qft_prims(n), f"brickwork{n}": brickwork_prims(n, 4, seed=7)}
    for label, prims in states.items():
        circ = CompiledCircuit(n, prims)
        state = circ(circ.init_state())
        del circ
        sync()
        base = held_gib()
        val, peak = peak_gib(lambda: M.expectation_pauli(state, n, single))
        ms_one = warm_ms(lambda: M.expectation_pauli(state, n, single))
        total, peak2 = peak_gib(lambda: M.expectation_pauli_sum(state, n, terms))
        ms_sum = warm_ms(lambda: M.expectation_pauli_sum(state, n, terms))
        cut = qaoa_maxcut_energy(StateVec(n, state), n, edges)
        ms_cut = warm_ms(lambda: qaoa_maxcut_energy(StateVec(n, state), n, edges))
        peak = max(peak, peak2)
        want = pauli_by_gates(state, single, n)
        want_terms = [pauli_by_gates(state, p, n) for _, p in terms]
        want_total = sum(c * w for (c, _), w in zip(terms, want_terms))
        want_cut = 0.5 * len(edges) + sum(c * w for (c, _), w in zip(cut_terms, want_terms))
        groups = len(M.group_terms([p for _, p in terms]))
        log(f"observables {label}: <P> = {val:.7f} (by gates {want:.7f}) {ms_one:.1f} ms; sum of "
            f"{len(terms)} terms in {groups} flip groups = {total:.7f} (by gates {want_total:.7f}) "
            f"{ms_sum:.1f} ms; MaxCut energy of {len(edges)} edges = {cut:.7f} (by gates "
            f"{want_cut:.7f}) {ms_cut:.1f} ms; peak {peak:.2f} GiB (state {base:.2f})")
        check(abs(val - want) <= 1e-5, f"{label}: <P> {val} != {want} by gates")
        check(abs(total - want_total) <= 1e-5 * sum(abs(c) for c, _ in terms),
              f"{label}: sum {total} != {want_total} by gates")
        check(abs(cut - want_cut) <= 1e-5 * 0.5 * len(edges),
              f"{label}: MaxCut {cut} != {want_cut}")
        check(DEV != "cuda" or peak <= base + OBS_SLACK_GIB,
              f"{label}: expectations took {peak:.2f} GiB beside a state of {base:.2f}")
        del state
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # --observable through the CLI's three state-vector modes
    for mode, kw in (("file path", {}), ("--compile", {"compile_mode": True}),
                     ("--mesh 1", {"mesh": 1})):
        buf = io.StringIO()
        t0 = time.perf_counter()
        rc = cli.eval_file(os.path.join(EXAMPLES, "<chip_smoke obs ghz>.qasm"),
                           source=ghz_qasm(n, measure=False), out=buf, seed=0,
                           observables=[zz, "x" * n, mixed_pauli(n, {0: "Z"})], **kw)
        sync()
        got = obs_lines(buf.getvalue())
        log(f"observables ghz{n} {mode}: {time.perf_counter() - t0:.2f} s, "
            f"{ {k[:3] + '..' + k[-3:]: v for k, v in got.items()} }")
        check(rc == 0 and buf.getvalue().rstrip().endswith("Done."),
              f"--observable {mode}: rc={rc}\n{buf.getvalue()[-2000:]}")
        check(len(got) == 3 and abs(got[zz] - 1) <= 1e-5 and abs(got["X" * n] - 1) <= 1e-5
              and abs(got[mixed_pauli(n, {0: "Z"})]) <= 1e-5, f"--observable {mode}: {got}")
    buf = io.StringIO()
    rc = cli.eval_file(os.path.join(EXAMPLES, "<chip_smoke obs bad>.qasm"),
                       source=ghz_qasm(3, measure=False), out=buf, observables=["ZZ"])
    check(rc == 2 and "qubism: --observable:" in buf.getvalue(), f"bad --observable: rc={rc}")
    run_repl()


def run_repl():
    """A Repl session on the card: teleportation line by line with a failing
    line in the middle, ``:obs``, ``:save`` of an N_REPL-qubit register,
    ``:load`` in a second Repl, one more gate, ``:obs`` again; the same
    lines without the checkpoint must print the same."""
    import tempfile

    import torch

    from qubism_torch import cli

    n = N_REPL
    head = ['include "qelib1.inc";', "qreg q[3];", "creg c0[1];", "creg c1[1];",
            "u3(0.3,0.2,0.1) q[0];", "h q[1];", "cx q[1],q[2];", "cx q[0],q[1];", "h q[0];",
            "cx q[0],q[7];",            # fails: the line must change nothing
            "measure q[0] -> c0[0];", "measure q[1] -> c1[0];",
            "if(c0==1) z q[2];", "if(c1==1) x q[2];", ":obs IIZ",
            f"qreg big[{n}];", "h big[0];"]
    head += [f"cx big[{i}],big[{i + 1}];" for i in range(n - 1)]
    head += [f"ry(0.4) big[{n // 2}];"]
    obs_big = "III" + mixed_pauli(n, {0: "X", n // 2: "Y", n - 1: "X"})
    tail = [f"rx(0.3) big[{n - 1}];", "cx q[2],big[0];", f":obs {obs_big}",
            ":obs III" + mixed_pauli(n, {0: "Z", 1: "Z"})]

    def session(lines, out, seed=5):
        r = cli.Repl(seed=seed, out=out, include_base=EXAMPLES)
        for text in lines:
            fails = text == "cx q[0],q[7];"
            if fails:
                before = {k: sv.state.clone() for k, sv in r.prog.stvecs.items()}
            check(r.line(text), f"repl stopped at {text!r}")
            if fails:
                check(all(torch.equal(before[k], sv.state) for k, sv in r.prog.stvecs.items())
                      and set(before) == set(r.prog.stvecs), "a failing line changed the state")
        return r

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session.npz")
        a_out, b_out, c_out = io.StringIO(), io.StringIO(), io.StringIO()
        first = session(head, a_out)
        check("ERROR on line 1" in a_out.getvalue() and "Index 7 out of bounds" in a_out.getvalue(),
              f"repl: the failing line printed {a_out.getvalue()[:400]!r}")
        check(all(sv.state.device.type == DEV for sv in first.prog.stvecs.values()),
              "a REPL state left the card")
        t0 = time.perf_counter()
        first.line(f":save {path}")
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        second = cli.Repl(seed=99, out=b_out, include_base=EXAMPLES)
        t0 = time.perf_counter()
        second.line(f":load {path}")
        sync()
        t_load = time.perf_counter() - t0
        for text in tail:
            second.line(text)
        whole = session(head + tail, c_out)
        sync()
    resumed = obs_lines(a_out.getvalue() + b_out.getvalue())
    straight = obs_lines(c_out.getvalue())
    log(f"repl: {len(head) + len(tail)} lines, checkpoint of a {n}-qubit register "
        f"{size / 2**20:.1f} MiB, save {t_save:.2f} s, load {t_load:.2f} s; :obs {resumed}")
    check(len(resumed) == 3 and resumed == straight,
          f"repl: resumed session printed {resumed}, uninterrupted {straight}")
    check(all(torch.equal(sv.state, whole.prog.stvecs[k].state)
              for k, sv in second.prog.stvecs.items()),
          "repl: the resumed state differs from the uninterrupted one")
    check(all(sv.state.device.type == DEV for sv in second.prog.stvecs.values()),
          "a loaded state is not on the card")


def noisy_programs(n):
    """A GHZ chain with two diagonal gates after it (gates only), and two
    brickwork layers with a reset and a mid-circuit measurement."""
    from qubism_torch.models.circuits import brickwork_qasm, ghz_qasm

    return {f"noisy ghz{n}": ghz_qasm(n, measure=False) + f"t q[0];\nrz(0.3) q[{n - 1}];\n",
            f"noisy brickwork{n}": brickwork_qasm(n, 2, seed=9, measure=False)
            + f"reset q[1];\nmeasure q[0] -> c[0];\nh q[{n - 1}];\n"}


def run_density_path():
    """The exact density engine at n = N_DENS through eval_file, against the
    same programs with every pass applied by the plain versions."""
    import numpy as np
    import torch

    from qubism_torch import cli
    from qubism_torch.core import density as D
    from qubism_torch.core.gates import Prim
    from qubism_torch.ops import kernels
    from qubism_torch.qasm.parser import parse_openqasm
    from qubism_torch.run.noisy import DensityProgram

    n = N_DENS
    parity = mixed_pauli(n, {0: "Z", n - 1: "Z"})
    observables = [parity, mixed_pauli(n, {0: "X", 1: "Y", n - 1: "Z"}), "X" * n]
    for label, src in noisy_programs(n).items():
        path = os.path.join(EXAMPLES, f"<chip_smoke {label}>.qasm")
        got = {}
        buf = io.StringIO()
        t0 = time.perf_counter()
        with counted_plain() as plain:
            rc = cli.eval_file(path, source=src, out=buf, seed=3, backend="density", noise=NOISE,
                               observables=observables, shots=SHOTS, dump_state=True,
                               inspect=lambda r: got.update(rho=r[0]))
        sync()
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        check(rc == 0 and text.rstrip().endswith("Done."),
              f"{label}: eval_file rc={rc}\n{text[-2000:]}")
        rho = got["rho"]
        check(rho.state.device.type == DEV and rho.state.numel() == 1 << (2 * n),
              f"{label}: rho on {rho.state.device} with {rho.state.numel()} entries")
        check(DEV != "cuda" or plain.calls == 0,
              f"{label}: {plain.calls} passes ran as plain versions on a CUDA tensor")
        tr, pur = rho.trace(), rho.purity()
        vals = obs_lines(text)
        counts = _counts(text)
        passes = sum(kernels.launches[k] for k in ("gate", "diag", "lane"))
        log(f"density {label}: {secs:.2f} s, trace {tr:.7f}, purity {pur:.6f}, "
            f"<Z0 Z{n - 1}> = {vals[parity]:.6f}, {len(counts)} outcomes in {SHOTS} shots, "
            f"{passes} kernel passes so far on this path")
        check(abs(tr - 1) <= 1e-5 and pur < 1 - 1e-3, f"{label}: trace {tr}, purity {pur}")
        check("Density matrix of q: " in text and f"noise={NOISE.replace(',', ', ')}" in text,
              f"{label}: no dump in\n{text[:400]}")
        check(sum(counts.values()) == SHOTS, f"{label}: counts sum {sum(counts.values())}")
        # the same program, every pass by the plain versions
        t0 = time.perf_counter()
        with plain_kernels():
            want, _ = tally(REFERENCE, lambda: DensityProgram(
                parse_openqasm(path, src), noise=NOISE).run(seed=3))
        sync()
        err = rel_err(rho.state, want.state)
        want_parity = want.expectation(parity)
        log(f"density {label}: against the plain versions rel_l2 {err:.3e} "
            f"({time.perf_counter() - t0:.2f} s), <Z0 Z{n - 1}> plain {want_parity:.6f}")
        check(err <= TOL, f"{label}: kernels vs plain rel L2 {err:.3e}")
        check(abs(vals[parity] - want_parity) <= 1e-5,
              f"{label}: parity {vals[parity]} != {want_parity} of the plain run")
        if "ghz" in label:  # the noise damps the parity and leaks counts off the pair
            top = sorted(counts, key=counts.get)[-2:]
            check(0 < vals[parity] < 1 - 1e-3 and set(top) == {"0" * n, "1" * n},
                  f"{label}: parity {vals[parity]}, most frequent outcomes {top}")
        del want

    # passes per gate and per channel, and the superoperator against the
    # term-by-term form, on the last program's rho
    cx = np.eye(4)[[0, 1, 3, 2]]
    per = {}
    for what, fn in (("1q gate", lambda: rho.apply(Prim(unitary(1, np.random.default_rng(1)), (2,)))),
                     ("2q gate", lambda: rho.apply(Prim(cx, (2, n - 1)))),
                     ("1q channel", lambda: rho.apply_channel(D.amplitude_damping(0.02), n // 2)),
                     ("2q channel", lambda: rho.apply_channel(D.depolarizing2(0.02), (1, n - 2)))):
        before = dict(kernels.launches)
        if DEV == "cuda":  # a warm-up call and two timed ones
            ms = tally(TIMED, lambda fn=fn: device_ms(fn, reps=2))
        else:
            ms = [fn() for _ in range(3)] and 0.0
        per[what] = (sum(kernels.launches[k] - before[k] for k in before) // 3, ms)
    log("density passes (and device ms) per " + ", ".join(
        f"{k}: {v[0]} ({v[1]:.2f} ms)" for k, v in per.items()))
    check(per["1q channel"][0] == 1 and per["2q channel"][0] == 1 and per["2q gate"][0] == 2,
          f"density passes {per}")
    for ks, t in ((D.depolarizing(0.01), 0), (D.amplitude_damping(0.02), n - 1),
                  (D.depolarizing2(0.02), (n - 2, 1))):
        a = D.DensityMatrix(n, rho.state.clone())
        a.apply_channel(ks, t)
        rho.apply_channel_plain(ks, t)
        sync()
        err = rel_err(a.state, rho.state)
        log(f"density apply_channel on {t} ({len(ks)} Kraus terms) against apply_channel_plain: "
            f"rel_l2 {err:.3e}")
        check(err <= TOL, f"apply_channel differs from apply_channel_plain by {err}")
        del a
    del rho
    if DEV == "cuda":
        torch.cuda.empty_cache()


def run_mesh_density_path():
    """The mesh-sharded rho: 4 shards placed on the one card. n =
    N_DENS_SMALL against DensityMatrix entry by entry, then the noisy GHZ at
    n = N_DENS_MESH (4 shards of 2^(2n-2)) through eval_file against
    DensityMatrix for trace, purity and one <P>."""
    import numpy as np
    import torch

    from qubism_torch import cli
    from qubism_torch.core.density import DensityMatrix
    from qubism_torch.qasm.parser import parse_openqasm
    from qubism_torch.run.compiler import EvGates
    from qubism_torch.run.noisy import DensityProgram

    mesh = card_mesh(4)

    n = N_DENS_SMALL
    for label, src in noisy_programs(n).items():
        path = os.path.join(EXAMPLES, f"<chip_smoke mesh {label}>.qasm")
        ast = parse_openqasm(path, src)
        sharded, _ = DensityProgram(ast, noise=NOISE, mesh=mesh).run(seed=1)
        dense, _ = tally(REFERENCE, lambda: DensityProgram(ast, noise=NOISE).run(seed=1))
        got = sharded.sim.amplitudes()
        want = dense.state.cpu().numpy()
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        log(f"mesh density {label} on 4 shards: rel_l2 against DensityMatrix {err:.3e}, max abs "
            f"{np.abs(got - want).max():.3e}, perm {sharded.sim.perm}, "
            f"{sharded.sim.dispatch_count} segments and swaps")
        check(err <= TOL, f"mesh {label}: sharded rho differs by {err}")
        del sharded, dense

    n = N_DENS_MESH
    label, src = next(iter(noisy_programs(n).items()))
    path = os.path.join(EXAMPLES, f"<chip_smoke mesh {label}>.qasm")
    pauli = "X" * n  # cos(pi/4 + 0.3) on the noiseless state, then damped
    parity = mixed_pauli(n, {0: "Z", n - 1: "Z"})
    got = {}
    buf = io.StringIO()
    t0 = time.perf_counter()

    def drive():
        return cli.eval_file(path, source=src, out=buf, seed=3, backend="density", noise=NOISE,
                             mesh=mesh, observables=[pauli, parity], shots=SHOTS,
                             inspect=lambda r: got.update(rho=r[0]))

    rc, peak = peak_gib(drive)
    secs = time.perf_counter() - t0
    text = buf.getvalue()
    check(rc == 0 and text.rstrip().endswith("Done."), f"mesh {label}: rc={rc}\n{text[-2000:]}")
    rho = got["rho"]
    sim = rho.sim
    check((sim.D, sim.w, sim.m) == (4, 0, 2 * n - 2), f"mesh {label}: layout {sim.D, sim.w, sim.m}")
    check(all(t.device.type == DEV for row in sim.banks for t in row), "a shard left the card")
    tr, pur = rho.trace(), rho.purity()
    vals = obs_lines(text)
    log(f"mesh density {label} on 4 shards of 2^{sim.m}: {secs:.2f} s, {sim.dispatch_count} "
        f"segments, swaps and channels, perm {sim.perm}, trace {tr:.7f}, purity {pur:.6f}, "
        f"<P> {vals[pauli]:.6f}, <Z0 Z{n - 1}> {vals[parity]:.6f}, peak {peak:.2f} GiB")
    check(DEV != "cuda" or peak <= MESH_DENS_PEAK_GIB,
          f"mesh {label}: peak {peak:.2f} GiB > {MESH_DENS_PEAK_GIB}")
    check(abs(tr - 1) <= 1e-5 and pur < 1 - 1e-3, f"mesh {label}: trace {tr}, purity {pur}")
    check(sum(_counts(text).values()) == SHOTS, f"mesh {label}: counts")
    del rho, sim
    got.clear()  # the sharded rho goes before the one-buffer rho comes
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # the same program on one buffer of 2^(2n) through DensityMatrix
    prog = DensityProgram(parse_openqasm(path, src), noise=NOISE, mesh=mesh)

    def single():
        dense = DensityMatrix(n)
        for ev in prog.events:
            check(isinstance(ev, EvGates), f"mesh {label}: event {type(ev).__name__}")
            for p in ev.prims:
                dense.apply([p])
                for _, ks, _ in prog.noise:
                    if np.asarray(ks[0]).shape[0] == 4:
                        if len(p.targets) == 2:
                            dense.apply_channel(ks, tuple(p.targets))
                    else:
                        for q in p.targets:
                            dense.apply_channel(ks, q)
        return dense

    dense = tally(REFERENCE, single)
    want = (dense.trace(), dense.purity(), dense.expectation(pauli), dense.expectation(parity))
    log(f"mesh density {label}: DensityMatrix on one buffer: trace {want[0]:.7f}, purity "
        f"{want[1]:.6f}, <P> {want[2]:.6f}, <Z0 Z{n - 1}> {want[3]:.6f}")
    check(abs(tr - want[0]) <= 1e-5 and abs(pur - want[1]) <= 1e-5
          and abs(vals[pauli] - want[2]) <= 1e-5 and abs(vals[parity] - want[3]) <= 1e-5,
          f"mesh {label}: {tr, pur, vals} against {want}")
    del dense
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # lindblad_evolve on the sharded rho (bench.py's configuration): pure
    # damping from |1...1> under a diagonal Ising H, so <Z_q> follows the
    # exact law 1 - 2 exp(-rate t) on the damped qubits
    from qubism_torch.core.gates import Prim
    from qubism_torch.models.dynamics import lindblad_evolve
    from qubism_torch.parallel import make_mesh
    from qubism_torch.parallel.density import ShardedDensityMatrix

    n = N_LIND_MESH
    damped = (0, n // 2, n - 1)
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    sm = np.array([[0, 1], [0, 0]], dtype=complex)
    h_terms = [(0.5, mixed_pauli(n, {i: "Z", i + 1: "Z"})) for i in range(n - 1)]
    obs = [mixed_pauli(n, {q: "Z"}) for q in damped]
    law = 1.0 - 2.0 * math.exp(-LIND_RATE * LIND_T)
    for label, lmesh in (("mesh=1", make_mesh(1)), ("4 shards", card_mesh(4))):
        def run():
            rho = ShardedDensityMatrix(n, lmesh).apply([Prim(x, (q,)) for q in range(n)])
            return lindblad_evolve(rho, h_terms, [(LIND_RATE, sm, q) for q in damped],
                                   t=LIND_T, steps=LIND_STEPS, observables=obs)

        ((rho, vals), secs), peak = peak_gib(lambda: timed_call(run))
        err = float(np.abs(vals[-1] - law).max())
        tr = rho.trace()
        log(f"mesh density lindblad n={n} {label} (D={rho.sim.D}, 2^{rho.sim.m} a shard): "
            f"{LIND_STEPS} steps of t = {LIND_T} in {secs:.3f} s, <Z_q> {vals[-1].round(6).tolist()}"
            f" against 1 - 2 exp(-{LIND_RATE * LIND_T}) = {law:.6f}: max err {err:.2e}, trace "
            f"{tr:.7f}, {rho.sim.dispatch_count} segments, swaps and channels, peak {peak:.2f} GiB")
        check(err < 1e-3 and abs(tr - 1.0) < 1e-4, f"lindblad {label}: err {err}, trace {tr}")
        del rho
        if DEV == "cuda":
            torch.cuda.empty_cache()

def qaoa_chords(n):
    """A ring with four chords: across the row qubits, from a row qubit into
    the lane block, from one into the last qubit, and inside the lane block."""
    from qubism_torch.models.circuits import ring_edges

    lane0 = n - 7
    return ring_edges(n) + [(0, n // 2), (1, lane0 + 2), (3, n - 1), (lane0, n - 2)]


def qaoa_ring(n, p):
    """QAOA MaxCut on a ring as the JAX package's bench runs it: (ansatz,
    terms, constant) of the energy to minimise, minus the cut."""
    from qubism_torch.models import variational as V
    from qubism_torch.models.circuits import ring_edges

    edges = ring_edges(n)
    terms, const = V.maxcut_terms(n, edges)
    return V.qaoa_maxcut_ansatz(n, edges, p), [(-c, s) for c, s in terms], -const


_PAULI = {"I": ((1, 0), (0, 1)), "X": ((0, 1), (1, 0)), "Y": ((0, -1j), (1j, 0)),
          "Z": ((1, 0), (0, -1))}


def ref_value_and_grad(ansatz, terms, constant, theta, eps=1e-5):
    """(E, dE/dtheta) in float64 numpy, apart from the port's engines and
    builders: a parameterized gate is exp(-i t/2 G) from the Pauli generator
    of its name, a fixed prim its own matrix, each applied by tensordot;
    <H> term by term; the gradient by central differences."""
    import numpy as np

    from qubism_torch.models.variational import PGate

    gen = {"rx": "X", "ry": "Y", "rz": "Z", "rzz": "ZZ"}
    n = ansatz.n

    def apply(psi, u, targets):
        k = len(targets)
        out = np.tensordot(np.asarray(u, dtype=np.complex128).reshape((2,) * 2 * k), psi,
                           axes=(list(range(k, 2 * k)), list(targets)))
        return np.moveaxis(out, list(range(k)), list(targets))

    def energy(th):
        psi = np.zeros((2,) * n, dtype=np.complex128)
        psi[(0,) * n] = 1.0
        for op in ansatz.ops:
            if isinstance(op, PGate):
                g = np.ones((1, 1))
                for c in gen[op.name]:
                    g = np.kron(g, _PAULI[c])
                t = op.scale * th[op.pidx[0]]
                u = math.cos(t / 2) * np.eye(len(g)) - 1j * math.sin(t / 2) * g
            else:
                u = op.dense()
            psi = apply(psi, u, op.targets)
        e = constant
        for c, p in terms:
            hp = psi
            for q, ch in enumerate(p):
                if ch != "I":
                    hp = apply(hp, _PAULI[ch], (q,))
            e += c * float(np.vdot(psi, hp).real)
        return e

    th = np.asarray(theta, dtype=np.float64)
    grad = np.zeros(len(th))
    for j in range(len(th)):
        d = np.zeros(len(th))
        d[j] = eps
        grad[j] = (energy(th + d) - energy(th - d)) / (2 * eps)
    return energy(th), grad


def vg_gap(a, b):
    """(|E_a - E_b|, max |g_a - g_b|) of two (energy, gradient) pairs."""
    import numpy as np

    ga, gb = (np.asarray(x[1], dtype=np.float64) for x in (a, b))
    return abs(float(a[0]) - float(b[0])), float(np.abs(ga - gb).max())


def timed_call(fn, *args):
    """(fn(*args), host seconds), synchronised."""
    sync()
    t0 = time.perf_counter()
    out = fn(*args)
    sync()
    return out, time.perf_counter() - t0


def timed_sweep(ansatz, terms, constant, theta):
    """The kernel engine's sweep (``adjoint_engine.kernel_adjoint_value_and_
    grad_fn``) run part by part from the engine's own functions, the host
    clock around each part, synchronised: (E, gradient, {part: ms}).
    "operands" is the host time of building (and uploading) the kernel
    operands of every unit for one call, alone: what descriptors built once
    and refreshed per step would save."""
    import numpy as np

    from qubism_torch.models import adjoint_engine as AE
    from qubism_torch.models import variational as V
    from qubism_torch.ops import apply as A

    n = ansatz.n
    units = AE.plan_units(ansatz.ops, n)
    _, checked = V._check_terms(terms, n)
    head = AE.diag_head if all(set(p) <= set("IZ") for _, p in checked) else AE.pauli_head
    th = V._host_theta(theta)
    ms = dict.fromkeys(("forward", "head", "contraction", "reverse", "operands"), 0.0)

    def part(name, fn):
        out, secs = timed_call(fn)
        ms[name] += secs * 1e3
        return out

    phi = A.zero_state(n)
    for unit in units:
        part("forward", lambda u=unit: AE.apply_unit(phi, u, th, n))
    e, lam = part("head", lambda: head(phi, n, checked, float(constant)))
    g = np.zeros(ansatz.num_params)
    for unit in reversed(units):
        part("contraction", lambda u=unit: AE.unit_grad(phi, lam, u, n, g))
        part("reverse", lambda u=unit: (AE.apply_unit(phi, u, th, n, dag=True),
                                        AE.apply_unit(lam, u, th, n, dag=True)))
    del phi, lam
    part("operands", lambda: [AE.unit_calls(u, th, n, DEV, dag)
                              for u in units for dag in (False, True, True)])
    return e, g, ms


def run_variational_path():
    """The variational trainer: the kernel adjoint engine against the plain
    sweep (QAOA with chords, the HEA under an XXZ chain) and against float64
    numpy; QAOA-28 p = 2 (launches against ``plan_units``, three warm calls, a
    finite difference, device time by kernel, the call split into its parts,
    the peak at p = 1 and p = 2); ``vqe_minimize(grad="adjoint")`` at n =
    28; the TFIM HVA (the head for a non-diagonal H) against the plain
    sweep. (n = 30 is the variational mesh path's.)"""
    import numpy as np
    import torch

    from qubism_torch.experiments import profile_circuits
    from qubism_torch.models import adjoint_engine as AE
    from qubism_torch.models import variational as V
    from qubism_torch.models.hamiltonians import heisenberg_xxz, maxcut, tfim

    rng = np.random.default_rng(7)

    def cases(n):
        edges = qaoa_chords(n)
        terms, const = maxcut(n, edges)
        return [(f"qaoa{n} p=2 ring+chords", V.qaoa_maxcut_ansatz(n, edges, 2), terms, const),
                (f"hea{n} 2 layers, xxz", V.hea_ansatz(n, 2),
                 heisenberg_xxz(n, jxy=0.6, jz=0.9, field=0.3)[0], 0.0)]

    def random_theta(ans):
        return rng.uniform(-math.pi, math.pi, ans.num_params).astype(np.float32)

    def engines(label, ans, terms, const):
        """The kernel engine ("auto" must pick it) against the plain sweep."""
        theta = random_theta(ans)
        kern = V.adjoint_value_and_grad_fn(ans, terms, const)
        check(kern._engine == "kernels", f"{label}: engine auto picked {kern._engine}")
        got, secs = timed_call(kern, theta)
        want, psecs = timed_call(V.adjoint_value_and_grad_fn(ans, terms, const, engine="plain"),
                                 theta)
        de, dg = vg_gap(got, want)
        log(f"variational {label}: kernels E = {float(got[0]):.6f} ({secs:.2f} s), plain sweep "
            f"{float(want[0]):.6f} ({psecs:.2f} s): |dE| {de:.2e}, max |dg| {dg:.2e} over "
            f"{ans.num_params} params")
        check(de <= VAR_E_TOL and dg <= VAR_G_TOL,
              f"{label}: kernel engine vs plain sweep |dE| {de:.2e}, |dg| {dg:.2e}")

    for case in cases(N_VAR):
        engines(*case)
    for label, ans, terms, const in cases(N_VAR_REF):
        theta = random_theta(ans)
        got = V.adjoint_value_and_grad_fn(ans, terms, const, engine="kernels")(theta)
        want, secs = timed_call(lambda: ref_value_and_grad(ans, terms, const, theta))
        de, dg = vg_gap(got, want)
        e_scale, g_scale = max(1.0, abs(want[0])), max(1.0, float(np.abs(want[1]).max()))
        log(f"variational {label}: kernels against float64 numpy |dE| {de:.2e} (|E| "
            f"{abs(want[0]):.3f}), max |dg| {dg:.2e} (max |g| {float(np.abs(want[1]).max()):.3f}; "
            f"the reference {secs:.2f} s)")
        check(de <= VAR_REF_TOL * e_scale and dg <= VAR_REF_TOL * g_scale,
              f"{label}: kernel engine vs float64 |dE| {de:.2e}, |dg| {dg:.2e}")

    # QAOA-28, p = 2
    n = N_QAOA
    state_gib = (8 << n) / 2**30
    ans, terms, const = qaoa_ring(n, 2)
    vg = V.adjoint_value_and_grad_fn(ans, terms, constant=const, segment_size=16)
    check(vg._engine == "kernels", f"qaoa{n}: engine auto picked {vg._engine}")
    theta = np.full(ans.num_params, 0.25, dtype=np.float32)
    counts = {}
    (first, cold) = tally(counts, lambda: timed_call(vg, theta))
    counts = {k: v for k, v in counts.items() if v}
    predicted = AE.predicted_launches(ans)
    units = AE.plan_units(ans.ops, n)
    log(f"variational qaoa{n} p=2: {len(ans.ops)} ops in {len(units)} units, launches per call "
        f"{counts}, plan_units predicts {predicted}; first call {cold:.3f} s")
    check(counts == predicted, f"qaoa{n}: launches {counts} != predicted {predicted}")
    # three warm calls (on the card a warm-up, one timed and one under
    # torch.profiler: device ms by kernel, idle share), and their peak
    calls = []
    (prof, prof_secs), peak = peak_gib(lambda: timed_call(lambda: (
        profile_circuits.profile(f"qaoa{n}", lambda: calls.append(vg(theta)), n)
        if DEV == "cuda" else {"wall_s": timed_call(lambda: calls.append(vg(theta)))[1]})))
    gap = max(max(vg_gap(c, first)) for c in calls)
    check(gap <= 1e-5, f"qaoa{n}: warm calls differ from the first by {gap}")
    e_t, g_t, parts = timed_sweep(ans, terms, const, theta)
    gap = max(vg_gap((e_t, g_t), first))
    check(gap <= 1e-5, f"qaoa{n}: the timed sweep differs by {gap}")
    eps = 1e-3
    shift = np.zeros_like(theta)
    shift[0] = eps
    fd = (float(vg(theta + shift)[0]) - float(vg(theta - shift)[0])) / (2 * eps)
    g0 = float(first[1][0])
    log(f"variational qaoa{n} p=2: E = {float(first[0]):.6f}, g = "
        f"{np.asarray(first[1]).round(6).tolist()}, g[0] {g0:.6f} vs central difference "
        f"(eps {eps}) {fd:.6f}; warm {prof['wall_s']:.4f} s; peak {peak:.2f} GiB "
        f"(state {state_gib:.2f})")
    if prof.get("kernel_ms"):
        ours = {k: round(v["ms"], 3) for k, v in prof["kernels"].items()
                if k.split("<")[0] in ENGINE_KERNELS}
        log(f"variational qaoa{n} p=2 device: {prof['device_ms']:.3f} ms, kernels "
            f"{sum(ours.values()):.3f} ms {ours}, other device work "
            f"{prof['kernel_ms'] - sum(ours.values()):.3f} ms, idle {prof['idle_share']:.1%} "
            f"(the three calls, the profiled one included, {prof_secs:.2f} s)")
    elif DEV == "cuda":
        log(f"variational qaoa{n} p=2 device: not measured (the profiler saw no device event)")
    log(f"variational qaoa{n} p=2 parts (host ms, synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    check(abs(g0 - fd) <= 1e-2, f"qaoa{n}: g[0] {g0} vs central difference {fd}")
    check(peak <= 4 * state_gib + VAR_SLACK_GIB,
          f"qaoa{n}: peak {peak:.2f} GiB > 4 states + {VAR_SLACK_GIB}")

    # memory constant in depth: the same at p = 1
    ans1, terms1, const1 = qaoa_ring(n, 1)
    vg1 = V.adjoint_value_and_grad_fn(ans1, terms1, constant=const1)
    (_, secs_p1), peak1 = peak_gib(lambda: timed_call(vg1, theta[:2]))
    log(f"variational qaoa{n} p=1: first call {secs_p1:.4f} s, peak {peak1:.2f} GiB "
        f"(p=2: {peak:.2f})")
    check(abs(peak - peak1) <= VAR_DEPTH_GIB, f"qaoa{n}: peak p=1 {peak1:.2f}, p=2 {peak:.2f}")
    del vg1

    # two Adam steps at n = 28 (the first Adam of a process imports
    # torch's compiler stack, ~2 s of host time: paid before the clock)
    torch.optim.Adam([torch.zeros(1, requires_grad=True)])
    (theta_opt, hist), secs = timed_call(lambda: V.vqe_minimize(
        ans, terms, theta, steps=VQE_STEPS, constant=const, grad="adjoint"))
    moved = float(np.abs(theta_opt.numpy() - theta).max())
    log(f"variational vqe_minimize qaoa{n} p=2, {VQE_STEPS} Adam steps: energies "
        f"{hist.tolist()}, theta moved {moved:.4f}; {secs / VQE_STEPS:.3f} s per step")
    check(bool(torch.isfinite(hist).all()) and moved > 1e-3,
          f"vqe_minimize: energies {hist.tolist()}, theta moved {moved}")
    del vg
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # the head for a non-diagonal H
    engines(f"tfim_hva{N_HVA} 2 layers, tfim", V.tfim_hva_ansatz(N_HVA, 2), tfim(N_HVA)[0], 0.0)


def timed_mesh_sweep(ansatz, terms, constant, theta, mesh):
    """The mesh engine's sweep (``adjoint_mesh.mesh_adjoint_value_and_grad_fn``)
    run part by part from its own functions, the host clock around each
    part, synchronised: (E, gradient, {part: ms})."""
    import numpy as np

    from qubism_torch.models import adjoint_mesh as AM
    from qubism_torch.models import variational as V

    devices, d, m, units = AM._validate(ansatz, mesh)
    n = ansatz.n
    _, checked = V._check_terms(terms, n)
    th = V._host_theta(theta)
    ms = dict.fromkeys(("forward", "head", "contraction", "reverse"), 0.0)

    def part(name, fn):
        out, secs = timed_call(fn)
        ms[name] += secs * 1e3
        return out

    phi = V._zero_shards(devices, m)
    for unit in units:
        part("forward", lambda u=unit: AM._apply_unit(phi, u, th, d, m))
    e, lam = part("head", lambda: AM._head(phi, checked, d, m))
    g = np.zeros(ansatz.num_params)
    for unit in reversed(units):
        part("contraction", lambda u=unit: AM._unit_grad(phi, lam, u, n, d, g))
        part("reverse", lambda u=unit: (AM._apply_unit(phi, u, th, d, m, dag=True),
                                        AM._apply_unit(lam, u, th, d, m, dag=True)))
    return e + constant, g, ms


def run_variational_mesh_path():
    """The variational trainer on an amplitude mesh
    (``models/adjoint_mesh.py``, ``mesh=``): QAOA-28 p = 2 (bench.py's
    configuration) through the mesh kernel engine on one shard and on 4
    shards of the card against the single-buffer engine (|dE|, max |dg| <
    MESH_TOL), warm seconds of the three and the host-timed share of the
    gradient contraction; QAOA-30 p = 2 over 2 shards of 2^29 against the
    single-buffer engine at n = 30, with both peaks; device-bit rx gates on
    4 shards at n = N_MESH_RX through the kernels against the plain sweep
    on the shards; VQE_MESH_STEPS ``vqe_minimize(mesh=...)`` steps."""
    import numpy as np
    import torch

    from qubism_torch.models import variational as V
    from qubism_torch.models.adjoint_mesh import mesh_adjoint_value_and_grad_fn
    from qubism_torch.parallel import make_mesh

    n = N_QAOA
    ans, terms, const = qaoa_ring(n, 2)
    theta = np.full(ans.num_params, 0.25, dtype=np.float32)
    single = V.adjoint_value_and_grad_fn(ans, terms, constant=const)
    check(single._engine == "kernels", f"qaoa{n}: the single-buffer engine is {single._engine}")
    want, _ = tally(REFERENCE, lambda: timed_call(single, theta))
    _, single_s = tally(REFERENCE, lambda: timed_call(single, theta))
    warm = {"single buffer": single_s}
    shares = {}
    for label, mesh in (("mesh=1", make_mesh(1)), ("4 shards", card_mesh(4))):
        vg = V.adjoint_value_and_grad_fn(ans, terms, constant=const, mesh=mesh)
        check(vg._engine == "kernels-mesh", f"qaoa{n} {label}: engine auto picked {vg._engine}")
        (got, cold), peak = peak_gib(lambda: timed_call(vg, theta))
        got, secs = timed_call(vg, theta)
        warm[label] = secs
        de, dg = vg_gap(got, want)
        e_t, g_t, parts = tally(TIMED, lambda: timed_mesh_sweep(ans, terms, const, theta, mesh))
        check(max(vg_gap((e_t, g_t), got)) <= 1e-5, f"qaoa{n} {label}: the timed sweep differs")
        shares[label] = parts["contraction"] / sum(parts.values())
        log(f"variational mesh qaoa{n} p=2 {label}: E = {float(got[0]):.6f}, |dE| {de:.2e}, "
            f"max |dg| {dg:.2e} against the single-buffer engine; first call {cold:.3f} s, "
            f"warm {secs:.3f} s, peak {peak:.2f} GiB; parts (host ms, synchronised) "
            + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
            + f": contraction {shares[label]:.1%}")
        check(de < MESH_TOL and dg < MESH_TOL,
              f"qaoa{n} {label}: |dE| {de:.2e}, max |dg| {dg:.2e} against the single buffer")
        del vg
    log(f"variational mesh qaoa{n} p=2 warm s: " + ", ".join(f"{k} {v:.3f}"
                                                               for k, v in warm.items()))

    # VQE_MESH_STEPS Adam steps through the mesh engine on one shard
    torch.optim.Adam([torch.zeros(1, requires_grad=True)])
    (theta_opt, hist), secs = timed_call(lambda: V.vqe_minimize(
        ans, terms, theta, steps=VQE_MESH_STEPS, constant=const, grad="adjoint",
        mesh=make_mesh(1)))
    moved = float(np.abs(theta_opt.numpy() - theta).max())
    log(f"variational mesh vqe_minimize qaoa{n} p=2 mesh=1, {VQE_MESH_STEPS} Adam steps: "
        f"energies {hist.tolist()}, theta moved {moved:.4f}; {secs / VQE_MESH_STEPS:.3f} s "
        f"per step")
    check(bool(torch.isfinite(hist).all()) and moved > 1e-3 and abs(float(hist[0]) - float(
        want[0])) < MESH_TOL, f"vqe_minimize mesh: energies {hist.tolist()}, moved {moved}")
    del single
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # QAOA-30 over 2 shards of 2^29 (the widest block without banks), then
    # the single-buffer engine at n = 30
    n = N_MESH_WIDE
    ans, terms, const = qaoa_ring(n, 2)
    vg = mesh_adjoint_value_and_grad_fn(ans, terms, card_mesh(2), constant=const)
    (got, secs), peak = peak_gib(lambda: timed_call(vg, theta))
    del vg
    if DEV == "cuda":
        torch.cuda.empty_cache()
    single = V.adjoint_value_and_grad_fn(ans, terms, constant=const)
    (want, ssecs), speak = tally(REFERENCE, lambda: peak_gib(lambda: timed_call(single, theta)))
    de, dg = vg_gap(got, want)
    state_gib = (8 << n) / 2**30
    log(f"variational mesh qaoa{n} p=2 on 2 shards: E = {float(got[0]):.6f}, g = "
        f"{np.asarray(got[1]).round(6).tolist()}, {secs:.3f} s (first call), peak {peak:.2f} "
        f"GiB (state {state_gib:.2f}); single buffer {ssecs:.3f} s, peak {speak:.2f} GiB: |dE| "
        f"{de:.2e}, max |dg| {dg:.2e}")
    check(de < MESH_TOL and dg < MESH_TOL, f"qaoa{n} on 2 shards: |dE| {de:.2e}, |dg| {dg:.2e}")
    check(peak <= 4 * state_gib + VAR_SLACK_GIB,
          f"qaoa{n} on 2 shards: peak {peak:.2f} GiB > 4 states + {VAR_SLACK_GIB}")
    del single
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # device-bit rx (the mixers on qubits 0 and 1 of 4 shards): the kernels
    # against the plain sweep on the same shards, and the shards' state
    n = N_MESH_RX
    ans, terms, const = qaoa_ring(n, 2)
    theta = np.random.default_rng(11).uniform(-math.pi, math.pi, 4).astype(np.float32)
    mesh = card_mesh(4)
    got, secs = timed_call(mesh_adjoint_value_and_grad_fn(ans, terms, mesh, constant=const),
                           theta)
    plain = V.adjoint_value_and_grad_fn(ans, terms, constant=const, mesh=mesh, engine="plain")
    check(plain._engine == "plain-mesh", f"rx{n}: plain engine {plain._engine}")
    want, psecs = timed_call(plain, theta)
    de, dg = vg_gap(got, want)
    with torch.no_grad():
        shards = V.state_fn(ans, mesh=mesh)(theta)
        flat = V.state_fn(ans)(theta)
    serr = float((torch.cat(shards) - flat).abs().max())
    log(f"variational mesh qaoa{n} p=2, rx on device bits of 4 shards: kernels {secs:.3f} s, "
        f"plain sweep on the shards {psecs:.3f} s: |dE| {de:.2e}, max |dg| {dg:.2e}; "
        f"state_fn(mesh) against one buffer max abs {serr:.2e}")
    check(de <= VAR_E_TOL and dg <= VAR_G_TOL and serr <= 1e-5,
          f"rx{n} on 4 shards: |dE| {de:.2e}, |dg| {dg:.2e}, state {serr:.2e}")


def sparse_hamiltonian(terms, n):
    """sum_j c_j P_j as a scipy sparse matrix (qubit 0 the most significant
    index bit): P|x> = i^{#Y} (-1)^{|x & z|} |x ^ f>."""
    import numpy as np
    import scipy.sparse as sp

    idx = np.arange(1 << n)
    h = sp.csr_matrix((1 << n, 1 << n), dtype=np.complex128)
    for c, p in terms:
        f = sum(1 << (n - 1 - q) for q, ch in enumerate(p) if ch in "XY")
        z = sum(1 << (n - 1 - q) for q, ch in enumerate(p) if ch in "YZ")
        parity = np.zeros_like(idx)
        for b in range(n):
            parity ^= ((idx & z) >> b) & 1
        vals = c * (1j ** p.count("Y")) * (1 - 2 * parity)
        h = h + sp.csr_matrix((vals, (idx ^ f, idx)), shape=h.shape)
    return h


def run_dynamics_path():
    """Closed-system dynamics: ``evolve_observed`` of a TFIM quench at
    N_DYN qubits against the same run by the plain versions, with the
    energy kept by the Strang splitting; ``imaginary_time_evolve`` of the
    TFIM at N_ITE qubits down to its ground energy from scipy."""
    import numpy as np
    import scipy.sparse.linalg as sla
    import torch

    from qubism_torch.core.statevec import StateVec
    from qubism_torch.models import dynamics as Dy
    from qubism_torch.models.hamiltonians import tfim

    n = N_DYN
    terms, _ = tfim(n)
    z0 = "Z" + "I" * (n - 1)

    def quench():
        return Dy.evolve_observed(StateVec.zero(n), terms, [z0, terms], DYN_T, DYN_STEPS)

    ((times, vals, final), secs), peak = peak_gib(lambda: timed_call(quench))
    del final
    with plain_kernels():
        (_, want, final), psecs = timed_call(quench)
    del final
    # each observable to DYN_TOL relative to max(1, |value|): |<H>| is n - 1
    err = np.abs(vals - want).max(axis=0)
    scale = np.maximum(1.0, np.abs(want).max(axis=0))
    drift = float(np.abs(vals[:, 1] - vals[0, 1]).max())
    log(f"dynamics tfim{n} quench, t = {DYN_T} in {DYN_STEPS} Strang steps: <Z0> "
        f"{vals[:, 0].round(7).tolist()}, energy {vals[:, 1].round(6).tolist()} (drift "
        f"{drift:.2e}); {secs:.2f} s, peak {peak:.2f} GiB; against the plain versions "
        f"({psecs:.2f} s) max |d<Z0>| {err[0]:.2e}, max |dE| {err[1]:.2e}")
    check(bool(np.all(err <= DYN_TOL * scale)),
          f"tfim{n} quench: kernels vs plain versions {err} (scale {scale})")
    check(drift <= 1e-3, f"tfim{n} quench: energy drift {drift:.2e}")
    check(abs(vals[0, 0] - 1) <= 1e-6 and vals[-1, 0] < 1 - 1e-3,
          f"tfim{n} quench: <Z0> {vals[:, 0]}")

    n = N_ITE
    terms, _ = tfim(n)
    e0 = float(sla.eigsh(sparse_hamiltonian(terms, n), k=1, which="SA")[0][0])
    plus = StateVec(n, torch.full((1 << n,), 2.0 ** (-n / 2), dtype=torch.complex64, device=DEV))
    (out, energies), secs = timed_call(lambda: Dy.imaginary_time_evolve(
        plus, terms, ITE_TAU, ITE_STEPS, record_energy=True))
    e = out.expectation_sum(terms)
    log(f"dynamics tfim{n} imaginary time tau = {ITE_TAU} in {ITE_STEPS} steps from |+>: "
        f"E = {e:.6f}, ground {e0:.6f} (scipy), |dE| {abs(e - e0):.2e}; {secs:.2f} s")
    check(abs(e - e0) <= 1e-3, f"tfim{n} imaginary time: E {e} vs ground {e0}")
    check(bool(np.all(np.diff(energies) < 1e-3)), "imaginary time: the energy rose")


def phase_device_operands(report):
    """The device-operand modes (K1 ``gate_dev``, K4 ``layer1q_dev``, K3
    ``lane_dev``): each against its plain version and against its parameter
    mode at N_CHECK and N_WIDE (K1 at k = 1..4, K4 at m = 1..6), the
    device-side lane operand bit for bit against the host one, then both
    modes timed at N_TIME."""
    import numpy as np
    import torch

    from qubism_torch.ops import kernels as K

    rng = np.random.default_rng(808)

    def hold(name, run, n, seed, label):
        s = rand_state(n, seed)
        plain, param, dev = s.clone(), s.clone(), s
        run("plain", plain)
        run("param", param)
        run("dev", dev)
        sync()
        err, perr = rel_err(dev, plain), rel_err(dev, param)
        abs_err = float((dev - plain).abs().max())
        del plain, param
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], abs_err)
        log(f"kernel {name} dev n={n} {label}: rel_l2 {err:.3e} against the plain version, "
            f"{perr:.3e} against the parameter mode, max_abs {abs_err:.3e}")
        tol = TOL_TIGHT if name in TIGHT else TOL
        check(err <= tol and perr <= tol,
              f"{name} device-operand mode at n={n} {label}: rel L2 {err:.3e} / {perr:.3e} > {tol}")

    for n in (N_CHECK, N_WIDE):
        for k in (1, 2, 3, 4):
            tg = tuple(sorted(rng.choice(n, k, replace=False).tolist()))
            u = unitary(k, rng)
            ut = torch.from_numpy(np.ascontiguousarray(u, dtype=np.complex64)).to(DEV)
            hold("gate", lambda mode, st, u=u, ut=ut, tg=tg: {
                "plain": lambda: K.gate_plain(st, ut, tg, n), "param": lambda: K.gate(st, u, tg, n),
                "dev": lambda: K.gate_dev(st, ut, tg, n)}[mode](), n, 7 * n + k, f"k={k} {tg}")
        for m in range(1, 7):
            qs = rng.choice(n, m, replace=False).tolist()
            us = np.stack([unitary(1, rng) for _ in range(m)]).astype(np.complex64)
            ut = torch.from_numpy(us).to(DEV)
            hold("layer1q", lambda mode, st, us=us, ut=ut, qs=qs: {
                "plain": lambda: K.layer1q_plain(st, tuple(zip(ut, qs)), n),
                "param": lambda: K.layer1q(st, tuple(zip(us, qs)), n),
                "dev": lambda: K.layer1q_dev(st, ut, qs, n)}[mode](), n, 9 * n + m, f"m={m} {qs}")
        u = unitary(7, rng)
        ut = torch.from_numpy(np.ascontiguousarray(u, dtype=np.complex64)).to(DEV)
        hold("lane", lambda mode, st: {
            "plain": lambda: K.lane_plain(st, ut, n), "param": lambda: K.lane(st, u, n),
            "dev": lambda: K.lane_dev(st, ut, n)}[mode](), n, 11 * n, "128 x 128")
    u = unitary(7, rng).astype(np.complex64)
    u.real[0, :6] = [0.0, -0.0, 1e-40, -3.4e38, 1 + 2 ** -12, -(1 + 2 ** -13)]
    host = K.lane_parts(u)
    dev = K.lane_parts_dev(torch.from_numpy(u).to(DEV)).cpu().numpy()
    same = bool(np.array_equal(host.view(np.uint32), dev.view(np.uint32)))
    log(f"kernel lane dev: lane_parts_dev bit-equal to the host lane_parts: {same}")
    check(same, "lane_parts_dev differs from lane_parts")

    if DEV != "cuda":
        return
    n = N_TIME
    gb = 16 * (1 << n) / 1e9
    s = rand_state(n, 77)
    u4 = unitary(4, rng)
    u4t = torch.from_numpy(np.ascontiguousarray(u4, dtype=np.complex64)).to(DEV)
    us6 = np.stack([unitary(1, rng) for _ in range(6)]).astype(np.complex64)
    us6t = torch.from_numpy(us6).to(DEV)
    q6 = (0, 4, 8, 12, 16, 20)
    u7 = unitary(7, rng)
    u7t = torch.from_numpy(np.ascontiguousarray(u7, dtype=np.complex64)).to(DEV)
    timed = [
        ("gate", lambda st: K.gate(st, u4, (2, 9, 15, 20), n),
         lambda st: K.gate_dev(st, u4t, (2, 9, 15, 20), n), (u4, (2, 9, 15, 20))),
        ("layer1q", lambda st: K.layer1q(st, tuple(zip(us6, q6)), n),
         lambda st: K.layer1q_dev(st, us6t, q6, n), (tuple(zip(us6, q6)),)),
        ("lane", lambda st: K.lane(st, u7, n), lambda st: K.lane_dev(st, u7t, n), (u7,)),
    ]
    from qubism_torch.ops import probes as P

    for name, param, dev, args in timed:
        # alternate parameter mode, device mode, device mode, parameter mode
        p1, d1, d2, p2 = (time_ms(f, s) for f in (param, dev, dev, param))
        dms, pms = (d1 + d2) / 2, (p1 + p2) / 2
        report[name]["dev_ms"] = dms
        bound_ms, bound_by = P.bound(*kernel_cost(name, args, n), tf32x3=name == "lane")
        log(f"time n={n} {name} dev: device operand {dms:.3f} ms ({gb / dms * 1e3:.1f} GB/s), "
            f"parameter mode {pms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
            f"{bound_ms / dms:.1%} of it)"
            + (" (lane dev forms its TF32 parts on the card each call)" if name == "lane" else ""))
    del s
    torch.cuda.empty_cache()


def ghz_lines(n):
    return ([f"qreg q[{n}]; creg c[{n}];", "U(1.5707963267948966, 0, 3.141592653589793) q[0];"]
            + [f"CX q[{q}], q[{q + 1}];" for q in range(n - 1)])


def traj_program(lines, noise):
    from qubism_torch.qasm.parser import parse_openqasm
    from qubism_torch.run.noisy import TrajectoryProgram

    return TrajectoryProgram(parse_openqasm("<chip_smoke>.qasm", "\n".join(lines)), noise=noise)


def fused_run(label, prog, ntraj, seed):
    """A warm-up of the fused engine on a few trajectories, then ``ntraj``
    timed, with the launches it makes and its peak: (bits by creg, seconds,
    launches per trajectory, peak GiB)."""
    from qubism_torch.run.traj_fused import FusedTrajectories

    plan = prog._fused_plan = FusedTrajectories(prog)
    prog.run_vals(4, seed=seed + 1000, engine="fused")
    counts = {}
    (vals, secs), peak = peak_gib(lambda: tally(counts, lambda: timed_call(
        lambda: prog.run_vals(ntraj, seed=seed, engine="fused"))))
    per = {k: v / ntraj for k, v in counts.items() if v}
    kinds = {}
    for st in plan.steps:
        kinds[type(st).__name__] = kinds.get(type(st).__name__, 0) + 1
    log(f"trajectories {label}: fused, {ntraj} trajectories warm {secs:.3f} s "
        f"({secs / ntraj * 1e3:.2f} ms each), {plan.dispatch_count - 1} batches, "
        f"launches per trajectory {per}, steps {kinds}, sites {plan.total_sites}, peak "
        f"{peak:.2f} GiB; no synchronising call inside a batch"
        + (" (sync debug mode 'error')" if DEV == "cuda" else ""))
    return vals, secs, per, peak


def vmapped_run(label, prog, ntraj, seed):
    """The vmapped engine on one batch (a warm-up), then ``ntraj`` timed:
    (bits by creg, seconds, peak GiB). The peak of the many batches may not
    exceed the one batch's by more than TRAJ_SLACK_GIB: a batch's final
    states leave the card before the next batch runs."""
    batch = min(ntraj, max(1, prog._MAX_LIVE // prog._traj_live_cost()))
    _, peak1 = peak_gib(lambda: prog.run_vals(batch, seed=seed + 1000))
    (vals, secs), peak = peak_gib(lambda: timed_call(lambda: prog.run_vals(ntraj, seed=seed)))
    log(f"trajectories {label}: vmapped, {ntraj} trajectories in batches of {batch} "
        f"{secs:.3f} s, peak {peak:.2f} GiB (one batch: {peak1:.2f} GiB; a batch's states "
        f"{batch * (8 << prog.n) / 2**30:.2f} GiB)")
    check(peak <= peak1 + TRAJ_SLACK_GIB,
          f"{label} vmapped: peak {peak:.2f} GiB at {ntraj} trajectories > one batch's "
          f"{peak1:.2f} + {TRAJ_SLACK_GIB}")
    return vals, secs, peak


def ghz_pins(label, bits, p, sites, ntraj):
    """bench.py's pins of a noisy GHZ: the clean fraction within 3 sigma +
    0.002 of (1 - 2p/3)^sites, and the clean split's chi2 < 16."""
    cleanmask = (bits == bits[:, :1]).all(axis=1)
    clean = float(cleanmask.mean())
    p_clean = (1 - 2 * p / 3) ** sites
    sig = (p_clean * (1 - p_clean) / ntraj) ** 0.5
    n0 = int((cleanmask & (bits[:, 0] == 0)).sum())
    n1 = int(cleanmask.sum()) - n0
    chi2 = (n0 - n1) ** 2 / max(n0 + n1, 1)
    log(f"trajectories {label}: clean fraction {clean:.4f} against (1 - 2p/3)^{sites} = "
        f"{p_clean:.4f} (3 sigma {3 * sig:.4f}), clean split {n0}/{n1} chi2 {chi2:.2f}")
    check(abs(clean - p_clean) < 3 * sig + 0.002,
          f"{label}: clean fraction {clean} vs {p_clean}")
    check(chi2 < 16.0, f"{label}: clean split chi2 {chi2}")


def run_trajectories_path():
    """Noisy trajectories: the fused engine on GHZ-28 under depolarizing
    noise and on 28 excited qubits under amplitude damping (closed-form
    pins, launches per trajectory, no synchronising call inside a batch,
    peak), a feed-forward program at N_TRAJ_FF through both engines, the
    vmapped engine on bench.py's GHZ-16 and timed at N_TRAJ_VMAP_WIDE, the
    CLI's trajectory mode and ``lindblad_mcwf`` against ``lindblad_evolve``."""
    import numpy as np

    from qubism_torch.cli import eval_file
    from qubism_torch.core.density import DensityMatrix
    from qubism_torch.core.gates import Prim
    from qubism_torch.models import dynamics as Dy
    from qubism_torch.run.traj_fused import FusedTrajectories
    from qubism_torch.utils.stats import chi2_quantile, chi2_test

    FusedTrajectories.sync_debug = "error" if DEV == "cuda" else None
    try:
        n, T, p = N_TRAJ, TRAJ_T, TRAJ_P
        state_gib = (8 << n) / 2**30
        prog = traj_program(ghz_lines(n) + ["measure q -> c;"], f"depolarizing:{p}")
        vals, secs, per, peak = fused_run(f"ghz{n} depolarizing:{p}", prog, T, 1)
        ghz_pins(f"ghz{n} fused", vals["c"], p, 2 * n - 1, T)
        ops_gib = T * sum(np.asarray(o).nbytes for ops in prog._fused_plan._realize_operands(
            np.random.default_rng(0)) for o in ops) / 2**30
        log(f"trajectories ghz{n}: peak {peak:.3f} GiB against one state {state_gib:.3f} + the "
            f"batch's operands {ops_gib:.4f} GiB")
        check(peak <= state_gib + ops_gib + TRAJ_SLACK_GIB,
              f"ghz{n} fused: peak {peak:.2f} GiB > one state {state_gib:.2f} + operands "
              f"{ops_gib:.4f} + {TRAJ_SLACK_GIB}")
        TRAJ_TIMES[f"fused ghz{n}"] = secs / T

        lines = [f"qreg q[{n}]; creg c[{n}];"]
        lines += [f"U(3.141592653589793, 0, 3.141592653589793) q[{q}];" for q in range(n)]
        prog = traj_program(lines + ["measure q -> c;"], f"ad:{TRAJ_AD}")
        vals, secs, _, peak = fused_run(f"x{n} ad:{TRAJ_AD}", prog, T, 2)
        p1 = vals["c"].mean(axis=0)
        want = 1.0 - TRAJ_AD
        z2 = float(((p1 - want) ** 2 / (want * (1 - want) / T)).sum())
        bound = chi2_quantile(n, 1e-4)
        log(f"trajectories x{n} ad:{TRAJ_AD}: P(1) per qubit {p1.min():.4f}..{p1.max():.4f} "
            f"against {want}, chi2 {z2:.2f} < {bound:.2f}")
        check(z2 < bound, f"x{n} ad: per-qubit chi2 {z2} >= {bound}")
        check(peak <= state_gib + TRAJ_SLACK_GIB + 0.01, f"x{n} ad: peak {peak:.2f} GiB")

        # feed-forward: a mid-circuit measurement, a reset and a correction
        n = N_TRAJ_FF
        lines = ghz_lines(n)
        lines[0] = f"qreg q[{n}]; creg m[1]; creg c[{n}];"
        # measuring q[0] collapses the GHZ state; the correction returns
        # q[0] to |0> and the reset keeps it there: c = 0...0 or 01...1
        lines += ["measure q[0] -> m[0];",
                  "if (m == 1) U(3.141592653589793, 0, 3.141592653589793) q[0];",
                  "reset q[0];", "measure q -> c;"]
        # damping on the measured, corrected and reset qubit: its MCWF sites
        # meet the mid-circuit measurement (the x28 run damps every qubit)
        prog = traj_program(lines, f"depolarizing:{p},ad:{p}@q[0]")

        def classes(vals):
            out = {}
            for m, c in zip(vals["m"][:, 0], vals["c"]):
                key = f"m={m} c=" + ("0" if not c.any() else "01" if c[1:].all() and not c[0]
                                     else "other")
                out[key] = out.get(key, 0) + 1
            return out

        fused, fsecs, _, _ = fused_run(f"feed-forward{n}", prog, TRAJ_FF_T, 3)
        vmap, vsecs, vpeak = vmapped_run(f"feed-forward{n}", prog, TRAJ_FF_T, 4)
        cf, cv = classes(fused), classes(vmap)
        keys = sorted(set(cf) | set(cv))
        a = np.array([cf.get(k, 0) for k in keys], dtype=float)
        b = np.array([cv.get(k, 0) for k in keys], dtype=float)
        res = chi2_test(a, (a + b) / (a.sum() + b.sum()))
        log(f"trajectories feed-forward{n}: fused {cf} ({fsecs:.2f} s), vmapped {cv} "
            f"({vsecs:.2f} s); chi2 {res}")
        check(bool(res), f"feed-forward{n}: fused and vmapped counts differ: {res}")
        clean = (cf.get("m=0 c=0", 0) + cf.get("m=1 c=01", 0)) / TRAJ_FF_T
        check(clean >= 0.8, f"feed-forward{n}: the fused engine's clean share {clean}")

        # the vmapped engine: bench.py's GHZ-16, then ms per trajectory wide
        n, T = N_TRAJ_VMAP, TRAJ_VMAP_T
        prog = traj_program(ghz_lines(n) + ["measure q -> c;"], f"depolarizing:{p}")
        prog.run_vals(T, seed=0)
        (vals, secs), peak = peak_gib(lambda: timed_call(lambda: prog.run_vals(T, seed=1)))
        log(f"trajectories ghz{n}: vmapped, {T} trajectories warm {secs:.3f} s, peak "
            f"{peak:.2f} GiB")
        ghz_pins(f"ghz{n} vmapped", vals["c"], p, 2 * n - 1, T)

        n, T = N_TRAJ_VMAP_WIDE, TRAJ_VMAP_WIDE_T
        prog = traj_program(ghz_lines(n) + ["measure q -> c;"], f"depolarizing:{p}")
        vals, secs, peak = vmapped_run(f"ghz{n}", prog, T, 1)
        TRAJ_TIMES[f"vmapped ghz{n}"] = secs / T
        check(vals["c"].shape == (T, n), f"ghz{n} vmapped: bits {vals['c'].shape}")
        _, fsecs, _, _ = fused_run(f"ghz{n} depolarizing:{p}", prog, 32, 5)
        TRAJ_TIMES[f"fused ghz{n}"] = fsecs / 32
        log(f"trajectories ms per trajectory: vmapped ghz{n} "
            f"{TRAJ_TIMES[f'vmapped ghz{n}'] * 1e3:.1f} (batches of "
            f"{max(1, prog._MAX_LIVE // prog._traj_live_cost())}, peak {peak:.2f} GiB), fused "
            f"ghz{n} {TRAJ_TIMES[f'fused ghz{n}'] * 1e3:.2f}, fused ghz{N_TRAJ} "
            f"{TRAJ_TIMES[f'fused ghz{N_TRAJ}'] * 1e3:.2f}")

        # the CLI's trajectory mode
        buf = io.StringIO()
        (rc, secs) = timed_call(lambda: eval_file(
            os.path.join(EXAMPLES, "teleportation.qasm"), seed=1, noise="dep:0.01",
            trajectories=256, observables=["ZZI"], out=buf))
        text = buf.getvalue()
        rows = [ln for ln in text.splitlines() if ln.startswith("  ")]
        total = sum(int(ln.rpartition(": ")[2]) for ln in rows)
        obs = [ln for ln in text.splitlines() if ln.startswith("<ZZI> = ")]
        log(f"trajectories cli teleportation dep:0.01, 256 trajectories ({secs:.2f} s): "
            f"{len(rows)} outcomes, {obs}")
        check(rc == 0 and text.startswith("Counts over classical registers (256 trajectories):")
              and total == 256 and len(obs) == 1 and " +- " in obs[0]
              and text.rstrip().endswith("Done."), f"cli trajectories rc={rc}\n{text[-2000:]}")

        # Lindblad by trajectories against the exact density matrix
        n = N_LINDBLAD
        sm = np.array([[0, 1], [0, 0]], dtype=complex)
        had = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
        h_terms = [(0.5, "Z" + "I" * (n - 1))]
        collapse = [(0.3, sm, 0)]
        paulis = ["X" + "I" * (n - 1), "Z" + "I" * (n - 1)]
        rho = DensityMatrix(n).apply([Prim(had, (0,))])
        Dy.lindblad_evolve(rho, h_terms, collapse, 0.5, steps=5)
        (_, est), secs = timed_call(lambda: Dy.lindblad_mcwf(
            n, [Prim(had, (0,))], h_terms, collapse, 0.5, steps=5, ntraj=LINDBLAD_T,
            observables=paulis, seed=1))
        parts = []
        for pauli, (mean, se) in zip(paulis, est):
            want = rho.expectation(pauli)
            parts.append(f"<{pauli[0]}0> {mean:.4f} +- {se:.4f} against {want:.4f}")
            check(abs(mean - want) <= 4 * se + 1e-3, f"lindblad_mcwf {pauli}: {mean} vs {want}")
        log(f"trajectories lindblad_mcwf n={n}, {LINDBLAD_T} trajectories ({secs:.2f} s): "
            + "; ".join(parts))
    finally:
        FusedTrajectories.sync_debug = None


def stab_run(label, fn, steps, what):
    """``fn()`` once as the warm-up, with its torch ops (each about one
    launch on the card), host reads and measurement rounds counted and its
    peak taken, then three timed runs: (the last output, the counts)."""
    from qubism_torch.stabilizer import tableau as Tb
    from qubism_torch.utils.profiling import count_ops

    Tb.reset_stats()
    (out, ops), peak = peak_gib(lambda: count_ops(fn))
    info = {"ops": ops, "syncs": Tb.stats["syncs"], "rounds": Tb.stats["rounds"], "peak": peak}
    secs = []
    for _ in range(3):
        out, s = timed_call(fn)
        secs.append(s)
    info["secs"] = min(secs)
    log(f"stabilizer {label}: warm {min(secs):.4f} s (best of 3 after one warm-up: "
        f"{', '.join(f'{s:.4f}' for s in secs)}), torch ops {ops} ({ops / steps:.1f} per "
        f"{what} step, {steps} steps), synchronising calls {info['syncs']}, measurement "
        f"rounds {info['rounds']}, peak {peak:.3f} GiB")
    return out, info


def device_launches(fn):
    """The kernels and copies the card ran for ``fn()``, by torch.profiler;
    None off the card or when it traced nothing."""
    import torch

    if DEV != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) or None


def stab_parse(lines):
    from qubism_torch.qasm.parser import parse_openqasm

    return parse_openqasm("<chip_smoke>.qasm", "\n".join(lines))


def stab_ghz_law(label, bits, p, sites, ntraj):
    """A noisy GHZ on frames: the clean fraction within 3 sigma + 0.005 of
    (1 - 2p/3)^sites, and the clean 0/1 split's chi2 < 16."""
    cleanmask = (bits == bits[:, :1]).all(axis=1)
    clean = float(cleanmask.mean())
    want = (1 - 2 * p / 3) ** sites
    sig = (want * (1 - want) / ntraj) ** 0.5
    n0 = int((cleanmask & (bits[:, 0] == 0)).sum())
    n1 = int(cleanmask.sum()) - n0
    chi2 = (n0 - n1) ** 2 / max(n0 + n1, 1)
    log(f"stabilizer {label}: clean fraction {clean:.4f} against (1 - 2p/3)^{sites} = "
        f"{want:.4f} (3 sigma {3 * sig:.4f}), clean split {n0}/{n1} chi2 {chi2:.2f}")
    check(abs(clean - want) < 3 * sig + 0.005, f"{label}: clean fraction {clean} vs {want}")
    check(chi2 < 16.0, f"{label}: clean split chi2 {chi2}")


def fallback_law(n, p):
    """The expected number of ones in the final register of the S4 program
    (GHZ-n, measure q[0] -> m, ``if (m == 1)`` X on every qubit, measure
    all) under bit flips p after every gate on each of its qubits. With
    q(j) = (1 - (1-2p)^j) / 2, the odd-parity chance of j independent
    flips: q[k] ^ q[0] before the correction is the parity of k + 2 flips
    (the flip of q[0] after CX(0,1), of q[j] after CX(j-1,j) for j <= k,
    carried down the chain, and of q[k] after CX(k,k+1)), n for the last
    qubit; m is a fair coin independent of them, and the correction's X
    adds one more flip where m = 1. So P(f_0 = 1) = p/2 and P(f_k = 1) =
    (q(k+2) + q(k+3)) / 2 (k < n-1), (q(n) + q(n+1)) / 2 (k = n-1)."""
    def q(j):
        return (1 - (1 - 2 * p) ** j) / 2

    return p / 2 + sum((q(k + 2) + q(k + 3)) / 2 for k in range(1, n - 1)) + (q(n) + q(n + 1)) / 2


def run_stabilizer_path():
    """The stabilizer backend at the JAX package's benchmark shapes: S1 a
    tableau (StabilizerSim(1000): GHZ chain against the CPU run word for
    word, 8192 shots, the register read in 2 rounds, two expectations), S2
    final-measure frames (GHZ-300 under depolarizing:0.001, 8192
    trajectories), S3 the QEC memory (d = 501, 8 rounds, 4096 trajectories,
    and d = 5 at p = 0.05), S4 the tableau batch (a 1000-qubit program with
    a mid-circuit measurement and an ``if`` correction under bitflip:0.01,
    64 trajectories, against its closed-form law, and noiseless), and the
    CLI (errorCorrection.qasm, GHZ-1000 with 8192 shots). No kernel of K1-K6
    runs here: the reference's stabilizer engine is plain XLA."""
    import numpy as np
    import torch

    from qubism_torch.cli import eval_file
    from qubism_torch.core.gates import Prim
    from qubism_torch.models.qec import repetition_memory
    from qubism_torch.stabilizer import (StabilizerSim, StabilizerTrajectoryProgram,
                                         apply_prims, identity_tableau, planes_from_tableau)
    from qubism_torch.stabilizer import tableau as Tb

    h = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
    cx = np.eye(4, dtype=np.complex128)[[0, 1, 3, 2]]

    # S1: the tableau (bench.py:580-598)
    n = N_STAB
    prims = [Prim(h, (0,))] + [Prim(cx, (q, q + 1)) for q in range(n - 1)]
    sim, _ = stab_run(f"S1 chain n={n}", lambda: StabilizerSim(n, seed=0).apply(prims), n, "gate")
    ref = apply_prims(identity_tableau(n, torch.device("cpu")), prims)
    same = all(np.array_equal(a, b) for a, b in zip(planes_from_tableau(sim.tab),
                                                    planes_from_tableau(ref)))
    kern = device_launches(lambda: StabilizerSim(n, seed=0).apply(prims))
    log(f"stabilizer S1 chain: planes equal to the CPU run word for word: {same}; the card ran "
        + ("not traced" if kern is None else f"{kern} kernels and copies ({kern / n:.1f} a gate)"))
    check(same, "S1: the chain's planes differ from the CPU run")

    def sample():
        sim._support = None            # the host elimination each time
        return sim.sample(STAB_SHOTS)

    b, _ = stab_run(f"S1 sample {STAB_SHOTS} shots", sample, 1, "sample")
    frac = float(b[:, 0].mean())
    log(f"stabilizer S1 sample: rows all equal {bool((b == b[:, :1]).all())}, "
        f"mean {frac:.4f} (|mean - 0.5| < 0.0166)")
    check(b.shape == (STAB_SHOTS, n) and (b == b[:, :1]).all(), "S1: sample rows differ")
    check(abs(frac - 0.5) < 0.0166, f"S1: sample mean {frac}")

    def measure():
        fresh = StabilizerSim(n, seed=1)
        fresh.tab = sim.tab
        return fresh.measure_qubits(range(n))

    outs, info = stab_run(f"S1 measure_qubits({n})", measure, n, "qubit")
    check(len(set(outs)) == 1, "S1: GHZ outcomes differ")
    check(info["rounds"] == 2, f"S1: {info['rounds']} readout rounds, not 2")
    zz = "Z" + "I" * (n - 2) + "Z"
    ev, _ = stab_run("S1 expectations", lambda: (sim.expectation(zz), sim.expectation("X" * n)),
                     2, "expectation")
    log(f"stabilizer S1: <Z0 Z{n - 1}> = {ev[0]}, <X^{n}> = {ev[1]}")
    check(ev == (1.0, 1.0), f"S1: expectations {ev}")

    # S2: final-measure frames (bench.py:963-1000)
    n, T, p = N_FRAMES, FRAMES_T, FRAMES_P
    ghz = ([f"qreg q[{n}]; creg c[{n}];", "U(1.5707963267948966, 0, 3.141592653589793) q[0];"]
           + [f"CX q[{q}], q[{q + 1}];" for q in range(n - 1)])
    prog = StabilizerTrajectoryProgram(stab_parse(ghz + ["measure q -> c;"]),
                                       noise=f"depolarizing:{p}")
    vals, _ = stab_run(f"S2 frames ghz{n} x {T}", lambda: prog.run_vals(T, seed=0)["c"], n, "gate")
    log(f"stabilizer S2: used_frames {prog.used_frames}")
    check(prog.used_frames, "S2: the frame executor was not used")
    stab_ghz_law(f"S2 ghz{n}", vals, p, 2 * n - 1, T)

    # S3: the QEC memory (bench.py:935-961)
    d, rounds, p, T = QEC_D, QEC_ROUNDS, QEC_P, QEC_T
    res, _ = stab_run(f"S3 qec d={d} ({2 * d - 1} qubits) x {T}",
                      lambda: repetition_memory(d, rounds, p, T, seed=0), 5 * rounds + 1, "layer")
    for r, tol in ((res, 0.003), (repetition_memory(5, rounds, 0.05, T, seed=1), 0.005)):
        sig = (r.analytic * (1 - r.analytic) / T) ** 0.5
        log(f"stabilizer S3 d={r.d} p={r.p}: logical rate {r.logical_rate:.5f} against "
            f"{r.analytic:.5f} (5 sigma {5 * sig:.5f} + {tol}), syndromes consistent "
            f"{r.syndrome_consistent}")
        check(r.syndrome_consistent, f"S3 d={r.d}: syndromes inconsistent")
        check(abs(r.logical_rate - r.analytic) < 5 * sig + tol,
              f"S3 d={r.d}: rate {r.logical_rate} vs {r.analytic}")

    # S4: the tableau batch (feed-forward)
    n, T, p = N_FALLBACK, FALLBACK_T, FALLBACK_P
    lines = ghz[:]
    lines[0] = f"qreg q[{n}]; creg m[1]; creg f[{n}];"
    lines = lines[:2] + [f"CX q[{k}], q[{k + 1}];" for k in range(n - 1)]
    lines += ["measure q[0] -> m[0];",
              "if (m == 1) U(3.141592653589793, 0, 3.141592653589793) q;", "measure q -> f;"]
    prog = StabilizerTrajectoryProgram(stab_parse(lines), noise=f"bitflip:{p}")
    vals, _ = stab_run(f"S4 tableau batch n={n} x {T}", lambda: prog.run_vals(T, seed=0),
                       2 * n, "gate")
    check(not prog.used_frames, "S4: frames were used for a feed-forward program")
    m, f = vals["m"][:, 0], vals["f"]
    ones = f.sum(axis=1)
    want = fallback_law(n, p)
    se = float(ones.std(ddof=1) / np.sqrt(T))
    log(f"stabilizer S4: used_frames {prog.used_frames}, m = 1 in {int(m.sum())} of {T}, "
        f"ones in f {ones.mean():.2f} +- {se:.2f} against the law's {want:.2f}, f[0] = 1 "
        f"only where m = 1: {bool((f[:, 0] <= m).all())}")
    check((f[:, 0] <= m).all(), "S4: f[0] = 1 where m = 0")
    check(abs(ones.mean() - want) < 5 * se + 1.0, f"S4: ones {ones.mean()} vs {want}")
    clean = StabilizerTrajectoryProgram(stab_parse(lines))
    cv = clean.run_vals(T, seed=1)
    log(f"stabilizer S4 noiseless: f all zero {bool((cv['f'] == 0).all())}, m = 1 in "
        f"{int(cv['m'].sum())} of {T}")
    check((cv["f"] == 0).all() and 0 < cv["m"].mean() < 1, "S4 noiseless: wrong outcomes")

    # the CLI
    Tb.reset_stats()
    out = io.StringIO()
    seen = {}
    rc = eval_file(os.path.join(EXAMPLES, "errorCorrection.qasm"), seed=0, backend="stabilizer",
                   dump_state=True, out=out, inspect=lambda st: seen.update(st[1]))
    got = {k: str(v) for k, v in seen.items()}
    log(f"stabilizer cli errorCorrection.qasm: rc {rc}, cregs {got}")
    check(rc == 0 and got == {"c": "000", "syn": "10"} and "Stabilizers of q(x)a" in out.getvalue(),
          f"cli errorCorrection: rc {rc}, {got}")
    n = N_STAB
    src = "\n".join(["qreg q[%d];" % n, "U(pi/2, 0, pi) q[0];"]
                    + [f"CX q[{k}], q[{k + 1}];" for k in range(n - 1)]) + "\n"
    out = io.StringIO()
    (rc, secs) = timed_call(lambda: eval_file("<ghz>.qasm", source=src, seed=2, shots=STAB_SHOTS,
                                              backend="stabilizer", out=out))
    rows = {ln.strip().rpartition(": ")[0]: int(ln.rpartition(": ")[2])
            for ln in out.getvalue().splitlines() if ln.startswith("  |")}
    n0 = rows.get("|" + "0" * n + ">", 0)
    n1 = rows.get("|" + "1" * n + ">", 0)
    log(f"stabilizer cli ghz{n} --shots {STAB_SHOTS}: rc {rc}, {secs:.3f} s, {n0}/{n1}, "
        f"other rows {len(rows) - bool(n0) - bool(n1)}")
    check(rc == 0 and n0 + n1 == STAB_SHOTS and (n0 - n1) ** 2 / STAB_SHOTS < 16,
          f"cli ghz{n}: rc {rc}, {n0}/{n1}")
    log(f"stabilizer host reads in the CLI runs: {Tb.stats['syncs']}")


def mps_opcodes(tapes):
    """Tape rows by opcode name, over (code, ...) tapes or packed codes."""
    import collections

    from qubism_torch.mps import engine as E

    names = {E._OP_2Q: "2q", E._OP_SHIFT_R: "shift_r", E._OP_SHIFT_L: "shift_l",
             E._OP_1Q: "1q", E._OP_NOP: "nop", E._OP_K1Q: "k1q"}
    out = collections.Counter()
    for codes in tapes:
        out.update(names[int(c)] for c in codes)
    return dict(sorted(out.items()))


def mps_instrumented(fn):
    """``fn()`` once with its torch ops counted (utils/profiling), the
    shapes of its SVDs, the names of ops that left a tensor on the CPU, and
    its synchronising calls counted by ``torch.cuda.set_sync_debug_mode``
    ("warn"): (out, {"ops", "svd", "cpu_ops", "syncs"})."""
    import collections
    import warnings

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from qubism_torch.utils.profiling import count_ops

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.svd = collections.Counter()
            self.cpu = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__
            if "svd" in name:
                self.svd[tuple(args[0].shape)] += 1
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if not func.is_view and any(isinstance(o, torch.Tensor) and o.device.type == "cpu"
                                        for o in outs):
                self.cpu[name] += 1
            return out

    syncs = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if DEV == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with Seen() as seen:
                out, ops = count_ops(fn)
            sync()
        finally:
            if DEV == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    heavy = [k for k in seen.cpu if any(s in k for s in ("svd", "mm", "matmul", "einsum"))]
    check(not heavy if DEV == "cuda" else True, f"mps: {heavy} ran on the CPU")
    return out, {"ops": ops, "svd": dict(seen.svd), "cpu_ops": dict(seen.cpu), "syncs": syncs}


def mps_report(label, rows, info, first, warm, peak, extra=""):
    """One line of a part: its seconds, rows, ops (and per row: of the
    tape replay alone where ``info`` has ``tape_ops``), syncs, SVDs, peak."""
    nrows = sum(rows.values())
    per = (f"tape replay {info['tape_ops']} ops, {info['tape_ops'] / max(nrows, 1):.1f} per row"
           if "tape_ops" in info else f"{info['ops'] / max(nrows, 1):.1f} per row")
    log(f"mps {label}: first call {first:.3f} s, warm {warm:.3f} s, tape rows {nrows} {rows}, "
        f"torch ops {info['ops']} ({per}), synchronising "
        f"calls {info['syncs']}, SVDs by shape {info['svd']} ({sum(info['svd'].values())} in "
        f"all), ops with a CPU result {info['cpu_ops']}, peak {peak:.3f} GiB" + extra)


def light_cone_z0(prims, k):
    """<Z_0> of the circuit from its gates inside the first ``k`` qubits
    (exact while qubit 0's backward light cone stays inside them), by the
    dense CompiledCircuit on the device."""
    from qubism_torch.ops.apply import zero_state
    from qubism_torch.ops.fusion import CompiledCircuit
    from qubism_torch.ops.measure import expectation_pauli

    cone = [p for p in prims if all(t < k for t in p.targets)]
    st = CompiledCircuit(k, cone, optimize=False)(zero_state(k))
    return expectation_pauli(st, k, "Z" + "I" * (k - 1))


def run_mps_path():
    """The MPS engine (plain torch with a library SVD: the reference's MPS
    engine is plain XLA), at the JAX package's bench.py shapes: GHZ-40 at
    chi = 4 with 512 samples; brickwork-100 at depth 4, chi = 16 with 256
    samples against a 12-qubit light-cone oracle; 64 noisy trajectories of
    that brickwork under depolarizing:0.001; adaptive chi on brickwork-60
    at depth 6 from chi = 4 (budget 1e-6, max_chi 64); and the CLI
    (teleportation with a dump and shots, a 64-qubit GHZ on the stabilizer
    and mps backends). Each part prints its tape rows by opcode, torch ops
    per row, synchronising calls, SVD shapes and peak."""
    import math

    import numpy as np
    import torch

    from qubism_torch.cli import eval_file
    from qubism_torch.core.gates import Prim
    from qubism_torch.models.circuits import brickwork_prims, brickwork_qasm
    from qubism_torch.mps import MPSSim, MPSTrajectoryProgram
    from qubism_torch.mps.engine import build_tape
    from qubism_torch.qasm.parser import parse_openqasm
    from qubism_torch.utils.profiling import count_ops

    check(not torch.backends.cuda.matmul.allow_tf32, "mps: TF32 matmuls are on")
    h = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
    cx = np.eye(4, dtype=np.complex128)[[0, 1, 3, 2]]

    def part(label, fn, rows, reps=3, replay=None):
        """First call (timed, its peak), one instrumented call, the best of
        ``reps`` warm calls; ``replay`` counts the ops of the tape alone."""
        (out, first), peak = peak_gib(lambda: timed_call(fn))
        _, info = mps_instrumented(fn)
        if replay is not None:
            info["tape_ops"] = count_ops(replay)[1]
        warm = min(timed_call(fn)[1] for _ in range(reps))
        return out, info, first, warm, peak

    # GHZ-40 (bench.py:600-623)
    n = N_MPS_GHZ
    ghz = [Prim(h, (0,))] + [Prim(cx, (q, q + 1)) for q in range(n - 1)]

    def ghz_run():
        sim = MPSSim(n, chi=MPS_GHZ_CHI, seed=0).apply(ghz)
        return sim, sim.sample(MPS_GHZ_SHOTS)

    rows = mps_opcodes([[c for c, _, _ in build_tape(ghz, 0)[0]]])
    (sim, bits), info, first, warm, peak = part(
        f"ghz{n}", ghz_run, rows, replay=lambda: MPSSim(n, chi=MPS_GHZ_CHI).apply(ghz))
    check(sim.sites.is_cuda == (DEV == "cuda"), f"mps ghz{n}: sites on {sim.sites.device}")
    mean = float(bits[:, 0].mean())
    mps_report(f"ghz{n} chi={MPS_GHZ_CHI} + {MPS_GHZ_SHOTS} samples", rows, info, first, warm,
               peak, f"; trunc_error {sim.trunc_error}, rows all equal "
               f"{bool((bits == bits[:, :1]).all())}, mean {mean:.4f} (|mean - 0.5| < 0.0663)")
    check(sim.trunc_error == 0.0, f"mps ghz{n}: trunc_error {sim.trunc_error}")
    check(bits.shape == (MPS_GHZ_SHOTS, n) and (bits == bits[:, :1]).all(),
          f"mps ghz{n}: sample rows differ")
    check(abs(mean - 0.5) < 0.0663, f"mps ghz{n}: mean {mean}")

    # brickwork-100 at depth 4 (bench.py:626-662)
    n, depth = N_MPS_BW, MPS_BW_DEPTH
    prims = brickwork_prims(n, depth, seed=5)
    z0_want = light_cone_z0(prims, MPS_CONE)

    def bw_run():
        sim = MPSSim(n, chi=MPS_BW_CHI, seed=0).apply(prims)
        return sim, sim.sample(MPS_BW_SHOTS)

    rows = mps_opcodes([[c for c, _, _ in build_tape(prims, 0)[0]]])
    (sim, bits), info, first, warm, peak = part(
        f"brickwork{n}", bw_run, rows, replay=lambda: MPSSim(n, chi=MPS_BW_CHI).apply(prims))
    z0 = sim.expectation("Z" + "I" * (n - 1))
    mps_report(f"brickwork{n} depth {depth} chi={MPS_BW_CHI} + {MPS_BW_SHOTS} samples", rows,
               info, first, warm, peak, f"; trunc_error {sim.trunc_error}, <Z0> {z0:.6f} "
               f"against the {MPS_CONE}-qubit light cone's {z0_want:.6f} (1e-4), samples "
               f"{bits.shape}")
    check(sim.sites.is_cuda == (DEV == "cuda"), f"mps brickwork{n}: sites on {sim.sites.device}")
    check(sim.trunc_error == 0.0, f"mps brickwork{n}: trunc_error {sim.trunc_error}")
    check(abs(z0 - z0_want) < 1e-4, f"mps brickwork{n}: <Z0> {z0} vs {z0_want}")
    check(bits.shape == (MPS_BW_SHOTS, n), f"mps brickwork{n}: samples {bits.shape}")

    # 64 noisy trajectories of it (bench.py:664-692)
    src = brickwork_qasm(n, depth, seed=5)
    prog = MPSTrajectoryProgram(parse_openqasm(os.path.join(EXAMPLES, "<chip_smoke>.qasm"), src),
                                noise=MPS_NOISE, chi=MPS_BW_CHI)
    rows = mps_opcodes([t[0] for t in prog._tapes()[0]])

    def noisy_run(seed=1):
        return prog.run_vals(MPS_NOISY_T, seed=seed)["c"]

    mbits, info, first, warm, peak = part(f"noisy brickwork{n}", noisy_run, rows, reps=1)
    on_card = sorted({dev for _, dev in prog._dev_tapes})
    p0 = float(mbits[:, 0].mean())
    p0_want = (1.0 - float(z0_want)) / 2.0
    sigma = math.sqrt(p0_want * (1 - p0_want) / MPS_NOISY_T)
    mps_report(f"noisy brickwork{n} {MPS_NOISE} x {MPS_NOISY_T} trajectories", rows, info, first,
               warm, peak, f"; {warm:.3f} s per {MPS_NOISY_T} trajectories, stochastic sites "
               f"{prog.sites}, operands on {on_card}, P(q0 = 1) {p0:.4f} against "
               f"{p0_want:.4f} (3 sigma + 0.04 = {3 * sigma + 0.04:.4f})")
    check(all(d.startswith(DEV) for d in on_card), f"mps noisy: operands on {on_card}")
    check(abs(p0 - p0_want) < 3 * sigma + 0.04, f"mps noisy brickwork{n}: {p0} vs {p0_want}")

    # adaptive chi at a bond the card notices
    n, depth = N_MPS_ADAPT, MPS_ADAPT_DEPTH
    prims = brickwork_prims(n, depth, seed=7)
    z0_want = light_cone_z0(prims, MPS_CONE)

    def adapt_run():
        return MPSSim(n, chi=4, seed=0, trunc_budget=MPS_BUDGET, max_chi=MPS_MAX_CHI).apply(prims)

    rows = mps_opcodes([[c for c, _, _ in build_tape(prims, 0)[0]]])
    sim, info, first, warm, peak = part(f"adaptive brickwork{n}", adapt_run, rows, reps=1)
    z0 = sim.expectation("Z" + "I" * (n - 1))
    mps_report(f"adaptive brickwork{n} depth {depth} from chi=4 (budget {MPS_BUDGET:g}, "
               f"max_chi {MPS_MAX_CHI})", rows, info, first, warm, peak,
               f"; final chi {sim.chi}, rollbacks {int(math.log2(sim.chi // 4))} (each a rerun "
               f"of the tape at twice the chi), trunc_error {sim.trunc_error:.3e}, <Z0> "
               f"{z0:.6f} against the light cone's {z0_want:.6f}")
    check(sim.chi <= MPS_MAX_CHI and sim.trunc_error <= MPS_BUDGET,
          f"mps adaptive: chi {sim.chi}, trunc_error {sim.trunc_error}")
    check(abs(z0 - z0_want) < 1e-4, f"mps adaptive: <Z0> {z0} vs {z0_want}")

    # the CLI (tests/test_cli.py:237-279)
    out = io.StringIO()
    seen = {}
    (rc, secs) = timed_call(lambda: eval_file(
        os.path.join(EXAMPLES, "teleportation.qasm"), seed=1, backend="mps", chi=4,
        dump_state=True, shots=64, out=out, inspect=lambda st: seen.update(sim=st[0])))
    text = out.getvalue()
    log(f"mps cli teleportation.qasm --backend mps --chi 4 --dump-state --shots 64: rc {rc}, "
        f"{secs:.3f} s, sites on {seen['sim'].sites.device}, "
        + " | ".join(ln for ln in text.splitlines() if ln.startswith(("MPS of", "  |", "CReg"))))
    check(rc == 0 and "mps backend" in text and "chi=4" in text and "Counts for state vector q"
          in text and seen["sim"].sites.is_cuda == (DEV == "cuda"), f"mps cli: rc {rc}")
    n = N_MPS_CLI
    src = "\n".join(["qreg q[%d];" % n, "U(pi/2, 0, pi) q[0];"]
                    + [f"CX q[{k}], q[{k + 1}];" for k in range(n - 1)]) + "\n"
    for backend, kw in (("stabilizer", {}), ("mps", {"chi": 4})):
        out = io.StringIO()
        rc, secs = timed_call(lambda: eval_file("<ghz>.qasm", source=src, seed=0, shots=32,
                                                backend=backend, out=out, **kw))
        rows = [ln for ln in out.getvalue().splitlines() if ln.startswith("  |")]
        ok = rc == 0 and all(r.strip().startswith(("|" + "0" * n + ">", "|" + "1" * n + ">"))
                             for r in rows)
        log(f"mps cli ghz{n} --backend {backend} --shots 32: rc {rc}, {secs:.3f} s, "
            f"{len(rows)} distinct rows, all GHZ outcomes {ok}")
        check(ok, f"mps cli ghz{n} {backend}: rc {rc}")


#: seconds per trajectory of the timed runs, by engine and program
def run_protocols_path():
    """The protocol models on the card's engines: linear XEB of the
    compiled brickwork-30 state (8192 of its own samples) against
    2^n sum p^2 - 1 summed on the card, within 5 of its standard errors;
    grouped shot estimation on the QAOA-28 state (4096 shots per group)
    within 5 standard errors of ``expectation_pauli_sum``; classical shadows
    at n = 20 (2-local Paulis within 5 of their standard deviation bound,
    3/sqrt(T)); MLAE at n = 16; Shor on 15 and 21; quantum volume at m = 6
    (density against trajectories); 2-qubit RB against the depolarizing
    law; simultaneous RB on 100 qubits on Pauli frames; ZNE at n = 12."""
    import numpy as np
    import torch

    from qubism_torch import models as Q
    from qubism_torch.core.density import depolarizing, depolarizing2
    from qubism_torch.core.gates import Prim
    from qubism_torch.core.statevec import StateVec
    from qubism_torch.models import variational as V
    from qubism_torch.ops import measure as M
    from qubism_torch.ops.fusion import CompiledCircuit

    def timed(fn):
        out, secs = timed_call(fn)
        return out, f"{secs:.3f} s"

    # XEB of brickwork-30
    n = N_BIG
    circ = CompiledCircuit(n, Q.brickwork_prims(n, 4, seed=7))
    state = circ(circ.init_state())
    sv = StateVec(n, state)
    idx, secs = timed(lambda: Q.counts_to_indices(sv.sample(XEB_SHOTS, seed=17)))
    (f, se), fsecs = timed(lambda: Q.xeb_stderr(sv, idx))
    sum_p2 = 0.0
    for part in state.split(1 << 24):
        sum_p2 += float((torch.view_as_real(part).double().square().sum(-1) ** 2).sum())
    exact = (1 << n) * sum_p2 - 1.0
    log(f"protocols xeb brickwork{n}: F = {f:.5f} +- {se:.5f} from {XEB_SHOTS} samples "
        f"({secs} sampling, {fsecs} scoring), 2^n sum p^2 - 1 = {exact:.5f}")
    check(abs(f - exact) <= 5 * se, f"xeb{n}: {f} +- {se} against {exact}")
    del circ, state, sv
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # grouped shot estimation on the QAOA-28 state
    n = N_QAOA
    ans, _, _ = qaoa_ring(n, 2)
    prims = V.bind(ans, np.full(ans.num_params, 0.25))
    terms = ([(0.5, mixed_pauli(n, {i: "Z", (i + 1) % n: "Z"})) for i in range(n)]
             + [(0.3, mixed_pauli(n, {i: "X"})) for i in range(n)]
             + [(0.2, mixed_pauli(n, {i: "Y", (i + 1) % n: "Y"})) for i in range(0, n, 2)])
    groups, _ = Q.qwc_groups([p for _, p in terms])
    (mean, err), secs = timed(lambda: Q.estimate_pauli_sum(
        prims, n, terms, shots=EST_SHOTS * len(groups), seed=5, allocation="uniform"))
    circ = CompiledCircuit(n, prims)
    exact = M.expectation_pauli_sum(circ(circ.init_state()), n, terms)
    del circ
    log(f"protocols estimate_pauli_sum qaoa{n}: {mean:.5f} +- {err:.5f} ({len(terms)} terms "
        f"in {len(groups)} groups, {EST_SHOTS} shots a group, {secs}); exact {exact:.5f}")
    check(abs(mean - exact) <= 5 * err, f"estimate{n}: {mean} +- {err} against {exact}")
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # classical shadows at n = 20
    n = N_SHADOW
    prims = Q.brickwork_prims(n, 3, seed=3)
    rec, secs = timed(lambda: Q.shadow_snapshots(prims, n, SHADOW_T, seed=9))
    circ = CompiledCircuit(n, prims)
    psi = circ(circ.init_state())
    paulis = [mixed_pauli(n, {q: a, q + 1: b}) for q in (0, n // 3, 2 * n // 3, n - 2)
              for a, b in (("Z", "Z"), ("X", "X"), ("Y", "Z"))]
    bound = 5 * 3.0 / math.sqrt(SHADOW_T)
    worst = max(abs(Q.shadow_expectation(rec, p) - M.expectation_pauli(psi, n, p))
                for p in paulis)
    log(f"protocols shadows n={n}: {SHADOW_T} snapshots in {secs}; {len(paulis)} 2-local "
        f"Paulis, worst |estimate - exact| {worst:.4f} (bound 5 x 3/sqrt(T) = {bound:.4f})")
    check(worst <= bound, f"shadows{n}: {worst} > {bound}")
    del circ, psi

    # MLAE at n = 16
    n = N_MLAE
    h = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
    good = tuple(int(x) for x in np.random.default_rng(4).choice(1 << n, 900, replace=False))
    res, secs = timed(lambda: Q.mlae_estimate([Prim(h, (q,)) for q in range(n)], n, good,
                                                      shots=256, seed=11))
    log(f"protocols mlae n={n}: a_hat {res.a_hat:.6f}, exact {res.a_exact:.6f} "
        f"({900 / 2**n:.6f}), {res.queries} queries, {secs}")
    check(abs(res.a_exact - 900 / 2**n) < 1e-5 and abs(res.a_hat - res.a_exact) < 0.1 * res.a_exact,
          f"mlae{n}: {res}")

    # Shor: the factors, and the order-finding circuits themselves (a
    # factor can come from a lucky gcd without one)
    for n_mod, t in ((15, None), (21, 9)):
        (p, q), secs = timed(lambda: Q.shor_factor(n_mod, seed=1, t=t))
        log(f"protocols shor_factor({n_mod}) = {p} x {q} ({secs})")
        check(p * q == n_mod and 1 < p < n_mod, f"shor {n_mod}: {p} x {q}")
    for a, n_mod, t, want in ((7, 15, 9, 4), (2, 21, 9, 6)):
        r, secs = timed(lambda: Q.estimate_order(a, n_mod, t=t, shots=48, seed=3))
        log(f"protocols estimate_order({a}, {n_mod}, t={t}) = {r} on "
            f"{t + (n_mod - 1).bit_length()} qubits ({secs})")
        check(r == want, f"order of {a} mod {n_mod}: {r}, not {want}")

    # quantum volume at m = 6: density against trajectories
    kraus2 = depolarizing2(0.02)
    exact, secs = timed(lambda: Q.qv_experiment(m=QV_M, n_circuits=QV_CIRCUITS, seed=3,
                                                     kraus2=kraus2))
    est, tsecs = timed(lambda: Q.qv_experiment(m=QV_M, n_circuits=QV_CIRCUITS, seed=3,
                                                    kraus2=kraus2, executor="trajectories",
                                                    ntraj=512))
    gap = max(abs(a - b) for a, b in zip(exact.hops, est.hops))
    log(f"protocols qv m={QV_M}: heavy-output mean {exact.hop_mean:.4f} by density ({secs}), "
        f"{est.hop_mean:.4f} by 512 trajectories ({tsecs}), worst circuit gap {gap:.4f}")
    check(gap < 0.08, f"qv{QV_M}: density {exact.hops} against trajectories {est.hops}")

    # RB on 2 qubits against the depolarizing law
    p = 0.03
    (_, _, alpha, r), secs = timed(lambda: Q.rb_experiment(2, depolarizing2(p),
                                                                 ms=(1, 2, 4, 8), n_seq=4,
                                                                 seed=2))
    log(f"protocols rb k=2: alpha {alpha:.7f} against 1 - 16p/15 = {1 - 16 * p / 15:.7f}, "
        f"r {r:.6f} ({secs})")
    check(abs(alpha - (1 - 16 * p / 15)) < 1e-6, f"rb: alpha {alpha}")

    # simultaneous RB at n = 100 on Pauli frames
    (surv, expected, frames), secs = timed(lambda: Q.simultaneous_rb_survivals(
        N_SRB, 4, 0.02, ntraj=2048, seed=6))
    sigma = np.sqrt(expected * (1 - expected) / 2048)
    worst = float((np.abs(surv - expected) / sigma).max())
    log(f"protocols simultaneous rb n={N_SRB}: frames {frames}, worst |surv - law| "
        f"{worst:.2f} sigma ({secs})")
    check(frames and worst < 5, f"simultaneous rb: frames {frames}, {worst} sigma")

    # ZNE at n = 12
    n = N_ZNE
    (est, vals), secs = timed(lambda: Q.zne_expectation(
        Q.ghz_prims(n), n, "Z" * n, kraus1=depolarizing(0.005), kraus2=depolarizing2(0.01),
        scales=(1, 3, 5), method="exp"))
    log(f"protocols zne ghz{n} <Z^{n}>: raw {vals}, extrapolated {est:.5f} ({secs})")
    check(abs(est - 1.0) < abs(vals[0] - 1.0) / 3, f"zne{n}: {est} from {vals}")


def time_probes_beside_library():
    """The stream probes beside their library call (P1 and P11, the phase
    in place at 256x1, 256x4 and 1024x4, beside ``mul_``; P3
    ``phase_out_256x4`` beside ``torch.mul(..., out=)``; P2's copy at 256x1,
    256x4 and 1024x4 beside ``copy_``; P4 ``read_256x4`` beside
    ``torch.sum``; P5 ``write_256x4`` beside ``fill_``), each pair timed
    alternately in one window, three rounds (``bw_probe.time_pass``: a
    warm-up, best of 3 windows of 16 calls). The rows reuse the memory
    PyTorch's allocator holds, as ``bw_probe`` does: nothing is freed with
    cudaFree between them, since passes right after a large free run
    slower. Run after the paths' counts were read: not their work."""
    from qubism_torch.experiments import bw_probe

    for variant in PROBE_LIBRARY_ROWS:
        probe = bw_probe.VARIANTS[variant](N_TIME, DEV)
        kern, lib = [], []
        for _ in range(3):
            kern.append(bw_probe.time_pass(probe.run))
            lib.append(bw_probe.time_pass(probe.library))
        spread = max(max(kern) - min(kern), max(lib) - min(lib))
        verdict = ("loses by more than the spread" if min(kern) - min(lib) > spread
                   else "within the spread")
        log(f"probe beside library {variant}: kernel ms {[round(t, 4) for t in kern]}, "
            f"library ms {[round(t, 4) for t in lib]}, best {min(kern):.4f} vs {min(lib):.4f}: "
            f"{verdict} ({spread:.4f})")
        del probe


TRAJ_TIMES = {}


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

    from qubism_torch import native
    from qubism_torch.config import config
    from qubism_torch.ops import build, kernels, probes

    check(config.device == "cuda", f"config.device is {config.device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build.library_path()})")
    t0 = time.perf_counter()
    check(native.ensure_built() is not None,
          f"the native lexer did not build: {native.build_error}")
    log(f"native lexer build: {time.perf_counter() - t0:.1f} s ({native.library_path()})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    report = {name: {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                     "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
                     "bound_ms": None, "bound_by": None, "library_ms": None, "dev_ms": None}
              for name, (src, tpu) in KERNELS.items()}

    t0 = time.perf_counter()
    phase_kernels(report)
    phase_device_operands(report)
    phase_butterfly(report)
    phase_probe_kernels(report)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    # each path with the counters set to 0 just before it and read just after
    paths = {"file path": run_main_path, "compiled path": run_compiled_path,
             "DSL": run_dsl_path, "bandwidth probe": lambda: run_bw_probe(report),
             "mesh path": run_mesh_path, "observables": run_observables_path,
             "density path": run_density_path, "mesh density path": run_mesh_density_path,
             "variational": run_variational_path,
             "variational mesh": run_variational_mesh_path, "dynamics": run_dynamics_path,
             "trajectories": run_trajectories_path, "stabilizer": run_stabilizer_path,
             "mps": run_mps_path, "protocols": run_protocols_path}

    def since(counts, before):
        return {k: v - before.get(k, 0) for k, v in counts.items() if v > before.get(k, 0)}

    for label, drive in paths.items():
        torch.cuda.reset_peak_memory_stats()
        PEAK[0] = 0
        t0 = time.perf_counter()
        timed_before, ref_before = dict(TIMED), dict(REFERENCE)
        kernels.reset_launches()
        probes.reset_launches()
        drive()
        launches = {**kernels.launches, **probes.launches}
        timed, ref = since(TIMED, timed_before), since(REFERENCE, ref_before)
        log(f"phase {label}: {time.perf_counter() - t0:.1f} s, launches {launches}"
            + (f" (in timing calls {timed})" if timed else "")
            + (f" (by the single-device reference {ref})" if ref else "")
            + f", peak {max(PEAK[0], torch.cuda.max_memory_allocated()) / 2**30:.1f} GiB")
        log(f"phase {label}: diag launches by (factors, widest k): "
            f"{ {f'{f}x{k}': c for (f, k), c in sorted(kernels.diag_shapes.items())} }")
        for name in KERNELS:
            report[name]["launches"] += launches[name] - ref.get(name, 0)
        for name in PATH_KERNELS[label]:
            own = launches[name] - timed.get(name, 0) - ref.get(name, 0)
            check(own > 0, f"the {label} never launched the {name} kernel")

    time_file_path_warm()  # after the paths' counts were read: not their work
    time_parse()
    time_probes_beside_library()

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
