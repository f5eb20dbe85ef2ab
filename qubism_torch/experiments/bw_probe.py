"""HBM bandwidth probe of the port: what one pass over the state sustains on
the card for each access pattern, and how the launch geometry moves it.

    python -m qubism_torch.experiments.bw_probe [n] [variant ...]
    python -m qubism_torch.experiments.bw_probe canon [n]

``n`` (default 28, at least 24 so that the state outgrows the card's 50 MB
L2) is the number of qubits: a complex64 state of 2^n amplitudes, made on
the card from a fixed seed. A variant is a key of :data:`VARIANTS` or of
:data:`JAX_VARIANTS` (the JAX package's probe names, each run as the port
variant that carries its function); without names every variant runs, and
``canon`` runs the four of the JAX probe's ``main_canon``.

Timing: one warm-up pass, then :data:`K` passes back to back between two
CUDA events, best of :data:`REPS` windows. The variants reuse the memory
PyTorch's allocator holds, and none frees it (cudaFree): right after
gigabytes are freed the card's passes run slower for some 100 ms. Each
variant prints one JSON line: ``variant``, ``n``, ``kernel`` (the port
kernel it launches, or null for the library yardstick), ``ms_per_pass``,
``gbps`` (the bytes the pass must move over its time), ``bound_ms`` and
``bound_by`` (the least time of one H100 SXM for those bytes and
operations, :func:`qubism_torch.ops.probes.bound`),
``frac_peak`` (``gbps`` over 3350 GB/s), ``frac_bound``, ``plain_ms``
(the kernel's plain version), ``library_ms`` (one PyTorch call computing the
same function, where there is one; a pair pass without tables: one
``torch.einsum`` of its 2x2 over the pair view) and ``library_rel_l2`` (that
call's result against the plain version's, where it is held: it must be
within :data:`LIBRARY_TOL`), ``launches`` (kernel launches counted in
the variant's timed run), ``replaces`` (the JAX names it stands for), and
the card's ``device`` name and ``power_limit`` (``nvidia-smi``).

Needs a CUDA GPU: without one it exits 2 and runs nothing. It exits 1 if a
variant reads above :data:`MAX_FRAC_PEAK` of the published peak (a pass the
compiler dropped, or a broken timer).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops import kernels, probes

N_DEFAULT = 28
#: the smallest n whose state (2^n * 8 bytes) outgrows the card's 50 MB L2
N_MIN = 24
K = 16  # passes per timed window
REPS = 3  # windows; the best is kept
#: a reading above this share of the published peak is a broken measurement
MAX_FRAC_PEAK = 1.05
#: the most a library call may differ from the plain version (relative L2)
LIBRARY_TOL = 1e-5
PEAK_GBPS = probes.PEAK_BYTES_PER_S / 1e9

_H = np.float32(0.70710678)
HADAMARD = np.array([[_H, _H], [_H, -_H]], dtype=np.complex64)


@dataclass
class Probe:
    """One variant, built at n qubits on a device: ``run`` is one pass of
    ``kernel`` (None: the library yardstick itself) over ``state``,
    ``plain`` the same pass by the plain version, ``library`` by one
    PyTorch call (or None); ``nbytes`` and ``flops`` are what one pass must
    move and compute (``tf32x3``: bounded by the TF32 rate, see
    ``probes.bound``)."""

    kernel: str | None
    state: torch.Tensor
    run: Callable[[], object]
    plain: Callable[[], object] | None
    library: Callable[[], object] | None
    nbytes: int
    flops: int
    #: the operations run as three TF32 products on the tensor cores
    tf32x3: bool = False
    #: relative L2 of the library call's result against the plain version's
    #: (None: not held, the library call updates the state in place)
    library_err: float | None = None


def _state(n: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(n)
    s = torch.randn(1 << n, dtype=torch.complex64, device=device, generator=g)
    return s.div_(torch.linalg.vector_norm(s))


#: the kernel that carries each stream mode (its launch counter)
STREAM_KERNEL = {"copy": "probe_copy", "read": "probe_read", "phase": "probe_stream",
                 "write": "probe_stream"}


def _stream(mode: str, geometry, second: bool = False):
    """A stream pass; ``second``: phase into a second buffer."""

    def build(n, device):
        s = _state(n, device)
        out = torch.empty_like(s) if second or mode == "copy" else None
        target = s if out is None else out
        library = {
            "copy": lambda: out.copy_(s),
            "phase": lambda: torch.mul(s, probes.PHASE, out=target),
            "read": lambda: torch.sum(torch.view_as_real(s)),
        }.get(mode)
        if mode == "write":
            v = torch.view_as_real(s)[0, 0].clone()
            value = torch.complex(v, v * 0.5)
            library = lambda: target.fill_(value)  # noqa: E731
        return Probe(STREAM_KERNEL[mode], s,
                     lambda: probes.stream(s, mode, n, out, geometry=geometry),
                     lambda: probes.stream_plain(s, mode, n, out),
                     library, *probes.stream_cost(mode, n))

    return build


def _torch_phase(n, device):
    """``state.mul_(c)``: the library yardstick where the JAX probe timed
    XLA's own phase multiply; no kernel."""
    s = _state(n, device)
    return Probe(None, s, lambda: s.mul_(probes.PHASE), None, None,
                 *probes.stream_cost("phase", n))


def _unitary(k: int, rng) -> np.ndarray:
    m = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0]


def _pair(q_of_n, tables: str = "", coef: str = "h", phase=probes.PHASE,
          geometry=probes.DEFAULT_GEOMETRY):
    """A pair pass on qubit ``q_of_n(n)``. ``coef`` "h" (Hadamard) or "u" (a
    random unitary); ``tables`` names the tables given ("row", "lane" or
    both), unit-modulus and seeded, so repeated passes keep the norm."""

    def build(n, device):
        q = q_of_n(n)
        rng = np.random.default_rng(q)
        u = HADAMARD if coef == "h" else _unitary(1, rng)
        tail = 1 << (n - 1 - q)
        C = min(2048, tail)

        def table(size):
            t = np.exp(1j * rng.uniform(0, 2 * math.pi, size)).astype(np.complex64)
            return torch.from_numpy(t).to(device)

        row = table(tail // C) if "row" in tables else None
        lane = table(C) if "lane" in tables else None
        s = _state(n, device)
        kw = dict(phase=phase, row=row, lane=lane)
        library, err = None, None
        if not tables:
            # one torch.einsum of the 2x2 (the |1> phase folded into its
            # second row) over the (rest, 2, tail) pair view, into a new
            # tensor, held against the plain version first. With a row or
            # lane table the phase depends on the position: no single call
            # computes it without a state-sized table multiplied out first.
            cf = np.asarray(u, dtype=np.complex128).reshape(2, 2) * np.array([[1], [phase]])
            m = torch.from_numpy(cf.astype(np.complex64)).to(device)
            library = lambda: torch.einsum("ij,xjy->xiy", m, s.view(-1, 2, tail))  # noqa: E731
            want = probes.pair_plain(s.clone(), q, u, n, **kw)
            got = library().reshape(-1)
            err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
            del want, got
        return Probe("probe_pair", s,
                     lambda: probes.pair(s, q, u, n, geometry=geometry, **kw),
                     lambda: probes.pair_plain(s, q, u, n, **kw),
                     library, *probes.pair_cost(n, row, lane), library_err=err)

    return build


def _lane(n, device):
    """K3 with U = M^T: the JAX probe's x . M on every 128-amplitude row."""
    s = _state(n, device)
    u = _unitary(7, np.random.default_rng(7))
    plan = kernels.lane_prepare(u, n, device)
    ut = torch.from_numpy(np.ascontiguousarray(u.T, dtype=np.complex64)).to(device)
    buf = torch.empty_like(s).view(-1, 128)
    amps = 1 << n
    return Probe("lane", s, lambda: kernels.lane(s, plan, n),
                 lambda: kernels.lane_plain(s, plan, n),
                 lambda: torch.matmul(s.view(-1, 128), ut, out=buf),
                 16 * amps + 128 * 128 * 8, amps * 128 * 8, tf32x3=True)


#: port variant -> a function (n, device) -> Probe. "<kind>_<T>x<V>" is a
#: launch geometry: T threads per block, V 16-byte vectors (stream) or
#: items of two pairs (pair) per thread and step.
VARIANTS: dict[str, Callable] = {
    "torch_phase": _torch_phase,
    "copy_256x1": _stream("copy", (256, 1)),
    "copy_256x4": _stream("copy", (256, 4)),
    "copy_1024x4": _stream("copy", (1024, 4)),
    "phase_256x1": _stream("phase", (256, 1)),
    "phase_256x4": _stream("phase", (256, 4)),
    "phase_1024x4": _stream("phase", (1024, 4)),
    "phase_out_256x4": _stream("phase", (256, 4), second=True),
    "read_256x4": _stream("read", (256, 4)),
    "write_256x4": _stream("write", (256, 4)),
    "pair_q5": _pair(lambda n: 5),
    "pair_q5_256x1": _pair(lambda n: 5, geometry=(256, 1)),
    "pair_q5_512x4": _pair(lambda n: 5, geometry=(512, 4)),
    "pair_q14": _pair(lambda n: 14),
    "pair_q17": _pair(lambda n: 17),
    "pair_q20": _pair(lambda n: 20),
    "pair_q5_tables": _pair(lambda n: 5, tables="row lane", coef="u"),
    "pair_q5_coef": _pair(lambda n: 5, coef="u"),
    "pair_q5_row": _pair(lambda n: 5, tables="row"),
    "pair_q5_lane": _pair(lambda n: 5, tables="lane", phase=1),
    "pair_s512": _pair(lambda n: n - 10, phase=1),
    "pair_s4096": _pair(lambda n: n - 13, phase=1),
    "lane_matmul": _lane,
}

#: the JAX probe's names (its VARIANTS, then main_canon's four) -> the port
#: variant that carries the same function. The TPU's (BR, C) VMEM blocks
#: become launch geometries by size: blocks of up to 2^18 amplitudes ->
#: 256x1, up to 2^20 -> 256x4, larger -> 1024x4, and the stage probes' three
#: block shapes take the pair kernel's three geometries; they do not map one
#: to one. dimension_semantics=("arbitrary",) (the "_arb" names) has no
#: counterpart: CUDA blocks run in no set order, so an "_arb" name runs the
#: variant of its name without the suffix.
JAX_VARIANTS: dict[str, str] = {
    "xla": "torch_phase",
    "copy_128x2048": "copy_256x1",
    "copy_512x8192": "copy_1024x4",
    "phase_128x2048": "phase_256x1",
    "phase_128x2048_arb": "phase_256x1",
    "phase_512x2048": "phase_256x4",
    "phase_128x8192": "phase_256x4",
    "phase_512x8192": "phase_1024x4",
    "phase_1024x8192": "phase_1024x4",
    "phase_512x8192_arb": "phase_1024x4",
    "phase_2048x8192": "phase_1024x4",
    "phase_8x131072": "phase_256x4",
    "phase_128x2048_noalias": "phase_out_256x4",
    "phase_256x4096": "phase_256x4",
    "phase_256x4096_arb": "phase_256x4",
    "read_only_128x2048": "read_256x4",
    "write_only_128x2048": "write_256x4",
    # the (A, 2, B, C) stage blocks: BB rows of C lanes per half
    "stage_q5_bb128_c2048": "pair_q5",
    "stage_q5_bb512_c2048": "pair_q5_512x4",
    "stage_q5_bb64_c8192": "pair_q5_256x1",
    "stage_q20_flat": "pair_q20",
    "stage_q17_flat": "pair_q17",
    "stage_q14_flat": "pair_q14",
    "stage_q5_flat": "pair_q5",
    "stage_q5_full_tables": "pair_q5_tables",
    "stage_q5_smem_only": "pair_q5_coef",
    "stage_q5_bt_only": "pair_q5_row",
    "stage_q5_ct_only": "pair_q5_lane",
    # main_canon
    "canon_phase_2d": "phase_256x4",
    "roll_lane_s512": "pair_s512",
    "roll_row_sr2": "pair_s4096",
    "lane_matmul_canon": "lane_matmul",
}
CANON = ("canon_phase_2d", "roll_lane_s512", "roll_row_sr2", "lane_matmul_canon")


def _counts() -> dict:
    return {**probes.launches, "lane": kernels.launches["lane"]}


def time_pass(fn, k: int = K, reps: int = REPS) -> float:
    """Milliseconds per call: one warm-up call, then the best of ``reps``
    windows of ``k`` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(k):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / k)
    return best


def card() -> tuple[str, str | None]:
    """The card's name and its power limit as nvidia-smi prints it."""
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return name, None
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not lines or ", " not in lines[0]:
        return name, None
    return name, lines[0].rsplit(", ", 1)[1]


def measure(name: str, n: int, device="cuda", card_info=(None, None)) -> dict:
    """Build variant ``name`` at n qubits and time it, its plain version and
    its library call; the result line (see the module docs)."""
    probe = VARIANTS[name](n, device)
    kernel = probe.kernel
    before = _counts()
    ms = time_pass(probe.run)
    launched = _counts()[kernel] - before[kernel] if kernel else 0
    plain_ms = time_pass(probe.plain) if probe.plain else None
    library_ms = time_pass(probe.library) if probe.library else None
    library_err = probe.library_err
    if library_err is not None and library_err > LIBRARY_TOL:
        raise RuntimeError(f"bw_probe {name}: the library call differs from the plain "
                           f"version by {library_err:.3e} (relative L2)")
    bound_ms, bound_by = probes.bound(probe.nbytes, probe.flops, probe.tf32x3)
    gbps = probe.nbytes / ms / 1e6
    # the memory stays with PyTorch's allocator for the next variant: freed
    # with cudaFree (empty_cache), gigabytes slow the card's passes for a
    # while after, and the next variant would be timed in it
    del probe
    return {"variant": name, "n": n, "kernel": kernel, "ms_per_pass": ms,
            "gbps": gbps, "bound_ms": bound_ms, "bound_by": bound_by,
            "frac_peak": gbps / PEAK_GBPS, "frac_bound": bound_ms / ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_rel_l2": library_err, "launches": launched,
            "replaces": [j for j, p in JAX_VARIANTS.items() if p == name],
            "device": card_info[0], "power_limit": card_info[1]}


def run(n: int, names, device="cuda", emit=print) -> list[dict]:
    """Measure each variant (port or JAX names, each port variant once) and
    ``emit`` its JSON line as it comes."""
    info = card() if device != "cpu" else ("cpu", None)
    lines = []
    for name in dict.fromkeys(JAX_VARIANTS.get(v, v) for v in names):
        line = measure(name, n, device, info)
        emit(json.dumps(line))
        lines.append(line)
    return lines


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    canon = "canon" in args
    args = [a for a in args if a != "canon"]
    n = int(args.pop(0)) if args and args[0].isdigit() else N_DEFAULT
    names = args or (list(CANON) if canon else list(VARIANTS))
    unknown = [v for v in names if v not in VARIANTS and v not in JAX_VARIANTS]
    if unknown:
        print(f"bw_probe: unknown variants {unknown}; known: {sorted(VARIANTS)} and the "
              f"JAX names {sorted(JAX_VARIANTS)}", file=sys.stderr)
        return 2
    if n < N_MIN:
        print(f"bw_probe: n = {n} < {N_MIN}: the state would fit in the card's L2",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bw_probe: needs a CUDA GPU (torch.cuda.is_available() is False); "
              "it does not run on the CPU", file=sys.stderr)
        return 2
    lines = run(n, names, emit=lambda s: print(s, flush=True))
    bad = [x["variant"] for x in lines if x["frac_peak"] > MAX_FRAC_PEAK]
    if bad:
        print(f"bw_probe: {bad} read above {MAX_FRAC_PEAK:.0%} of {PEAK_GBPS:.0f} GB/s",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
