"""Run one cell of ``BENCHMARK.json`` once.

A cell names a configuration (``qbench/configs/<config>.json``: the circuit
family and its sizes) and its own file ``qbench/cells/<cell>.json`` (the
entry that drives a program, the traffic's parameters and the limits of the
check). The family's generator is ``qbench/circuits/<family>.py``, the entry
``qbench/entries/<entry>.py`` and each metric's reader
``qbench/metrics/<metric>.py``; all are found by these names, so a new cell,
configuration, entry or metric is new files and new entries in
``BENCHMARK.json``.

The loop is closed with one caller: a program is submitted, its result
waited for, then the next is submitted, until ``seconds`` have passed. Each
program's inputs are drawn from the run's seed and its index before its
clock starts. Set-up is the process's start until the window opens: imports,
the card, the kernel library and native lexer from the checkout's build
cache, the entry's own set-up and one warm program of the cell's shapes.

A family (``qbench/circuits/<family>.py``) defines ``draw(cfg, seed)``, a
program's parameters from its seed, and whichever of these its entries and
its check use (an entry may read more: ``entries/compiled.py`` reads
``body`` and ``basis``):

* ``text(cfg, p)``: the program as OpenQASM 2.0, for the file entries;
* ``gates(cfg, p)``: its gate list from |0...0>, ``[(u, targets, diag)]``,
  for the plain reference ``qbench.reference.simulate``; needed where the
  cell's limits name ``amps_err``, ``state_err`` or ``xeb_gap``;
* ``closed_form(cfg, p, idx)``: its final amplitudes at ``idx``, held
  against every program's fingerprint under ``amps_err``;
* ``numbers(cfg, p, device, tf32=False)``: the plain reference's values of
  what the program returns, ``{name: np.ndarray}``, for ``numbers_err``;
  plain PyTorch or NumPy, nothing of the program; with ``tf32`` every
  product's inputs rounded to TF32, as ``simulate(..., tf32=True)`` does;
* ``probs(cfg, ref)``: the distribution the shots are drawn from, given
  the reference's vector; |ref|^2 where it has none.

An entry (``qbench/entries/<entry>.py``) has ``make(ctx)``, whose object
has ``prepare(p, seed)`` (outside the clock) and ``program(inputs) ->
Outcome``; where the cell checks ``state_err``, ``answer()``, the last
program's final state; and optionally ``release()``, which frees the
entry's memory before the references run. ``qbench/check.py`` says what is
compared and when a program counts as failed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "qubism_tpu")


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def plugin(root: Path, kind: str, name: str):
    """The module ``qbench/<kind>/<name>.py`` under ``root``."""
    path = Path(root) / "qbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"qbench: no {kind} file for {name!r} at {path}")
    mod_name = "qbench._" + kind + "_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    spec: dict        # qbench/cells/<name>.json
    cfg: dict         # the configuration's file, with any overrides
    family: object    # qbench/circuits/<family>.py
    entry: object     # qbench/entries/<entry>.py
    end_to_end: list  # BENCHMARK.json's metric entries that this cell reports
    per_layer: list
    root: Path

    @property
    def n(self) -> int:
        return self.cfg["num_qubits"]


def load_cell(name: str, root: Path = ROOT, overrides: dict | None = None) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"qbench: no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = {**json.loads((root / conf["file"]).read_text()), **(overrides or {})}
    spec = json.loads((root / "qbench" / "cells" / f"{name}.json").read_text())
    if spec["config"] != w["config"]:
        raise ValueError(f"qbench: cell {name} names config {spec['config']}, "
                         f"BENCHMARK.json {w['config']}")

    def mine(metrics):
        return [m for m in metrics if "workloads" not in m or name in m["workloads"]]

    return Cell(name, w["chips"], spec, cfg, plugin(root, "circuits", cfg["family"]),
                plugin(root, "entries", spec["entry"]), mine(bench["end_to_end"]),
                mine(bench["per_layer"]), root)


def seed_of(seed: int, *keys: int) -> int:
    """A 63-bit seed from the run's seed and ``keys``: the same for the same
    arguments, independent for different ones."""
    s = np.random.SeedSequence([seed % (1 << 64), *keys]).generate_state(2, np.uint32)
    return (int(s[0]) << 31) ^ int(s[1])


def fingerprint_indices(cell: Cell, seed: int) -> np.ndarray | None:
    """The sorted basis indices, drawn from the run's seed, at which every
    program's final state is kept for the check; None for a cell that names
    no ``fingerprint``."""
    if "fingerprint" not in cell.spec["check"]:
        return None
    k = min(cell.spec["check"]["fingerprint"], 1 << cell.n)
    rng = np.random.default_rng(seed_of(seed, 3))
    return np.sort(rng.choice(1 << cell.n, k, replace=False))


@dataclass
class Outcome:
    """What one program returned: its exit code, what it printed (its
    counts, where the cell takes shots), a fingerprint of its final state
    (its amplitudes at the run's indices, on the device) and its numbers
    (host arrays by name, such as ``{"value": (1,), "grad": (P,)}``)."""

    rc: int
    text: str | None = None
    fp: object = None
    error: str | None = None
    numbers: dict[str, np.ndarray] | None = None


@dataclass
class Context:
    """What an entry is given: the cell, its device, the fingerprint's
    indices on the device, and a synchronise that waits for the device."""

    cell: Cell
    device: object
    idx: object = None
    traffic: dict = field(default_factory=dict)

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def family(self):
        return self.cell.family

    @property
    def n(self) -> int:
        return self.cell.n

    @property
    def root(self) -> Path:
        return self.cell.root

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """Set up, warm, run the window and check it. Returns the result's
    fields and, under ``checks``, each number compared with its limit."""
    import torch

    from qubism_torch.config import config
    from qubism_torch.ops import kernels

    from .check import judge
    from .trace import Tracer, span

    config.device = device
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    ctx = Context(cell, dev, traffic=cell.spec.get("traffic", {}))
    idx = fingerprint_indices(cell, seed)
    ctx.idx = torch.from_numpy(idx).to(dev) if idx is not None else None
    entry = cell.entry.make(ctx)

    def draw(i: int):
        s = seed_of(seed, 2, i) if i >= 0 else seed_of(seed, 1)
        return cell.family.draw(cell.cfg, s), s

    p, s = draw(-1)
    warm = entry.program(entry.prepare(p, s))
    if warm.rc != 0:
        raise RuntimeError(f"qbench: the warm program failed (rc {warm.rc}): {warm.error}")
    ctx.sync()
    gc.collect()  # every window starts from a collected heap
    setup_s = time.perf_counter() - t_start

    kernels.reset_launches()
    tracer = Tracer() if trace else None
    if tracer:
        tracer.start(cuda)
    params, outcomes, latencies = [], [], []
    t0 = time.perf_counter()
    with span("qbench.window", trace):
        while time.perf_counter() - t0 < seconds:
            with span("qbench.input", trace):
                p, s = draw(len(params))
                inputs = entry.prepare(p, s)
            t_sub = time.perf_counter()
            with span("qbench.program", trace):
                try:
                    out = entry.program(inputs)
                except Exception as e:  # a failed program counts and the loop goes on
                    out = Outcome(rc=-1, error=f"{type(e).__name__}: {e}")
            latencies.append(time.perf_counter() - t_sub)
            params.append(p)
            outcomes.append(out)
    window_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    record = tracer.stop() if tracer else {}
    record.update(programs=len(outcomes), latencies_s=latencies, window_s=window_s,
                  setup_s=setup_s, peak_bytes=peak, launches=launches)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = plugin(cell.root, "metrics", m["name"]).read(record)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    t_check = time.perf_counter()
    failures, checks = judge(ctx, entry, params, outcomes, seed)
    failed = len(failures)
    if failures:
        print(f"qbench: {failed} failed programs; the first: {failures[0]}", file=sys.stderr)
    for c in checks.values():  # JSON has no NaN: a number that is not finite reads null
        if c["value"] is not None and not math.isfinite(c["value"]):
            c["value"] = None
    lat = np.array(latencies) * 1e3
    print(f"qbench: {cell.name}: {len(outcomes)} programs in {window_s:.3f} s, "
          f"set-up {setup_s:.3f} s, check {time.perf_counter() - t_check:.1f} s; latency ms "
          f"first {lat[0]:.1f} min {lat.min():.1f} median {np.median(lat):.1f} "
          f"max {lat.max():.1f}" if len(lat) else "", file=sys.stderr)
    result = {
        "correct": bool(outcomes) and failed == 0 and all(
            c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(outcomes),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": cell.chips, "memory_peak_bytes": peak},
    }
    if trace:
        from .trace import breakdown, busy_intervals, window

        w, busy = window(record), busy_intervals(record)
        if w is not None:
            result["device"]["window_s"] = (w[1] - w[0]) / 1e6
        if busy is not None:
            result["device"]["busy_s"] = sum(e - s for s, e in busy) / 1e6
        result["breakdown"] = breakdown(record)
    result["checks"] = checks
    return result


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(args, t_start: float) -> int:
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"qbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"qbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"qbench: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
