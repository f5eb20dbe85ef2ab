"""The traced run: spans around the port's layers, the kernel wrappers'
bounds, and the profiler's record that the per-layer readers read.

The spans are the benchmark's own: each call the port makes into a layer is
wrapped, by attribute at run time, in a ``torch.profiler.record_function``
named ``qbench.<layer>``; nothing of the port is edited, and the originals
are put back when the window closes. Each call of a kernel wrapper of
``qubism_torch.ops.kernels`` (the module attribute and its ``KERNEL_FNS``
entry) runs in a ``qbench.kernel.<name>`` span and adds the least time its
work needs (:mod:`qbench.roofline`).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import inspect
from collections import defaultdict

from . import roofline

#: (span, module, attribute path): the calls into each layer
LAYER_SPANS = (
    ("qbench.parse", "qubism_torch.cli", "parse_openqasm"),
    ("qbench.run", "qubism_torch.cli", "run_program"),
    ("qbench.run", "qubism_torch.run.compiler", "CompiledProgram.__init__"),
    ("qbench.run", "qubism_torch.run.compiler", "CompiledProgram.run"),
    ("qbench.sample", "qubism_torch.ops.sample", "sample_counts"),
)

#: cost name -> the wrapper's attribute in qubism_torch.ops.kernels
KERNEL_WRAPPERS = {"gate": "gate", "layer1q": "layer1q", "lane": "lane", "diag": "diag",
                   "stage": "stage_block"}

#: host calls into the CUDA runtime that wait for the device: the
#: synchronising calls, and the copies (a copy to the host waits for the
#: work before it; the small uploads of operands count with them)
BLOCKING_PREFIXES = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
                     "cudaEventSynchronize", "cudaMemcpy")


def span(name: str, on: bool):
    """A ``record_function`` span, or nothing when the run is not traced."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class Tracer:
    """Installs the spans and the profiler for one window."""

    def __init__(self):
        self.bound_s = defaultdict(float)
        self.calls = defaultdict(int)
        self._undo = []
        self._prof = None

    def _patch(self, owner, attr, new):
        old = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        setattr(owner, attr, new)
        self._undo.append(lambda: setattr(owner, attr, old))
        return old

    def _install_layers(self):
        from torch.profiler import record_function

        for name, module, path in LAYER_SPANS:
            owner = importlib.import_module(module)
            *parents, attr = path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                with record_function(_name):
                    return _fn(*args, **kwargs)

            self._patch(owner, attr, wrapped)

    def _install_kernels(self):
        from torch.profiler import record_function

        from qubism_torch.ops import kernels

        wrapped_by_fn = {}
        for cost, attr in KERNEL_WRAPPERS.items():
            fn = getattr(kernels, attr)
            sig = inspect.signature(fn)

            def wrapped(*args, _fn=fn, _cost=cost, _sig=sig, **kwargs):
                bound = list(_sig.bind(*args, **kwargs).arguments.values())
                self.bound_s[_cost] += roofline.kernel_bound_s(_cost, tuple(bound[1:-1]),
                                                              bound[-1])
                self.calls[_cost] += 1
                with record_function(f"qbench.kernel.{_cost}"):
                    return _fn(*args, **kwargs)

            wrapped_by_fn[fn] = wrapped
            self._patch(kernels, attr, wrapped)
        table = kernels.KERNEL_FNS
        for key, (fn, plain) in list(table.items()):
            if fn in wrapped_by_fn:
                table[key] = (wrapped_by_fn[fn], plain)
                self._undo.append(lambda k=key, v=(fn, plain): table.__setitem__(k, v))

    def start(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        self._install_layers()
        self._install_kernels()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=acts, record_shapes=False, with_stack=False,
                             profile_memory=False)
        self._prof.start()

    def stop(self) -> dict:
        """Stop the profiler, put the originals back, and return the record:
        ``cpu`` the spans (``qbench.*`` and any of the port's own) and the
        runtime's blocking calls, ``device`` every device operation,
        ``marks`` the spans' marks on the device timeline, each as (name,
        start us, end us); the kernel wrappers' device time, bound and calls
        by name."""
        import torch

        self._prof.stop()
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()
        cpu, device, marks = [], [], []
        for ev in self._prof.events():
            t = ev.time_range
            name = ev.name
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                # a span's mark on the device timeline: from the first to the
                # last end of the work launched inside it
                if getattr(ev, "is_user_annotation", False) or name.startswith("qbench."):
                    marks.append((name, t.start, t.end))
                else:
                    device.append((name, t.start, t.end))
            elif name.startswith(("qbench.", "qubism")) or name.startswith(BLOCKING_PREFIXES):
                cpu.append((name, t.start, t.end))
        self._prof = None
        return {"cpu": cpu, "device": device, "marks": marks,
                "kernel_device_us": kernel_device_us(device, marks),
                "kernel_bound_s": dict(self.bound_s), "kernel_calls": dict(self.calls)}


def kernel_device_us(device, marks) -> dict:
    """Device us of the kernels (not copies or fills) inside each kernel
    wrapper's mark, by wrapper. One stream runs the engine's work in order,
    so what runs inside a wrapper's mark is what that call launched."""
    kernels = sorted((s, e) for name, s, e in device
                     if not name.startswith(("Memcpy", "Memset")))
    starts = [s for s, _ in kernels]
    out = defaultdict(float)
    for name, s, e in marks:
        if not name.startswith("qbench.kernel."):
            continue
        i = bisect.bisect_left(starts, s)
        while i < len(kernels) and kernels[i][0] < e:
            out[name[len("qbench.kernel."):]] += min(kernels[i][1], e) - kernels[i][0]
            i += 1
    return dict(out)


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def window(record: dict):
    """(start us, end us) of the ``qbench.window`` span, or None."""
    spans = [(s, e) for name, s, e in record.get("cpu", ()) if name == "qbench.window"]
    return spans[0] if spans else None


def busy_intervals(record: dict):
    """The union of the device's operations inside the window."""
    w = window(record)
    if w is None or not record.get("device"):
        return None
    return clip(union((s, e) for _, s, e in record["device"]), *w)


def innermost(spans, lo: float, hi: float) -> list[tuple[float, float, str]]:
    """The window [lo, hi) cut into (start, end, name) pieces, each named by
    the innermost of the nested host ``spans`` (name, start, end) open over
    it, ``qbench.window`` where none is."""
    spans = [sp for sp in spans if sp[2] > sp[1]]
    events = sorted([(s, 1, i) for i, (_, s, _) in enumerate(spans)]
                    + [(e, 0, i) for i, (_, _, e) in enumerate(spans)])
    pieces, open_, t = [], [], lo
    for time_, is_start, i in events:
        cut = min(max(time_, lo), hi)
        if cut > t:
            pieces.append((t, cut, spans[open_[-1]][0] if open_ else "qbench.window"))
            t = cut
        if is_start:
            open_.append(i)
        elif i in open_:
            open_.remove(i)
    if hi > t:
        pieces.append((t, hi, "qbench.window"))
    return pieces


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations by summed seconds (short names), and the idle
    time of the device in the window by what the host was doing meanwhile:
    the innermost ``qbench`` span it was in (summed seconds)."""
    ops = defaultdict(float)
    for name, s, e in record.get("device", ()):
        ops[roofline.short_name(name)] += (e - s) / 1e6
    w, busy = window(record), busy_intervals(record)
    gaps = defaultdict(float)
    if w is not None and busy is not None:
        edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
        holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
        spans = [(name, s, e) for name, s, e in record["cpu"]
                 if name.startswith("qbench.") and name != "qbench.window"]
        pieces = innermost(spans, *w)
        j = 0
        for gs, ge in holes:  # both sorted: one pass over the pieces
            while j < len(pieces) and pieces[j][1] <= gs:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][0] < ge:
                ps, pe, name = pieces[k]
                gaps[name] += (min(pe, ge) - max(ps, gs)) / 1e6
                k += 1

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
