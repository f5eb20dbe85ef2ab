"""The port's own spans and counters as a traced window shows them.

``qubism_torch.utils.profiling`` opens a ``record_function`` named
``qubism.<layer>`` around the work of each layer while a profiler records,
and counts events in ``profiling.counters``, which
``kernels.reset_launches()`` clears when the window opens. The per-layer
readers read them here, per program of the window; on a port without them
each reading is None.
"""

from __future__ import annotations

import bisect

from qbench.trace import union


def self_ms(record: dict, name: str, inner=lambda other: False) -> float | None:
    """Host ms a program spends in the ``name`` spans of the record, less
    the part of them that the spans nested in them cover, of the names that
    ``inner`` accepts; None where the record holds no ``name`` span or no
    program."""
    cpu = record.get("cpu", ())
    outer = union((s, e) for n, s, e in cpu if n == name)
    if not outer or not record.get("programs"):
        return None
    starts = [s for s, _ in outer]

    def nested(s, e):
        i = bisect.bisect_right(starts, s) - 1
        return i >= 0 and e <= outer[i][1]

    ins = union((s, e) for n, s, e in cpu if n != name and inner(n) and nested(s, e))
    return (sum(e - s for s, e in outer) - sum(e - s for s, e in ins)) / 1e3 / record["programs"]


def is_port_span(name: str) -> bool:
    return name.startswith("qubism.")


def counter(name: str) -> int | None:
    """The port's counter ``name`` over the window (0 where nothing counted
    it), or None where the port keeps no counters."""
    from qubism_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    return None if counters is None else counters.get(name, 0)
