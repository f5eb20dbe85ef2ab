"""Prims the interpreter's flushes hand to fusion per fused op they get back
(the port's counters ``prims`` over ``fused_ops`` over the window): how many
gates a pass over the state carries. None where nothing was fused."""

from qbench.spans import counter


def read(record):
    prims, ops = counter("prims"), counter("fused_ops")
    return prims / ops if ops else None
