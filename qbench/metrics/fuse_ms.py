"""Host ms a program spends in greedy fusion (``ops/fusion.py fuse``: the
port's ``qubism.fuse`` spans), over the traced window's programs."""

from qbench.spans import self_ms


def read(record):
    return self_ms(record, "qubism.fuse")
