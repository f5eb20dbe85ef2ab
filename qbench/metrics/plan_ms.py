"""Host ms a program spends planning fused ops (``ops/fusion.py plan``:
folding each op's operands) less the copies of those operands to the
device inside it: the port's ``qubism.plan`` spans less their
``qubism.sync`` spans, over the traced window's programs."""

from qbench.spans import self_ms


def read(record):
    return self_ms(record, "qubism.plan", lambda name: name == "qubism.sync")
