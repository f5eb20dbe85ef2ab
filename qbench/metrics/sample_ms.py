"""Host ms a program spends in the sampler (``ops/sample.py
sample_counts``) less its copies between host and device: the port's
``qubism.sample`` spans less their ``qubism.sync`` spans, over the traced
window's programs."""

from qbench.spans import self_ms


def read(record):
    return self_ms(record, "qubism.sample", lambda name: name == "qubism.sync")
