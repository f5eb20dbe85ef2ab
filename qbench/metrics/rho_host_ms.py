"""Host ms a program spends on the density engine's passes outside the
kernels: the port's ``qubism.density.unitary`` and
``qubism.density.channel`` spans (the dispatch of each pass, a gate's
expansion over the lane block, a channel's superoperator) less the
``qubism.sync`` spans in them (the operands' uploads, which wait for the
device), over the traced window's programs."""

from qbench.spans import self_ms


def read(record):
    parts = [self_ms(record, name, lambda inner: inner == "qubism.sync")
             for name in ("qubism.density.unitary", "qubism.density.channel")]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
