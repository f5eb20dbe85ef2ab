"""Host ms a program spends in the kernel adjoint engine's gradient
contraction (the port's ``qubism.adjoint.contract`` spans: each unit's
walks of phi and lam, ``ops/measure.py pauli_pair_sums``) less the copies
between host and device inside them (their ``qubism.sync`` spans: a walk's
uploads and read-back where it makes them), over the traced window's
programs. None on a port without these spans."""

from qbench.spans import self_ms


def read(record):
    return self_ms(record, "qubism.adjoint.contract", lambda name: name == "qubism.sync")
