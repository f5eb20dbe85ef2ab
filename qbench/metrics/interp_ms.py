"""Host ms a program spends in the interpreter's own work, statement
dispatch and gate expansion: its ``qubism.interp`` spans less the port's
spans inside them (the flushes with their fusion, planning and copies, the
state's first write), over the traced window's programs."""

from qbench.spans import is_port_span, self_ms


def read(record):
    return self_ms(record, "qubism.interp", is_port_span)
