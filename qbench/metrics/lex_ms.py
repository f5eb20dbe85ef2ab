"""Host ms a program spends in the lexer (``qasm/lexer.py tokenize``, either
route: the port's ``qubism.lex`` spans), over the traced window's programs."""

from qbench.spans import self_ms


def read(record):
    return self_ms(record, "qubism.lex")
