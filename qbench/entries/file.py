"""The file path by the interpreter (``python -m qubism_torch <file>``)."""

from qbench.filepath import FileEntry


def make(ctx):
    return FileEntry(ctx, compile_mode=False)
