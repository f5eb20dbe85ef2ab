"""The file path by the compiler (``python -m qubism_torch --compile
<file>``, dense blocks of the cell's ``fuse_width`` qubits)."""

from qbench.filepath import FileEntry


def make(ctx):
    return FileEntry(ctx, compile_mode=True)
