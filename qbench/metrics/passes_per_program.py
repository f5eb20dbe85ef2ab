"""Kernel launches over the window (every key of
``qubism_torch.ops.kernels.launches``) per program: an exact count."""


def read(record):
    n = record["programs"]
    return sum(record["launches"].values()) / n if n else None
