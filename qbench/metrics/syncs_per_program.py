"""Copies between host and device per program (the port's counter
``syncs`` over the window: each a pageable copy that PyTorch makes
synchronously, so the host waits for the device's queue)."""

from qbench.spans import counter


def read(record):
    syncs, n = counter("syncs"), record["programs"]
    return syncs / n if syncs is not None and n else None
