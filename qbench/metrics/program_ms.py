"""The window's length over the programs completed in it, in ms (host
clock): every program and every gap between them counts."""


def read(record):
    n = record["programs"]
    return record["window_s"] * 1e3 / n if n else None
