"""Host ms a program spends inside ``qubism_torch.cli.parse_openqasm`` (the
``qbench.parse`` spans of the traced window, over its programs)."""


def read(record):
    spans = [e - s for name, s, e in record.get("cpu", ()) if name == "qbench.parse"]
    return sum(spans) / 1e3 / record["programs"] if spans and record["programs"] else None
