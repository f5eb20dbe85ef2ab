"""JSON codec for AST nodes (used by checkpoint/resume).

Generic over the dataclass node types in :mod:`qubism_torch.qasm.ast`: each
node encodes as ``{"t": <classname>, <field>: <value>, ...}``. Needed to
persist user gate definitions (CustomGate bodies are AST fragments) across
checkpoint/resume of interpreter state.
"""

from __future__ import annotations

import dataclasses

from . import ast as A

_NODE_TYPES = {
    cls.__name__: cls
    for cls in vars(A).values()
    if isinstance(cls, type) and dataclasses.is_dataclass(cls)
}


def to_jsonable(node):
    if isinstance(node, (str, int, float, bool)) or node is None:
        return node
    if isinstance(node, (list, tuple)):
        return [to_jsonable(x) for x in node]
    if dataclasses.is_dataclass(node):
        out = {"t": type(node).__name__}
        for f in dataclasses.fields(node):
            out[f.name] = to_jsonable(getattr(node, f.name))
        return out
    raise TypeError(f"cannot serialize {node!r}")


def from_jsonable(data):
    if isinstance(data, (str, int, float, bool)) or data is None:
        return data
    if isinstance(data, list):
        return tuple(from_jsonable(x) for x in data)
    if isinstance(data, dict):
        cls = _NODE_TYPES[data["t"]]
        kwargs = {k: from_jsonable(v) for k, v in data.items() if k != "t"}
        return cls(**kwargs)
    raise TypeError(f"cannot deserialize {data!r}")
