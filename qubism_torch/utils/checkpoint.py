"""Checkpoint / resume of interpreter state.

Counterpart of qubism_tpu/utils/checkpoint.py, in the same file format: the
full :class:`ProgState` (every state vector, register views, classical
registers, user gate table) in one ``.npz`` file, so long runs can stop and
resume (REPL ``:save``/``:load`` or the library API), with the parser symbol
table riding along. A state vector is stored as the JAX package stores it,
``sv_<name>`` a (2, 2^n) float32 array of (re, im) planes, so a checkpoint
written by either package loads in the other. A PRNG cannot cross packages:
this one writes its generator's state as ``torch_rng_state`` and reads only
that (never the JAX package's ``prng_key``); a file without it loads with
``gen = None``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.creg import CReg
from ..core.statevec import StateVec
from ..ops.apply import planes_from_state, state_from_planes
from ..qasm.ast import SourcePos
from ..qasm.parser import ParserState
from ..qasm.serialize import from_jsonable, to_jsonable
from ..run.progstate import CustomGate, ProgState, QRegView


def save_progstate(ps: ProgState, path: str, parser_state: ParserState | None = None):
    """Serialize ``ps`` (and optionally the parser symbol table) to ``path``."""
    arrays: dict[str, np.ndarray] = {}
    svmeta = {}
    for name, sv in ps.stvecs.items():
        arrays[f"sv_{name}"] = np.stack(planes_from_state(sv.state))
        svmeta[name] = sv.n
    if ps.gen is not None:
        arrays["torch_rng_state"] = ps.gen.get_state().numpy()
    meta = {
        "svs": svmeta,
        "qregs": {k: [v.target, v.start, v.size] for k, v in ps.qregs.items()},
        "cregs": {k: list(v.bits) for k, v in ps.cregs.items()},
        "funcs": {
            k: {"params": list(f.params), "args": list(f.args),
                "body": to_jsonable(f.body)}
            for k, f in ps.funcs.items()
        },
        "pos": [ps.pos.file, ps.pos.line, ps.pos.col],
        "id_table": (
            {k: [p.file, p.line, p.col] for k, p in parser_state.id_table.items()}
            if parser_state is not None else None
        ),
    }
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_progstate(path: str) -> tuple[ProgState, ParserState | None]:
    """Load a checkpoint onto ``config.device``. Returns (ProgState,
    ParserState-or-None)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        ps = ProgState()
        for name, n in meta["svs"].items():
            planes = data[f"sv_{name}"]
            ps.stvecs[name] = StateVec(n, state_from_planes(planes[0], planes[1]))
        if "torch_rng_state" in data:
            ps.gen = torch.Generator()
            ps.gen.set_state(torch.from_numpy(np.array(data["torch_rng_state"])))
    ps.qregs = {k: QRegView(t, s, z) for k, (t, s, z) in meta["qregs"].items()}
    ps.cregs = {k: CReg(tuple(bits)) for k, bits in meta["cregs"].items()}
    ps.funcs = {
        k: CustomGate(tuple(f["params"]), tuple(f["args"]), from_jsonable(f["body"]))
        for k, f in meta["funcs"].items()
    }
    ps.pos = SourcePos(*meta["pos"])
    pstate = None
    if meta["id_table"] is not None:
        pstate = ParserState(
            {k: SourcePos(*v) for k, v in meta["id_table"].items()}, None
        )
    return ps, pstate
