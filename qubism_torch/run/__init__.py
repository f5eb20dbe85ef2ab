"""Interpreter / runtime: program state, statement evaluation."""

from .progstate import (  # noqa: F401
    CustomGate,
    ProgState,
    QasmRuntimeError,
    QRegView,
    blank_state,
)
from .interpreter import Interpreter, run_program, run_program_incremental  # noqa: F401
