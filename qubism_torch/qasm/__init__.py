"""OpenQASM 2.0 front-end: AST, lexer, parser."""

from . import ast  # noqa: F401
from .lexer import tokenize, LexError  # noqa: F401
from .parser import (  # noqa: F401
    ParserState,
    QasmParseError,
    initial_state,
    parse_openqasm,
    parse_openqasm_incremental,
)
