"""Tokenizer for OpenQASM 2.0.

Reproduces the reference's lexing behavior (src/Qubism/QASM/Parser.hs:106-182):

* ``//`` line comments and (non-standard) ``/* */`` block comments;
* reserved words: if barrier gate measure reset creg qreg pi sin cos tan exp
  ln sqrt U CX include (Parser.hs:133-135) — a reserved word followed by an
  alphanumeric character lexes as an identifier instead (``rword`` uses
  ``notFollowedBy alphaNumChar``);
* identifiers: a letter followed by alphanumerics;
* numbers: naturals and floats (fraction and/or exponent);
* symbols: ``; , ( ) [ ] { } -> ==`` and the arithmetic operators;
* quoted file paths for ``include``;
* the non-standard ``:dump`` token (Parser.hs:292-294).
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import native
from ..utils import profiling
from .ast import SourcePos

RESERVED = {
    "if", "barrier", "gate", "measure", "reset", "creg", "qreg", "pi",
    "sin", "cos", "tan", "exp", "ln", "sqrt", "U", "CX", "include",
}

_SYMBOLS = ("->", "==", ";", ",", "(", ")", "[", "]", "{", "}", "+", "-", "*", "/")


class LexError(Exception):
    def __init__(self, pos: SourcePos, message: str, source_line: str = ""):
        self.pos = pos
        self.message = message
        self.source_line = source_line
        super().__init__(f"{pos}: {message}")


@dataclass(frozen=True)
class Tok:
    kind: str  # 'kw' | 'ident' | 'nat' | 'real' | 'str' | 'sym' | 'dump' | 'eof'
    value: object
    pos: SourcePos


#: inputs of this many characters or more go through the native scanner
#: (:mod:`qubism_torch.native`): generated circuit files reach hundreds of
#: kilobytes, where the Python loop below is most of the parse
_NATIVE_THRESHOLD = 1 << 15

#: calls of :func:`tokenize` by the route they took
routes = {"native": 0, "python": 0}


def tokenize(text: str, file: str = "") -> list[Tok]:
    """The tokens of ``text``, ending in an ``eof`` token. Long inputs go
    through the native scanner; where it is not built or rejects the text,
    the Python lexer runs and raises the diagnostic."""
    with profiling.span("qubism.lex"):
        if len(text) >= _NATIVE_THRESHOLD:
            toks = native.native_tokenize(text, file)
            if toks is not None:
                routes["native"] += 1
                return toks
        routes["python"] += 1
        return _tokenize_py(text, file)


def _tokenize_py(text: str, file: str = "") -> list[Tok]:
    toks: list[Tok] = []
    i, line, col = 0, 1, 1
    n = len(text)
    lines = text.splitlines()

    def pos() -> SourcePos:
        return SourcePos(file, line, col)

    def err(msg: str) -> LexError:
        src = lines[line - 1] if 0 < line <= len(lines) else ""
        return LexError(pos(), msg, src)

    def advance(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and text[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = text[i]
        # whitespace
        if c in " \t\r\n":
            advance(1)
            continue
        # comments
        if text.startswith("//", i):
            j = text.find("\n", i)
            advance((j - i) if j != -1 else (n - i))
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j == -1:
                raise err("unterminated block comment")
            advance(j + 2 - i)
            continue
        # :dump
        if text.startswith(":dump", i):
            toks.append(Tok("dump", ":dump", pos()))
            advance(5)
            continue
        # quoted filepath
        if c == '"':
            j = text.find('"', i + 1)
            if j == -1 or "\n" in text[i + 1 : j]:
                raise err("unterminated string literal")
            toks.append(Tok("str", text[i + 1 : j], pos()))
            advance(j + 1 - i)
            continue
        # identifiers / keywords
        if c.isalpha():
            j = i + 1
            while j < n and text[j].isalnum():
                j += 1
            word = text[i:j]
            kind = "kw" if word in RESERVED else "ident"
            toks.append(Tok(kind, word, pos()))
            advance(j - i)
            continue
        # numbers
        if c.isdigit():
            j = i
            while j < n and text[j].isdigit():
                j += 1
            is_float = False
            if j < n and text[j] == "." and j + 1 < n and text[j + 1].isdigit():
                is_float = True
                j += 1
                while j < n and text[j].isdigit():
                    j += 1
            if j < n and text[j] in "eE":
                k = j + 1
                if k < n and text[k] in "+-":
                    k += 1
                if k < n and text[k].isdigit():
                    is_float = True
                    j = k
                    while j < n and text[j].isdigit():
                        j += 1
            word = text[i:j]
            if is_float:
                toks.append(Tok("real", float(word), pos()))
            else:
                toks.append(Tok("nat", int(word), pos()))
            advance(j - i)
            continue
        # symbols (longest first)
        for s in _SYMBOLS:
            if text.startswith(s, i):
                toks.append(Tok("sym", s, pos()))
                advance(len(s))
                break
        else:
            raise err(f"unexpected character {c!r}")
    toks.append(Tok("eof", None, pos()))
    return toks
