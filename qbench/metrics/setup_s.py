"""Seconds from the process's start until the window opens (host clock):
imports, the card, the kernel library and native lexer from the build
cache, the entry's set-up and one warm program."""


def read(record):
    return record["setup_s"]
