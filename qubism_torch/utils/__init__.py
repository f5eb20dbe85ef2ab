"""Utilities: checkpoint/resume, profiling, statistics."""

from .checkpoint import load_progstate, save_progstate  # noqa: F401
from .profiling import hbm_fraction, timed, trace  # noqa: F401
