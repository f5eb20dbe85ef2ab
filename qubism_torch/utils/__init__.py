"""Utilities: checkpoint/resume, profiling, statistics."""

from .profiling import hbm_fraction, timed, trace  # noqa: F401

_CHECKPOINT = ("load_progstate", "save_progstate")


def __getattr__(name):
    # the checkpoint module imports most of the package, and most of the
    # package imports profiling: it is loaded on its first use
    if name in _CHECKPOINT:
        from . import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
