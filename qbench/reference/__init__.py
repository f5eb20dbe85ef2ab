"""The benchmark's plain reference and its control (:mod:`.statevec`)."""

from .statevec import round_tf32_, simulate

__all__ = ["round_tf32_", "simulate"]
