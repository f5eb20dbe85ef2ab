"""Amplitude sharding over a mesh of devices, with per-shard banks and
device <-> local relabelling swaps (counterpart of qubism_tpu/parallel)."""

from .mesh import make_mesh  # noqa: F401
from .sharded import ShardedSim  # noqa: F401
