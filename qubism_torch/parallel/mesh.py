"""The device mesh of the amplitude-sharded engine.

Counterpart of qubism_tpu/parallel/mesh.py. A mesh is a tuple of
``torch.device``s, one per shard; its size is a power of two, since the
shard index is the top log2(D) bits of the amplitude index.
"""

from __future__ import annotations

import torch

from ..config import config


def make_mesh(n_devices: int | None = None) -> tuple[torch.device, ...]:
    """The first ``n_devices`` GPUs when ``config.device`` names CUDA (all of
    them, rounded down to a power of two, for None); on the CPU, that many
    shards of the one CPU device (one for None). Raises ValueError for a
    size that is not a power of two or more GPUs than the machine has."""
    if torch.device(config.device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(have)]
    else:
        have = None
        devices = [torch.device("cpu")]
    if n_devices is None:
        n_devices = 1 << (len(devices).bit_length() - 1) if devices else 1
    if n_devices < 1 or n_devices & (n_devices - 1):
        raise ValueError(f"n_devices must be a power of two, got {n_devices}")
    if have is None:
        return (devices[0],) * n_devices
    if n_devices > have:
        raise ValueError(f"requested {n_devices} devices, have {have}")
    return tuple(devices[:n_devices])
