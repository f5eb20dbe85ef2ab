"""Stabilizer (Clifford) backend: bit-packed Aaronson-Gottesman tableaus
on the GPU, Pauli-frame executors and noisy Clifford trajectories. See
:mod:`qubism_torch.stabilizer.tableau`."""

from .noise import NotPauliChannelError, StabilizerTrajectoryProgram, pauli_channel_cdfs
from .program import StabilizerProgram
from .tableau import (NotCliffordError, StabilizerSim, Tableau, affine_support,
                      apply_prims, clifford_tables, expectation,
                      identity_tableau, measure_seq, planes_from_tableau,
                      sample_bits, stabilizer_strings, tableau_from_planes)

__all__ = [
    "NotCliffordError",
    "NotPauliChannelError",
    "StabilizerProgram",
    "StabilizerSim",
    "StabilizerTrajectoryProgram",
    "Tableau",
    "affine_support",
    "apply_prims",
    "clifford_tables",
    "expectation",
    "identity_tableau",
    "measure_seq",
    "pauli_channel_cdfs",
    "planes_from_tableau",
    "sample_bits",
    "stabilizer_strings",
    "tableau_from_planes",
]
