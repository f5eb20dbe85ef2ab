"""Matrix-product-state backend: bounded-entanglement circuits at 100+
qubits (:class:`MPSSim`), whole QASM programs on it (:class:`MPSProgram`)
and noisy MPS trajectories (:class:`MPSTrajectoryProgram`). See
:mod:`qubism_torch.mps.engine`."""

from .engine import MPSSim, NotAdjacentError
from .noise import MPSTrajectoryProgram, split_mps_noise
from .program import MPSProgram

__all__ = ["MPSProgram", "MPSSim", "MPSTrajectoryProgram", "NotAdjacentError",
           "split_mps_noise"]
