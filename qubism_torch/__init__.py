"""qubism-torch: the OpenQASM 2.0 simulator and circuit DSL of qubism_tpu on
PyTorch and CUDA.

Two surfaces, as in the JAX package (``import qubism_torch as qt``):

1. the **DSL**: :class:`StateVec`, the :class:`Gate` constructors and
   combinators, and :class:`Session` for stateful programs with mid-circuit
   measurement and classical feed-forward; ``CompiledCircuit(g.n,
   g.prims)`` (ops/fusion.py) runs a gate's prims fused;
   :class:`DensityMatrix` and the Kraus channels for mixed states;
2. the **QASM path**: ``python -m qubism_torch file.qasm`` (with
   ``--compile`` for the compiled engine, ``--noise`` for noisy
   trajectories (:class:`TrajectoryProgram`), ``--backend density --noise``
   for the exact density engine, ``--backend stabilizer`` for Clifford
   circuits at 1000+ qubits on the tableau engine, :class:`StabilizerSim`
   and :class:`StabilizerTrajectoryProgram`), and the REPL with no file.

Both run on one NVIDIA Hopper GPU through hand-written CUDA kernels for the
state-vector passes (ops/kernels.py, csrc/). Importing the package imports
torch and numpy only; the kernels are built on first use.
"""

from .config import TOLERANCE, config  # noqa: F401
from .core import algebra  # noqa: F401
from .core.creg import CReg, bit  # noqa: F401
from .core.density import (  # noqa: F401
    DensityMatrix,
    amplitude_damping,
    bit_flip,
    depolarizing,
    depolarizing2,
    phase_damping,
    phase_flip,
)
from .core.gates import (  # noqa: F401
    Gate,
    Prim,
    cnot,
    controlled,
    hadamard,
    ident,
    if_bit,
    kronecker,
    on_every,
    on_just,
    on_range,
    pauli_x,
    pauli_y,
    pauli_z,
    phase,
    swap,
    u3_matrix,
    unitary,
)
from .core.statevec import StateVec, mk_qubit, mk_state_vec  # noqa: F401
from .session import Session  # noqa: F401
from .run.noisy import (  # noqa: F401
    DensityProgram,
    TrajectoryProgram,
    parse_noise_spec,
)
from .stabilizer import StabilizerSim, StabilizerTrajectoryProgram  # noqa: F401

__version__ = "0.1.0"
