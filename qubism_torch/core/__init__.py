"""Core value types: classical registers, primitive gates, state vectors,
density matrices and their channels."""

from .creg import ONE, ZERO, CReg, bit  # noqa: F401
from .density import (  # noqa: F401
    DensityMatrix,
    amplitude_damping,
    bit_flip,
    depolarizing,
    phase_damping,
    phase_flip,
)
from .gates import (  # noqa: F401
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
from .statevec import StateVec, mk_qubit, mk_state_vec  # noqa: F401
