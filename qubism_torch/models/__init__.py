"""Circuit families for benchmarks and examples, Hamiltonians, Trotterized
dynamics (closed, and open by the exact density matrix or by MCWF
trajectories), quantum trajectories, differentiable variational circuits
(VQE / QAOA by autograd and by the adjoint method), and repetition-code QEC
memory on Pauli frames."""

from .variational import (  # noqa: F401
    Ansatz,
    PGate,
    adjoint_value_and_grad_fn,
    ansatz_qasm,
    bind,
    energy_fn,
    hea_ansatz,
    maxcut_terms,
    qaoa_maxcut_ansatz,
    sample_fn,
    state_fn,
    tfim_hva_ansatz,
    value_and_grad_fn,
    vqe_minimize,
)
from .dynamics import (  # noqa: F401
    correlation_observed,
    dissipator_kraus,
    evolve,
    evolve_observed,
    imaginary_time_evolve,
    ite_step_prims,
    lindblad_evolve,
    lindblad_mcwf,
    lindblad_step_program,
    pauli_exp_prim,
    pauli_rotation_prim,
    spectral_function,
    trotter_prims,
    trotter_step_prims,
)
from .trajectories import (  # noqa: F401
    ChannelOp,
    run_trajectories,
    trajectory_expectation,
    trajectory_pauli_sum,
    trajectory_probs,
    trajectory_sample,
)
from .hamiltonians import (  # noqa: F401
    h2_minimal,
    heisenberg_xxz,
    maxcut,
    tfim,
)
from .circuits import (  # noqa: F401
    adder_qasm,
    brickwork_prims,
    brickwork_qasm,
    ghz_prims,
    ghz_qasm,
    prims_qasm,
    qaoa_maxcut_energy,
    qaoa_prims,
    qft_prims,
    qft_qasm,
    ring_edges,
)
from .qec import (  # noqa: F401
    RepetitionMemoryResult,
    repetition_logical_rate,
    repetition_memory,
)
