"""Circuit families for benchmarks and examples, Hamiltonians, Trotterized
dynamics (closed, and open by the exact density matrix or by MCWF
trajectories), quantum trajectories, differentiable variational circuits
(VQE / QAOA by autograd and by the adjoint method, on one device or an
amplitude mesh), repetition-code QEC memory on Pauli frames, and the
protocol models: amplitude estimation, XEB, Shor, tomography, classical
shadows, shot-based estimation, quantum volume, error mitigation and
randomized benchmarking."""

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
    qaoa_qasm,
    qft_prims,
    qft_qasm,
    ring_edges,
)
from .amplitude import (  # noqa: F401
    amplitude_exact,
    grover_iterate_prims,
    invert_prims,
    mlae_estimate,
    reflection_prim,
)
from .mitigation import (  # noqa: F401
    fold_prims,
    mitigate_counts,
    mitigate_z_expectation,
    zne_expectation,
)
from .qv import (  # noqa: F401
    haar_su4,
    heavy_set,
    measured_quantum_volume,
    qv_experiment,
    qv_prims,
)
from .rb import (  # noqa: F401
    clifford_group,
    fit_rb,
    irb_experiment,
    rb_experiment,
    rb_prims,
    rb_sequence,
    rb_survivals,
    simultaneous_rb_survivals,
)
from .shor import (  # noqa: F401
    estimate_order,
    shor_factor,
    shor_order_prims,
)
from .estimation import (  # noqa: F401
    EnergyEstimator,
    estimate_energy_fn,
    estimate_pauli_sum,
    qwc_groups,
    spsa_minimize,
)
from .shadows import (  # noqa: F401
    ShadowRecord,
    shadow_expectation,
    shadow_pauli_sum,
    shadow_snapshots,
)
from .tomography import (  # noqa: F401
    choi_from_kraus,
    exact_state_tomography,
    fidelity,
    process_fidelity,
    process_tomography,
    project_to_physical,
    reconstruct_state,
    sampled_state_tomography,
)
from .xeb import (  # noqa: F401
    counts_to_indices,
    linear_xeb,
    log_xeb,
    sampled_probabilities,
    xeb_stderr,
)
from .qec import (  # noqa: F401
    RepetitionMemoryResult,
    repetition_logical_rate,
    repetition_memory,
)
