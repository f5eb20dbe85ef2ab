"""Trotterized Hamiltonian dynamics: |psi(t)> = exp(-iHt) |psi(0)>.

Counterpart of qubism_tpu/models/dynamics.py (its closed-system half, and
the exact Lindblad integrator on :class:`~qubism_torch.core.density.DensityMatrix`).
The ``(coef, pauli_string)`` terms of :mod:`qubism_torch.models.hamiltonians`
are exponentiated term by term into rotation prims ``exp(-i theta/2 P)``
and composed into first- or second-order (Strang) Trotter steps: plain
:class:`~qubism_torch.core.gates.Prim` streams, which
:class:`~qubism_torch.ops.fusion.CompiledCircuit` runs through the kernels
(pure Z-strings are diagonal prims, so a whole ZZ ladder is one diag pass;
the X terms of a step are one 1q layer).

Error model (standard Trotter bounds): first order O(t^2/steps), Strang
O(t^3/steps^2) per total evolution.

:func:`lindblad_evolve` integrates the master equation exactly on a
:class:`~qubism_torch.core.density.DensityMatrix` or, past one buffer, on a
:class:`~qubism_torch.parallel.density.ShardedDensityMatrix`;
:func:`lindblad_step_program` and :func:`lindblad_mcwf` unravel it into
trajectories of the noisy trajectory engine (models/trajectories.py).
"""

from __future__ import annotations

import math

import numpy as np

from ..core.gates import Prim

_P1 = {
    "X": np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex),
    "Y": np.array([[0.0, -1.0j], [1.0j, 0.0]], dtype=complex),
    "Z": np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex),
}

#: widest Pauli term exponentiated into one dense prim (a 2^k x 2^k host
#: matrix); wider terms should be split
_MAX_SUPPORT = 6


def _support(pauli: str) -> tuple[tuple[int, ...], str]:
    """(targets, compact letters) for the non-identity positions
    (``pauli[q]`` acts on qubit q, qubit 0 = most significant index bit)."""
    targets = tuple(q for q, c in enumerate(pauli) if c != "I")
    letters = "".join(pauli[q] for q in targets)
    for c in letters:
        if c not in "XYZ":
            raise ValueError(f"bad Pauli letter {c!r} in {pauli!r}")
    return targets, letters


def _checked_support(pauli: str):
    targets, letters = _support(pauli)
    if len(targets) > _MAX_SUPPORT:
        raise ValueError(
            f"Pauli term {pauli!r} has weight {len(targets)} > {_MAX_SUPPORT}; "
            f"split the term or coarse-grain the Hamiltonian")
    return targets, letters


def _z_signs(k: int) -> np.ndarray:
    """(-1)^parity of each k-bit index (+1 even, -1 odd)."""
    idx = np.arange(1 << k)
    parity = np.zeros(1 << k, dtype=np.int64)
    for b in range(k):
        parity ^= (idx >> (k - 1 - b)) & 1
    return 1.0 - 2.0 * parity


def _dense_pauli(letters: str) -> np.ndarray:
    p = _P1[letters[0]]
    for c in letters[1:]:
        p = np.kron(p, _P1[c])
    return p


def pauli_rotation_prim(theta: float, pauli: str) -> Prim | None:
    """``exp(-i theta/2 * P)`` as one Prim on P's support: exactly
    ``cos(theta/2) I - i sin(theta/2) P``. Pure Z-strings give a diagonal
    prim (entries ``exp(-i theta/2 * (-1)^parity)``). None for an identity
    string (a global phase)."""
    targets, letters = _checked_support(pauli)
    if not targets:
        return None
    half = 0.5 * theta
    if set(letters) == {"Z"}:
        return Prim(np.exp(-1.0j * half * _z_signs(len(targets))), targets, diag=True)
    u = (math.cos(half) * np.eye(1 << len(targets), dtype=complex)
         - 1.0j * math.sin(half) * _dense_pauli(letters))
    return Prim(u, targets)


def pauli_exp_prim(a: float, pauli: str) -> Prim | None:
    """``exp(-a * P)`` (a real) as one non-unitary Prim on P's support:
    ``cosh(a) I - sinh(a) P``; pure Z-strings are diagonal (entries
    ``exp(-a * (+-1))``). None for the identity string."""
    targets, letters = _checked_support(pauli)
    if not targets:
        return None
    if set(letters) == {"Z"}:
        return Prim(np.exp(-a * _z_signs(len(targets))).astype(complex), targets, diag=True)
    u = (math.cosh(a) * np.eye(1 << len(targets), dtype=complex)
         - math.sinh(a) * _dense_pauli(letters))
    return Prim(u, targets)


def _split(terms, scale: float, order: int):
    """(scale * c_j, P_j) in first-order or Strang order."""
    if order == 1:
        return [(scale * c, p) for c, p in terms]
    if order == 2:
        half = [(0.5 * scale * c, p) for c, p in terms]
        return half + half[::-1]
    raise ValueError(f"order must be 1 or 2, got {order}")


def ite_step_prims(terms, dtau: float, order: int = 2) -> list[Prim]:
    """One imaginary-time Trotter step of ``exp(-dtau * sum_j c_j P_j)``
    (same splittings as :func:`trotter_step_prims`)."""
    return [p for a, s in _split(terms, dtau, order) if (p := pauli_exp_prim(a, s)) is not None]


def trotter_step_prims(terms, dt: float, order: int = 2) -> list[Prim]:
    """One Trotter step of ``exp(-i dt * sum_j c_j P_j)``.

    order=1: Lie product prod_j exp(-i c_j dt P_j).
    order=2: Strang split prod_j exp(-i c_j dt/2 P_j) * (reversed prod).
    Terms are exponentiated in the given order: group commuting terms
    adjacently (the :mod:`hamiltonians` builders do) so fusion folds them
    into shared passes."""
    return [p for th, s in _split(terms, 2.0 * dt, order)
            if (p := pauli_rotation_prim(th, s)) is not None]


def trotter_prims(terms, t: float, steps: int, order: int = 2) -> list[Prim]:
    """The full ``exp(-iHt)`` circuit: ``steps`` repeated Trotter steps."""
    if steps < 1:
        raise ValueError("steps must be >= 1")
    return trotter_step_prims(terms, t / steps, order) * steps


def _circuit(n: int, prims, compile_kwargs):
    from ..ops.fusion import CompiledCircuit

    return CompiledCircuit(n, prims, **compile_kwargs)


def imaginary_time_evolve(state, terms, tau: float, steps: int,
                          order: int = 2, record_energy: bool = False,
                          **compile_kwargs):
    """Ground-state projection by imaginary-time evolution:
    ``psi(tau) = exp(-tau H) psi0 / ||...||``, renormalized after every
    step (the factors are not unitary). ``state`` is a
    :class:`~qubism_torch.core.statevec.StateVec`, left as it is. Returns
    ``(final_state, energies)`` with ``energies[i] = <H>`` after step i
    (only when ``record_energy``; else an empty list)."""
    from ..core.statevec import StateVec

    n = state.n
    step = _circuit(n, ite_step_prims(terms, tau / steps, order), compile_kwargs)
    cur = StateVec(n, state.state.clone())
    energies = []
    for _ in range(steps):
        cur = StateVec(n, step(cur.state)).normalize()
        if record_energy:
            energies.append(cur.expectation_sum(terms))
    return cur, energies


def evolve(state, terms, t: float, steps: int, order: int = 2, **compile_kwargs):
    """Evolve a :class:`~qubism_torch.core.statevec.StateVec` under the
    Pauli-sum Hamiltonian ``terms`` for time ``t``: returns psi(t) as a new
    StateVec (the circuit updates a copy of the state in place)."""
    from ..core.statevec import StateVec

    n = state.n
    circ = _circuit(n, trotter_prims(terms, t, steps, order), compile_kwargs)
    return StateVec(n, circ(state.state.clone()))


def evolve_observed(state, terms, observables, t: float, steps: int,
                    order: int = 2, record_every: int = 1, **compile_kwargs):
    """Evolve while recording observables: returns ``(times, values,
    final_state)`` with ``values[i][j] = <obs_j>(times[i])``.

    Each observable is a Pauli sum ``[(coef, pauli), ...]`` (a bare string
    means ``[(1.0, string)]``). One compiled segment of ``record_every``
    Trotter steps is reused across the sweep; the t=0 point is included."""
    from ..core.statevec import StateVec

    obs = [[(1.0, o)] if isinstance(o, str) else list(o) for o in observables]
    n = state.n
    if steps % record_every:
        raise ValueError("record_every must divide steps")
    dt_seg = t * record_every / steps
    seg = _circuit(n, trotter_prims(terms, dt_seg, record_every, order), compile_kwargs)
    times = [0.0]
    values = [[state.expectation_sum(o) for o in obs]]
    cur = StateVec(n, state.state.clone())
    for i in range(steps // record_every):
        seg(cur.state)
        times.append(dt_seg * (i + 1))
        values.append([cur.expectation_sum(o) for o in obs])
    return np.array(times), np.array(values), cur


def correlation_observed(state, terms, a_pauli: str, b_pauli: str,
                         t: float, steps: int, order: int = 2,
                         record_every: int = 1, **compile_kwargs):
    """Dynamic correlation function ``C(t_k) = <psi| A(t_k) B |psi>``
    (``A(t) = e^{iHt} A e^{-iHt}``), whose Fourier transform is a spectral
    function.

    ``|u(t)> = e^{-iHt}|psi>`` and ``|w(t)> = e^{-iHt} B|psi>`` march
    through one compiled Trotter segment, and each record point is one
    pair reduction ``<u|A|w>`` (:func:`ops.measure.pauli_pair_sums`).
    Returns ``(times, C)`` with ``C`` complex128 of length
    ``steps // record_every + 1`` (t=0 included)."""
    from ..ops import measure as M

    n = state.n
    a_pauli = M._check_pauli(a_pauli, n)
    b_pauli = M._check_pauli(b_pauli, n)
    if steps % record_every:
        raise ValueError("record_every must divide steps")
    u = state.state.clone()
    w = M.apply_pauli(u, b_pauli, n)
    f, z, n_y = M.pauli_masks(a_pauli)

    def c_of():
        # pauli_pair_sums(a, b) reduces <b|P|a> without i^{#Y}: a = w, b = u
        s = M.pauli_pair_sums(w, u, n, f, (z,))[0]
        return M._apply_iy(s.real, s.imag, n_y)

    dt_seg = t * record_every / steps
    seg = _circuit(n, trotter_prims(terms, dt_seg, record_every, order), compile_kwargs)
    times = [0.0]
    vals = [c_of()]
    for i in range(steps // record_every):
        seg(u)
        seg(w)
        times.append(dt_seg * (i + 1))
        vals.append(c_of())
    return np.asarray(times), np.asarray(vals, dtype=np.complex128)


def spectral_function(times: np.ndarray, corr: np.ndarray):
    """``(omegas, S)``: the discrete Fourier transform of a uniformly
    sampled correlation record, ``S(omega) = dt * sum_k e^{i omega t_k}
    C(t_k)`` (fftshifted, ascending omega)."""
    times = np.asarray(times, dtype=np.float64)
    dt = float(times[1] - times[0])
    s = np.fft.fftshift(np.fft.ifft(np.asarray(corr))) * len(corr) * dt
    omegas = np.fft.fftshift(np.fft.fftfreq(len(corr), dt)) * 2.0 * math.pi
    return omegas, s


# ---------------------------------------------------------------------------
# Open-system (Lindblad) dynamics on the density engine
# ---------------------------------------------------------------------------


def _expm(a: np.ndarray) -> np.ndarray:
    """Matrix exponential by scaling-and-squaring + Taylor (host side; the
    inputs are small 4^k x 4^k superoperators)."""
    a = np.asarray(a, dtype=np.complex128)
    nrm = float(np.linalg.norm(a, 1))
    s = max(0, int(math.ceil(math.log2(nrm))) + 1) if nrm > 0 else 0
    x = a / (1 << s)
    term = np.eye(a.shape[0], dtype=np.complex128)
    out = term.copy()
    for k in range(1, 24):
        term = term @ x / k
        out += term
    for _ in range(s):
        out = out @ out
    return out


def dissipator_kraus(l_op: np.ndarray, rate: float, dt: float) -> list[np.ndarray]:
    """The exact Kraus decomposition of ``exp(dt * D_L)`` for one k-local
    jump operator, ``D_L(rho) = rate (L rho L^dag - {L^dag L, rho}/2)``:
    exponentiate the (4^k, 4^k) superoperator on the host (row-major vec:
    ``vec(A X B) = (A kron B^T) vec(X)``), reshuffle to the Choi matrix and
    eigendecompose. Each factor is CPTP by construction."""
    L = np.asarray(l_op, dtype=np.complex128)
    d = L.shape[0]
    ldl = L.conj().T @ L
    eye = np.eye(d, dtype=np.complex128)
    sup = rate * (np.kron(L, np.conj(L)) - 0.5 * np.kron(ldl, eye) - 0.5 * np.kron(eye, ldl.T))
    e = _expm(sup * dt)
    # J[(m,i),(n,j)] = E[(m,n),(i,j)]  (Choi reshuffle, row-major vec)
    choi = e.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(d * d, d * d)
    w, v = np.linalg.eigh((choi + choi.conj().T) / 2.0)
    return [math.sqrt(float(lam)) * v[:, a].reshape(d, d)
            for a, lam in enumerate(w) if lam > 1e-12]


def _halves(collapse, dt: float):
    out = []
    for rate, l_op, targets in collapse:
        if isinstance(targets, int):
            targets = (targets,)
        out.append((tuple(targets), dissipator_kraus(l_op, float(rate), dt / 2.0)))
    return out


def lindblad_evolve(rho, h_terms, collapse, t: float, steps: int,
                    order: int = 2, observables=None):
    """Integrate the Lindblad master equation ``drho/dt = -i[H, rho] +
    sum_a rate_a D_{L_a}(rho)`` on a
    :class:`~qubism_torch.core.density.DensityMatrix` or a
    :class:`~qubism_torch.parallel.density.ShardedDensityMatrix`, in place.

    Strang-split into exact CPTP factors: per step, each dissipator's
    exact half-step channel (``apply_channel``), the unitary Trotter step
    of ``h_terms`` (``order`` 1 or 2), then the dissipator half-steps in
    reverse. ``collapse``: iterable of ``(rate, l_matrix, targets)``.
    With ``observables`` (Pauli strings) returns ``(rho, values)`` with
    ``values[s][j] = <P_j>`` after step s (t=0 included); else ``rho``."""
    halves = _halves(collapse, t / steps)
    hstep = trotter_step_prims(h_terms, t / steps, order) if h_terms else []
    values = None
    if observables is not None:
        values = [[rho.expectation(p) for p in observables]]
    for _ in range(steps):
        for tg, kr in halves:
            rho.apply_channel(kr, tg)
        if hstep:
            rho.apply(hstep)
        for tg, kr in reversed(halves):
            rho.apply_channel(kr, tg)
        if values is not None:
            values.append([rho.expectation(p) for p in observables])
    if values is not None:
        return rho, np.asarray(values)
    return rho


def lindblad_step_program(h_terms, collapse, dt: float, order: int = 2):
    """ONE Strang step of the Lindblad generator as a trajectory program
    (Prims + :class:`~qubism_torch.models.trajectories.ChannelOp`s):
    dissipator half-step channels, the unitary Trotter step, the halves
    reversed. Repeat ``steps`` times (Python list multiply) and feed to
    :func:`~qubism_torch.models.trajectories.run_trajectories`: the MCWF
    unraveling of :func:`lindblad_evolve`, at memory T * 2^n instead of
    4^n."""
    from .trajectories import ChannelOp

    halves = [ChannelOp(kr, tg) for tg, kr in _halves(collapse, dt)]
    hstep = trotter_step_prims(h_terms, dt, order) if h_terms else []
    return halves + hstep + halves[::-1]


def lindblad_mcwf(n: int, prep_prims, h_terms, collapse, t: float,
                  steps: int, ntraj: int, observables=None, seed: int = 0,
                  order: int = 2, uniforms=None):
    """Monte-Carlo wavefunction integration of the master equation:
    ``ntraj`` pure trajectories of ``prep + steps x Strang step`` run as
    ONE batch. Returns ``(states, estimates)`` where ``states`` is the
    (T, 2^n) trajectory batch and ``estimates[j] = (mean, stderr)`` per
    observable Pauli string (None when ``observables`` is None), converging
    to :func:`lindblad_evolve`'s exact density values at ~1/sqrt(T).
    ``uniforms`` ((T, S) floats) replaces the seeded channel draws."""
    from .trajectories import run_trajectories, trajectory_expectation

    program = list(prep_prims) + lindblad_step_program(
        h_terms, collapse, t / steps, order) * steps
    states = run_trajectories(n, program, ntraj, seed=seed, uniforms=uniforms)
    if observables is None:
        return states, None
    return states, [trajectory_expectation(states, p, n) for p in observables]
