"""Noisy MPS trajectories: Pauli channels and damping on bounded-entanglement
circuits.

Counterpart of qubism_tpu/mps/noise.py: the third leg of the trajectory
family (the dense ``run/noisy.py`` at <= ~26 qubits, the Clifford-only
``stabilizer/noise.py`` at 1000+): NON-Clifford noisy circuits at 50-100+
qubits, as long as each trajectory's entanglement fits the bond cap ``chi``.

A batch of T trajectories is one ``(T, n, chi, 2, chi)`` tensor and a
``(T,)`` discarded weight; every tape row applies to the whole batch (the
SVDs of 2q and shift rows are batched over T). Pauli channels (depolarizing,
bit flip, phase flip, dep2) have branch probabilities INDEPENDENT of the
state, so a sampled noise event is one more 1q row of the tape (an identity
slot) whose operand each trajectory takes from a (4, 2, 2) Pauli table by
its row's CDF; dep2 draws one joint 16-outcome index per gate. Amplitude
and phase damping change branch weights WITH the state: those are
``_OP_K1Q`` rows carrying both Kraus blocks, whose MCWF branch is chosen on
the device from ``||K0 psi||^2 / ||psi||^2`` (exact transfer contractions).

Measurement, feed-forward and reset run on the batch as the base class's
dense engine runs them: Born probabilities by exact transfer contractions
(correct in ANY canonical form), projection by a 1q row and a renormalised
site, ``torch.where`` on the predicate for feed-forward. Each trajectory
draws its randomness from its row of the base class's uniform table: one
column per K row, Pauli slot and dep2 pair of a gate event (in that order),
per measured qubit and per readout flip.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from ..ops import measure as M
from ..run.noisy import TrajectoryProgram
from ..stabilizer.noise import NotPauliChannelError, pauli_channel_cdfs
from .engine import (_OP_1Q, _OP_K1Q, _PAULI, _apply_1q_, _pauli_ops, _renorm, build_tape,
                     kraus_norm_ops, pack_tape, right_envs, run_tape, walk_expect)

__all__ = ["MPSTrajectoryProgram", "split_mps_noise"]


def split_mps_noise(spec: str):
    """Classify a --noise spec for the MPS tape executor, PRESERVING SPEC
    ORDER (non-commuting mixes like ``ad`` + ``dep`` compose differently per
    order, and DensityProgram applies spec order, so every engine must).
    Pauli channels (dep/bf/pf/dep2) sample their branches from CDFs
    (state-independent probabilities); any non-Pauli 2-Kraus 2x2 channel
    (amplitude/phase damping today, dispatched by the parsed Kraus SHAPE,
    so new ``NOISE_CHANNELS`` entries route automatically) becomes an
    ``_OP_K1Q`` row whose MCWF branch is chosen on the device. Returns
    ``[(kind, data, tspec), ...]`` in spec order with kind ``"p1"`` (data =
    (4,) CDF), ``"p2"`` (data = (16,) CDF) or ``"k"`` (data = (4, 4)
    complex, K0 in [:2, :2], K1 in [:2, 2:4], the tape row layout), and
    tspec the part's unresolved ``@`` qubit target string (None = all
    qubits). Channels that fit none of these raise the mps-labelled
    :class:`~qubism_torch.stabilizer.noise.NotPauliChannelError`."""
    from ..run.noisy import parse_noise_spec, split_channel_target

    chans = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        part, tspec = split_channel_target(part)
        try:
            c1, c2 = pauli_channel_cdfs(part, backend="mps")
        except NotPauliChannelError as err:
            # unknown names get parse_noise_spec's clearer error here
            (_, ks), = parse_noise_spec(part)
            ks = [np.asarray(k) for k in ks]
            if not (len(ks) == 2 and ks[0].shape == (2, 2)):
                raise err
            k4 = np.zeros((4, 4), dtype=np.complex128)
            k4[:2, :2] = ks[0]
            k4[:2, 2:4] = ks[1]
            chans.append(("k", k4, tspec))
        else:
            chans.append(("p1", c1[0], tspec) if len(c1) else ("p2", c2[0], tspec))
    return chans


#: (I, X, Y, Z), the table a Pauli slot takes its operand from
_PAULI4 = np.stack([_PAULI[c] for c in "IXYZ"]).astype(np.complex64)
#: the projectors onto |0> and |1>: a measurement's walk reads both weights
_PROJ = np.stack([np.diag([1.0, 0.0]), np.diag([0.0, 1.0])]).astype(np.complex64)


class MPSTrajectoryProgram(TrajectoryProgram):
    """Noisy QASM as batched matrix-product-state trajectories.

    Inherits the creg/feed-forward machinery, the uniform table, the
    batching (``mesh=`` splits a batch over devices) and the host API of
    :class:`~qubism_torch.run.noisy.TrajectoryProgram`; the quantum state
    of a batch is a ``(T, n, chi, 2, chi)`` MPS instead of T x 2^n
    amplitudes. The per-trajectory discarded weight accumulates on the
    device; ``run_vals(..., return_states=True)`` returns the final states
    as ``(sites, disc)``, the discarded weight the LAST leaf (the JAX
    package's ``(re, im, disc)`` with re and im joined).

    The tapes, and with them the stochastic sites (:attr:`sites`), follow
    from the host-tracked orthogonality center, which advances through
    every gate event in program order, the bodies of ``if`` statements
    included whether or not a trajectory takes them (every readout is a
    transfer contraction, so no trajectory depends on where the center is).
    They are built once, on first use.
    """

    def __init__(self, ast, noise=None, chi: int = 32):
        from ..run.compiler import elaborate
        from ..run.noisy import split_readout_spec

        (self.n, self.events, self.cregs0, self.layout,
         self.qreg_sizes) = elaborate(ast)
        self.chi = chi
        self.readout_p = None
        if isinstance(noise, str):
            from ..run.noisy import resolve_noise_targets

            noise, self.readout_p = split_readout_spec(noise)
            self.chans = [
                (k, d, None if t is None else resolve_noise_targets(
                    t, self.layout, self.qreg_sizes, self.n))
                for k, d, t in split_mps_noise(noise)]
        else:
            self.chans = [("p1", np.asarray(c, dtype=np.float32), None)
                          for c in np.asarray(noise if noise is not None
                                              else np.zeros((0, 4), np.float32))]
        self.kraus4s = [d for k, d, _ in self.chans if k == "k"]
        self.noise = [("pauli", None)] if self.chans else []
        self.creg_names = sorted(self.cregs0)
        self.creg_sizes = {c: len(self.cregs0[c].bits) for c in self.creg_names}
        self._site = 0
        self._center = 0
        self._plan = None          # (tapes in run order, stochastic sites)
        self._ti = 0               # the next tape of a run
        self._dev_tapes = {}       # (tape index, device) -> its device operands

    def _traj_live_cost(self) -> int:
        return max(1, 4 * self.n * self.chi * self.chi + 2 * self.n)

    # -- tape construction (host side, once) ------------------------------------

    def _tape(self, prims):
        """Flatten a prim stream into one op tape through the engine's
        ``build_tape``, inserting an identity 1q row after each gate per (channel,
        physical site): the noise slots a trajectory overwrites with its
        sampled Pauli. Returns the packed host arrays (codes, qs, us) plus
        (Pauli slot rows, their CDFs, dep2 first rows, dep2 second rows,
        their CDFs, K1Q rows)."""
        rows, cdf_rows = [], []      # 1q noise slots and their channel CDF (4,)
        rows2a, rows2b = [], []      # PAIRED slots for dep2 (joint draw)
        cdf2_rows = []               # the pair's channel CDF (16,)
        krows = []                   # _OP_K1Q rows (general 2-Kraus)
        eye2 = np.eye(2, dtype=complex)

        def noise_slots(tape, sites, logical):
            # slots in SPEC ORDER; ``logical`` carries qubit IDENTITY for
            # targeted (@) channels: a routed 2q gate parks logical qubit b
            # at physical site a+1 when the slots land (engine.build_tape)
            for kind, data, tset in self.chans:
                if kind == "p1":
                    for t, lq in zip(sites, logical):
                        if tset is not None and lq not in tset:
                            continue
                        rows.append(len(tape))
                        cdf_rows.append(data)
                        tape.append((_OP_1Q, t, eye2))
                elif kind == "p2":
                    if len(sites) == 2 and (tset is None or set(logical) <= tset):
                        rows2a.append(len(tape))
                        tape.append((_OP_1Q, sites[0], eye2))
                        rows2b.append(len(tape))
                        tape.append((_OP_1Q, sites[1], eye2))
                        cdf2_rows.append(data)
                else:  # "k": the Kraus blocks are static per program
                    for t, lq in zip(sites, logical):
                        if tset is not None and lq not in tset:
                            continue
                        krows.append(len(tape))
                        tape.append((_OP_K1Q, t, data))

        tape, self._center = build_tape(prims, self._center, on_gate=noise_slots)
        return pack_tape(tape) + (np.asarray(rows, dtype=np.int32),
                                  np.asarray(cdf_rows, dtype=np.float32).reshape(-1, 4),
                                  np.asarray(rows2a, dtype=np.int32),
                                  np.asarray(rows2b, dtype=np.int32),
                                  np.asarray(cdf2_rows, dtype=np.float32).reshape(-1, 16),
                                  np.asarray(krows, dtype=np.int32))

    def _tapes(self):
        """(the tapes of the gate events in run order, the stochastic sites
        per trajectory): a host pass over the events as :meth:`_exec` walks
        them, ``if`` bodies included."""
        if self._plan is None:
            from ..run.compiler import EvCond, EvGates, EvMeasure

            self._center = 0
            tapes = []
            count = 0

            def walk(events):
                nonlocal count
                for ev in events:
                    if isinstance(ev, EvGates):
                        t = self._tape(ev.prims)
                        tapes.append(t)
                        count += len(t[3]) + len(t[5]) + len(t[8])
                    elif isinstance(ev, EvMeasure):
                        count += len(ev.qubits) * (2 if self.readout_p else 1)
                    elif isinstance(ev, EvCond):
                        walk(ev.body)

            walk(self.events)
            self._plan = (tapes, count)
        return self._plan

    @property
    def sites(self) -> int:
        """Stochastic sites per trajectory (the uniform table's columns).
        Building the tapes raises NotAdjacentError for a prim wider than 2
        qubits."""
        return self._tapes()[1]

    def _dev_tape(self, i: int, dev):
        """Tape ``i``'s operands on ``dev``, uploaded once: the (L, 4, 4)
        row operands, the slots' CDFs, the K rows' norm operators and the
        Pauli table."""
        key = (i, str(dev))
        if key not in self._dev_tapes:
            codes, _, us, _, cdf, _, _, cdf2, _ = self._tapes()[0][i]

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            self._dev_tapes[key] = dict(
                us=up(us), cdf=up(cdf), cdf2=up(cdf2), pauli=up(_PAULI4),
                kks={k: up(v) for k, v in kraus_norm_ops(us, codes).items()})
        return self._dev_tapes[key]

    # -- the batch ------------------------------------------------------------

    def _cols(self, u, k: int):
        """The next ``k`` stochastic sites' (T, k) uniforms."""
        cols = u[:, self._site:self._site + k]
        self._site += k
        return cols

    def _gates(self, state, u):
        sites, disc = state
        i = self._ti
        self._ti += 1
        codes, qs, _, rows, _, rows2a, rows2b, _, krows = self._tapes()[0][i]
        d = self._dev_tape(i, sites.device)
        over, kuni = {}, {}
        if len(krows):
            uk = self._cols(u, len(krows))
            kuni = {int(r): uk[:, j] for j, r in enumerate(krows)}
        if len(rows):
            # c = #(cdf[j] <= u, j < 3) in 0..3: each slot's own CDF
            c = (d["cdf"][:, :3] <= self._cols(u, len(rows))[..., None]).sum(-1)
            ops = d["pauli"][c]                                 # (T, slots, 2, 2)
            over.update({int(r): ops[:, j] for j, r in enumerate(rows)})
        if len(rows2a):
            # ONE joint 16-outcome draw per 2q gate per channel: c >> 2 on
            # the gate's lower site, c & 3 on the upper
            c2 = (d["cdf2"][:, :15] <= self._cols(u, len(rows2a))[..., None]).sum(-1)
            lo, hi = d["pauli"][c2 >> 2], d["pauli"][c2 & 3]
            over.update({int(r): lo[:, j] for j, r in enumerate(rows2a)})
            over.update({int(r): hi[:, j] for j, r in enumerate(rows2b)})
        new = sites.clone()
        dd = run_tape(new, codes.tolist(), qs.tolist(), d["us"], over, kuni, d["kks"])
        return new, disc + dd

    def _measure(self, state, qubits, u):
        """Measure ``qubits`` in turn: each trajectory's weights of |0> and
        |1> on the qubit by an exact transfer contraction, a Born draw, the
        projection, and the kept branch's weight renormalising the site.
        Qubits in ascending order (``measure q -> c``) take one sweep
        (:meth:`_measure_sweep`); others one walk each."""
        sites, disc = state
        new = sites.clone()
        proj = torch.from_numpy(_PROJ).to(new.device)
        if list(qubits) == sorted(set(qubits)):
            return self._measure_sweep(new, list(qubits), u, proj), (new, disc)
        bits = []
        for q in qubits:
            vals = walk_expect(new, 2, {q: proj}).real              # (T, 2)
            v0, v1 = vals[:, 0], vals[:, 1]
            bit = self._draw(v0, v1, u)
            _apply_1q_(new, proj[bit.long()], q)
            new[:, q] *= _renorm(torch.where(bit == 1, v1, v0))[:, None, None, None]
            bits.append(bit)
        return bits, (new, disc)

    def _draw(self, v0, v1, u):
        """The Born draw of one qubit from its branch weights (T,)."""
        p1 = (v1 / (v0 + v1).clamp_min(1e-30)).clamp(0.0, 1.0)
        thr = torch.sqrt(p1) if config.reference_sqrt_born else p1
        return (self._u(u) < thr).to(torch.int32)

    def _measure_sweep(self, new, qubits, u, proj):
        """Ascending ``qubits`` in one sweep: the right environments of the
        state once, then a left environment carried site by site. A
        projection at site i changes neither the right environment of a
        later site nor the left one of an earlier, so each qubit's weights
        are one local contraction with the projected sites before it (the
        same numbers the walk of :meth:`_measure` gives, in O(n) launches
        for the event instead of O(n) per qubit). Projects ``new`` in place;
        returns the bits."""
        t, chi = new.shape[0], self.chi
        envs = right_envs(new)                             # (n, T, chi, chi) [ket, bra]
        left = torch.zeros((t, chi, chi), dtype=new.dtype, device=new.device)
        left[:, 0, 0] = 1                                  # [bra, ket]
        todo = set(qubits)
        bits = []
        for i in range(qubits[-1] + 1):
            a = new[:, i]
            k = torch.matmul(left, a.view(t, chi, 2 * chi)).view(t, chi, 2, chi)
            # e[s] = A_s^H left A_s: (T, 2, chi, chi) [bra, ket]
            e = torch.matmul(a.permute(0, 2, 3, 1).conj(), k.transpose(1, 2))
            if i not in todo:
                left = e.sum(1)
                continue
            w = (e * envs[i].transpose(-1, -2)[:, None]).sum((-1, -2)).real     # (T, 2)
            bit = self._draw(w[:, 0], w[:, 1], u)
            sc = _renorm(torch.where(bit == 1, w[:, 1], w[:, 0]))
            a.copy_(torch.matmul(proj[bit.long()][:, None], a) * sc[:, None, None, None])
            left = torch.where((bit == 1)[:, None, None], e[:, 1], e[:, 0]) * (sc * sc)[:, None, None]
            bits.append(bit)
        return bits

    def _reset(self, state, qubits):
        """The reference's reset: projection to |0> without a Born draw
        (Simulation.hs:146-156), renormalised by the branch's weight."""
        sites, disc = state
        new = sites.clone()
        proj = torch.from_numpy(_PROJ).to(new.device)
        for q in qubits:
            v0 = walk_expect(new, 1, {q: proj[:1]}).real[:, 0]
            _apply_1q_(new, proj[0], q)
            new[:, q] *= _renorm(v0)[:, None, None, None]
        return new, disc

    def _sel_state(self, pred, new, old):
        return new if pred is None else tuple(self._sel(pred, a, b) for a, b in zip(new, old))

    def _exec(self, events, state, cregs, u, pred):
        from ..run.compiler import EvCond, EvDump, EvGates, EvMeasure, EvReset

        for ev in events:
            if isinstance(ev, EvGates):
                state = self._sel_state(pred, self._gates(state, u), state)
            elif isinstance(ev, EvMeasure):
                bits, new = self._measure(state, ev.qubits, u)
                state = self._sel_state(pred, new, state)
                self._write_creg_bits(cregs, ev.writes, self._readout(bits, u), pred)
            elif isinstance(ev, EvReset):
                state = self._sel_state(pred, self._reset(state, ev.qubits), state)
            elif isinstance(ev, EvCond):
                hit = self._cond_hit(cregs, ev)
                sub = hit if pred is None else pred & hit
                state, cregs = self._exec(ev.body, state, cregs, u, sub)
            elif isinstance(ev, EvDump):
                pass
            else:  # pragma: no cover
                raise TypeError(f"unknown event {type(ev).__name__}")
        return state, cregs

    def _run_batch(self, u: torch.Tensor):
        """One batch: ``u`` the (T, S) uniforms on the batch's device.
        Returns (cregs of (T, size) int32 tensors, the final (sites, disc)
        or None for a program with no qubits)."""
        self._tapes()
        self._site = 0
        self._ti = 0
        dev = u.device
        u = u.to(torch.float32)
        t = u.shape[0]
        cregs = {c: torch.zeros((t, self.creg_sizes[c]), dtype=torch.int32, device=dev)
                 for c in self.creg_names}
        state = None
        if self.n:
            sites = torch.zeros((t, self.n, self.chi, 2, self.chi), dtype=torch.complex64,
                                device=dev)
            sites[..., 0, 0, 0] = 1
            state = (sites, torch.zeros(t, dtype=torch.float32, device=dev))
            state, cregs = self._exec(self.events, state, cregs, u, None)
        return cregs, state

    def _final_values(self, state, paulis) -> np.ndarray:
        """(T, k) per-trajectory <P> / <psi|psi> of the final states: all
        strings and the norm in one walk."""
        k, ops = _pauli_ops(paulis, self.n, state[0].device)
        vals = walk_expect(state[0], k, ops).real.double()
        return (vals[:, 1:] / vals[:, :1].clamp_min(1e-30)).cpu().numpy()

    # -- host API ---------------------------------------------------------------

    def run_vals(self, ntraj: int, seed: int | None = None, uniforms=None,
                 return_states: bool = False, mesh=None,
                 max_live_words: int | None = None, engine: str = "vmap"):
        """Trajectory outcomes: creg name -> (ntraj, size) int32 bit arrays,
        and with ``return_states`` the final ``(sites, disc)`` as CPU tensors
        ((ntraj, n, chi, 2, chi) complex64 and (ntraj,) float32). ``mesh``
        splits each batch over devices; ``engine`` is accepted for the base
        class's callers: "fused" is refused (it is the dense engine's)."""
        if engine not in ("vmap", "fused", "auto"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "fused":
            raise ValueError(f"engine='fused' applies to the dense state-vector "
                             f"engine, not {type(self).__name__}")

        def to_host(u):
            cregs, state = self._run_batch(u)
            return ({c: v.cpu().numpy() for c, v in cregs.items()},
                    tuple(t.cpu() for t in state) if return_states and state is not None
                    else None)

        parts = self._batches(ntraj, seed, uniforms, mesh, max_live_words, to_host)
        out = {c: np.concatenate([p[0][c] for p in parts])[:ntraj] for c in self.creg_names}
        if not return_states:
            return out
        if not self.n:
            return out, None
        return out, tuple(torch.cat([p[1][i] for p in parts])[:ntraj] for i in range(2))

    def expectations(self, paulis, ntraj: int, seed: int | None = None,
                     uniforms=None, mesh=None):
        """Monte-Carlo ``<P>`` for many strings, all reduced on each
        trajectory's final state in one walk. (mean, stderr) pairs in input
        order."""
        ups = [M._check_pauli(p, self.n) for p in paulis]
        mean, stderr = self._mc_estimate(lambda st: self._final_values(st, ups),
                                         ntraj, seed, uniforms, mesh)
        return [(float(m), float(s)) for m, s in zip(mean, stderr)]

    def expectation_sum(self, terms, ntraj: int, seed: int | None = None,
                        uniforms=None, mesh=None):
        """Monte-Carlo ``<H>`` for a Pauli sum: the per-trajectory energy is
        summed first, so the stderr is that of the energy itself."""
        terms = [(float(c), M._check_pauli(p, self.n)) for c, p in terms]
        coefs = np.asarray([c for c, _ in terms])

        def energy(state):
            return (self._final_values(state, [p for _, p in terms]) @ coefs)[:, None]

        mean, stderr = self._mc_estimate(energy, ntraj, seed, uniforms, mesh)
        return float(mean[0]), float(stderr[0])
