"""Noisy Clifford trajectories: Pauli channels on the tableau at 1000+ qubits.

Counterpart of qubism_tpu/stabilizer/noise.py. A Pauli error never changes
a stabilizer tableau's X/Z planes: conjugating a row by a Pauli P only
flips its sign when they anticommute, so a sampled Pauli channel
(depolarizing, bit flip, phase flip, dep2) is a phase-plane update
(tableau.py:pauli_phase) after each gate.

:class:`StabilizerTrajectoryProgram` picks its engine as the JAX package
does (``used_frames`` records it): a program of gates and one final
measurement runs on Pauli frames (frames.py:frame_run_vals); gates with
mid-circuit measurement and reset and no feed-forward on the mid-circuit
frame scan (frames.py:frame_run_vals_events); anything else (feed-forward,
a reset of a superposed qubit) on exact tableaux, one ``(T, 2n, W)`` batch
per live-state cap, the way the dense engine is a (T, 2^n) batch:
feed-forward by ``torch.where`` on the predicate, measurement by the
rounds of tableau.py:measure_seq, each batch's outcomes to the host
before the next. The batch draws its randomness from the uniform table of
:class:`~qubism_torch.run.noisy.TrajectoryProgram` (row t is trajectory
t's), so its outcomes do not depend on the batch size or the ``mesh``
split.

Amplitude/phase damping are not Pauli channels and are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import measure as M
from ..run.noisy import TrajectoryProgram, _count_sites
from .tableau import (Tableau, _host, _where, apply_prims, expect_packed,
                      identity_tableau, measure_seq, pauli_phase, x_phase_flips)

__all__ = ["StabilizerTrajectoryProgram", "pauli_channel_cdfs", "NotPauliChannelError"]


class NotPauliChannelError(ValueError):
    """Raised for noise channels a stabilizer engine cannot unravel."""


#: channel name -> (p) -> (pI, pX, pY, pZ)
_PAULI_CHANNELS = {
    "depolarizing": lambda p: (1 - p, p / 3, p / 3, p / 3),
    "dep": lambda p: (1 - p, p / 3, p / 3, p / 3),
    "bitflip": lambda p: (1 - p, p, 0.0, 0.0),
    "bf": lambda p: (1 - p, p, 0.0, 0.0),
    "phaseflip": lambda p: (1 - p, 0.0, 0.0, p),
    "pf": lambda p: (1 - p, 0.0, 0.0, p),
}


def pauli_channel_cdfs(spec: str, backend: str = "stabilizer"):
    """Parse a --noise spec into stacked Pauli-channel CDFs: ``(cdfs1,
    cdfs2)``, 1-qubit channels as (C1, 4) cumulative (pI, pX, pY, pZ) rows
    and 2-qubit depolarizing (``dep2:p``, after every 2-qubit gate) as
    (C2, 16) rows whose index c is Pauli ``c >> 2`` on the gate's first
    qubit and ``c & 3`` on its second. Non-Pauli channels raise
    :class:`NotPauliChannelError`; ``@`` targeting is refused on the
    stabilizer backend; ``backend`` labels the messages."""
    cdfs1, cdfs2 = [], []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "@" in part and backend == "stabilizer":
            raise ValueError(
                f"per-qubit noise targeting ({part!r}) is not supported "
                f"on the stabilizer backend; the dense trajectory, "
                f"density, and mps executors support '@'")
        name, sep, val = part.partition(":")
        name = name.strip().lower()
        if not sep:
            raise NotPauliChannelError(
                f"noise channel {name!r} needs a parameter "
                f"(e.g. {name}:0.01)")
        if name in ("dep2", "depolarizing2"):
            p = float(val)
            probs = np.full(16, p / 15.0, dtype=np.float32)
            probs[0] = 1.0 - p
            cdfs2.append(np.cumsum(probs))
            continue
        fac = _PAULI_CHANNELS.get(name)
        if fac is None:
            raise NotPauliChannelError(
                f"noise channel {name!r} is not a Pauli channel; the "
                f"{backend} backend unravels depolarizing/dep2/bitflip/"
                f"phaseflip here (amplitude/phase damping: the dense "
                f"trajectory mode, or the mps backend's in-scan Kraus "
                f"path)")
        probs = np.asarray(fac(float(val)), dtype=np.float32)
        cdfs1.append(np.cumsum(probs))
    return (np.stack(cdfs1) if cdfs1 else np.zeros((0, 4), np.float32),
            np.stack(cdfs2) if cdfs2 else np.zeros((0, 16), np.float32))


class StabilizerTrajectoryProgram(TrajectoryProgram):
    """Noisy Clifford QASM as tableau trajectories, with the Pauli-frame
    executors where the program allows them.

    Inherits the creg/feed-forward machinery, the uniform table, the
    batching and the host API of :class:`TrajectoryProgram`; the quantum
    state of a trajectory is a bit-packed tableau instead of 2^n
    amplitudes. ``noise`` is a spec string or (C, 4) Pauli CDF rows.
    """

    def __init__(self, ast, noise=None):
        from ..run.compiler import elaborate
        from ..run.noisy import split_readout_spec

        (self.n, self.events, self.cregs0, self.layout,
         self.qreg_sizes) = elaborate(ast)
        self.readout_p = None
        if isinstance(noise, str):
            noise, self.readout_p = split_readout_spec(noise)
            self.cdfs, self.cdfs2 = pauli_channel_cdfs(noise)
        else:
            self.cdfs = np.asarray(noise if noise is not None
                                   else np.zeros((0, 4), np.float32), np.float32)
            self.cdfs2 = np.zeros((0, 16), np.float32)
        self.noise = [("pauli", None)] if len(self.cdfs) or len(self.cdfs2) else []
        self.creg_names = sorted(self.cregs0)
        self.creg_sizes = {c: len(self.cregs0[c].bits) for c in self.creg_names}
        # the uniform table's columns, in the order _exec takes them: after
        # each prim one per 1q channel per qubit and one per 2q channel on a
        # 2q prim; one per measured qubit (and one per readout flip)
        kchans = [(None, False)] * len(self.cdfs) + [(None, True)] * len(self.cdfs2)
        self.sites = _count_sites(self.events, kchans, [None] * len(kchans), self.readout_p)
        self._site = 0
        self.used_frames = False

    def _traj_live_cost(self) -> int:
        """Words per trajectory: the planes and the phase, and the readout's
        three (n, n) float32 work matrices."""
        words = (self.n + 31) // 32
        return max(1, 4 * self.n * words + 2 * self.n + 3 * self.n * self.n)

    # -- the tableau batch ----------------------------------------------------

    def _gates(self, tab: Tableau, prims, u) -> Tableau:
        from .tableau import _apply_table, _gate_table

        if not len(self.cdfs) and not len(self.cdfs2):
            return apply_prims(tab, prims)
        dev = tab.x.device
        x, z, s = tab.x.clone(), tab.z.clone(), tab.s
        cdfs = torch.from_numpy(np.asarray(self.cdfs, np.float32)).to(dev)
        cdfs2 = torch.from_numpy(np.asarray(self.cdfs2, np.float32)).to(dev)
        for p in prims:
            t = p.targets
            if len(t) > 2:
                raise NotPauliChannelError(
                    "stabilizer trajectories apply 1- and 2-qubit Clifford "
                    "prims; decompose wider prims first")
            table = _gate_table(p.dense(), dev)
            if table is not None:
                s = _apply_table(x, z, s, t, table)
            for ci in range(len(self.cdfs)):
                for q in t:
                    c = (cdfs[ci, :3] <= self._u(u)[:, None]).sum(-1).to(torch.int32)
                    s = pauli_phase(Tableau(x, z, s), q, c)
            if len(t) == 2:
                for ci in range(len(self.cdfs2)):
                    c = (cdfs2[ci, :15] <= self._u(u)[:, None]).sum(-1).to(torch.int32)
                    s = pauli_phase(Tableau(x, z, s), t[0], c >> 2)
                    s = pauli_phase(Tableau(x, z, s), t[1], c & 3)
        return Tableau(x, z, s.to(torch.int32))

    @staticmethod
    def _sel_tab(pred, new: Tableau, old: Tableau) -> Tableau:
        return new if pred is None else _where(pred, new, old)

    def _exec(self, events, tab, cregs, u, pred):
        from ..run.compiler import EvCond, EvDump, EvGates, EvMeasure, EvReset

        for ev in events:
            if isinstance(ev, EvGates):
                tab = self._sel_tab(pred, self._gates(tab, ev.prims, u), tab)
            elif isinstance(ev, EvMeasure):
                rnd = torch.stack([(self._u(u) < 0.5).to(torch.int32) for _ in ev.qubits], 1)
                outs, new = measure_seq(tab, ev.qubits, rnd, self.n)
                tab = self._sel_tab(pred, new, tab)
                bits = [outs[:, k] for k in range(len(ev.qubits))]
                self._write_creg_bits(cregs, ev.writes, self._readout(bits, u), pred)
            elif isinstance(ev, EvReset):
                # the reference's reset projects to |0> (Simulation.hs:146-156):
                # a measurement with a FORCED 0 outcome is that projection; a
                # |1>-certain qubit, whose projection is the zero vector, takes
                # the X flip (the physical reset)
                zeros = torch.zeros((u.shape[0], len(ev.qubits)), dtype=torch.int32,
                                    device=u.device)
                outs, new = measure_seq(tab, ev.qubits, zeros, self.n)
                new = new._replace(s=x_phase_flips(new, ev.qubits, outs))
                tab = self._sel_tab(pred, new, tab)
            elif isinstance(ev, EvCond):
                hit = self._cond_hit(cregs, ev)
                sub = hit if pred is None else pred & hit
                tab, cregs = self._exec(ev.body, tab, cregs, u, sub)
            elif isinstance(ev, EvDump):
                pass
            else:  # pragma: no cover
                raise TypeError(f"unknown event {type(ev).__name__}")
        return tab, cregs

    def _run_batch(self, u: torch.Tensor):
        """One batch: ``u`` the (T, S) uniforms on the batch's device.
        Returns (cregs of (T, size) int32 tensors, the (T, 2n, W) tableau
        batch or None for a program with no qubits)."""
        self._site = 0
        dev = u.device
        u = u.to(torch.float32)
        cregs = {c: torch.zeros((u.shape[0], self.creg_sizes[c]), dtype=torch.int32, device=dev)
                 for c in self.creg_names}
        tab = None
        if self.n:
            tab = identity_tableau(self.n, dev, batch=u.shape[0])
            tab, cregs = self._exec(self.events, tab, cregs, u, None)
        return cregs, tab

    # -- the engine choice ----------------------------------------------------

    def _frame_plan(self):
        """(prims, final measure event) when the program is Clifford gates
        followed by ONE final measurement."""
        from ..run.compiler import EvGates, EvMeasure

        evs = list(self.events)
        if not evs or not isinstance(evs[-1], EvMeasure):
            return None
        if any(not isinstance(e, EvGates) for e in evs[:-1]):
            return None
        return [p for e in evs[:-1] for p in e.prims], evs[-1]

    def _frame_plan_midcircuit(self):
        """The event stream when it is MID-CIRCUIT frame-eligible: gates,
        measurements and resets, no feed-forward, at least one measurement,
        and every reset qubit either untouched so far or covered by the
        immediately preceding measurement (where the frame executor's
        physical reset coincides with the reference's projection)."""
        from ..run.compiler import EvDump, EvGates, EvMeasure, EvReset

        evs = [e for e in self.events if not isinstance(e, EvDump)]
        if not any(isinstance(e, EvMeasure) for e in evs):
            return None
        touched: set[int] = set()
        prev = None
        for ev in evs:
            if isinstance(ev, EvGates):
                touched |= {t for p in ev.prims for t in p.targets}
            elif isinstance(ev, EvMeasure):
                touched |= set(ev.qubits)
            elif isinstance(ev, EvReset):
                fresh = all(q not in touched for q in ev.qubits)
                measured = (isinstance(prev, EvMeasure)
                            and set(ev.qubits) <= set(prev.qubits))
                if not (fresh or measured):
                    return None
                touched |= set(ev.qubits)
            else:
                return None
            prev = ev
        return evs

    def _gates_only(self) -> bool:
        from ..run.compiler import EvGates

        return bool(self.n) and all(isinstance(e, EvGates) for e in self.events)

    def _prims(self):
        return [p for e in self.events for p in e.prims]

    def run_vals(self, ntraj: int, seed: int | None = None, uniforms=None,
                 return_states: bool = False, mesh=None,
                 max_live_words: int | None = None, engine: str = "vmap"):
        """Trajectory outcomes: creg name -> (ntraj, size) int32 bit arrays
        (and the final (ntraj, 2n, W) tableau planes on the host when
        ``return_states``). A final-measurement-only program takes the
        Pauli-frame executor, a mid-circuit measure/reset program without
        feed-forward the mid-circuit frame scan, anything else (or injected
        ``uniforms``) the tableau batch; ``self.used_frames`` records which
        ran. The frame paths draw their randomness differently, so a seed's
        outcomes (not distributions) differ between them. ``mesh`` splits
        only the tableau batch. ``engine`` is accepted for the base class's
        callers: "fused" is refused (it is the dense engine's)."""
        from .frames import frame_run_vals, frame_run_vals_events

        if engine not in ("vmap", "fused", "auto"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "fused":
            raise ValueError(f"engine='fused' applies to the dense state-vector "
                             f"engine, not {type(self).__name__}")
        self.used_frames = False
        if not return_states and self.n and uniforms is None:
            plan = self._frame_plan()
            if plan is not None:
                out = frame_run_vals(self, plan[0], plan[1], ntraj, seed)
            else:
                evs = self._frame_plan_midcircuit()
                out = None if evs is None else frame_run_vals_events(self, evs, ntraj, seed)
            if out is not None:
                self.used_frames = True
                return out

        def to_host(u):
            cregs, tab = self._run_batch(u)
            return ({c: v.cpu().numpy() for c, v in cregs.items()},
                    tuple(t.cpu() for t in tab) if return_states and tab is not None else None)

        parts = self._batches(ntraj, seed, uniforms, mesh, max_live_words, to_host)
        out = {c: np.concatenate([p[0][c] for p in parts])[:ntraj] for c in self.creg_names}
        if not return_states:
            return out
        if not self.n:
            return out, None
        return out, Tableau(*(torch.cat([p[1][i] for p in parts])[:ntraj] for i in range(3)))

    # -- Monte-Carlo observables --------------------------------------------

    def expectations(self, paulis, ntraj: int, seed: int | None = None,
                     uniforms=None, mesh=None):
        """Monte-Carlo ``<P>`` for many strings: a gates-only program
        evaluates every string against ONE frame propagation (a frame cannot
        reproduce a post-collapse expectation), anything else on the final
        tableaux of one batch run. (mean, stderr) pairs in input order."""
        from .frames import frame_expectations

        ups = [M._check_pauli(p, self.n) for p in paulis]
        self.used_frames = False
        if self._gates_only() and uniforms is None:
            out = frame_expectations(self, self._prims(), ups, ntraj, seed)
            if out is not None:
                self.used_frames = True
                return out
        mean, stderr = self._mc_estimate(
            lambda tab: np.stack([_host(expect_packed(tab, p, self.n)) for p in ups], 1),
            ntraj, seed, uniforms, mesh)
        return [(float(m), float(s)) for m, s in zip(mean, stderr)]

    def expectation_sum(self, terms, ntraj: int, seed: int | None = None,
                        uniforms=None, mesh=None):
        """Monte-Carlo ``<H>`` for a Pauli sum; a gates-only program takes
        ONE frame propagation for all terms."""
        from .frames import frame_expectation_sum

        terms = [(float(c), M._check_pauli(p, self.n)) for c, p in terms]
        self.used_frames = False
        if self._gates_only() and uniforms is None:
            out = frame_expectation_sum(self, self._prims(), terms, ntraj, seed)
            if out is not None:
                self.used_frames = True
                return out
        coefs = np.asarray([c for c, _ in terms])

        def energy(tab):
            vals = np.stack([_host(expect_packed(tab, p, self.n)) for _, p in terms], 1)
            return (vals.astype(np.float64) @ coefs)[:, None]

        mean, stderr = self._mc_estimate(energy, ntraj, seed, uniforms, mesh)
        return float(mean[0]), float(stderr[0])
