"""Noisy OpenQASM programs: the noise-spec parsing, quantum trajectories
and the exact density backend.

Counterpart of qubism_tpu/run/noisy.py: ``--noise`` specs (parsed and
resolved against a program's layout, with the JAX package's messages),
:class:`TrajectoryProgram`, which runs a whole program (gates, channels,
mid-circuit measurement, feed-forward, reset) as a batch of independent
noisy trajectories, and :class:`DensityProgram`, which runs it on a
vectorized density matrix with every channel applied exactly.

Noise is circuit-level: each 1-qubit Kraus channel in the model is applied
to every qubit a gate touches, after the gate; 2-qubit channels (dep2) fire
once per 2-qubit gate. Channels can be RESTRICTED to qubits with an ``@``
target suffix (``dep:0.02@q[0]+anc``): a targeted 1q channel fires only on
gate qubits in its set, a targeted 2q channel only when BOTH gate qubits are
in the set. Items are ``+``-separated: a qreg name (all its qubits),
``name[i]`` (one qubit), or a bare absolute qubit index.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..config import config
from ..core import density as channels
from ..core.creg import CReg
from ..models import trajectories as T
from ..models.trajectories import _unitary_mix
from ..ops import apply as A
from ..ops import measure as M
from ..ops.apply import _sort_targets
from ..utils import profiling

__all__ = ["TrajectoryProgram", "DensityProgram", "single_buffer_cap", "group_runs",
           "parse_noise_spec", "NOISE_CHANNELS", "split_channel_target",
           "noise_spec_targets", "resolve_noise_targets", "resolve_traj_mesh"]

#: name (and aliases) -> 1-qubit Kraus-list factory taking one float param.
NOISE_CHANNELS = {
    "depolarizing": channels.depolarizing,
    "dep": channels.depolarizing,
    "depolarizing2": channels.depolarizing2,   # 2q gates only
    "dep2": channels.depolarizing2,
    "amplitude-damping": channels.amplitude_damping,
    "ad": channels.amplitude_damping,
    "phase-damping": channels.phase_damping,
    "pd": channels.phase_damping,
    "bitflip": channels.bit_flip,
    "bf": channels.bit_flip,
    "phaseflip": channels.phase_flip,
    "pf": channels.phase_flip,
}


def split_readout_spec(spec: str | None):
    """Extract a classical readout-error term (``ro:p`` / ``readout:p``)
    from a --noise spec. Returns (remaining_spec, p_or_None). Readout
    error is a REPORTING flip: each measured bit is written to the creg
    flipped with probability p, while the state collapses on the true
    outcome: the standard assignment-error model of the trajectory
    engines. The exact density backend refuses it."""
    rest, p = [], None
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.partition(":")
        if name.strip().lower() in ("ro", "readout"):
            if not sep:
                raise ValueError(
                    "readout channel needs a parameter (e.g. ro:0.01)")
            if "@" in val:
                raise ValueError(
                    "per-qubit readout-error targeting (ro:p@...) is not "
                    "supported; readout error applies to every measured "
                    "bit")
            p = float(val)
        else:
            rest.append(part)
    return ",".join(rest), p


def split_channel_target(part: str):
    """``"dep:0.01@q[2]+anc"`` -> ``("dep:0.01", "q[2]+anc")``; a part
    with no ``@`` returns ``(part, None)``."""
    core, sep, tgt = part.partition("@")
    if not sep:
        return part.strip(), None
    tgt = tgt.strip()
    if not tgt:
        raise ValueError(f"empty '@' target in noise part {part!r}")
    return core.strip(), tgt


def noise_spec_targets(spec: str):
    """The per-part ``@`` target specs of a --noise string, in spec
    order (None for untargeted parts). Parallel to
    :func:`parse_noise_spec`'s channel list; readout (``ro:p``) parts
    are excluded, mirroring :func:`split_readout_spec`."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        core, tspec = split_channel_target(part)
        name = core.partition(":")[0].strip().lower()
        if name in ("ro", "readout"):
            if tspec is not None:
                raise ValueError(
                    "per-qubit readout-error targeting (ro:p@...) is not "
                    "supported; readout error applies to every measured "
                    "bit")
            continue
        out.append(tspec)
    return out


def resolve_noise_targets(tspec: str, layout, qreg_sizes, n: int):
    """Resolve an ``@`` target spec into a frozenset of absolute qubit
    indices. ``layout`` maps qreg name -> first absolute qubit (the
    elaborator's layout), ``qreg_sizes`` maps name -> size, ``n`` is the
    total qubit count. Items are ``+``-separated: ``name`` (the whole
    qreg), ``name[i]``, or a bare absolute index."""
    qubits = set()
    for item in tspec.split("+"):
        item = item.strip()
        if not item:
            raise ValueError(f"empty item in noise target {tspec!r}")
        if item.isdigit():
            q = int(item)
            if q >= n:
                raise ValueError(
                    f"noise target qubit {q} out of range (n={n})")
            qubits.add(q)
            continue
        name, sep, idx = item.partition("[")
        name = name.strip()
        if name not in layout:
            raise ValueError(
                f"noise target {item!r}: no qreg named {name!r} "
                f"(declared: {sorted(layout) or 'none'})")
        base, size = layout[name], qreg_sizes[name]
        if not sep:
            qubits.update(range(base, base + size))
            continue
        idx = idx.strip()
        if not idx.endswith("]") or not idx[:-1].strip().isdigit():
            raise ValueError(f"malformed noise target {item!r}")
        k = int(idx[:-1])
        if k >= size:
            raise ValueError(
                f"noise target {item!r}: index {k} out of bounds for "
                f"{name}[{size}]")
        qubits.add(base + k)
    return frozenset(qubits)


def _normalize_noise(noise, layout, qreg_sizes, n):
    """Normalize a --noise value for a program: returns
    ``(chan_list, tsets)`` where chan_list is ``[(label, kraus_list,
    tset)]`` triples (``tset`` = frozenset of absolute qubits or None =
    all qubits — kept IN the entry so ``prog.noise`` round-trips into
    another program with its targeting intact) and tsets the parallel
    per-channel list. Accepts a spec string (``@`` targeting resolved
    against the program layout), or a parsed list whose entries are
    ``(label, ks)``, ``(label, ks, qubit_iterable)``, or round-tripped
    triples with a frozenset."""
    if noise is None:
        return [], []
    if isinstance(noise, str):
        chans, tsets = [], []
        for label, ks, tspec in _parse_noise_parts(noise):
            tset = (None if tspec is None
                    else resolve_noise_targets(tspec, layout, qreg_sizes, n))
            chans.append((label, ks, tset))
            tsets.append(tset)
        return chans, tsets
    chans, tsets = [], []
    for entry in noise:
        if len(entry) == 2:
            (label, ks), tset = entry, None
        else:
            label, ks, tgt = entry
            if tgt is None:
                tset = None
            else:
                qs = sorted(int(q) for q in tgt)
                bad = [q for q in qs if q < 0 or q >= n]
                if bad:
                    raise ValueError(
                        f"noise channel {label!r}: target qubit {bad[0]} "
                        f"out of range (n={n})")
                tset = frozenset(qs)
        chans.append((label, ks, tset))
        tsets.append(tset)
    return chans, tsets


def _parse_noise_parts(spec: str):
    """ONE tokenizer pass over a --noise spec: ``[(label, kraus_list,
    tspec_or_None), ...]`` — channel data and target specs come from the
    same walk, so they cannot fall out of index-parallel."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        part, tspec = split_channel_target(part)
        suffix = f"@{tspec}" if tspec else ""
        name, sep, val = part.partition(":")
        name = name.strip().lower()
        if name not in NOISE_CHANNELS:
            known = sorted(set(NOISE_CHANNELS) - {"dep", "ad", "pd", "bf",
                                                  "pf"})
            raise ValueError(
                f"unknown noise channel {name!r}; known: {', '.join(known)}")
        if not sep:
            raise ValueError(f"noise channel {name!r} needs a parameter "
                             f"(e.g. {name}:0.01)")
        p = float(val)
        out.append((f"{name}:{p}{suffix}", NOISE_CHANNELS[name](p), tspec))
    return out


def parse_noise_spec(spec: str):
    """``"depolarizing:0.01,ad:0.05"`` -> [(label, kraus_list), ...].

    A part may carry an ``@`` qubit-target suffix (``dep:0.01@q[2]``);
    the suffix is kept in the label but plays no role here — programs
    resolve it against their layout via :func:`_parse_noise_parts` +
    :func:`resolve_noise_targets`."""
    return [(label, ks) for label, ks, _ in _parse_noise_parts(spec)]


def resolve_traj_mesh(mesh):
    """Resolve a ``--mesh`` value to the devices a trajectory batch is split
    over, or ``None``.

    Trajectories are embarrassingly parallel, so unlike the amplitude-sharded
    state-vector path (``parallel/sharded.py``) the mesh here only splits the
    batch: each device runs ``batch/D`` whole trajectories, and the only
    traffic between devices is the final gather of per-trajectory outcomes.
    Accepts a device count (``int``; on the CPU, that many shards of the one
    CPU device) or a sequence of ``torch.device``s."""
    if mesh is None:
        return None
    if not isinstance(mesh, int):
        devs = tuple(torch.device(d) for d in mesh)
        return devs if len(devs) > 1 else None
    d = int(mesh)
    if torch.device(config.device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if d > have:
            raise ValueError(f"--mesh {d}: only {have} device(s) visible")
        devs = tuple(torch.device("cuda", i) for i in range(d))
    else:
        devs = (torch.device(config.device),) * d
    return devs if d > 1 else None


def _traj_split(batch, devs):
    """The batch's rows split evenly over ``devs`` (the counterpart of the
    JAX package's ``_traj_sharding``): [(device, rows)]."""
    step = batch.shape[0] // len(devs)
    return [(dev, batch[i * step:(i + 1) * step]) for i, dev in enumerate(devs)]


def _count_sites(events, kchans, tsets, readout_p) -> int:
    """The stochastic sites of one trajectory, in the order
    :meth:`TrajectoryProgram._exec` draws them: channels after each gate,
    one per measured qubit, then one readout flip per measured bit. A site
    inside an ``if`` body counts whether or not the branch is taken."""
    from .compiler import EvCond, EvGates, EvMeasure

    s = 0
    for ev in events:
        if isinstance(ev, EvGates):
            for p in ev.prims:
                for (_, is2q), tset in zip(kchans, tsets):
                    t = tuple(int(q) for q in p.targets)
                    if is2q:
                        s += len(t) == 2 and (tset is None or set(t) <= tset)
                    else:
                        s += sum(1 for q in t if tset is None or q in tset)
        elif isinstance(ev, EvMeasure):
            s += len(ev.qubits) * (2 if readout_p else 1)
        elif isinstance(ev, EvCond):
            s += _count_sites(ev.body, kchans, tsets, readout_p)
    return s


class TrajectoryProgram:
    """A QASM program run as a batch of independent noisy trajectories.

    ``noise`` is a spec string (see :func:`parse_noise_spec`) or an
    already-parsed list; ``None`` runs noiseless trajectories (still
    useful: independent mid-circuit re-runs per shot).

    The vmapped engine of the JAX package (``engine="vmap"``) is a (T, 2^n)
    batch here, every event applied to all rows at once by the out-of-place
    appliers of :mod:`~qubism_torch.models.trajectories`. Classical
    registers are (T, size) int32 bit tensors (column k = bit k, LSB-first);
    feed-forward is branch-free (the op is applied, then kept per row by
    ``torch.where`` on the predicate), so nothing is read back before the
    end. Each trajectory takes one row of a (T, S) float64 uniform table
    (S = :attr:`sites`), from a CPU generator seeded with ``seed`` or given
    as ``uniforms``: site s gets the column the JAX package's site counter
    gives it.
    """

    def __init__(self, ast, noise=None):
        from .compiler import elaborate

        (self.n, self.events, self.cregs0, self.layout,
         self.qreg_sizes) = elaborate(ast)
        self.readout_p = None
        if isinstance(noise, str):
            noise, self.readout_p = split_readout_spec(noise)
        self.noise, self._tsets = _normalize_noise(
            noise, self.layout, self.qreg_sizes, self.n)
        self.creg_names = sorted(self.cregs0)
        self.creg_sizes = {c: len(self.cregs0[c].bits) for c in self.creg_names}
        # Each channel's Kraus set is split once on the host, in SPEC ORDER
        # (non-commuting mixes like dep2+ad compose differently per order;
        # DensityProgram applies spec order, so every engine must).
        # Mixed-unitary channels (all Paulis) take the one-application CDF
        # path (models/trajectories._unitary_mix). 2q channels carry BOTH
        # target orderings: `cx q[2], q[0]` is descending, and its
        # SWAP-conjugated variant applies on the sorted axes.
        self._kchans = []
        for _, ks, _ in self.noise:
            is2q = np.asarray(ks[0]).shape[0] == 4
            variants = []
            for desc in ((False, True) if is2q else (False,)):
                kss = ([_sort_targets(np.asarray(k, dtype=complex), (1, 0))[0] for k in ks]
                       if desc else [np.asarray(k, dtype=complex) for k in ks])
                mix = _unitary_mix(kss)
                if mix is not None:
                    variants.append(("umix", mix))
                else:
                    variants.append(("kraus", np.stack(kss).astype(np.complex64)))
            self._kchans.append((tuple(variants), is2q))
        #: stochastic sites per trajectory (columns of the uniform table)
        self.sites = _count_sites(self.events, self._kchans, self._tsets, self.readout_p)
        self._site = 0  # the site counter of a run

    # -- batched execution --------------------------------------------------

    def _u(self, u):
        """The next stochastic site's (T,) float32 uniforms."""
        col = u[:, self._site].contiguous()
        self._site += 1
        return col

    @staticmethod
    def _sel(pred, new, old):
        if pred is None:
            return new
        return torch.where(pred.view((-1,) + (1,) * (new.dim() - 1)), new, old)

    def _readout(self, bits, u):
        """The readout-error reporting flip (the state already collapsed on
        the true bits)."""
        if not self.readout_p:
            return bits
        p = np.float32(self.readout_p).item()
        return [b ^ (self._u(u) < p).to(torch.int32) for b in bits]

    def _write_creg_bits(self, cregs, writes, bits, pred):
        """Store measured bits into the (T, size) creg bit tensors:
        ``writes`` = per statement (creg, bit_index_or_None, count)."""
        off = 0
        for creg, bit_index, count in writes:
            old = cregs[creg]
            if bit_index is None:
                val = torch.stack(bits[off:off + count], dim=1)
            else:
                val = old.clone()
                val[:, bit_index] = bits[off]
            cregs[creg] = self._sel(pred, val, old)
            off += count

    def _cond_hit(self, cregs, ev):
        """`if (creg == value)` per row, against the constant's LSB-first
        bit pattern (exact at any register width)."""
        old = cregs[ev.creg]
        size = self.creg_sizes[ev.creg]
        if ev.value >> size:           # value cannot fit: never true
            return torch.zeros(old.shape[0], dtype=torch.bool, device=old.device)
        want = torch.tensor([(ev.value >> k) & 1 for k in range(size)],
                            dtype=torch.int32, device=old.device)
        return (old == want).all(dim=1)

    def _apply_noise(self, new, p, u):
        for (variants, is2q), tset in zip(self._kchans, self._tsets):
            if is2q:
                if len(p.targets) != 2:
                    continue
                t = tuple(int(q) for q in p.targets)
                if tset is not None and not set(t) <= tset:
                    continue   # targeted coupler channel
                kind, kp = variants[t[0] > t[1]]
                apply = T.apply_unitary_mix_batch if kind == "umix" else T.apply_channel_batch
                new = apply(new, kp, tuple(sorted(t)), self.n, self._u(u))
            else:
                kind, kp = variants[0]
                apply = T.apply_unitary_mix_batch if kind == "umix" else T.apply_channel_batch
                for q in p.targets:
                    if tset is not None and int(q) not in tset:
                        continue
                    new = apply(new, kp, (int(q),), self.n, self._u(u))
        return new

    def _exec(self, events, psi, cregs, u, pred):
        from .compiler import EvCond, EvDump, EvGates, EvMeasure, EvReset

        for ev in events:
            if isinstance(ev, EvGates):
                for p in ev.prims:
                    new = self._apply_noise(T.apply_prim_batch(psi, p, self.n), p, u)
                    psi = self._sel(pred, new, psi)
            elif isinstance(ev, EvMeasure):
                bits = []
                new = psi
                for q in ev.qubits:
                    p1 = M.prob_one_batch(new, q, self.n)
                    thr = torch.sqrt(p1) if config.reference_sqrt_born else p1
                    bit = (self._u(u) < thr).to(torch.int32)
                    new = M.collapse_batch(new, bit, q, self.n)
                    bits.append(bit)
                psi = self._sel(pred, new, psi)
                self._write_creg_bits(cregs, ev.writes, self._readout(bits, u), pred)
            elif isinstance(ev, EvReset):
                new = psi
                for q in ev.qubits:
                    new = M.collapse_batch(new, 0, q, self.n)
                psi = self._sel(pred, new, psi)
            elif isinstance(ev, EvCond):
                hit = self._cond_hit(cregs, ev)
                sub = hit if pred is None else pred & hit
                psi, cregs = self._exec(ev.body, psi, cregs, u, sub)
            elif isinstance(ev, EvDump):
                pass  # no per-trajectory dump inside a batch
            else:  # pragma: no cover
                raise TypeError(f"unknown event {type(ev).__name__}")
        return psi, cregs

    def _run_batch(self, u: torch.Tensor):
        """Run one batch: ``u`` the (T, S) uniforms on the batch's device.
        Returns (cregs dict of (T, size) int32 tensors, final (T, 2^n)
        states or None for a program with no qubits)."""
        self._site = 0
        dev = u.device
        u = u.to(torch.float32)
        cregs = {c: torch.zeros((u.shape[0], self.creg_sizes[c]), dtype=torch.int32, device=dev)
                 for c in self.creg_names}
        psi = None
        if self.n:
            psi = T._zero_batch(u.shape[0], self.n, dev)
            psi, cregs = self._exec(self.events, psi, cregs, u, None)
        return cregs, psi

    # -- host API -----------------------------------------------------------

    #: Cap on simultaneously-live state words (batch x per-trajectory
    #: cost): 2^28 x 4 B = 2 GiB of live trajectory state per batch.
    _MAX_LIVE = 1 << 28

    def _traj_live_cost(self) -> int:
        """Per-trajectory live state in 4-byte words."""
        return 2 << max(self.n, 1)

    def _table(self, ntraj, seed, uniforms, padded):
        """The (padded, S) float64 uniform table; injected ``uniforms``
        ((ntraj, S)) are padded by repeating their last row."""
        if uniforms is None:
            return T.uniform_table(padded, self.sites, seed)
        u = torch.as_tensor(np.asarray(uniforms, dtype=np.float64).reshape(ntraj, self.sites))
        if padded > ntraj:
            u = torch.cat([u, u[-1:].expand(padded - ntraj, -1)])
        return u

    def _batches(self, ntraj, seed, uniforms, mesh, max_live_words, fn):
        """Run ``fn(uniforms on a device)`` over live-state-capped batches,
        each split evenly over the mesh's devices; returns the per-batch,
        per-device results in trajectory order. ``fn`` returns host values,
        so the device holds one batch at a time, whatever ``ntraj`` is."""
        devs = resolve_traj_mesh(mesh) or (A.device(),)
        d = len(devs)
        padded = -(-ntraj // d) * d
        table = self._table(ntraj, seed, uniforms, padded)
        cap = self._MAX_LIVE if max_live_words is None else max_live_words
        per = max(1, cap // self._traj_live_cost())
        batch = max(d, min(padded, per * d) // d * d)
        out = []
        for lo in range(0, padded, batch):
            for dev, rows in _traj_split(table[lo:min(lo + batch, padded)], devs):
                out.append(fn(rows.to(dev)))
        return out

    def run_vals(self, ntraj: int, seed: int | None = None, uniforms=None,
                 return_states: bool = False, mesh=None,
                 max_live_words: int | None = None, engine: str = "vmap"):
        """Run ``ntraj`` trajectories. Returns a dict creg name -> (ntraj,
        size) int32 outcome BIT arrays (column k = creg bit k, LSB-first:
        exact at any register width), plus the (ntraj, 2^n) complex64 final
        states (a CPU tensor) when ``return_states``.

        Trajectories run in batches sized so the live state block (batch x
        2^n complex64) stays under ~2 GiB per device (``max_live_words``
        overrides :attr:`_MAX_LIVE`); small runs are one batch. ``mesh`` (a
        device count or a sequence of devices, :func:`resolve_traj_mesh`)
        splits each batch over D devices. Results do not depend on the batch
        size or the split: row t always runs on row t of the table.

        ``engine="fused"`` runs the program through the kernels
        (:mod:`~qubism_torch.run.traj_fused`): mixture noise realized into
        gate operands on the host, amplitude/phase damping as MCWF sites
        chosen on the device, mid-circuit measurement, reset and
        feed-forward too. It raises
        :class:`~qubism_torch.run.traj_fused.FusedUnsupported` for reference
        sqrt-Born mode, >12-qubit mid-circuit events, >2-target prims and 2q
        state-dependent Kraus; its random stream is its own (statistically
        equivalent, not bit-identical to this engine's). ``engine="auto"``
        tries fused and takes this engine on ``FusedUnsupported``."""
        if engine not in ("vmap", "fused", "auto"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine in ("fused", "auto") and not return_states and mesh is None:
            from .traj_fused import FusedUnsupported, run_vals_fused

            try:
                return run_vals_fused(self, ntraj, seed=seed)
            except FusedUnsupported:
                if engine == "fused":
                    raise
        elif engine == "fused":
            raise ValueError("engine='fused' does not support return_states or mesh")

        def to_host(u):
            # each device's share to the host as its batch ends: the final
            # states are dropped here unless asked for, so device memory
            # does not grow with ntraj
            cregs, psi = self._run_batch(u)
            return ({c: v.cpu().numpy() for c, v in cregs.items()},
                    psi.cpu() if return_states and psi is not None else None)

        parts = self._batches(ntraj, seed, uniforms, mesh, max_live_words, to_host)
        out = {c: np.concatenate([p[0][c] for p in parts])[:ntraj] for c in self.creg_names}
        if not return_states:
            return out
        return out, (torch.cat([p[1] for p in parts])[:ntraj] if self.n else None)

    # -- Monte-Carlo observables --------------------------------------------

    def _mc_estimate(self, values, ntraj: int, seed, uniforms, mesh):
        """Shared Monte-Carlo scaffolding: ``values(final states)`` -> (T, k)
        per-trajectory values of each batch; returns (mean, stderr) over the
        trajectories, (k,) arrays (stderr 0 at one trajectory)."""
        parts = self._batches(ntraj, seed, uniforms, mesh, None,
                              lambda u: values(self._run_batch(u)[1]))
        vals = np.concatenate(parts)[:ntraj].astype(np.float64)
        mean = vals.mean(axis=0)
        stderr = (vals.std(axis=0, ddof=1) / np.sqrt(ntraj) if ntraj > 1
                  else np.zeros_like(mean))
        return mean, stderr

    def expectation(self, pauli: str, ntraj: int, seed: int | None = None,
                    uniforms=None, mesh=None):
        """Monte-Carlo ``<P>`` over ``ntraj`` noisy trajectories: returns
        ``(mean, stderr)``. The estimator is the trajectory average of the
        FINAL-state expectation; mid-circuit measurement and feed-forward
        run per trajectory exactly as in :meth:`run_vals`."""
        return self.expectations([pauli], ntraj, seed=seed, uniforms=uniforms, mesh=mesh)[0]

    def expectations(self, paulis, ntraj: int, seed: int | None = None,
                     uniforms=None, mesh=None):
        """Monte-Carlo ``<P>`` for MANY Pauli strings on one run: all strings
        reduce on each trajectory's final state. Returns a list of (mean,
        stderr) pairs in input order."""
        paulis = [M._check_pauli(p, self.n) for p in paulis]
        mean, stderr = self._mc_estimate(
            lambda psi: T.pauli_values(psi, self.n, paulis).astype(np.float32),
            ntraj, seed, uniforms, mesh)
        return [(float(m), float(s)) for m, s in zip(mean, stderr)]

    def expectation_sum(self, terms, ntraj: int, seed: int | None = None,
                        uniforms=None, mesh=None):
        """Monte-Carlo ``<H>`` for a Pauli sum ``terms = [(coef, pauli),
        ...]``: returns ``(mean, stderr)``. The per-trajectory energy is
        summed first, so the stderr is the shot noise of the energy itself,
        correlations between terms included."""
        terms = [(float(c), M._check_pauli(p, self.n)) for c, p in terms]
        coefs = np.asarray([c for c, _ in terms])

        def energy(psi):
            vals = T.pauli_values(psi, self.n, [p for _, p in terms]).astype(np.float32)
            return (vals.astype(np.float64) @ coefs)[:, None]

        mean, stderr = self._mc_estimate(energy, ntraj, seed, uniforms, mesh)
        return float(mean[0]), float(stderr[0])

    def counts(self, ntraj: int, seed: int | None = None, uniforms=None,
               mesh=None, engine: str = "vmap"):
        """Joint classical-register outcome histogram over trajectories:
        {"c=0110 d=1": count}, bits rendered LSB-first like the
        reference's CReg Show."""
        vals = self.run_vals(ntraj, seed=seed, uniforms=uniforms, mesh=mesh, engine=engine)
        rows = []
        for t in range(ntraj):
            rows.append(" ".join(f"{c}={CReg.of(vals[c][t])}" for c in self.creg_names))
        return collections.Counter(rows)


def single_buffer_cap(dev: torch.device) -> int:
    """The widest n whose rho :class:`DensityProgram` keeps in one buffer
    on ``dev``. On the CPU it is :attr:`DensityProgram.MAX_N`, the JAX
    package's 14. On a CUDA card it is the largest n whose 8 * 4^n bytes
    of complex64 fill at most half of the card's memory, which leaves the
    other half for the work beside rho: 16 on an 80 GB H100 (32 GiB), 15 on
    a 24 GB card (8 GiB)."""
    if dev.type != "cuda":
        return DensityProgram.MAX_N
    total = torch.cuda.get_device_properties(dev).total_memory
    n = 0
    while 8 * 4 ** (n + 1) <= total // 2:
        n += 1
    return n


#: the widest run of gates :class:`DensityProgram` composes into one pass:
#: its superoperator on 2 x 2 qubits is the gate kernel's widest matrix
FUSED_WIDTH = 2


def group_runs(targets) -> list[list[int]]:
    """The runs into which :class:`DensityProgram` groups a stretch of gates
    on at most :data:`FUSED_WIDTH` qubits each between two barriers, given
    each gate's qubits in program order: lists of the gates' indices, each
    in program order, in the order the runs are applied.

    A gate joins the latest run on any of its qubits if their qubits
    together number at most :data:`FUSED_WIDTH`. Otherwise a single-qubit
    gate waits for its qubit's first run, and a wider gate opens a run,
    which takes the gates waiting on its qubits first. Gates still waiting
    at the end (their qubits have no run) pair up into runs of their own,
    applied last.

    Applying the runs in this order is exact: on every qubit the gates keep
    their program order. A gate joins a run after which no run holds any of
    its qubits, so it moves ahead only of runs on other qubits. A waiting
    gate goes into the first run on its qubit, ahead of that qubit's later
    gates, or into a run of its own after every run, none of which holds
    its qubit. And a gate on other qubits, with the channels after it,
    commutes with it.
    """
    runs: list[tuple[set, list]] = []  # (qubits, gate indices), in the order opened
    latest: dict[int, int] = {}  # qubit -> its latest run
    waiting: dict[int, list] = {}  # qubit -> its gates that no run holds yet
    for g, t in enumerate(targets):
        t = {int(q) for q in t}
        r = max((latest[q] for q in t if q in latest), default=None)
        if r is None or len(runs[r][0] | t) > FUSED_WIDTH:
            if len(t) == 1:
                (q,) = t
                waiting.setdefault(q, []).append(g)
                continue
            r = len(runs)
            runs.append((set(), []))
        qubits, gates = runs[r]
        gates.extend(sorted(i for q in t for i in waiting.pop(q, ())))
        gates.append(g)
        qubits |= t
        latest.update(dict.fromkeys(t, r))
    left = list(waiting.values())
    return [gates for _, gates in runs] + [
        sorted(sum(left[i:i + FUSED_WIDTH], [])) for i in range(0, len(left), FUSED_WIDTH)]


class DensityProgram:
    """Exact open-system execution of a QASM program: the state is a
    vectorized density matrix on the dense engine (a 2n-qubit tensor,
    core/density.py), with the --noise channels applied exactly
    (rho -> sum K rho K^dag) instead of sampled, for n small enough that
    4^n amplitudes fit.

    Mid-circuit measurement samples ONE outcome per measure and projects
    rho (like hardware, one run); ``--shots`` then reads the exact final
    diagonal.

    On one buffer, the gates on at most :data:`FUSED_WIDTH` qubits between
    two barriers (a measurement, reset, conditional, dump, a wider gate or
    the end) are grouped into runs on at most that many qubits
    (:func:`group_runs`): a gate joins the latest run on its qubits where
    it fits, and a single-qubit gate waits for its qubit's next run. Each
    run is one pass over rho: its gates and the channels after each,
    composed on the host into one superoperator in program order
    (:meth:`~qubism_torch.core.density.DensityMatrix.apply_superoperator`).
    The runs are applied in the order they were opened, which keeps the
    gates of every qubit in program order: a gate moves only past gates
    and channels on other qubits, which commute with it. So a Boixo cycle's
    single-qubit gates ride in the pass of their qubit's next cz. A wider
    gate takes a pass for its rows, one for its columns and one a channel;
    the mesh's rho takes that route for every gate.
    """

    #: 2*n qubits ride the dense engine: the widest rho in one buffer on the
    #: CPU, the JAX package's cap (its TPU's 2^29-element buffers). A CUDA
    #: card holds more: :func:`single_buffer_cap`.
    MAX_N = 14

    def __init__(self, ast, noise=None, mesh=None):
        from .compiler import elaborate

        (self.n, self.events, self.cregs0, self.layout,
         self.qreg_sizes) = elaborate(ast)
        #: shard count (or device sequence) for the mesh-sharded rho
        #: (parallel/density.py), which lifts the single-buffer cap
        self.mesh = mesh
        if mesh is None:
            dev = A.device()
            cap = single_buffer_cap(dev)
            if self.n > cap:
                # on the CPU the JAX package's words; on a card, the card's
                which = "" if dev.type != "cuda" else (
                    f", the widest rho in half of the "
                    f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.1f} GB "
                    f"of {torch.cuda.get_device_name(dev)}")
                raise ValueError(
                    f"--backend density stores 4^n amplitudes; n={self.n} > "
                    f"{cap}{which}. Shard over a mesh (--mesh D) or use "
                    f"--noise with --trajectories (sampled) instead.")
        if isinstance(noise, str):
            noise, ro = split_readout_spec(noise)
            if ro is not None:
                raise ValueError(
                    "readout error (ro:p) is a per-shot reporting flip; "
                    "the exact density backend has no shots to flip — "
                    "use trajectory mode")
        self.noise, self._tsets = _normalize_noise(
            noise, self.layout, self.qreg_sizes, self.n)
        #: each channel's superoperator, built once for the composed runs
        self._supers = [channels.superoperator(ks) for _, ks, _ in self.noise]

    def run(self, seed: int | None = None, dump_writer=None, uniforms=None):
        """Execute from |0...0><0...0|. Returns (rho, cregs dict); rho is
        None for a program with no qubits. Each measured qubit takes one
        uniform from a CPU generator seeded with ``seed``, or the next of
        ``uniforms``. The run is the span ``qubism.density``."""
        with profiling.span("qubism.density"):
            return self._run(seed, dump_writer, uniforms)

    def _run(self, seed, dump_writer, uniforms):
        from ..core.density import DensityMatrix
        from .compiler import EvCond, EvDump, EvGates, EvMeasure, EvReset

        dump_writer = dump_writer or (lambda s: None)
        gen = torch.Generator().manual_seed(0 if seed is None else seed)
        injected = None if uniforms is None else iter(uniforms)
        if not self.n:
            rho = None
        elif self.mesh is not None:
            from ..parallel.density import ShardedDensityMatrix
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(self.mesh) if isinstance(self.mesh, int) else self.mesh
            rho = ShardedDensityMatrix(self.n, mesh)
        else:
            rho = DensityMatrix(self.n)
        cregs = dict(self.cregs0)

        fused = isinstance(rho, DensityMatrix)
        narrow: list = []  # the gates since the last barrier, grouped at the next

        def flush():
            for run in group_runs([p.targets for p in narrow]):
                with profiling.span("qubism.density.unitary"):
                    prims = [narrow[i] for i in run]
                    order = tuple(sorted({int(q) for p in prims for q in p.targets}))
                    rho.apply_superoperator(self._superoperator(prims, order), order, len(prims))
            narrow.clear()

        def exec_events(events):
            for ev in events:
                if isinstance(ev, EvGates):
                    for p in ev.prims:
                        if fused and len(p.targets) <= FUSED_WIDTH:
                            narrow.append(p)
                            continue
                        flush()
                        rho.apply([p])
                        for ks, _, ct in self._channels(p):
                            rho.apply_channel(ks, ct)
                    continue
                flush()  # every other event reads or changes rho as it stands
                if isinstance(ev, EvMeasure):
                    bits = [rho.measure_qubit(q, gen, None if injected is None
                                              else float(next(injected)))
                            for q in ev.qubits]
                    off = 0
                    for creg, bit_index, count in ev.writes:
                        if bit_index is None:
                            cregs[creg] = CReg.of(bits[off:off + count])
                        else:
                            cregs[creg] = cregs[creg].set_bit(
                                bit_index, bits[off])
                        off += count
                elif isinstance(ev, EvReset):
                    for q in ev.qubits:
                        rho.reset(q)
                elif isinstance(ev, EvCond):
                    if cregs[ev.creg].to_natural() == ev.value:
                        exec_events(ev.body)
                elif isinstance(ev, EvDump):
                    dump_writer(self._pretty(rho, cregs))

        exec_events(self.events)
        flush()
        # the recursive closure is a reference cycle that holds rho: break it,
        # so that rho's memory is freed when the caller drops it, not at the
        # next garbage collection
        exec_events = None
        return rho, cregs

    def _channels(self, p):
        """The channels that follow gate ``p``, in the spec's order, as
        (Kraus list, superoperator, targets): a 1-qubit channel on each of
        the gate's qubits in its set, a 2-qubit one (4x4 Kraus) on a 2-qubit
        gate whose qubits are both in its set, in the gate's target order."""
        for (_, ks, _), s, tset in zip(self.noise, self._supers, self._tsets):
            if np.asarray(ks[0]).shape[0] == 4:
                t = tuple(int(q) for q in p.targets)
                if len(t) == 2 and (tset is None or set(t) <= tset):
                    yield ks, s, t
            else:
                for q in p.targets:
                    if tset is None or int(q) in tset:
                        yield ks, s, (int(q),)

    def _superoperator(self, prims, qubits):
        """The map of a run of gates on ``qubits`` (sorted) and the channels
        after each, on vec(rho)'s (qubits, qubits + n): each gate's
        U (x) conj(U) and each channel's superoperator, widened to those
        targets and multiplied from the left in the order the pass-by-pass
        route applies them, in complex128."""
        n = self.n
        dst = tuple(qubits) + tuple(q + n for q in qubits)

        def on(s, t):
            return A._expand_np(s, t + tuple(q + n for q in t), dst)

        out = np.eye(1 << len(dst), dtype=np.complex128)
        for p in prims:
            u = np.asarray(p.dense(), dtype=np.complex128)
            out = on(np.kron(u, u.conj()), tuple(int(q) for q in p.targets)) @ out
            for _, s, t in self._channels(p):
                out = on(s, t) @ out
        return out

    def _pretty(self, rho, cregs) -> str:
        out = ["Dump of the internal state (density backend): \n\n"]
        if rho is not None:
            name = "(x)".join(self.layout) if self.layout else ""
            noise = ", ".join(lbl for lbl, *_ in self.noise) or "none"
            out.append(f"Density matrix of {name}: {rho.n} qubits, "
                       f"trace={rho.trace():.6f}, purity={rho.purity():.6f}, "
                       f"noise={noise}\n")
            probs = rho.probs()
            for i, p in enumerate(probs):
                if p > 5e-7:
                    out.append(f"  |{format(i, f'0{rho.n}b')}>  p={p:.6f}\n")
        for reg in sorted(cregs):
            out.append(f"{reg}: {cregs[reg]}\n")
        out.append("\n")
        return "".join(out)
