"""Noisy OpenQASM programs: the noise-spec parsing and the exact density
backend.

Counterpart of qubism_tpu/run/noisy.py, the exact part: ``--noise`` specs
(parsed and resolved against a program's layout, with the JAX package's
messages) and :class:`DensityProgram`, which runs a program on a vectorized
density matrix with every channel applied exactly.

Noise is circuit-level: each 1-qubit Kraus channel in the model is applied
to every qubit a gate touches, after the gate; 2-qubit channels (dep2) fire
once per 2-qubit gate. Channels can be RESTRICTED to qubits with an ``@``
target suffix (``dep:0.02@q[0]+anc``): a targeted 1q channel fires only on
gate qubits in its set, a targeted 2q channel only when BOTH gate qubits are
in the set. Items are ``+``-separated: a qreg name (all its qubits),
``name[i]`` (one qubit), or a bare absolute qubit index.

The sampled counterpart (``TrajectoryProgram``, with ``resolve_traj_mesh``
and ``_traj_sharding``) is not ported yet; it goes below
:func:`parse_noise_spec`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import density as channels
from ..core.creg import CReg

__all__ = ["DensityProgram", "parse_noise_spec", "NOISE_CHANNELS",
           "split_channel_target", "noise_spec_targets",
           "resolve_noise_targets"]

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


# TrajectoryProgram, resolve_traj_mesh and _traj_sharding go here.


class DensityProgram:
    """Exact open-system execution of a QASM program: the state is a
    vectorized density matrix on the dense engine (a 2n-qubit tensor,
    core/density.py), with the --noise channels applied exactly
    (rho -> sum K rho K^dag) instead of sampled, for n small enough that
    4^n amplitudes fit.

    Mid-circuit measurement samples ONE outcome per measure and projects
    rho (like hardware, one run); ``--shots`` then reads the exact final
    diagonal.
    """

    #: 2*n qubits ride the dense engine: the widest rho in one buffer.
    MAX_N = 14

    def __init__(self, ast, noise=None, mesh=None):
        from .compiler import elaborate

        (self.n, self.events, self.cregs0, self.layout,
         self.qreg_sizes) = elaborate(ast)
        #: shard count (or device sequence) for the mesh-sharded rho
        #: (parallel/density.py), which lifts the single-buffer cap
        self.mesh = mesh
        if mesh is None and self.n > self.MAX_N:
            raise ValueError(
                f"--backend density stores 4^n amplitudes; n={self.n} > "
                f"{self.MAX_N}. Shard over a mesh (--mesh D) or use "
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

    def run(self, seed: int | None = None, dump_writer=None, uniforms=None):
        """Execute from |0...0><0...0|. Returns (rho, cregs dict); rho is
        None for a program with no qubits. Each measured qubit takes one
        uniform from a CPU generator seeded with ``seed``, or the next of
        ``uniforms``."""
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

        def exec_events(events):
            for ev in events:
                if isinstance(ev, EvGates):
                    for p in ev.prims:
                        rho.apply([p])
                        for (_, ks, _), tset in zip(self.noise, self._tsets):
                            if np.asarray(ks[0]).shape[0] == 4:
                                t = tuple(int(q) for q in p.targets)
                                if len(t) == 2 and (tset is None
                                                    or set(t) <= tset):
                                    rho.apply_channel(ks, t)
                            else:
                                for q in p.targets:
                                    if tset is None or int(q) in tset:
                                        rho.apply_channel(ks, (int(q),))
                elif isinstance(ev, EvMeasure):
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
        # the recursive closure is a reference cycle that holds rho: break it,
        # so that rho's memory is freed when the caller drops it, not at the
        # next garbage collection
        exec_events = None
        return rho, cregs

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
