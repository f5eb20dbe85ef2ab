"""The kernel adjoint engine on an amplitude mesh: the adjoint sweep of
:mod:`.adjoint_engine` with phi and lam each split into D = 2^d shards.

Counterpart of qubism_tpu/models/adjoint_mesh.py. The mesh is a tuple of
torch devices (``parallel.make_mesh``; a device may repeat, so several
shards can share one card). Shard i is one contiguous complex64 tensor of
2^m amplitudes (m = n - d) on ``mesh[i]``, holding the amplitudes whose top
d qubits read i: the JAX package's ``shard_map`` block layout and the
port's ``ShardedSim`` with no banks. The units of
:func:`.adjoint_engine.plan_units` are applied shard by shard, in place:

* **1q units**: the local gates through :func:`.adjoint_engine.unit_calls`
  on every shard with the targets moved into the shard (K4 layers and one
  K3 kron); a gate on a device bit combines shard i with its partner
  i ^ mask, ``new_i = u[b, b] x_i + u[b, 1-b] x_partner`` with b the
  shard's bit, one temporary per pair (both shards are read before either
  is written), the partner copied over when it lies on another device;
* **diagonal units**: no shard reads another. Each shard picks its
  sub-table of every factor by its device bits; local factors go to K2
  (``fusion.plan(DiagLayer(...))``), a factor only on device bits is one
  complex scalar per shard;
* **fixed dense prims** sit on local targets (K1, or K3 in the lane
  block); one on a device bit is refused;
* **gradient contraction**: ``2 s Im <lam|G phi>`` per generator term, per
  flip mask one :func:`ops.measure.pauli_pair_sums` walk of shard i of phi
  with shard i ^ (the term's device flip bits) of lam, the device Z/Y bits
  a sign per shard, summed over the shards in float64 on the host (the two
  state form of ``ShardedSim.expectation_sum``);
* **head**: diagonal (I/Z) Hamiltonians only. The device-bit Z parities
  are folded into the coefficients per shard, so ``lam_i = w_i phi_i`` and
  the energy are :func:`.adjoint_engine.diag_head` per shard, summed in
  float64.

Left out, as the TPU compiler's needs: the ``lax.scan`` batching and
``optimization_barrier`` of the pair reductions, and the straddle-term cap
on a diag group (the port's K2 splits wide factors itself).
``units_per_chunk`` (the JAX engine's jit chunking) is accepted and
changes nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.gates import Prim
from ..ops import kernels
from ..ops import measure as M
from ..ops.apply import canonical_device
from ..ops.fusion import DiagLayer, plan
from ..parallel.sharded import LOCAL_MAX
from . import adjoint_engine as AE
from .variational import (PGate, _check_terms, _field, _gen_terms, _host_theta, _op_matrix,
                          _pair_values, _parity_signs, _peer, _zero_shards)


def _shift(op, d: int):
    """An op with its targets moved into shard coordinates."""
    if isinstance(op, Prim):
        return op.shifted(-d)
    return dataclasses.replace(op, targets=tuple(t - d for t in op.targets))


def _run_calls(shards, unit, theta: np.ndarray, m: int, dag: bool):
    """A unit on local targets applied to every shard in place; its kernel
    operands are built once per device."""
    calls = {}
    for x in shards:
        if x.device not in calls:
            calls[x.device] = AE.unit_calls(unit, theta, m, x.device, dag)
        for name, args in calls[x.device]:
            getattr(kernels, name)(x, *args, m)


# ---------------------------------------------------------------------------
# Applying a unit to the shards
# ---------------------------------------------------------------------------


def _apply_1q_unit(shards, ops, theta, d: int, m: int, dag: bool):
    local = [_shift(op, d) for op in ops if op.targets[0] >= d]
    if local:
        _run_calls(shards, ("1q", local), theta, m, dag)
    for op in ops:
        q = op.targets[0]
        if q >= d:
            continue
        u = _op_matrix(op, theta, dag)[1]
        mask = 1 << (d - 1 - q)
        for i in range(len(shards)):
            j = i ^ mask
            if j < i:
                continue
            b = (i >> (d - 1 - q)) & 1
            xi, xj = shards[i], shards[j]
            keep = xi.clone()
            xi.mul_(complex(u[b, b])).add_(_peer(shards, i, j), alpha=complex(u[b, 1 - b]))
            xj.mul_(complex(u[1 - b, 1 - b])).add_(keep.to(xj.device),
                                                   alpha=complex(u[1 - b, b]))
            del keep


def _apply_diag_unit(shards, ops, theta, d: int, m: int, dag: bool):
    tables = [(_op_matrix(op, theta, dag)[1], tuple(op.targets)) for op in ops]
    for i, x in enumerate(shards):
        factors = []
        scale = 1.0
        for table, targets in tables:
            k = len(targets)
            gsel = [j for j in range(k) if targets[j] < d]
            lsel = [j for j in range(k) if targets[j] >= d]
            local = tuple(targets[j] - d for j in lsel)
            if not gsel:
                factors.append((table, local))
                continue
            sub = (table.reshape((2,) * k).transpose(gsel + lsel)
                   .reshape(1 << len(gsel), 1 << len(lsel))[_field(i, [targets[j] for j in gsel], d)])
            if lsel:
                factors.append((sub, local))
            else:
                scale *= complex(sub[0])
        if factors:
            name, args = plan(DiagLayer(tuple(factors)), m, x.device)
            getattr(kernels, name)(x, *args, m)
        if scale != 1.0:
            x.mul_(scale)


def _apply_unit(shards, unit, theta, d: int, m: int, dag: bool = False):
    """A unit (or its dagger) applied to the shards in place."""
    kind, ops = unit
    if kind == "1q":
        _apply_1q_unit(shards, ops, theta, d, m, dag)
    elif kind == "diag":
        _apply_diag_unit(shards, ops, theta, d, m, dag)
    else:
        _run_calls(shards, ("prim", [_shift(ops[0], d)]), theta, m, dag)


def _unit_grad(phi, lam, unit, n: int, d: int, g: np.ndarray):
    """Add a unit's gradient contributions into ``g`` (float64) from the
    sharded (phi, lam) pair at the unit's after boundary (the sharded
    counterpart of :func:`.adjoint_engine.unit_walks` and
    :func:`.adjoint_engine.add_grads`)."""
    entries = [(op.pidx[0], op.scale * coef, pauli) for op in unit[1] if isinstance(op, PGate)
               for coef, pauli in _gen_terms(op, n)]
    if not entries:
        return
    vals = _pair_values(phi, lam, n, d, [p for _, _, p in entries])
    for (pidx, sc, _), v in zip(entries, vals):
        g[pidx] += 2.0 * sc * v.imag


def _head(phi, checked, d: int, m: int):
    """(E, lam = H phi) for a diagonal H on the shards: each shard's
    coefficients carry the parity of its device Z bits, and
    :func:`.adjoint_engine.diag_head` does the rest per shard."""
    zg = [M.pauli_masks(p)[1] >> m for _, p in checked]
    e = 0.0
    lam = []
    for i, x in enumerate(phi):
        signs = _parity_signs(i, zg)
        ei, li = AE.diag_head(x, m, [(c * s, p[d:]) for (c, p), s in zip(checked, signs)], 0.0)
        e += ei
        lam.append(li)
    return e, tuple(lam)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _validate(ansatz, mesh):
    """(devices, d, m, units) of an ansatz on ``mesh``; ValueError when it
    has no lowering there."""
    D = len(mesh)
    d = D.bit_length() - 1
    if D < 1 or (1 << d) != D:
        raise ValueError(f"mesh size {D} is not a power of two")
    n = ansatz.n
    m = n - d
    if m < 2:
        raise ValueError(f"{D} shards need n >= {d + 2}")
    if m > LOCAL_MAX:
        raise ValueError(
            f"per-device block of {m} qubits exceeds the single-buffer limit "
            f"({LOCAL_MAX}); banked adjoint states are not supported")
    units = AE.plan_units(ansatz.ops, n)
    if units is None:
        raise ValueError("ansatz has ops without a kernel lowering")
    for kind, ops in units:
        if kind == "prim" and any(t < d for t in ops[0].targets):
            raise ValueError(
                f"fixed dense prim on device-bit targets {ops[0].targets}: relabel the "
                f"circuit or use the plain mesh sweep (engine='plain')")
    devices = tuple(canonical_device(dv) for dv in mesh)
    return devices, d, m, units


def supports_mesh(ansatz, mesh) -> bool:
    """True when every op of the ansatz lowers on this mesh (the head must
    also be diagonal; the router tries the constructor for that)."""
    try:
        _validate(ansatz, mesh)
        return True
    except ValueError:
        return False


def mesh_adjoint_value_and_grad_fn(ansatz, terms, mesh, constant: float = 0.0,
                                   units_per_chunk: int = 4):
    """``theta -> (energy, dE/dtheta)``: the adjoint sweep through the
    kernels on phi and lam sharded over ``mesh`` (~2 states plus one shard
    of temporaries in all, at any depth). Energy and gradient come back as
    float32 CPU tensors; the callable's ``_engine`` is ``"kernels-mesh"``.
    Diagonal (I/Z) Hamiltonians only. Raises ValueError when an op or the
    head has no lowering on this mesh:
    ``variational.adjoint_value_and_grad_fn(engine="auto")`` then runs the
    plain sweep on the shards. ``units_per_chunk`` changes nothing."""
    del units_per_chunk
    devices, d, m, units = _validate(ansatz, mesh)
    n = ansatz.n
    _, checked = _check_terms(terms, n)
    if not all(set(p) <= set("IZ") for _, p in checked):
        raise ValueError("mesh adjoint head supports diagonal (I/Z) Hamiltonians; use the "
                         "plain mesh sweep (engine='plain')")

    def vg(theta):
        th = _host_theta(theta)
        phi = _zero_shards(devices, m)
        for unit in units:
            _apply_unit(phi, unit, th, d, m)
        e, lam = _head(phi, checked, d, m)
        g = np.zeros(ansatz.num_params)
        for unit in reversed(units):
            _unit_grad(phi, lam, unit, n, d, g)
            _apply_unit(phi, unit, th, d, m, dag=True)
            _apply_unit(lam, unit, th, d, m, dag=True)
        return (torch.tensor(e + float(constant), dtype=torch.float32),
                torch.from_numpy(g.astype(np.float32)))

    vg._engine = "kernels-mesh"
    return vg
