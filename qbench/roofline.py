"""The yardstick of the kernels: the card's published peaks, the bytes and
operations one call of each kernel wrapper needs, and the least time they
allow.

Copied from the port's own arithmetic (``chip_smoke.py`` ``kernel_cost``,
``qubism_torch/ops/probes.py`` ``bound`` and its peaks) so that a later
change to the program cannot move the yardstick. The cost is that of the
work a wrapper is asked for, from its operands: every amplitude read and
written once plus the operands read once, whatever the kernel reads again
and however many passes it takes. So the same work reads the same bound
whatever kernel implements it.
"""

from __future__ import annotations

import re

import numpy as np

#: published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W): HBM3
#: bytes/s, float32 operations/s outside the tensor cores, TF32 on them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12

#: the lane block: the last 7 qubits form the rows the lane kernel multiplies
LANE_BITS = 7


def bound_s(nbytes: float, flops: float, tf32x3: bool = False) -> float:
    """The least seconds: the larger of the bytes over the memory rate and
    the operations over their peak. ``tf32x3``: each float32 operation runs
    on the tensor cores as three TF32 products (the lane kernel)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 3 * flops / PEAK_TF32_FLOP_PER_S if tf32x3 else flops / PEAK_FP32_FLOP_PER_S
    return max(t_bytes, t_ops)


def _factors(arg):
    """The (diagonal, targets) factors of a diag call's operand: the factors
    themselves, or a prepared plan that holds them as ``factors``."""
    return getattr(arg, "factors", arg)


def kernel_cost(name: str, args: tuple, n: int) -> tuple[int, int]:
    """(bytes, float32 operations) of one call of the kernel wrapper
    ``name`` with ``args`` (its arguments between the state and n) on 2^n
    amplitudes. A complex multiply-add is 8 operations, a complex product 6."""
    amps = 1 << n
    if name == "gate":
        d = 1 << len(args[1])
        return 16 * amps + 8 * d * d, 8 * d * amps
    if name == "layer1q":
        m = len(args[0])
        return 16 * amps + 32 * m, 16 * m * amps
    if name == "diag":  # each factor's product, then one into the amplitude
        factors = _factors(args[0])
        tables = sum(np.asarray(d).size for d, _ in factors)
        return 16 * amps + 8 * tables, 6 * (len(factors) + 1) * amps
    if name == "lane":
        lanes = 1 << min(n, LANE_BITS)
        return 16 * amps + 8 * lanes * lanes, 8 * lanes * amps
    if name == "stage":  # per group of 2^k: C x, the phase lookups, the phases
        plan = args[0]
        k, d = len(plan.targets), 1 << len(plan.targets)
        groups = amps // d
        ops = 8 * d * d + 6 * k * plan.chunks + 6 * k * d // 2
        return 16 * amps + 8 * (d * d + plan.tables.size), ops * groups
    raise ValueError(f"no cost for kernel {name!r}")


def kernel_bound_s(name: str, args: tuple, n: int) -> float:
    """The least seconds one call of wrapper ``name`` needs on the card."""
    nbytes, flops = kernel_cost(name, args, n)
    tf32x3 = name == "lane" and n >= LANE_BITS
    return bound_s(nbytes, flops, tf32x3)


def short_name(name: str) -> str:
    """A device kernel's name without its namespace, arguments and return
    type (``layer1q_kernel<6, false>``)."""
    m = re.search(r"(\w+_kernel)\b(<[^(]*>)?", name)
    return (m.group(1) + (m.group(2) or "")) if m else name.split("(")[0][-60:]
