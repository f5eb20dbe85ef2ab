"""The comparisons that decide ``correct``.

Every amplitude number is the worst error of an amplitude, in units of the
root-mean-square amplitude 2^(-n/2), after the program's state is turned by
the one global phase that best aligns it with the reference's (a global
phase is no observable, and the reference takes OpenQASM's U without one).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

#: amplitudes a block of the full-state comparison moves to the card at once
_BLOCK = 1 << 26

_COUNT_LINE = re.compile(r"^\s+\|([01]+)>: (\d+)$", re.M)


def amps_err(a: np.ndarray, r: np.ndarray, n: int) -> float:
    """Worst |a e^(-i phi) - r| over the entries, over 2^(-n/2); phi is the
    phase of <r|a> over these entries."""
    a = np.asarray(a, dtype=np.complex128)
    r = np.asarray(r, dtype=np.complex128)
    ov = np.vdot(r, a)
    ph = ov / abs(ov) if abs(ov) > 0 else 1.0
    return float(np.max(np.abs(a * np.conj(ph) - r))) * math.sqrt(1 << n)


def state_err(a: np.ndarray, ref: torch.Tensor, n: int) -> float:
    """:func:`amps_err` over every amplitude: ``a`` the program's state on the
    host, ``ref`` the reference's on the card, compared block by block."""
    blocks = [(s, min(s + _BLOCK, a.size)) for s in range(0, a.size, _BLOCK)]
    ov = 0j
    for s, e in blocks:
        x = torch.from_numpy(a[s:e]).to(ref.device).to(torch.complex128)
        ov += complex(torch.vdot(ref[s:e].to(torch.complex128), x))
    ph = ov / abs(ov) if abs(ov) > 0 else 1.0
    worst = 0.0
    for s, e in blocks:
        x = torch.from_numpy(a[s:e]).to(ref.device).to(torch.complex128)
        d = (x * complex(np.conj(ph)) - ref[s:e].to(torch.complex128)).abs().max()
        worst = max(worst, float(d))
    return worst * math.sqrt(1 << n)


def parse_counts(text: str) -> dict[str, int]:
    """The ``|bits>: count`` rows that the CLI prints after its shots."""
    return {bits: int(c) for bits, c in _COUNT_LINE.findall(text)}


def xeb_gap(counts: dict[str, int], ref: torch.Tensor) -> float:
    """|r - 1|, r the mean reference probability of the program's shots over
    its expectation under the reference (sum of p^2): 1 for shots drawn from
    the reference's distribution, about 1/2 for shots drawn without regard to
    it from a scrambled state."""
    shots = sum(counts.values())
    idx = torch.tensor([int(b, 2) for b in counts], dtype=torch.int64, device=ref.device)
    c = torch.tensor(list(counts.values()), dtype=torch.float64, device=ref.device)
    p = ref[idx].abs().double().square()
    mean_p = float((c * p).sum()) / shots
    second = sum(float(ref[s:s + _BLOCK].abs().double().square().square().sum())
                 for s in range(0, ref.numel(), _BLOCK))
    return abs(mean_p / second - 1)


def judge(ctx, entry, params: list, outcomes: list, seed: int) -> tuple[int, dict]:
    """(programs failed, {number: {"value", "limit"}}) for one window.

    A program failed when it raised, returned another exit code than 0,
    left no state of the cell's width, or printed counts that do not add up
    to the cell's shots. The numbers, each compared where the cell's
    ``check.limits`` names it:

    * ``amps_err``: the fingerprints (the run's sampled amplitudes) of every
      program against the family's closed form where it has one, and of one
      program drawn from the seed and the last one against the reference;
    * ``state_err``: every amplitude of the last program's final state
      against the reference;
    * ``xeb_gap``: :func:`xeb_gap` of the shots of those two programs.

    The last program's state is copied to the host and every state of the
    program freed before the reference runs on the card."""
    from .harness import seed_of
    from .reference import simulate

    n, cfg, family = ctx.n, ctx.cfg, ctx.family
    shots = ctx.traffic.get("shots")
    counts, failed = [], 0
    for o in outcomes:
        c = parse_counts(o.text) if shots and o.text is not None else None
        failed += bool(o.rc != 0 or o.fp is None
                       or (shots and (not c or sum(c.values()) != shots)))
        counts.append(c)
    done = [i for i, o in enumerate(outcomes) if o.fp is not None]
    fps = dict(zip(done, torch.stack([outcomes[i].fp for i in done]).cpu().numpy())) \
        if done else {}
    idx = ctx.idx.cpu().numpy()
    last = len(outcomes) - 1
    answer = entry.answer() if last in fps else None
    host = answer.cpu().numpy() if answer is not None else None
    del answer
    entry.release()
    for o in outcomes:
        o.fp = None

    amps, xeb, state = [], [], None
    closed = getattr(family, "closed_form", None)
    if closed is not None:
        amps += [amps_err(fp, closed(cfg, params[i], idx), n) for i, fp in fps.items()]
    if outcomes:
        j = int(np.random.default_rng(seed_of(seed, 4)).integers(0, len(outcomes)))
        for i in sorted({j, last}):
            ref = simulate(n, family.gates(cfg, params[i]), ctx.device)
            if i in fps:
                amps.append(amps_err(fps[i], ref[ctx.idx].cpu().numpy(), n))
            if i == last and host is not None:
                state = state_err(host, ref, n)
            if counts[i]:
                xeb.append(xeb_gap(counts[i], ref))
            del ref
    numbers = {"amps_err": max(amps) if amps else None, "state_err": state,
               "xeb_gap": max(xeb) if xeb else None}
    return failed, {name: {"value": numbers.get(name), "limit": limit}
                    for name, limit in ctx.cell.spec["check"]["limits"].items()}
