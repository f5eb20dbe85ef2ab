"""The comparisons that decide ``correct``.

Every amplitude number is the worst error of an amplitude, in units of the
root-mean-square amplitude 2^(-n/2), after the program's state is turned by
the one global phase that best aligns it with the reference's (a global
phase is no observable, and the reference takes OpenQASM's U without one).
A family's numbers (a value, a gradient) are compared as they are against
its plain reference's, and shots against the distribution the family says
they are drawn from (by default |amplitude|^2 of the reference's vector).
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


def distribution(family, cfg: dict, ref: torch.Tensor) -> torch.Tensor:
    """The distribution the program's shots are drawn from, given the
    reference's vector: the family's ``probs`` where it has one, else
    |ref|^2 in float64."""
    probs = getattr(family, "probs", None)
    return probs(cfg, ref) if probs is not None else ref.abs().double().square_()


def xeb_gap(counts: dict[str, int], probs: torch.Tensor) -> float:
    """|r - 1|, r the mean probability under ``probs`` of the program's
    shots over its expectation under ``probs`` (sum of p^2): 1 for shots
    drawn from that distribution, about 1/2 for shots drawn without regard
    to it from a scrambled state."""
    shots = sum(counts.values())
    idx = torch.tensor([int(b, 2) for b in counts], dtype=torch.int64, device=probs.device)
    c = torch.tensor(list(counts.values()), dtype=torch.float64, device=probs.device)
    mean_p = float((c * probs[idx].double()).sum()) / shots
    second = sum(float(probs[s:s + _BLOCK].double().square().sum())
                 for s in range(0, probs.numel(), _BLOCK))
    return abs(mean_p / second - 1)


def numbers_err(got: dict, want: dict) -> float:
    """The worst over names of max|a - r| / max(1, max|r|): ``got`` the
    program's numbers, ``want`` the reference's, of the same names and
    shapes."""
    errs = []
    for name, r in want.items():
        r = np.asarray(r, dtype=np.float64)
        d = np.abs(np.asarray(got[name], dtype=np.float64) - r)
        errs.append(d.max(initial=0) / max(1.0, np.abs(r).max(initial=0)))
    return float(np.max(errs, initial=0))  # a NaN anywhere reads NaN


def _same_form(got: dict | None, want: dict) -> bool:
    return got is not None and set(got) == set(want) and all(
        np.shape(got[k]) == np.shape(want[k]) for k in want)


def judge(ctx, entry, params: list, outcomes: list, seed: int) -> tuple[list[str], dict]:
    """(a line for each program that failed, {number: {"value", "limit"}})
    for one window.

    A program failed when it raised or returned another exit code than 0;
    where ``amps_err`` or ``state_err`` is among the cell's limits, when it
    left no state; where ``numbers_err`` is, when it left no numbers of the
    reference's names and shapes; and where the cell takes shots, when its
    counts do not add up to them. The numbers, each computed only where the
    cell's ``check.limits`` names it:

    * ``amps_err``: the fingerprints (the run's sampled amplitudes) of every
      program against the family's closed form where it has one, and of one
      program drawn from the seed and the last one against the reference;
    * ``state_err``: every amplitude of the last program's final state
      against the reference;
    * ``xeb_gap``: :func:`xeb_gap` of the shots of those two programs, on
      :func:`distribution` of the reference's vector;
    * ``numbers_err``: :func:`numbers_err` of those two programs' numbers
      against the family's ``numbers``.

    The reference's vector (``simulate`` of the family's gate list) is made
    only for the first three. The last program's state is copied to the
    host and every state of the program freed before a reference runs."""
    from .harness import seed_of
    from .reference import simulate

    n, cfg, family = ctx.n, ctx.cfg, ctx.family
    limits = ctx.cell.spec["check"]["limits"]
    shots = ctx.traffic.get("shots")
    states = "amps_err" in limits or "state_err" in limits
    counts = [parse_counts(o.text) if shots and o.text is not None else None
              for o in outcomes]
    done = [i for i, o in enumerate(outcomes) if o.fp is not None] if states else []
    fps = dict(zip(done, torch.stack([outcomes[i].fp for i in done]).cpu().numpy())) \
        if done else {}
    last = len(outcomes) - 1
    answer = entry.answer() if "state_err" in limits and last in fps else None
    host = answer.cpu().numpy() if answer is not None else None
    del answer
    if hasattr(entry, "release"):
        entry.release()
    for o in outcomes:
        o.fp = None

    found = {name: [] for name in ("amps_err", "state_err", "xeb_gap", "numbers_err")}
    want = None
    closed = getattr(family, "closed_form", None)
    if closed is not None and "amps_err" in limits:
        idx = ctx.idx.cpu().numpy()
        found["amps_err"] += [amps_err(fp, closed(cfg, params[i], idx), n)
                              for i, fp in fps.items()]
    if outcomes:
        j = int(np.random.default_rng(seed_of(seed, 4)).integers(0, len(outcomes)))
        for i in sorted({j, last}):
            if states or "xeb_gap" in limits:
                ref = simulate(n, family.gates(cfg, params[i]), ctx.device)
                if i in fps and "amps_err" in limits:
                    found["amps_err"].append(amps_err(fps[i], ref[ctx.idx].cpu().numpy(), n))
                if i == last and host is not None:
                    found["state_err"].append(state_err(host, ref, n))
                if counts[i] and "xeb_gap" in limits:
                    found["xeb_gap"].append(xeb_gap(counts[i], distribution(family, cfg, ref)))
                del ref
            if "numbers_err" in limits:
                want = family.numbers(cfg, params[i], ctx.device)
                if _same_form(outcomes[i].numbers, want):
                    found["numbers_err"].append(numbers_err(outcomes[i].numbers, want))

    failures = []
    for i, o in enumerate(outcomes):
        why = (f"rc {o.rc} {o.error or ''}" if o.rc != 0
               else "no state" if states and i not in fps
               else "no numbers of the reference's names and shapes"
               if want is not None and not _same_form(o.numbers, want)
               else f"counts not adding up to {shots} shots"
               if shots and (not counts[i] or sum(counts[i].values()) != shots)
               else None)
        if why:
            failures.append(f"program {i}: {why} {(o.text or '')[-400:]}")
    return failures, {name: {"value": float(np.max(found[name])) if found.get(name) else None,
                             "limit": limit} for name, limit in limits.items()}
