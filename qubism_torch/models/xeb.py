"""Cross-entropy benchmarking (XEB) for random-circuit sampling.

Counterpart of qubism_tpu/models/xeb.py. The linear XEB fidelity is the
acceptance metric for brickwork/RCS workloads (Arute et al. 2019): for
samples x_1..x_S drawn from a device (or a noisy simulation) and ideal Born
probabilities p(x) of the target circuit,

    F_XEB = 2^n * mean_i p(x_i) - 1.

Sampling from the ideal distribution gives F -> 1 for Haar-like
(Porter-Thomas) circuits; uniform (fully-depolarized) samples give
F -> 0; partially-noisy samplers land in between, which is exactly the
fidelity estimate. The log variant uses mean log p.

Probability lookups gather the sampled amplitudes on the state's device
and read back only those: O(S), never the 2^n state, so XEB scoring works
at the full benchmark sizes (n = 30+). The reference has no benchmarking
machinery at all.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sampled_probabilities(state, samples) -> np.ndarray:
    """Born probabilities p(x_i) of the given basis indices (host float64).

    ``state`` is a StateVec or a complex64 state tensor (any shape of 2^n
    entries, read flat); ``samples`` is any int array of basis indices. One
    gather on the state's device per call."""
    t = getattr(state, "state", state).reshape(-1)
    idx = torch.from_numpy(np.asarray(samples, dtype=np.int64).reshape(-1)).to(t.device)
    a = torch.view_as_real(t[idx]).double()
    return (a * a).sum(dim=-1).cpu().numpy()


def linear_xeb(state, samples, n: int | None = None) -> float:
    """F_XEB = 2^n <p(x_i)> - 1 over the sampled bitstrings."""
    if n is None:
        n = state.n
    p = sampled_probabilities(state, samples)
    return float((1 << n) * p.mean() - 1.0)


def log_xeb(state, samples, n: int | None = None) -> float:
    """Log cross-entropy fidelity: <log(2^n p(x_i))> + gamma, normalized
    so ideal Porter-Thomas sampling gives 1 and uniform sampling 0.
    Zero-probability samples clamp at float32 tiny (they indicate F~0
    anyway)."""
    if n is None:
        n = state.n
    p = np.maximum(sampled_probabilities(state, samples), 1e-38)
    # ideal PT: <log(Dp)> over samples drawn FROM p is 1 - gamma; uniform
    # draws give -gamma. Normalize to [0, 1].
    gamma = 0.5772156649015329
    return float(np.mean(np.log((1 << n) * p)) + gamma)


def counts_to_indices(counts: dict[str, int]) -> np.ndarray:
    """Expand a {bitstring: count} histogram (the samplers' output
    format) into a flat index array for the XEB estimators."""
    out = np.empty(sum(counts.values()), dtype=np.int64)
    k = 0
    for s, c in counts.items():
        out[k:k + c] = int(s, 2)
        k += c
    return out


def xeb_stderr(state, samples, n: int | None = None) -> tuple[float, float]:
    """(F_XEB, standard error) — the error bar of the mean-probability
    estimator, for judging sample-size adequacy."""
    if n is None:
        n = state.n
    p = sampled_probabilities(state, samples)
    d = float(1 << n)
    vals = d * p - 1.0
    return float(vals.mean()), float(vals.std(ddof=1) / math.sqrt(len(vals)))
