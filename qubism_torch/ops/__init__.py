"""State-vector engine: appliers, kernels, fusion, measurement, sampling."""

from .apply import apply_diag, apply_gate, normalize, tensor  # noqa: F401
from .measure import collapse, measure_qubit, prob_one, probabilities  # noqa: F401
