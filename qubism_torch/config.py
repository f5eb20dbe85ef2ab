"""Global configuration for the qubism-torch engine.

The reference simulator (qubitrot/qubism) has a handful of numerical quirks
that we deliberately deviate from by default (see SURVEY.md §2.4):

* ``unitary θ φ λ`` is non-unitary for generic parameters
  (reference ``src/Qubism/QGate.hs:112-118``): the matrix entries use the
  exponent ``φ + λ/2`` (precedence bug) and the top row is missing its minus
  signs. We implement the OpenQASM 2.0 spec matrix (arXiv:1707.03429) by
  default; set ``reference_u3_bug = True`` to replicate the reference bug.

* measurement sampling uses ``r < sqrt(p)`` instead of the Born rule
  ``r < p`` (reference ``src/Qubism/StateVec.hs:121-129``). We use the
  correct Born rule by default; set ``reference_sqrt_born = True`` to
  replicate.

* ``pi`` evaluates to the truncated literal ``3.14159265358979``
  (reference ``src/Qubism/QASM/Simulation.hs:211``). We use ``math.pi`` by
  default; set ``reference_truncated_pi = True`` to replicate (the
  difference is ~3e-15, far inside the 1e-6 acceptance tolerance).

* the reference loses single-qubit gates applied to registers that have been
  fused with others (``src/Qubism/QASM/Simulation.hs:87-100`` writes the
  updated state vector under the QReg's name instead of the backing state
  vector's id, orphaning the update). This is a plain bug with no redeeming
  semantics; we always write to the backing state vector and provide no
  compat flag.

The torch device the state lives on is ``config.device``: ``"cuda"`` unless
the ``QUBISM_TORCH_DEVICE`` environment variable names another one. A CUDA
device that is absent is an error (ops/apply.py:device), never a silent
run on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import os

#: L2 tolerance for approximate equality of states and gates.
#: Mirrors the reference (src/Qubism/StateVec.hs:47-49, QGate.hs:54-56).
TOLERANCE = 1e-6

#: Truncated pi literal used by the reference expression evaluator
#: (src/Qubism/QASM/Simulation.hs:211).
REFERENCE_PI = 3.14159265358979


@dataclasses.dataclass
class Config:
    """Amplitudes are one contiguous complex64 tensor on ``device``.
    Reference-compatibility quirks are off by default (see module docs)."""

    reference_u3_bug: bool = False
    reference_sqrt_born: bool = False
    reference_truncated_pi: bool = False

    #: Force register measurement through the sequential per-qubit stream
    #: instead of the (distribution-identical) marginal-table path.
    force_sequential_measure: bool = False

    #: torch device name for every state tensor
    device: str = dataclasses.field(
        default_factory=lambda: os.environ.get("QUBISM_TORCH_DEVICE", "cuda"))

    @property
    def pi(self) -> float:
        return REFERENCE_PI if self.reference_truncated_pi else math.pi


#: Process-global configuration instance. Mutate fields directly
#: (e.g. ``config.device = "cpu"``) or via CLI flags.
config = Config()
