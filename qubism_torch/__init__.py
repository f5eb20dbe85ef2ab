"""qubism-torch: the OpenQASM 2.0 simulator of qubism_tpu on PyTorch and CUDA.

The OpenQASM file path (``python -m qubism_torch file.qasm``) runs on one
NVIDIA Hopper GPU, with hand-written CUDA kernels for its four state-vector
passes (ops/kernels.py, csrc/). Importing the package imports torch and
numpy only; the kernels are built on first use.
"""

from .config import TOLERANCE, config  # noqa: F401

__version__ = "0.1.0"
