"""Circuit families as OpenQASM text."""
