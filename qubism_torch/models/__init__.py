"""Circuit families: prim streams for the compiled engine and OpenQASM text."""
