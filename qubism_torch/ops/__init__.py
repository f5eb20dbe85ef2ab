"""State-vector engine: appliers, kernels, fusion, measurement, sampling."""
