"""qbench: the benchmark of ``qubism_torch`` on one NVIDIA H100.

``python -m qbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. The cells,
configurations, entries, circuit families and metric readers are files of
their own under this folder, found by the names ``BENCHMARK.json`` gives.
"""
