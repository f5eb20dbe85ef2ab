"""The readers of the port's spans and counters on synthetic records: self
times less the spans nested inside, per program; None without programs,
without the spans, or on a port that keeps no counters."""

import pytest

from qbench import harness

#: two programs: (name, start us, end us); program 2 has no sampler
CPU = [
    ("qubism.program", 0, 1000), ("qubism.parse", 10, 110), ("qubism.lex", 20, 60),
    ("qubism.interp", 120, 820), ("qubism.sync", 130, 140),
    ("qubism.flush", 300, 800), ("qubism.fuse", 310, 410),
    ("qubism.plan", 420, 520), ("qubism.sync", 430, 450),
    ("qubism.plan", 530, 600),
    ("qubism.sample", 850, 990), ("qubism.sync", 860, 870), ("qubism.sync", 980, 990),
    ("cudaStreamSynchronize", 862, 869),
    ("qubism.program", 2000, 2600), ("qubism.parse", 2010, 2050), ("qubism.lex", 2020, 2040),
    ("qubism.interp", 2100, 2500), ("qubism.flush", 2200, 2500),
    ("qubism.fuse", 2210, 2260), ("qubism.plan", 2300, 2400),
    ("qubism.sync", 2300, 2310), ("qubism.sync", 2390, 2400),
]


def read(name, cpu=CPU, programs=2):
    return harness.plugin(harness.ROOT, "metrics", name).read(
        {"cpu": list(cpu), "programs": programs})


@pytest.mark.parametrize("name, want_us", [
    ("lex_ms", 40 + 20),
    ("fuse_ms", 100 + 50),
    # interp less every port span inside it: a sync, then the flush
    ("interp_ms", (700 - 10 - 500) + (400 - 300)),
    ("plan_ms", (100 - 20) + 70 + (100 - 20)),
    ("sample_ms", 140 - 20),
])
def test_self_time_per_program(name, want_us):
    assert read(name) == pytest.approx(want_us / 1e3 / 2)


@pytest.mark.parametrize("name", ["lex_ms", "interp_ms", "fuse_ms", "plan_ms", "sample_ms"])
def test_no_programs_or_no_spans_read_none(name):
    assert read(name, programs=0) is None
    assert read(name, cpu=[("qbench.run", 0, 10)]) is None


def test_an_enclosing_span_is_not_subtracted():
    # the program span holds the interpreter's: only spans inside it count
    cpu = [("qubism.program", 0, 100), ("qubism.interp", 10, 90), ("qubism.plan", 95, 99)]
    assert read("interp_ms", cpu, programs=1) == pytest.approx(0.08)


def test_counters(monkeypatch):
    from qubism_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", {"prims": 60, "fused_ops": 8, "syncs": 30})
    assert read("prims_per_pass") == 7.5
    assert read("syncs_per_program") == 15
    assert read("syncs_per_program", programs=0) is None
    monkeypatch.setattr(profiling, "counters", {})
    assert read("prims_per_pass") is None
    assert read("syncs_per_program") == 0


def test_a_port_without_counters_reads_none(monkeypatch):
    from qubism_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert read("prims_per_pass") is None and read("syncs_per_program") is None


@pytest.mark.parametrize("cell", ["rcs30.file", "qft30.compiled"])
def test_traced_cpu_run_reads_the_new_metrics(cpu_device, cell):
    import time

    names = {"lex_ms", "interp_ms", "fuse_ms", "plan_ms", "prims_per_pass",
             "syncs_per_program", "sample_ms"}
    c = harness.load_cell(cell, overrides={"num_qubits": 8, "lattice": [2, 4]})
    r = harness.run_cell(c, 2**33 + 9, 0.2, True, "cpu", time.perf_counter())
    mine = {m["name"] for m in c.per_layer} & names
    assert mine and mine <= set(r["metrics"])
    assert r["metrics"]["syncs_per_program"]["value"] == 0
