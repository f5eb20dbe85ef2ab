"""The port's own spans and counters (``qubism_torch.utils.profiling``): the
spans a file opens under ``torch.profiler`` and how they nest, the counters
of a flush, the host/device copies (none on the CPU), nothing entered while
neither a profiler nor ``--verbose`` is on, and the ``--verbose`` line; the
exact density backend's spans and its counts of passes over rho on the
benchmark's noisy random circuit at 2 x 3."""

import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from qubism_torch.cli import eval_file  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim  # noqa: E402
from qubism_torch.ops import apply, fusion, kernels  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm  # noqa: E402
from qubism_torch.run.compiler import elaborate  # noqa: E402
from qubism_torch.run.interpreter import run_program  # noqa: E402
from qubism_torch.run.noisy import group_runs  # noqa: E402
from qubism_torch.utils import profiling  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from qbench.circuits import boixo, noisy_boixo  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
PATH = os.path.join(EXAMPLES, "traced.qasm")  # includes resolve to examples/qelib1.inc

#: a user gate, a cz (qelib1: h, cx, h) and a wide enough register for
#: several fused ops; the shots run the sampler
SOURCE = """OPENQASM 2.0;
include "qelib1.inc";
gate zz(t) a, b { cx a, b; rz(t) b; cx a, b; }
qreg q[10];
creg c[10];
h q;
cz q[0], q[1];
zz(0.3) q[2], q[3];
t q[4];
cx q[0], q[9];
u3(0.1, 0.2, 0.3) q[8];
"""
#: its prims: h is one U each; cz is h, cx, h; the user gate cx, rz (one
#: U), cx; t, cx and u3 one each
PRIMS = 10 + 3 + 3 + 1 + 1 + 1

#: each span of a file and the span it runs in
PARENT = {
    "qubism.parse": "qubism.program",
    "qubism.lex": "qubism.parse",
    "qubism.interp": "qubism.program",
    "qubism.flush": "qubism.interp",
    "qubism.fuse": "qubism.flush",
    "qubism.plan": "qubism.flush",
    "qubism.sample": "qubism.program",
}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(profiling, "VERBOSE", False)
    kernels.reset_launches()


def _run(shots=64):
    out = io.StringIO()
    assert eval_file(PATH, source=SOURCE, seed=3, shots=shots, out=out) == 0
    return out.getvalue()


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("qubism.")]


def _parent(span, spans):
    """The innermost other span that holds ``span``."""
    name, s, e = span
    holders = [sp for sp in spans if sp is not span and sp[1] <= s and e <= sp[2]]
    return min(holders, key=lambda sp: sp[2] - sp[1])[0] if holders else None


def test_a_file_opens_every_span_nested_in_its_caller():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert "Done." in _run()
    spans = _spans(prof)
    names = {name for name, _, _ in spans}
    assert names == {"qubism.program", *PARENT}
    (program,) = [sp for sp in spans if sp[0] == "qubism.program"]
    for sp in spans:
        if sp is not program:
            assert _parent(sp, spans) == PARENT[sp[0]], sp[0]
            assert program[1] <= sp[1] and sp[2] <= program[2]
    # qelib1.inc is lexed inside the parse as well as the file
    assert sum(name == "qubism.lex" for name, _, _ in spans) == 2
    assert sum(name == "qubism.plan" for name, _, _ in spans) == profiling.counters["fused_ops"]


def _random_flush():
    rng = np.random.default_rng(5)
    prims = []
    for q in (0, 3, 5, 8, 2, 7):
        a, b = rng.normal(size=2)
        prims.append(Prim(np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]) *
                          np.exp(1j * b), (q,)))
    prims.append(Prim(np.diag([1, 1, 1, -1]).astype(complex), (1, 4)))
    prims.append(Prim(np.eye(4)[[0, 1, 3, 2]].astype(complex), (6, 2)))
    prims.append(Prim(np.array([1, np.exp(0.4j)]), (5,), True))
    return 9, prims


def _boixo_flush():
    """The benchmark's random circuit at 2 x 5, whose plan is layered."""
    cfg = {"lattice": [2, 5], "num_qubits": 10, "cz_depth": 12}
    text = boixo.text(cfg, boixo.draw(cfg, 4))
    n, events, *_ = elaborate(parse_openqasm(os.path.join(ROOT, "qbench", "program.qasm"), text))
    return n, list(events[0].prims)


def _chain_flush():
    """A chain of cx after an h, each followed by a rotation: no layer
    holds two of its gates, so the greedy plan is kept."""
    n, prims = 9, [Prim(np.array([[1, 1], [1, -1]]) / np.sqrt(2), (0,))]
    for q in range(n - 1):
        prims.append(Prim(np.eye(4)[[0, 1, 3, 2]].astype(complex), (q, q + 1)))
        prims.append(Prim(np.array([[np.cos(q), -np.sin(q)], [np.sin(q), np.cos(q)]]), (q,)))
    return n, prims


@pytest.mark.parametrize("flush,plan", [
    (_random_flush, {"sched_layered": 1}),
    (_boixo_flush, {"sched_layered": 1, "diag_runs": 26}),
    (_chain_flush, {"sched_greedy": 1}),
])
def test_counters_of_a_flush_are_its_prims_and_fused_ops(flush, plan):
    n, prims = flush()
    ops = fusion.fuse_scheduled(prims, n, fusion.MAX_BLOCK)
    assert profiling.counters == plan
    kernels.reset_launches()
    state = apply.zero_state(n)
    fusion.apply_prims_fused(state, prims, n)
    assert profiling.counters == {"prims": len(prims), "fused_ops": len(ops), **plan}
    assert 1 < len(ops) < len(prims)


def test_the_interpreter_counts_the_prims_qelib1_expands():
    run_program(parse_openqasm(PATH, SOURCE), seed=0)
    assert profiling.counters["prims"] == PRIMS
    assert 1 <= profiling.counters["fused_ops"] < profiling.counters["prims"]


def test_no_sync_on_the_cpu():
    _run()
    assert profiling.counters.get("syncs", 0) == 0
    a = np.arange(4, dtype=np.complex64)
    t = apply.to_device(a, torch.device("cpu"))
    assert t.data_ptr() == a.ctypes.data and apply.to_host(t) is not None
    assert "syncs" not in profiling.counters


def test_a_copy_off_the_cpu_counts_one_sync_in_its_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = apply.to_device(np.ones(3, dtype=np.complex64), "meta")
    assert t.device.type == "meta" and tuple(t.shape) == (3,)
    assert profiling.counters == {"syncs": 1}
    assert [name for name, _, _ in _spans(prof)] == ["qubism.sync"]


def test_nothing_is_entered_without_a_profiler_or_verbose(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not profiling.profiler_on()
    assert profiling.span("qubism.program") is profiling.span("qubism.fuse")
    assert "Done." in _run()
    assert profiling.span_s == {}


def test_reset_launches_clears_the_counters():
    _run()
    assert profiling.counters["prims"] > 0
    kernels.reset_launches()
    assert profiling.counters == {} and all(v == 0 for v in kernels.launches.values())


def test_verbose_prints_one_line_a_program(monkeypatch, capsys):
    monkeypatch.setattr(profiling, "VERBOSE", True)
    _run()
    _run(shots=None)
    lines = [ln for ln in capsys.readouterr().err.splitlines() if "program: host ms" in ln]
    assert len(lines) == 2
    for name in ("qubism.program", *PARENT):
        assert f"{name} " in lines[0]
    assert "qubism.sample" not in lines[1]
    ops = profiling.counters["fused_ops"] // 2
    assert lines[0].endswith(f"syncs 0, prims {PRIMS}, fused_ops {ops}, sched_greedy 1")
    assert profiling.span_s == {}


def test_verbose_spans_also_reach_a_running_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "VERBOSE", True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run()
    assert {name for name, _, _ in _spans(prof)} == {"qubism.program", *PARENT}


#: the noisy random circuit of the benchmark's density cell at 2 x 3
NOISY = {"lattice": [2, 3], "qubits": 6, "num_qubits": 12, "cz_depth": 8,
         "noise": "depolarizing:0.0016,dep2:0.0062"}
#: each span of a density run and the span it runs in; the shots' readout
#: runs after the run, in the program. Every gate of these texts is on at
#: most two qubits, so each run of gates and channels is one composed pass
#: (``qubism.density.unitary``) and no ``qubism.density.channel`` opens
DENSITY_PARENT = {
    "qubism.parse": "qubism.program",
    "qubism.lex": "qubism.parse",
    "qubism.density": "qubism.program",
    "qubism.density.unitary": "qubism.density",
    "qubism.density.readout": "qubism.program",
}


def _run_density(source, shots=64):
    out = io.StringIO()
    path = os.path.join(ROOT, "qbench", "program.qasm")  # includes qbench/qelib1.inc
    assert eval_file(path, source=source, seed=3, shots=shots, out=out, backend="density",
                     noise=NOISY["noise"]) == 0, out.getvalue()
    return out.getvalue()


def test_density_spans_nest_and_count_every_pass_over_rho():
    p = noisy_boixo.draw(NOISY, 7)
    names = [g for ops in boixo.moments(NOISY, p) for g, *_ in ops]
    cz, single = names.count("cz"), len(names) - names.count("cz")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert "Done." in _run_density(noisy_boixo.text(NOISY, p))
    spans = _spans(prof)
    assert {name for name, _, _ in spans} == {"qubism.program", *DENSITY_PARENT}
    outer = [sp for sp in spans if sp[0] == "qubism.density.readout"
             and _parent(sp, spans) != "qubism.density.readout"]
    assert len(outer) == 1  # the shots read the diagonal once, after the run
    for sp in spans:
        if sp[0] != "qubism.program" and sp not in outer and sp[0] == "qubism.density.readout":
            assert _parent(sp, spans) == "qubism.density.readout"
        elif sp[0] != "qubism.program":
            assert _parent(sp, spans) == DENSITY_PARENT[sp[0]], sp[0]
    # the elaborated gates (a U each, a cz h, cx, h) fall into runs on at
    # most two qubits, one a cz's cx, each with its channels one pass and
    # one span; the pass-by-pass route (3 passes a noisy U, 11 a cz) is not
    # taken
    runs = len(group_runs([t for _, t in noisy_boixo.elaborated(NOISY, p)]))
    assert runs == cz
    c = profiling.counters
    assert c["rho_fused_passes"] == runs
    assert c["rho_fused_prims"] == single + 3 * cz
    assert c.get("rho_unitary_passes", 0) + c.get("rho_channel_passes", 0) == 0
    assert sum(name == "qubism.density.unitary" for name, _, _ in spans) == runs
    assert sum(name == "qubism.density.channel" for name, _, _ in spans) == 0


def test_a_measurement_reads_rho_inside_the_run():
    source = ('OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[2];\ncreg c[2];\n'
              "h q[0];\ncx q[0], q[1];\nmeasure q[0] -> c[0];\n")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_density(source, shots=None)
    spans = _spans(prof)
    reads = [sp for sp in spans if sp[0] == "qubism.density.readout"]
    assert reads and all(_parent(sp, spans) in ("qubism.density", "qubism.density.readout")
                         for sp in reads)
    # h and cx on q[0], q[1] with their channels (one on h's qubit, two and
    # dep2 on cx's): one composed pass, before the measurement ends the run.
    # The projection's two diagonal passes are no gate's
    c = profiling.counters
    assert (c["rho_fused_passes"], c["rho_fused_prims"]) == (1, 2)
    assert c.get("rho_unitary_passes", 0) + c.get("rho_channel_passes", 0) == 0


def test_verbose_line_of_a_density_program(monkeypatch, capsys):
    monkeypatch.setattr(profiling, "VERBOSE", True)
    p = noisy_boixo.draw(NOISY, 7)
    _run_density(noisy_boixo.text(NOISY, p))
    (line,) = [ln for ln in capsys.readouterr().err.splitlines() if "program: host ms" in ln]
    for name in ("qubism.program", *DENSITY_PARENT):
        assert f"{name} " in line
    runs = len(group_runs([t for _, t in noisy_boixo.elaborated(NOISY, p)]))
    prims = len(noisy_boixo.elaborated(NOISY, p))
    assert line.endswith(f"syncs 0, prims 0, fused_ops 0, rho_fused_passes {runs}, "
                         f"rho_fused_prims {prims}")
