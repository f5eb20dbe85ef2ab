"""QAOA MaxCut value and gradient (``qbench/circuits/qaoa_maxcut.py``)
through the port's kernel adjoint engine against the benchmark's plain
adjoint reference (``qbench/reference/adjoint.py``), on seeded random
3-regular graphs on the CPU, where every kernel wrapper runs its plain
version: the reference against the parameter-shift rule, the
configuration's graph against its generator, the engine's spans and its
count of pair walks, and the harness's ``qaoa28.valgrad`` and
``rcs30.compile`` cells at small widths with their controls.

Also the pair reduction the engine's gradient walks go through
(``kernels.pair_sums``, whose plain version runs here), the walks planned
once per engine into one sums buffer, and the entry's refusal of an engine
that reads each walk back."""

import collections
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from qbench import control, harness  # noqa: E402
from qbench.circuits import qaoa_maxcut as fam  # noqa: E402
from qbench.reference import adjoint  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.models.adjoint_engine import plan_units  # noqa: E402
from qubism_torch.models.variational import (adjoint_value_and_grad_fn,  # noqa: E402
                                             maxcut_terms, qaoa_maxcut_ansatz)
from qubism_torch.ops import kernels  # noqa: E402
from qubism_torch.ops import measure as M  # noqa: E402
from qubism_torch.utils import profiling  # noqa: E402

SEED = 2**35 + 25
CPU = torch.device("cpu")

#: the configuration, cell and metrics of qaoa28.valgrad as BENCHMARK.json
#: lists them, and the accepted metrics that read it too
REGISTRATION = {
    "configs": [{"name": "qaoa28", "file": "qbench/configs/qaoa28.json", "reduced": [],
                 "source": "Farhi, Goldstone and Gutmann, arXiv:1411.4028 (2014)",
                 "why": "QAOA MaxCut value+grad through the kernel adjoint engine"}],
    "workloads": [{"name": "qaoa28.valgrad", "config": "qaoa28", "traffic": "valgrad",
                   "chips": 1, "why": "one value and gradient a program"}],
    "per_layer": [{"name": name, "unit": unit, "better": "lower", "source": source,
                   "layer": "adjoint", "moves": "program_ms", "workloads": ["qaoa28.valgrad"]}
                  for name, unit, source in (("contract_ms", "ms/program", "program_span"),
                                             ("walks_per_program", "walks/program",
                                              "program_counter"))],
    "also": ("passes_per_program", "kernels_roofline", "device_idle_pct", "syncs_per_program"),
}


@pytest.fixture(scope="module")
def qaoa_root():
    """The checkout's benchmark files, which list ``qaoa28.valgrad``."""
    return harness.ROOT


def test_benchmark_lists_the_cell_and_its_metrics():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        listed = {e["name"]: e for e in bench[key]}
        for want in REGISTRATION[key]:
            got = listed[want["name"]]
            for field in ("file", "reduced", "config", "traffic", "chips", "unit", "source",
                          "layer", "moves", "workloads"):
                if field in want and not (key == "configs" and field == "source"):
                    assert got[field] == want[field], (want["name"], field)
    assert (harness.ROOT / "qbench" / "cells" / "qaoa28.valgrad.json").is_file()
    for m in bench["per_layer"]:
        if m["name"] in REGISTRATION["also"]:
            assert m["workloads"][-1] == "qaoa28.valgrad", m["name"]


def _qaoa_cell(root, n, p):
    return harness.load_cell("qaoa28.valgrad", root=root, overrides=_overrides(n, p))


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setenv("QUBISM_TORCH_DEVICE", "cpu")
    kernels.reset_launches()


def _cfg(n, p, graph_seed=7):
    return {"num_qubits": n, "p_layers": p, "edges": fam.regular_graph(n, 3, graph_seed)}


def _engine(cfg, engine="kernels"):
    n, edges = cfg["num_qubits"], [tuple(e) for e in cfg["edges"]]
    return adjoint_value_and_grad_fn(qaoa_maxcut_ansatz(n, edges, cfg["p_layers"]),
                                     *maxcut_terms(n, edges), engine=engine)


def _theta(cfg, seed):
    return fam.draw(cfg, seed)["theta"]


def _is_3_regular(n, edges):
    degree = collections.Counter(v for e in edges for v in e)
    pairs = [tuple(e) for e in edges]
    return (all(a < b for a, b in pairs) and len(set(pairs)) == len(pairs)
            and set(degree) == set(range(n)) and set(degree.values()) == {3})


def test_configuration_graph_is_its_generator():
    cfg = json.loads((ROOT / "qbench" / "configs" / "qaoa28.json").read_text())
    assert cfg["family"] == "qaoa_maxcut" and (cfg["num_qubits"], cfg["p_layers"]) == (28, 3)
    edges = fam.regular_graph(cfg["num_qubits"], cfg["degree"], cfg["graph"]["seed"])
    assert edges == cfg["edges"] and len(edges) == 42
    assert _is_3_regular(28, edges)


@pytest.mark.parametrize("n, seed", [(8, 1), (10, 2), (28, 3)])
def test_pairing_model_draws_simple_3_regular_graphs(n, seed):
    edges = fam.regular_graph(n, 3, seed)
    assert len(edges) == 3 * n // 2 and _is_3_regular(n, edges)
    assert fam.regular_graph(n, 3, seed) == edges != fam.regular_graph(n, 3, seed + 1)


@pytest.mark.parametrize("n, p", [(8, 1), (8, 3), (10, 1), (10, 3)])
def test_kernel_engine_matches_the_plain_adjoint_reference(n, p):
    cfg = _cfg(n, p)
    vg = _engine(cfg)
    assert vg._engine == "kernels"
    for seed in (SEED, SEED + 1):
        theta = _theta(cfg, seed)
        value, grad = vg(torch.tensor(theta, dtype=torch.float32))
        want = fam.numbers(cfg, {"theta": theta}, CPU)
        scale = max(1.0, float(np.abs(want["value"]).max()), float(np.abs(want["grad"]).max()))
        assert abs(float(value) - want["value"][0]) < 1e-5 * scale
        np.testing.assert_allclose(grad.numpy(), want["grad"], rtol=0, atol=1e-5 * scale)


def _shift_rule(cfg, theta):
    """Value and gradient by the parameter-shift rule, gate by gate (each
    gate is exp(-i t P) with P^2 = 1: d<E>/dt = <E>(t + pi/4) - <E>(t -
    pi/4)), over the reference's own complex128 forward sweep."""
    n = cfg["num_qubits"]
    zterms, constant = fam.terms(cfg)

    def value(shift=None):
        phi = adjoint.forward(n, fam.circuit(cfg, theta, shift), CPU)
        return constant + adjoint._vdot(phi, adjoint.observable(phi, zterms, n)).real

    owners = [gen[0] for *_, gen in fam.circuit(cfg, theta) if gen is not None]
    grad = np.zeros(len(theta))
    for k, j in enumerate(owners):
        grad[j] += value((k, math.pi / 4)) - value((k, -math.pi / 4))
    return value(), grad


def _toy():
    spec = importlib.util.spec_from_file_location(
        "qaoa_toy", ROOT / "qbench" / "tests" / "toys" / "qaoa_maxcut.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("p", [1, 2])
def test_reference_matches_the_parameter_shift_rule(p):
    cfg = _cfg(6, p, graph_seed=11)
    for seed in (SEED, SEED + 2):
        theta = _theta(cfg, seed)
        want = fam.numbers(cfg, {"theta": theta}, CPU)
        value, grad = _shift_rule(cfg, theta)
        assert abs(value - want["value"][0]) < 1e-9
        np.testing.assert_allclose(want["grad"], grad, rtol=0, atol=1e-9)
        # and the toy's own rule over the float32 state-vector reference
        toy = _toy().numbers(cfg, {"theta": theta}, CPU)
        np.testing.assert_allclose(toy["value"], want["value"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(toy["grad"], want["grad"], rtol=0, atol=2e-5)


def _spans(prof):
    return sorted((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name.startswith("qubism.adjoint"))


def test_pair_walks_and_spans_of_a_call():
    n, p = 10, 3
    cfg = _cfg(n, p)
    vg = _engine(cfg)
    theta = torch.tensor(_theta(cfg, SEED), dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vg(theta)
        vg(theta)
    # a walk for each cost layer (one flip mask) and each qubit of a mixer
    assert profiling.counters["pair_walks"] == 2 * p * (n + 1)
    spans = _spans(prof)
    calls = [(s, e) for name, s, e in spans if name == "qubism.adjoint"]
    assert len(calls) == 2
    count = collections.Counter(name for name, _, _ in spans)
    units = len(plan_units(qaoa_maxcut_ansatz(n, [tuple(e) for e in cfg["edges"]], p).ops, n))
    assert count == {"qubism.adjoint": 2, "qubism.adjoint.head": 2,
                     "qubism.adjoint.contract": 2 * 2 * p,
                     "qubism.adjoint.sweep": 2 * 3 * units}
    for name, s, e in spans:
        if name != "qubism.adjoint":
            assert any(cs <= s and e <= ce for cs, ce in calls), name


@pytest.mark.parametrize("flip, copies", [(0, 4), (1 << 3, 5)])
def test_a_walk_copies_through_the_counted_routes(monkeypatch, flip, copies):
    """A walk's sign tables and gather index go up and its sums come back
    by ``ops.apply.to_device`` / ``to_host``, which count ``syncs`` and
    open ``qubism.sync`` off the CPU."""
    seen = []
    for name in ("to_device", "to_host"):
        real = getattr(M, name)
        monkeypatch.setattr(M, name, lambda *a, _real=real, _name=name:
                            seen.append(_name) or _real(*a))
    n = 8
    rng = np.random.default_rng(3)
    a = torch.from_numpy((rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n))
                         .astype(np.complex64))
    b = torch.from_numpy(np.roll(a.numpy(), 5))
    sums = M.pauli_pair_sums(a, b, n, flip, [0b101, 0b11000])
    assert seen.count("to_device") == copies - 1 and seen.count("to_host") == 1
    idx = np.arange(1 << n)
    for z, got in zip([0b101, 0b11000], sums):
        sign = 1 - 2 * (np.vectorize(lambda x: bin(x).count("1"))(idx & z) & 1)
        want = np.sum(np.conj(b.numpy()[idx ^ flip]) * sign * a.numpy())
        assert abs(got - want) < 1e-4
    assert profiling.counters["pair_walks"] == 1


def _overrides(n, p):
    return {"num_qubits": n, "p_layers": p, "edges": fam.regular_graph(n, 3, 5)}


@pytest.mark.parametrize("n, p, trace", [(8, 3, False), (14, 1, True)])
def test_cell_correct_on_cpu(qaoa_root, n, p, trace):
    cell = _qaoa_cell(qaoa_root, n, p)
    r = harness.run_cell(cell, SEED, 0.5, trace, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"numbers_err"}
    assert r["checks"]["numbers_err"]["value"] < r["checks"]["numbers_err"]["limit"] / 10
    if trace:
        # n >= 14: "auto" takes the kernel engine, whose walks and spans
        # the new metrics read; kernel launches count CUDA kernels alone
        metrics = {k: v["value"] for k, v in r["metrics"].items()}
        assert metrics["walks_per_program"] == p * (n + 1)
        assert metrics["contract_ms"] > 0
        assert metrics["passes_per_program"] == metrics["syncs_per_program"] == 0
    else:
        assert {"setup_s", "program_ms"} <= set(r["metrics"])


def _altered(numbers, how):
    out = dict(numbers)
    if how == "grad_off":
        out["grad"] = out["grad"].copy()
        out["grad"][-1] += 1e-2
    elif how == "missing":
        del out["grad"]
    return out


@pytest.mark.parametrize("how", ["grad_off", "missing"])
def test_wrong_numbers_are_not_correct(qaoa_root, how):
    cell = _qaoa_cell(qaoa_root, 8, 3)
    mod = harness.plugin(qaoa_root, "entries", "valgrad")

    def make(ctx):
        entry = mod.make(ctx)
        run = entry.program

        def program(inputs):
            out = run(inputs)
            out.numbers = _altered(out.numbers, how)
            return out

        entry.program = program
        return entry

    cell.entry = SimpleNamespace(make=make)
    r = harness.run_cell(cell, SEED, 0.3, False, "cpu", time.perf_counter())
    assert not r["correct"], r["checks"]
    if how == "grad_off":
        assert r["failed"] == 0 and r["checks"]["numbers_err"]["value"] > 5e-4
    else:
        assert r["failed"] == r["attempted"] and r["checks"]["numbers_err"]["value"] is None


@pytest.mark.parametrize("seed", [11, 2**40 + 7])
def test_cell_tf32_control_is_not_correct(qaoa_root, seed):
    r = control.run(_qaoa_cell(qaoa_root, 8, 3), seed, "tf32", "cpu")
    assert r["attempted"] == 1 and r["failed"] == 0
    assert not r["correct"], r["checks"]
    assert r["checks"]["numbers_err"]["value"] > 3 * r["checks"]["numbers_err"]["limit"]


def test_new_metrics_read_nothing_without_the_ports_spans(monkeypatch):
    """A port without the adjoint spans and counter (the parent of these
    metrics) gives no reading, and no error."""
    monkeypatch.setattr(profiling, "counters", {"syncs": 3})
    record = {"programs": 4, "cpu": [("qubism.sync", 0.0, 1.0)]}
    for name in ("contract_ms", "walks_per_program"):
        assert harness.plugin(harness.ROOT, "metrics", name).read(record) is None


RCS = {"lattice": [2, 3], "num_qubits": 6}


def test_rcs30_compile_cell_correct_on_cpu():
    cell = harness.load_cell("rcs30.compile", overrides=RCS)
    assert cell.spec["entry"] == "compile" and cell.spec["traffic"] == {"shots": 8192}
    r = harness.run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"state_err", "amps_err", "xeb_gap"}


@pytest.mark.parametrize("fault", ["tf32", "flipped_shots"])
def test_rcs30_compile_control_is_not_correct(fault):
    r = control.run(harness.load_cell("rcs30.compile", overrides=RCS), 2**33 + 1, fault, "cpu")
    assert r["attempted"] == 1 and not r["correct"], r["checks"]


def _pair(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(2, 1 << n)) + 1j * rng.normal(size=(2, 1 << n))
    return [torch.from_numpy(x.astype(np.complex64)) for x in v]


@pytest.mark.parametrize("flip, same", [(0, True), (0, False), (1 << 2, False), (0b1011, False)])
def test_pair_sums_adds_the_walk_into_its_buffer(flip, same):
    """``kernels.pair_sums`` (its plain version here) adds the walk's real
    and imaginary parts into ``out``; ``pauli_pair_sums(..., out=)`` does
    the same and returns nothing."""
    n = 7
    a, b = _pair(n, 5)
    b = a if same else b
    zs = [0, 0b11, 0b1000001, 0b0110100]
    want = M.pair_walk(a, b, n, flip, zs)
    out = torch.zeros(len(zs), 2, dtype=torch.float64)
    assert kernels.pair_sums(a, b, flip, zs, out, n) is out
    kernels.pair_sums(a, b, flip, zs, out, n)
    np.testing.assert_allclose(out.numpy(), 2 * want, rtol=1e-12, atol=0)
    out2 = torch.zeros(len(zs), 2, dtype=torch.float64)
    assert M.pauli_pair_sums(a, b, n, flip, zs, out=out2) is None
    np.testing.assert_array_equal(out2.numpy(), want)
    sums = M.pauli_pair_sums(a, b, n, flip, zs)
    np.testing.assert_array_equal(np.stack([sums.real, sums.imag], 1), want)
    if same:
        assert not want[:, 1].any()


@pytest.mark.parametrize("bad", ["shape", "dtype", "flip", "mask", "no_masks"])
def test_pair_sums_refuses_what_the_kernel_cannot_take(bad):
    n = 5
    a, b = _pair(n, 6)
    zs, flip = [1, 2], 3
    out = torch.zeros(2, 2, dtype=torch.float64)
    if bad == "shape":
        out = torch.zeros(3, 2, dtype=torch.float64)
    elif bad == "dtype":
        out = torch.zeros(2, 2, dtype=torch.float32)
    elif bad == "flip":
        flip = 1 << n
    elif bad == "mask":
        zs = [1, 1 << n]
    else:
        zs, out = [], torch.zeros(0, 2, dtype=torch.float64)
    with pytest.raises(ValueError):
        kernels.pair_sums(a, b, flip, zs, out, n)


def test_contraction_is_planned_once_into_one_buffer():
    """The walks of a QAOA engine: one a cost layer, one a qubit of a mixer
    layer, last unit first; their slots fill the buffer in order, one a
    generator term; and the buffer is zeroed between calls."""
    from qubism_torch.models import adjoint_engine as AE

    n, p = 8, 3
    cfg = _cfg(n, p)
    edges = [tuple(e) for e in cfg["edges"]]
    units = plan_units(qaoa_maxcut_ansatz(n, edges, p).ops, n)
    walks, slots = AE.contraction_plan(units, n)
    assert len(walks) == len(units) and sum(map(len, walks)) == p * (n + 1)
    assert len(slots) == p * (len(edges) + n)
    firsts = [first for unit in walks for _, _, first in unit]
    sizes = [len(zs) for unit in walks for _, zs, _ in unit]
    assert firsts == list(np.cumsum([0] + sizes[:-1]))
    assert sorted({pidx for pidx, _, _ in slots}) == list(range(2 * p))
    assert [len(u) for u in walks][:2] == [n, 1]  # the last mixer, then the last cost layer
    vg = _engine(cfg)
    assert vg._contract == "device"
    thetas = [torch.tensor(_theta(cfg, s), dtype=torch.float32) for s in (SEED, SEED + 3)]
    vg(thetas[0])
    again = vg(thetas[1])
    fresh = _engine(cfg)(thetas[1])
    for x, y in zip(again, fresh):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_entry_refuses_an_engine_that_reads_each_walk_back(monkeypatch):
    """On a card the entry's set-up fails for a kernel engine whose walks
    are not summed on the card (a traced run of it would not end in time)."""
    from qubism_torch.models import variational

    mod = harness.plugin(harness.ROOT, "entries", "valgrad")
    real = variational.adjoint_value_and_grad_fn

    def without_device_sums(*args, **kwargs):
        fn = real(*args, **{**kwargs, "engine": "kernels"})

        def vg(theta):
            return fn(theta)

        vg._engine = fn._engine
        return vg

    monkeypatch.setattr(variational, "adjoint_value_and_grad_fn", without_device_sums)
    cfg = _cfg(8, 1)
    ctx = SimpleNamespace(n=8, cfg=cfg, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="summed on the card"):
        mod.make(ctx)
    ctx.device = CPU
    assert mod.make(ctx).fn._engine == "kernels"
