"""``BENCHMARK.json`` against the rules a benchmark file is held to before
any run: keys, names, units, lengths, files, and what every cell reports."""

import json
import re

import pytest

from qbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used and c["file"].startswith(tuple(bench["paths"]))
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert (harness.ROOT / "qbench" / "circuits" / f"{cfg['family']}.py").is_file()


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        cell = harness.load_cell(w["name"])
        assert (harness.ROOT / "qbench" / "entries" / f"{cell.spec['entry']}.py").is_file()
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_metrics(bench):
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in e2e)
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {x["name"] for x in e2e} and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (harness.ROOT / "qbench" / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
