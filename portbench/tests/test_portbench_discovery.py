"""BENCHMARK.json against the contract's mechanical rules, and the
harness's discovery of every file a cell names by name."""

import json
import re
import shutil

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]


def test_entries_names_and_lines():
    for kind, entries in (("config", BENCH["configs"]),
                          ("workload", BENCH["workloads"]),
                          ("end_to_end", BENCH["end_to_end"]),
                          ("per_layer", BENCH["per_layer"])):
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), kind
        for e in entries:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") \
                else set()
            assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup


@pytest.mark.parametrize("workload", CELLS)
def test_cell_reports_enough(workload):
    cell = harness.load_cell(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], workload)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(workload)
    assert harness.load_module("systems", cell.config["system"]).Session
    ref = harness.load_module("reference", cell.config["name"])
    assert callable(ref.compare) and callable(ref.simulate)
    for m in cell.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_configs_state_their_cuts():
    for c in BENCH["configs"]:
        path = harness.ROOT / c["file"]
        assert path.is_relative_to(harness.ROOT / "portbench")
        doc = json.loads(path.read_text())
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert sorted(c["reduced"]) == sorted(doc["reduced"])
        for key in c["reduced"]:
            assert key in doc, key
        assert doc["guarantee"] and doc["assumed"]


def test_layers_are_one_line_each_spelled_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (harness.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_a_new_cell_is_data_only(tmp_path):
    """A cell added to a copy of BENCHMARK.json with a new mix file is
    found without touching any file that exists."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.PKG / "traffic", root / "portbench" / "traffic")
    shutil.copytree(harness.PKG / "configs", root / "portbench" / "configs")
    bench = dict(BENCH)
    mix = json.loads((harness.PKG / "traffic" / "zipf-closed.json")
                     .read_text())
    mix.update(name="zipf-closed-8", callers=8)
    (root / "portbench" / "traffic" / "zipf-closed-8.json").write_text(
        json.dumps(mix))
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "counter-zipf-8", "config": "sharded-counter-4m",
         "traffic": "zipf-closed-8", "chips": 1, "why": "eight callers"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("counter-zipf-8", root)
    assert cell.traffic["callers"] == 8
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    assert not cell.per_layer


def test_unknown_cell_and_mismatched_mix(tmp_path):
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")
    root = tmp_path / "checkout"
    shutil.copytree(harness.PKG / "traffic", root / "portbench" / "traffic")
    shutil.copytree(harness.PKG / "configs", root / "portbench" / "configs")
    bench = dict(BENCH)
    bench["workloads"] = [{"name": "bad", "config": "savina-thread-ring",
                           "traffic": "zipf-closed", "chips": 1,
                           "why": "a ring under asks"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError):
        harness.load_cell("bad", root)
