"""Every name the harness finds resolves from the files alone, and
``BENCHMARK.json`` keeps the contract's shape."""

import importlib.util
import json
import os
import re

import pytest

from benchmark.harness import cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = cell.load_json(cell.ROOT, "BENCHMARK.json")


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # 2 + 14 runs a cell, each run_seconds + 60 s, 2 × 90 s a cell, 1200 s spare, 24 cells
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _one_line(conf["source"]) and _one_line(conf["why"])
    assert conf["file"] == f"benchmark/configs/{conf['name']}.json"
    data = cell.load_json(cell.ROOT, conf["file"])
    assert all(NAME.match(k) and k in data for k in conf["reduced"])
    for d in ("families", "reference"):
        assert os.path.exists(os.path.join(cell.BENCH, d, data["family"] + ".py"))
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entry(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _one_line(w["why"])
    assert w["chips"] == 1
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = cell.load_json(cell.BENCH, "traffic", w["traffic"] + ".json")
    assert NAME.match(traffic["phase"]) and traffic["chunk"] > 0
    phase = _load(os.path.join(cell.BENCH, "phases", traffic["phase"] + ".py"))
    assert all(callable(getattr(phase, k)) for k in ("Loop", "calls", "reference_run", "numbers"))
    limits = cell.load_json(cell.BENCH, "limits", w["name"] + ".json")
    assert {"loss", "grad", "change", "replay"} <= set(limits) <= {
        "loss", "loss_first", "loss_pre", "grad", "grad_pre", "grad_median", "change",
        "change_median", "ema", "ema_median", "replay"}
    assert all(v >= 0 for v in limits.values()) and limits["replay"] == 0
    reports = cell.reported(BENCH, w["name"], False)
    names = {m["name"] for m in reports}
    assert "setup_s" in names and len(names) >= 2
    assert cell.reported(BENCH, w["name"], True), "every cell reports a per-layer metric"


def test_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def _load(path):
    spec = importlib.util.spec_from_file_location("m_" + os.path.basename(path)[:-3]
                                                  .replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_entry(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert callable(_load(os.path.join(cell.BENCH, "metrics", m["name"] + ".py")).read)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_entry(m):
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _one_line(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moves = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in m["workloads"]:
        assert w in cells and w in moves.get("workloads", [w])
    assert callable(_load(os.path.join(cell.BENCH, "metrics", m["name"] + ".py")).read)
