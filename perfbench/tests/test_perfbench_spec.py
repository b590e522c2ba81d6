"""BENCHMARK.json, its configuration, traffic and limits files, and its metric
readers: present, well formed and consistent with each other."""

from __future__ import annotations

import ast
import json
import re

import pytest

from perfbench.tests.scaled import CHECKOUT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_DIR = CHECKOUT / "perfbench"


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    for e in bench[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_configs(bench):
    from perfbench.program import model_config

    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        path = CHECKOUT / c["file"]
        assert path.parent == BENCH_DIR / "configs" and path.stem == c["name"]
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        model_config(cfg["model"])          # round-trips through the program's dataclass
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_workloads_report_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH_DIR / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v > 0 for v in limits.values())
        reported = [m["name"] for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in bench["per_layer"])


def test_per_layer_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moves = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in moves.get("workloads", cells), (m["name"], w)
        reader = BENCH_DIR / "metrics" / f"{m['name']}.py"
        tree = ast.parse(reader.read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body)
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_traffic_entries_exist(bench):
    for w in bench["workloads"]:
        traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH_DIR / "entries" / f"{traffic['entry']}.py").is_file()

