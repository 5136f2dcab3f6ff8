"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, and every file a cell is found by."""
import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
DOC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(DOC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in DOC["paths"])
    assert 1 <= len(DOC["command"]) <= 32 and all(line(w) for w in DOC["command"])
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs():
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(DOC["paths"][0] + "/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == c["name"]


def test_cells():
    names = {c["name"] for c in DOC["configs"]}
    seen = set()
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert os.path.isfile(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(BENCH, "limits", w["name"] + ".json"))
    assert {w["config"] for w in DOC["workloads"]} == names
    assert sum(w["chips"] == 4 for w in DOC["workloads"]) <= max(1, len(DOC["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in DOC["workloads"]}
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    reported = {c: {n for n, m in e2e.items() if c in m.get("workloads", cells)} for c in cells}
    layers = {}
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        assert all(c in cells and m["moves"] in reported[c] for c in m["workloads"])
        assert any(os.path.isfile(os.path.join(BENCH, "metrics", n + ".py"))
                   for n in (m["name"], m["name"].split(".")[0]))
        for c in m["workloads"]:
            layers.setdefault(c, set()).add(m["name"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in cells:
        assert "setup_s" in reported[c] and len(reported[c]) >= 2 and layers.get(c)
    allm = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert len(allm) == len(set(allm))


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("rel", ["traffic", "kernels", "limits", "configs"])
def test_data_files_parse(rel):
    d = os.path.join(BENCH, rel)
    for f in os.listdir(d):
        assert f.endswith(".json") and NAME.match(f[:-5].replace("/", ""))
        json.load(open(os.path.join(d, f)))
