"""BENCHMARK.json against the benchmark's contract: names, units,
keys, and the files its entries name."""

import json
import os
import re

import pytest

from kqbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = spec.load()


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    with open(os.path.join(spec.ROOT, "BENCHMARK.json"), "rb") as fh:
        assert len(fh.read()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(text_ok(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert os.path.isdir(os.path.join(spec.ROOT, p))


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["why"])
        assert text_ok(c["source"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("kqbench/") and os.path.isfile(
            os.path.join(spec.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert text_ok(w["why"])
        assert os.path.isfile(os.path.join(spec.KQBENCH, "traffic",
                                           w["traffic"] + ".json"))
        cells.add(w["name"])
    assert len(cells) == len(BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert text_ok(m["layer"]) and m["moves"] in e2e
        # the metric it moves is reported in each of its cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        assert os.path.isfile(os.path.join(spec.KQBENCH, "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in spec.metrics(BENCH, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics(BENCH, "per_layer", cell)
    w = spec.cell(BENCH, cell)
    traffic = spec.traffic(w["traffic"])
    for m in e2e:
        assert m in ("setup_s", "peak_device_gib") or m in traffic["rates"]
    _path, cfg = spec.config(BENCH, w["config"])
    assert cfg["generator"] == "genome_reads"
    for m in spec.metrics(BENCH, "per_layer", cell):
        assert callable(spec.reader(m["name"]))


def test_files_under_paths_are_named_from_name_characters():
    for root, dirs, files in os.walk(spec.KQBENCH):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), spec.ROOT)
            assert PATH.match(rel), rel


def test_traffic_files_are_data():
    for name in os.listdir(os.path.join(spec.KQBENCH, "traffic")):
        assert name.endswith(".json")
        with open(os.path.join(spec.KQBENCH, "traffic", name)) as fh:
            t = json.load(fh)
        assert {"setup", "job", "stdout", "files", "rates"} <= set(t)
