"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration, whose file
holds the genome, the reads and k, and a traffic, whose file
kqbench/traffic/<traffic>.json holds the set-up jobs, the job the
window repeats, what its comparison reads and how its rates count.  A
per-layer metric is read by kqbench/metrics/<metric>.py.  A new cell
or metric is new files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

KQBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(KQBENCH)


def load() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str):
    """(path, contents) of a configuration's file."""
    for c in bench["configs"]:
        if c["name"] == name:
            path = os.path.join(ROOT, c["file"])
            with open(path) as fh:
                return path, json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(os.path.join(KQBENCH, "traffic", name + ".json")) as fh:
        return json.load(fh)


def metrics(bench: dict, kind: str, cell_name: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """The `read(run)` of kqbench/metrics/<name>.py."""
    path = os.path.join(KQBENCH, "metrics", name + ".py")
    s = importlib.util.spec_from_file_location(
        "kqbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read
