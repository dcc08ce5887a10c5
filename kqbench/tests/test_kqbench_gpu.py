"""On the card: a short run of every cell, from the command that
BENCHMARK.json names, is correct and prints the cell's metrics.

    python3 -m pytest kqbench/tests -m gpu
"""

import json
import subprocess
import sys

import pytest

from kqbench import spec

BENCH = spec.load()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable if w == "python3" else w
           for w in BENCH["command"]]
    out = subprocess.run(cmd + ["--workload", cell, "--seed", "77",
                                "--seconds", "2", "--trace", str(trace)],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics(BENCH, kind, cell)}
    assert set(r["metrics"]) == want
    assert r["device"]["platform"] == "gpu"
    if trace:
        assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
