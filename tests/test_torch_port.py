"""PyTorch port: package boundaries and device selection."""

import contextlib
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

_IMPORT_ALL = """
import importlib, pkgutil, sys
before = set(sys.modules)
import kreeq_tpu_torch
for m in pkgutil.walk_packages(kreeq_tpu_torch.__path__, "kreeq_tpu_torch."):
    importlib.import_module(m.name)
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib",
                                                    "kreeq_tpu"))
print(len([m for m in new if m.startswith("kreeq_tpu_torch.")]), bad)
"""


def test_port_imports_no_jax():
    """Every module of the port imports without jax or kreeq_tpu."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.split(" ", 1)
    assert int(count) >= 15
    assert bad.strip() == "[]"


def test_no_cuda_and_no_platform_raises(monkeypatch):
    """Without a CUDA device the port stops instead of running on the
    CPU unasked."""
    from kreeq_tpu_torch import device as D
    from kreeq_tpu_torch.cli.main import run

    monkeypatch.delenv("KREEQ_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(D.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(["kreeq", "validate", "-r", __file__])
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    assert D.resolve_device() == torch.device("cpu")
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="not a platform"):
        D.resolve_device()


def _small_inputs(tmp_path):
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), 600))
    rp = tmp_path / "reads.fq"
    rp.write_text("".join(f"@r{i}\n{genome[s:s + 100]}\n+\n{'I' * 100}\n"
                          for i, s in enumerate(range(0, 500, 20))))
    ap = tmp_path / "asm.fa"
    ap.write_text(f">a\n{genome[:300]}\n")
    return str(rp), str(ap)


def _run_cpu(monkeypatch, argv):
    from kreeq_tpu_torch.cli.main import run

    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run(["kreeq", *argv]) == 0
    return buf.getvalue()


def test_trace_dir_writes_trace(tmp_path, monkeypatch):
    """--trace-dir: a torch.profiler chrome trace of the run."""
    rp, ap = _small_inputs(tmp_path)
    trace = tmp_path / "trace"
    out = _run_cpu(monkeypatch, ["validate", "-r", rp, "-f", ap,
                                 "--trace-dir", str(trace)])
    assert "Kreeq" in out
    with open(trace / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_subgraph_runs(tmp_path, monkeypatch):
    """Subgraph mode runs in the port, from a DB the port wrote."""
    rp, ap = _small_inputs(tmp_path)
    db = str(tmp_path / "reads.kreeq")
    _run_cpu(monkeypatch, ["validate", "-r", rp, "-o", db])
    out = _run_cpu(monkeypatch, ["subgraph", "-d", db, "-f", ap])
    assert out.startswith("Subgraph summary statistics:\n")
    assert "# segments: " in out and "DBG Summary statistics:" in out


def test_wrappers_refuse_other_devices():
    from kreeq_tpu_torch.ops.kernels import count_runs_cuda

    keys = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        count_runs_cuda(keys, torch.zeros(4, dtype=torch.uint8,
                                          device="meta"))
