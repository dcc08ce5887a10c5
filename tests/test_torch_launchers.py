"""PyTorch port, the launchers from a checkout (bin/kreeq-torch,
bin/kreeq-torch-decompressor, bin/kreeq-torch-validate): each runs in a
fresh interpreter, without an installed package, and imports neither
jax nor the JAX package; kreeq-torch runs `validate -r -f` on the CPU
with the stdout of the port's CLI called in-process."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a launcher run under runpy, then the names of the jax and JAX-package
# modules it imported, on the last line
RUNNER = """\
import runpy, sys
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    if e.code not in (None, 0):
        raise
sys.stdout.flush()
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kreeq_tpu")))
"""


def _launch(name: str, args, cwd) -> list:
    """stdout lines of bin/<name> with `args` in a fresh interpreter,
    from `cwd`, with the CPU as the port's device; the last line is the
    list of jax modules imported."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["KREEQ_TPU_PLATFORM"] = "cpu"
    res = subprocess.run([sys.executable, "-c", RUNNER,
                          os.path.join(ROOT, "bin", name), *args],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout.splitlines()


@pytest.mark.parametrize("name,module,usage", [
    ("kreeq-torch", "main", "kreeq [mode] -h"),
    ("kreeq-torch-decompressor", "decompressor", "decompressor [mode]"),
    ("kreeq-torch-validate", "validate_runner", "kreeq-validate <path"),
])
def test_launcher_runs_without_jax(tmp_path, name, module, usage):
    """Each launcher is the five-line wrapper of the port's `main`: with
    no arguments it prints its usage, and no jax module is imported."""
    with open(os.path.join(ROOT, "bin", name)) as fh:
        text = fh.read()
    assert f"from kreeq_tpu_torch.cli.{module} import main" in text
    assert os.access(os.path.join(ROOT, "bin", name), os.X_OK)
    lines = _launch(name, [], tmp_path)
    assert lines[0].startswith(usage)
    assert lines[-1] == "[]"


def test_launcher_validates_like_the_cli(tmp_path, monkeypatch):
    """bin/kreeq-torch validate -r -f from another directory: the QV
    table of the port's CLI run in this process, and no jax imported."""
    from kreeq_tpu_torch.cli.main import run

    rng = np.random.default_rng(3)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 600))
    (tmp_path / "asm.fa").write_text(f">a\n{genome}\n")
    (tmp_path / "reads.fa").write_text("".join(
        f">r{i}\n{genome[s:s + 80]}\n"
        for i, s in enumerate(rng.integers(0, 520, 90))))
    argv = ["validate", "-r", "reads.fa", "-f", "asm.fa", "-k", "11"]
    lines = _launch("kreeq-torch", argv, tmp_path)
    assert lines[-1] == "[]"
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with contextlib.redirect_stdout(buf):
            run(["kreeq", *argv])
    finally:
        os.chdir(cwd)
    assert lines[:-1] == buf.getvalue().splitlines()
    assert lines[-2].endswith("Kreeq")
