"""The import guard: the reference and the generator load nothing of
JAX, of the JAX package or of the program; a run that finds JAX or
the JAX package loaded fails."""

import subprocess
import sys

import pytest

from kqbench import run, spec

PROBE = """
import sys
import kqbench.reference, kqbench.reference.kmers, kqbench.reference.validate
import kqbench.gen, kqbench.gen.genome_reads, kqbench.compare, kqbench.bounds
import kqbench.kinds, kqbench.kinds.bkwig
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_reference_imports_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    top = set(eval(out.stdout))
    assert not top & {"jax", "jaxlib", "flax", "kreeq_tpu",
                      "kreeq_tpu_torch", "torch"}


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kreeq_tpu_torch_extra", sys)
    assert "kreeq_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kreeq_tpu.core", sys)
    assert run.forbidden_modules() == {"kreeq_tpu"}


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax"])
def test_each_forbidden_name(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == {name.split(".")[0]}


def test_no_card_no_result():
    """Without a CUDA card the run prints nothing and exits 2."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cell = spec.load()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "-m", "kqbench.run", "--workload", cell, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
        capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""
