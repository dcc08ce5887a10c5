"""PyTorch port, the entry points (kreeq_tpu_torch/entry.py)
against __graft_entry__.py's on the CPU: entry()'s four numbers, the
dry run's totals on 2 and 3 gloo ranks against JAX's full_pipeline_fn
on meshes of as many of its virtual devices, and the sharded CLI over
a generated golden corpus (chip_smoke.write_corpus; DBs and goldens
written by the JAX CLI) on 2 ranks, exact."""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("KREEQ_TPU_FORCE_SHARDED", raising=False)


def test_entry_matches_jax():
    """The flagship step's (n, #valid, #missing, #edge-missing) on the
    JAX entry's seeded chunks."""
    import __graft_entry__

    from kreeq_tpu_torch.entry import entry

    fn, args = entry()
    assert all(a.device.type == "cpu" and a.dtype == torch.uint8
               for a in args)
    got = [int(x) for x in fn(*args)]
    jfn, jargs = __graft_entry__.entry()
    for a, j in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(j))
    assert got == [int(x) for x in jfn(*jargs)]
    assert got[0] > 0 and got[1] == len(args[1]) - 21 + 1


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip_matches_jax(n):
    """dryrun_multichip(n)'s totals, from n launched gloo ranks, equal
    those of JAX's full_pipeline_fn on the JAX dry run's layout, which
    dryrun_layout reproduces byte for byte."""
    import jax
    import jax.numpy as jnp

    from kreeq_tpu.constants import seq_to_codes
    from kreeq_tpu.parallel.sharded import full_pipeline_fn, make_mesh
    from kreeq_tpu_torch.entry import dryrun_layout, dryrun_multichip

    # the layout of __graft_entry__.dryrun_multichip, :86-95
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=64 * n + 128))
    reads = np.full((n, 128), 4, np.uint8)
    asm = np.full((n, 128), 4, np.uint8)
    for d in range(n):
        r = genome[d * 64:d * 64 + 120]
        a = genome[d * 64 + 7:d * 64 + 119]
        reads[d, :len(r)] = seq_to_codes(r)
        asm[d, :len(a)] = seq_to_codes(a)
        mine = dryrun_layout(n, d)
        assert np.array_equal(mine[0], reads[d])
        assert np.array_equal(mine[1], asm[d])
    out = full_pipeline_fn(make_mesh(jax.devices()[:n]), 21)(
        jnp.asarray(reads), jnp.asarray(asm))
    want = [int(np.asarray(x)[0]) for x in out[2:5]]
    assert int(np.asarray(out[5])[0]) == 0
    res = dryrun_multichip(n)
    assert res["ranks"] == n and len(res["per_rank"]) == n
    assert res["sums"] == want
    assert all(r["sums"] == want for r in res["per_rank"])
    assert want[0] > 0 and want[1] == 0


def test_entry_main_prints():
    """`python -m kreeq_tpu_torch.entry` prints the step's numbers and
    `dryrun_multichip OK`, as the JAX module's __main__ does."""
    res = subprocess.run([sys.executable, "-m", "kreeq_tpu_torch.entry"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("entry: [array(")
    assert lines[-1] == "dryrun_multichip OK"


def _quiet(run):
    def cli(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            assert run(argv) == 0
    return cli


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A golden corpus: inputs and DBs from chip_smoke.write_corpus, the
    goldens of the JAX generator."""
    import chip_smoke
    from kreeq_tpu.cli import generate_tests
    from kreeq_tpu.cli.main import run

    root = str(tmp_path_factory.mktemp("corpus") / "c")
    chip_smoke.write_corpus(root, 7, _quiet(run))
    cwd, stdin = os.getcwd(), sys.stdin
    os.chdir(root)
    sys.stdin = io.StringIO("Y\n")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            generate_tests.main()
    finally:
        os.chdir(cwd)
        sys.stdin = stdin
    return root


def test_golden_picks_one_of_each_mode(corpus):
    from kreeq_tpu_torch.entry import golden_picks

    picks = [os.path.basename(p) for p in golden_picks(corpus)]
    assert picks == ["test.0.tst", "test.50.tst", "test.58.tst",
                     "test.65.tst"]
    with open(os.path.join(corpus, "validateFiles", picks[2])) as fh:
        assert "--traversal-algorithm traversal" in fh.readline()


def test_cli_golden_sharded_passes_and_catches_a_planted_line(corpus,
                                                              tmp_path):
    """The four .tst pass as 2 launched ranks under
    KREEQ_TPU_FORCE_SHARDED=1 (union through merge_sharded on tables
    where a rank may own no row); a changed golden line fails; a root
    without a .tst of the four modes is an error."""
    from kreeq_tpu_torch.entry import cli_golden_sharded

    assert cli_golden_sharded(corpus, 2) == 4

    planted = tmp_path / "planted"
    (planted / "validateFiles").mkdir(parents=True)
    os.symlink(os.path.join(corpus, "testFiles"), planted / "testFiles")
    with open(os.path.join(corpus, "validateFiles", "test.50.tst")) as fh:
        lines = fh.read().split("\n")
    lines[3] = lines[3] + "1"
    (planted / "validateFiles" / "test.50.tst").write_text("\n".join(lines))
    with pytest.raises(AssertionError, match="test.50.tst at line 1"):
        cli_golden_sharded(str(planted), 2)

    empty = tmp_path / "empty"
    (empty / "validateFiles").mkdir(parents=True)
    shutil.copy(os.path.join(corpus, "validateFiles", "test.63.tst"),
                empty / "validateFiles")
    with pytest.raises(ValueError, match="no .tst of the modes"):
        cli_golden_sharded(str(empty), 2)
