"""PyTorch port, `kreeq subgraph` through the CLIs on the CPU: stdout and
the -o x.gfa|x.gfa2|x.gfa.gz files (after decompression) must be what
the JAX package's CLI prints and writes, for best-first and traversal,
--no-collapse, --no-reference with --search-depth, -c, -p spans and
`-o gfa` to stdout, at k = 21, 31 and 32; and the fatal paths must give
the JAX CLI's message and exit code."""

import contextlib
import gzip
import io

import pytest
import torch

from .test_torch_subgraph import _write_inputs

torch.set_num_threads(1)


def _stdout(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module", params=["21", "31", "32"])
def db(request, tmp_path_factory):
    """(DB, assembly, spans): the DB written once per k by the JAX CLI."""
    from kreeq_tpu.cli.main import run as jax_run

    tmp = tmp_path_factory.mktemp(f"subcli{request.param}")
    rp, ap, bp = _write_inputs(tmp)
    out = str(tmp / "reads.kreeq")
    _stdout(jax_run, ["kreeq", "validate", "-r", rp, "-k", request.param,
                      "-o", out])
    return out, ap, bp


@pytest.fixture
def both(monkeypatch):
    from kreeq_tpu.cli.main import run as jax_run
    from kreeq_tpu_torch.cli.main import run

    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    return jax_run, run


def _read_text(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return fh.read()


@pytest.mark.parametrize("ext,opts", [
    ("", []),
    ("gfa", []),
    ("gfa2", ["--traversal-algorithm", "traversal"]),
    ("gfa.gz", ["--no-collapse"]),
    ("gfa", ["--no-reference", "--search-depth", "3"]),
    ("gfa2", ["-c", "2"]),
    ("gfa.gz", ["-p", "SPANS"]),
    ("stdout", []),
])
def test_subgraph_matches_jax(tmp_path, db, both, ext, opts):
    """ext "" writes no file, "stdout" is `-o gfa`: the GFA on stdout
    after the two summaries, with no DB summary.  The port's job counts
    the seed nodes and the traversal's rounds or the best-first's
    boundary sources."""
    from kreeq_tpu_torch.utils import log

    path, ap, bp = db
    opts = [bp if o == "SPANS" else o for o in opts]
    outs = []
    for name, fn in zip(("jax", "port"), both):
        out = str(tmp_path / f"{name}.{ext}")
        argv = ["kreeq", "subgraph", "-d", path, "-f", ap, *opts]
        if ext == "stdout":
            argv += ["-o", "gfa"]
        elif ext:
            argv += ["-o", out]
        stdout = _stdout(fn, argv)
        outs.append((stdout, _read_text(out) if ext not in ("", "stdout")
                     else None))
    assert outs[1] == outs[0]
    rec = log.jobs[-1]  # the port's
    c = rec["counters"]
    assert c["subgraph.seed"] >= c["subgraph.blue"] > 0
    if "traversal" in opts:
        assert c["subgraph.rounds"] > 0 and c["subgraph.round_nodes"] > 0
        assert "kq.subgraph.search" not in rec["spans"]
    else:
        assert rec["spans"]["kq.subgraph.search"]["calls"] == 1
        assert c["subgraph.seed"] >= c["subgraph.sources"] > 0
        assert "subgraph.rounds" not in c
    stdout, gfa = outs[0]
    assert stdout.startswith("Subgraph summary statistics:")
    assert "+++Assembly summary+++" in stdout
    assert ("DBG Summary statistics:" in stdout) == (ext != "stdout")
    if ext == "stdout":
        gfa = stdout[stdout.index("H\t"):]
    if gfa is not None:
        segments = gfa.count("\nS\t")
        assert segments > 1
        assert f"# segments: {segments}" in stdout


@pytest.mark.parametrize("args,msg", [
    ([], "Need to provide one database (-d).\n"),
    (["-d", "DB", "DB"], "Need to provide one database (-d).\n"),
    (["-d", "DB", "--traversal-algorithm", "dfs"],
     "Cannot find input algorithm (dfs). Terminating.\n"),
])
def test_subgraph_fatal_paths_match_jax(db, both, capsys, args, msg):
    path, ap, _bp = db
    args = [path if a == "DB" else a for a in args]
    for fn in both:
        with pytest.raises(SystemExit) as exc:
            fn(["kreeq", "subgraph", *args, "-f", ap])
        assert exc.value.code == 1
        assert capsys.readouterr().err == msg
