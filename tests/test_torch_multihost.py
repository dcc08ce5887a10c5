"""PyTorch port, the multi-process launch: the port's CLI started as 2
processes with KREEQ_TPU_COORDINATOR, _NUM_PROCESSES and _PROCESS_ID on
the CPU (gloo) against the single-process JAX CLI, on 3 read files of
unequal size (tests/test_multihost.py's), so one rank gets a single
small file and the ranks count different numbers of chunks: rank 0
prints what the JAX CLI prints, byte for byte, rank 1 prints nothing,
and each output file is written once, by rank 0, equal to the JAX
CLI's; with forced table windows, under KREEQ_TPU_FORCE_SHARDED=1 in
`union`, and for a checkpointed build killed after its first part and
resumed."""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 2048  # bases per read chunk: ranks run 2 and 1 chunks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def inputs(tmp_path):
    """3 FASTA read files of 24, 6 and 2 reads (rank 1 gets the one of
    6), an assembly of 400 bases with an SNV pair 18 apart."""
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), size=1200))
    files = []
    for i, n_reads in enumerate((24, 6, 2)):
        p = tmp_path / f"reads{i}.fasta"
        with open(p, "w") as fh:
            for r in range(n_reads):
                s = int(rng.integers(0, 1050))
                fh.write(f">r{i}.{r}\n{genome[s:s + 150]}\n")
        files.append(str(p))
    asm = list(genome[100:500])
    for j in (200, 218):
        asm[j] = "ACGT"[("ACGT".index(asm[j]) + 1) % 4]
    (tmp_path / "asm.fasta").write_text(">a\n" + "".join(asm) + "\n")
    return files, str(tmp_path / "asm.fasta")


def _launch(tmp_path, argv, env, ranks=2):
    """The port's CLI as `ranks` processes, rank r in tmp_path/rank<r>;
    [(returncode, stdout bytes, stderr bytes)] by rank."""
    port = _free_port()
    procs = []
    for r in range(ranks):
        cwd = tmp_path / f"rank{r}"
        cwd.mkdir(exist_ok=True)
        penv = {**os.environ, "KREEQ_TPU_PLATFORM": "cpu",
                "KREEQ_TPU_CHUNK": str(CHUNK),
                "PYTHONPATH": os.pathsep.join(
                    [ROOT, os.environ.get("PYTHONPATH", "")]),
                "KREEQ_TPU_COORDINATOR": f"127.0.0.1:{port}",
                "KREEQ_TPU_NUM_PROCESSES": str(ranks),
                "KREEQ_TPU_PROCESS_ID": str(r), **env}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kreeq_tpu_torch.cli.main", *argv[1:]],
            cwd=cwd, env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    runs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        runs.append((p.returncode, out, err))
    return runs


def _jax(tmp_path, monkeypatch, argv, env):
    """stdout of the single-process JAX CLI, run in tmp_path/jax with the
    same switches."""
    from kreeq_tpu.cli.main import run

    cwd = tmp_path / "jax"
    cwd.mkdir(exist_ok=True)
    with monkeypatch.context() as mp:
        mp.chdir(cwd)
        mp.setenv("KREEQ_TPU_CHUNK", str(CHUNK))
        for name, value in env.items():
            mp.setenv(name, value)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run(argv) == 0
    return buf.getvalue().encode()


def _same_output(got, want):
    """A file or a `.kreeq` directory, byte for byte."""
    assert os.path.exists(want)
    if os.path.isdir(want):
        names = sorted(os.listdir(want))
        assert sorted(os.listdir(got)) == names and names
        for name in names:
            _same_output(os.path.join(got, name), os.path.join(want, name))
    else:
        with open(got, "rb") as g, open(want, "rb") as w:
            assert g.read() == w.read(), got


def _dbs(tmp_path, monkeypatch, files):
    """Two .kreeq DBs written by the JAX CLI, of the first file and of
    the other two."""
    out = []
    for name, reads in (("a", files[:1]), ("b", files[1:])):
        db = str(tmp_path / f"{name}.kreeq")
        _jax(tmp_path, monkeypatch, ["kreeq", "validate", "-r", *reads, "-k",
                                     "17", "-o", db], {})
        out.append(db)
    return out


@pytest.mark.parametrize("case", ["validate", "kreeq", "windowed", "union"])
def test_two_ranks_match_single_process_jax(tmp_path, monkeypatch, inputs,
                                            case):
    """validate -r -f (stdout); -o x.kreeq; forced windows
    (MAX_TABLE_ROWS 300: the gathered table held on the host) with
    -o x.bkwig and --detect-anomalies; `union -o` under FORCE_SHARDED=1
    (a merge of key-range slices, one a rank).  Files are named
    relative to each rank's own directory, so a rank-1 write shows."""
    files, asm = inputs
    env, outs = {}, []
    if case == "validate":
        argv = ["kreeq", "validate", "-f", asm, "-r", *files, "-k", "17"]
    elif case == "kreeq":
        argv = ["kreeq", "validate", "-r", *files, "-k", "17", "-o",
                "out.kreeq"]
        outs = ["out.kreeq"]
    elif case == "windowed":
        env = {"KREEQ_TPU_MAX_TABLE_ROWS": "300"}
        argv = ["kreeq", "validate", "-r", *files, "-f", asm, "-k", "17",
                "-o", "out.bkwig", "--detect-anomalies", "anom.bed"]
        outs = ["out.bkwig", "anom.bed"]
    else:
        env = {"KREEQ_TPU_FORCE_SHARDED": "1"}
        argv = ["kreeq", "union", "-d", *_dbs(tmp_path, monkeypatch, files),
                "-o", "out.kreeq"]
        outs = ["out.kreeq"]
    want = _jax(tmp_path, monkeypatch, argv, env)
    assert b"DBG Summary" in want
    (rc0, out0, err0), (rc1, out1, err1) = _launch(
        tmp_path, argv + ["--verbose"], env)
    assert rc0 == 0 and rc1 == 0, (err0 + err1).decode()
    assert out0 == want
    assert out1 == b""
    for err in (err0, err1):
        built = [json.loads(x.split("distributed build ", 1)[1])
                 for x in err.decode().splitlines() if "distributed build" in x]
        assert [b["on_host"] for b in built] == (
            [] if case == "union" else [case == "windowed"])
    for name in outs:
        _same_output(str(tmp_path / "rank0" / name),
                     str(tmp_path / "jax" / name))
        assert not os.path.exists(tmp_path / "rank1" / name)


def _profile(err: str):
    """({span: calls}, {counter: n}) of the job that --profile printed
    to `err`."""
    spans, counters, part = {}, {}, ""
    for line in err.splitlines():
        f = line.split()
        if line.startswith("==="):
            part = line
        elif "spans of job" in part and f and f[0].startswith("kq."):
            spans[f[0]] = int(f[-3])  # name, parent, calls, total, self
        elif part == "=== counters ===" and len(f) == 2:
            counters[f[0]] = int(f[1])
    return spans, counters


def test_two_ranks_verbose_names_backend_and_build(tmp_path, inputs):
    """--verbose: each rank logs its device and backend (gloo on the
    CPU), and its share of the distributed build, and --profile the
    job's collectives; stdout as without."""
    files, asm = inputs
    argv = ["kreeq", "validate", "-f", asm, "-r", *files, "-k", "17"]
    runs = _launch(tmp_path, argv + ["--verbose", "--profile"], {})
    for r, (rc, _out, err) in enumerate(runs):
        assert rc == 0, err.decode()
        err = err.decode()
        assert f"rank {r} of 2: cpu, gloo backend" in err
        assert "2 rank(s) on this host" in err
        line = next(x for x in err.splitlines() if "distributed build" in x)
        rep = json.loads(line.split("distributed build ", 1)[1])
        # rank 0 has files 0 and 2 (2 chunks), rank 1 file 1 (1 chunk)
        assert (rep["rank"], rep["chunks"], rep["rounds"]) == (r, 2 - r, 2)
        spans, counters = _profile(err)
        assert spans["kq.shard.route"] == 2 and spans["kq.shard.gather"] == 1
        assert counters["shard.gather_rows"] == rep["rows"] > 0
        assert counters["shard.host_gathers"] == 0
    assert runs[1][1] == b""


def test_host_ranks_pick_card_and_backend(monkeypatch):
    """The launch's host names give each rank its place on its host: a
    2-host launch of 8 ranks with 4 cards a host takes NCCL and cards
    0-3 on each host; 8 ranks on one host of 4 cards share them over
    gloo; torchrun's LOCAL_* variables win where set."""
    import torch

    from kreeq_tpu_torch import device as D
    from kreeq_tpu_torch.parallel.multihost import host_ranks

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(D, "_HOST_RANKS", None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    card = torch.device("cuda", 0)
    hosts = ["a", "b"] * 4  # ranks alternate between the hosts
    assert [host_ranks(hosts, r) for r in range(8)] == [
        (r // 2, 4) for r in range(8)]
    D.set_host_ranks(*host_ranks(hosts, 5))
    assert (D.local_rank(), D.local_ranks()) == (2, 4)
    assert D.collective_backend(card) == "nccl"
    D.set_host_ranks(*host_ranks(["a"] * 8, 5))
    assert (D.local_rank(), D.local_ranks()) == (5, 8)
    assert D.collective_backend(card) == "gloo"
    assert D.collective_backend(torch.device("cpu")) == "gloo"
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert (D.local_rank(), D.local_ranks()) == (1, 2)
    assert D.collective_backend(card) == "nccl"


def test_checkpointed_two_ranks_resume_matches_jax(tmp_path, monkeypatch,
                                                   inputs):
    """KREEQ_TPU_BUILD_CKPT under the launch: both ranks read every file
    and count their share of each batch; killed after the first part
    (both ranks stop), then resumed.  Rank 0's stdout and the checkpoint
    directory equal the JAX CLI's, killed and resumed the same way."""
    files, asm = inputs
    ckpt = {"KREEQ_TPU_BUILD_CKPT": "ckpt", "KREEQ_TPU_BUILD_CKPT_BATCH": "1"}
    argv = ["kreeq", "validate", "-f", asm, "-r", *files, "-k", "17"]
    crash = {**ckpt, "KREEQ_TPU_BUILD_CKPT_CRASH_AFTER": "1"}
    with pytest.raises(RuntimeError, match="fault injection"):
        _jax(tmp_path, monkeypatch, argv, crash)
    want = _jax(tmp_path, monkeypatch, argv, ckpt)
    # the launch: rank 0 writes into its own directory's ckpt/
    abs_ckpt = {**ckpt, "KREEQ_TPU_BUILD_CKPT": str(tmp_path / "port.ckpt")}
    runs = _launch(tmp_path, argv, {**abs_ckpt,
                                    "KREEQ_TPU_BUILD_CKPT_CRASH_AFTER": "1"})
    for rc, out, err in runs:
        assert rc != 0 and b"fault injection" in err and out == b""
    parts = sorted(f for f in os.listdir(tmp_path / "port.ckpt")
                   if f.endswith(".keys.npy"))
    assert parts == ["p00000.keys.npy"]
    (rc0, out0, err0), (rc1, out1, err1) = _launch(tmp_path, argv, abs_ckpt)
    assert rc0 == 0 and rc1 == 0, (err0 + err1).decode()
    assert out0 == want and out1 == b""
    got_dir, want_dir = str(tmp_path / "port.ckpt"), str(tmp_path / "jax" /
                                                         "ckpt")
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and "manifest.jsonl" in names
    for name in names:
        _same_output(os.path.join(got_dir, name),
                     os.path.join(want_dir, name))
