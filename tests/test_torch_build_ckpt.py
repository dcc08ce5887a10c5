"""PyTorch port, the resumable build (KREEQ_TPU_BUILD_CKPT) against the
JAX package on the CPU: the checkpointed build equals the plain build,
a build killed by the fault hook (KREEQ_TPU_BUILD_CKPT_CRASH_AFTER) at
each of its first manifest appends resumes to the JAX package's resumed
table bit for bit, through host merges too, and leaves a checkpoint
directory equal to the JAX package's file for file; a directory of
another build is refused."""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CHUNK = 1024  # bases per read chunk: a dozen chunks, several parts


def _mk_reads(tmp_path, n=4000, seed=3):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=n))
    rp = tmp_path / "r.fasta"
    rp.write_text("".join(f">r{i}\n{genome[i:i + 120]}\n"
                          for i in range(0, n - 150, 30)))
    return str(rp)


def _arrays(table):
    """(keys u64, cov, fw, bw) of a table of either package."""
    if hasattr(table, "to_numpy"):
        return table.to_numpy()
    return table.keys, table.cov, table.fw, table.bw


def _assert_same(got, want):
    for g, w in zip(_arrays(got), _arrays(want)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _build(pkg, rp, k, ckpt=None, crash=None):
    """One from_reads of `pkg` ("jax" or "port"), with the checkpoint
    switches of this call only."""
    keys = ("KREEQ_TPU_BUILD_CKPT", "KREEQ_TPU_BUILD_CKPT_CRASH_AFTER")
    old = {key: os.environ.get(key) for key in keys}
    for key, val in zip(keys, (ckpt, crash)):
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(val)
    try:
        if pkg == "jax":
            from kreeq_tpu.core.table import KmerTable

            return KmerTable.from_reads([rp], k, chunk=CHUNK)
        from kreeq_tpu_torch.core.table import KmerTable

        return KmerTable.from_reads([rp], k, torch.device("cpu"),
                                    chunk=CHUNK)
    finally:
        for key, val in old.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def _resume(pkg, rp, k, ckpt, crash):
    """Builds until one is not killed by the fault hook; returns the
    table and the number of attempts."""
    for attempt in range(1, 50):
        try:
            return _build(pkg, rp, k, ckpt, crash), attempt
        except RuntimeError as e:
            assert "fault injection" in str(e)
    raise AssertionError("the build never finished")


def _same_dir(got, want):
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and "manifest.jsonl" in names
    for name in names:
        with open(os.path.join(got, name), "rb") as g, \
                open(os.path.join(want, name), "rb") as w:
            assert g.read() == w.read(), name


@pytest.mark.parametrize("k", [21, 31, 32])
def test_checkpointed_build_matches_plain(tmp_path, monkeypatch, k):
    monkeypatch.setenv("KREEQ_TPU_BUILD_CKPT_BATCH", "2")
    rp = _mk_reads(tmp_path, seed=k)
    plain = _build("port", rp, k)
    ck = str(tmp_path / "ck")
    _assert_same(_build("port", rp, k, ck), plain)
    # again from the finished directory: the final part only
    _assert_same(_build("port", rp, k, ck), plain)


@pytest.mark.parametrize("crash_after", [1, 2, 3])
def test_crash_resume_matches_jax(tmp_path, monkeypatch, crash_after):
    """Killed after every crash_after-th manifest append until it
    finishes; parts above HOST_MERGE_ROWS merge on the host.  The job
    records a resume a build, and a write of each recorded part and
    merge output."""
    from kreeq_tpu_torch.utils import log

    k = 21
    monkeypatch.setenv("KREEQ_TPU_BUILD_CKPT_BATCH", "2")
    monkeypatch.setenv("KREEQ_TPU_HOST_MERGE_ROWS", "3000")
    rp = _mk_reads(tmp_path)
    dirs = {pkg: str(tmp_path / pkg) for pkg in ("jax", "port")}
    with log.job() as rec:
        got, attempts = _resume("port", rp, k, dirs["port"], crash_after)
    want, jax_attempts = _resume("jax", rp, k, dirs["jax"], crash_after)
    assert attempts == jax_attempts > 1
    assert rec["spans"]["kq.build.host_merge"]["calls"] >= 1
    assert rec["spans"]["kq.ckpt.resume"]["calls"] == attempts
    _assert_same(got, want)
    _same_dir(dirs["port"], dirs["jax"])
    # every chunk is in exactly one recorded part: no batch was counted
    # twice
    with open(os.path.join(dirs["port"], "manifest.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    eof = [r for r in recs if r["op"] == "eof"]
    written = [r for r in recs if r["op"] in ("part", "merge")]
    assert rec["spans"]["kq.ckpt.write"]["calls"] == len(written)
    assert rec["counters"]["ckpt.rows"] == sum(r["rows"] for r in written)
    assert len(eof) == 1
    assert sum(r["chunks"] for r in recs if r["op"] == "part") == \
        eof[0]["chunks"] > 4


def test_stale_checkpoint_refused(tmp_path):
    rp = _mk_reads(tmp_path)
    ck = str(tmp_path / "ck")
    _build("port", rp, 21, ck)
    with pytest.raises(RuntimeError, match="different build"):
        _build("port", rp, 19, ck)
