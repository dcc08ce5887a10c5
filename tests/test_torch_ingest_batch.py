"""The parser's read batches packed straight into chunks (CPU):
native.ReadBatch through ops/kmers.pack_reads gives byte for byte the
chunks of the same reads packed one by one and the JAX package's, over
formats, edge lengths, long reads, files that share a chunk and chunk
sizes; a job's counters and spans say which cut packed the reads; a
checkpointed build resumed after some chunks equals an unbroken one."""

import contextlib
import gzip
import io
import itertools

import numpy as np
import pytest
import torch

from kreeq_tpu.io.fastx import iter_reads as jax_iter_reads
from kreeq_tpu.ops.kmers import pack_reads as jax_pack_reads
from kreeq_tpu_torch.io.fastx import iter_reads
from kreeq_tpu_torch.native import ReadBatch
from kreeq_tpu_torch.ops.kmers import pack_reads
from kreeq_tpu_torch.utils import log

K = 21


def _bases(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), int(n)))


def _fastq(reads, eol="\n"):
    return "".join(f"@r{i}{eol}{r}{eol}+{eol}{'I' * len(r)}{eol}"
                   for i, r in enumerate(reads))


def _fasta(reads, width=60, eol="\n"):
    out = []
    for i, r in enumerate(reads):
        out.append(f">r{i} comment{eol}")
        out.extend(r[j:j + width] + eol for j in range(0, len(r), width))
    return "".join(out)


def _case_fastq(rng, chunk):
    # N, IUPAC codes and lower case read as BAD or as their base
    return [("r.fq", _fastq([_bases(rng, m, "ACGTNacgtRYKM")
                             for m in rng.integers(1, 300, 120)]))]


def _case_fasta_multiline(rng, chunk):
    return [("r.fa", _fasta([_bases(rng, m)
                             for m in rng.integers(1, 700, 60)]))]


def _case_gz(rng, chunk):
    return [("r.fq.gz", gzip.compress(_fastq(
        [_bases(rng, m, "ACGTN") for m in rng.integers(1, 300, 120)])
        .encode()))]


def _case_crlf(rng, chunk):
    reads = [_bases(rng, m) for m in rng.integers(1, 400, 40)]
    return [("r.fq", _fastq(reads, eol="\r\n")),
            ("r.fa", _fasta(reads, width=70, eol="\r\n"))]


def _case_empty_records(rng, chunk):
    reads = [_bases(rng, m) if m % 3 else "" for m in range(1, 90)]
    return [("r.fa", _fasta(reads)), ("r.fq", _fastq(reads))]


def _case_edge_lengths(rng, chunk):
    # chunk - 1 bases fill a chunk to its end; 10 + (chunk - 12) bases
    # and their separators too, the second separator on the chunk's
    # last byte; chunk bases are one too many: a chunk of its own
    lengths = [chunk - 1, 10, chunk - 12, chunk, 3, chunk - 1, chunk + 1,
               7, chunk - 1]
    return [("r.fq", _fastq([_bases(rng, m) for m in lengths]))]


def _case_hifi(rng, chunk):
    return [("r.fq", _fastq([_bases(rng, m, "ACGTN")
                             for m in rng.integers(5000, 25001, 10)]))]


def _case_two_files(rng, chunk):
    # the first file's reads fill part of a chunk the second's finish
    return [("a.fq", _fastq([_bases(rng, m)
                             for m in rng.integers(20, 150, 9)])),
            ("b.fa", _fasta([_bases(rng, m)
                             for m in rng.integers(20, 300, 40)]))]


CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
         if name.startswith("_case_")}
PARAMS = ([(name, chunk) for name in CASES for chunk in (256, 4096, 1000)]
          + [("hifi", 1 << 16)])


def _write(tmp_path, files):
    paths = []
    for name, data in files:
        p = tmp_path / name
        if isinstance(data, str):
            p.write_bytes(data.encode())
        else:
            p.write_bytes(data)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("case,chunk", PARAMS)
def test_batch_chunks_are_the_per_read_chunks(tmp_path, case, chunk):
    rng = np.random.default_rng(19)
    paths = _write(tmp_path, CASES[case](rng, chunk))
    batches = [b for p in paths for b in iter_reads(p)]
    assert len(batches) == len(paths)
    assert all(isinstance(b, ReadBatch) for b in batches)

    got = list(pack_reads(iter(batches), K, chunk))
    one_by_one = list(pack_reads((r for b in batches for r in b), K, chunk))
    jax = list(jax_pack_reads(
        itertools.chain.from_iterable(jax_iter_reads(p) for p in paths),
        K, chunk))
    assert len(got) == len(one_by_one) == len(jax) > 0
    for g, o, j in zip(got, one_by_one, jax):
        assert g.dtype == o.dtype == np.uint8
        assert np.array_equal(g, o) and np.array_equal(g, np.asarray(j))
    # every chunk owns its bytes: a later chunk writes none of them
    assert not any(np.shares_memory(a, b)
                   for a, b in itertools.combinations(got, 2))


def _run(argv):
    from kreeq_tpu_torch.cli.main import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run(["kreeq", *argv]) == 0
    return buf.getvalue()


def _job_files(tmp_path):
    """Two FASTQ files of reads of 60-180 bases from one genome, and a
    FASTA of the genome's first 3 kbp."""
    rng = np.random.default_rng(18)
    genome = _bases(rng, 30000)
    paths, lengths = [], []
    for f in range(2):
        starts = rng.integers(0, len(genome) - 200, 1500)
        ms = rng.integers(60, 181, len(starts))
        p = tmp_path / f"reads{f}.fq"
        p.write_text(_fastq([genome[s:s + m] for s, m in zip(starts, ms)]))
        paths.append(str(p))
        lengths.extend(ms.tolist())
    ap = tmp_path / "asm.fa"
    ap.write_text(f">a\n{genome[:3000]}\n")
    return paths, str(ap), lengths


@pytest.mark.parametrize("native", [True, False])
def test_job_counters_name_the_cut(tmp_path, monkeypatch, native):
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("KREEQ_TPU_CHUNK", "8192")  # reads span chunks
    paths, ap, lengths = _job_files(tmp_path)
    want = _run(["validate", "-r", *paths, "-f", ap])
    if not native:
        monkeypatch.setenv("KREEQ_TPU_NO_NATIVE", "1")
        assert _run(["validate", "-r", *paths, "-f", ap]) == want
    job = log.jobs[-1]
    c = job["counters"]
    n = len(lengths)
    if native:
        assert c["ingest.files"] == 2 and c["ingest.reads"] == n
        assert c["ingest.bases"] == sum(lengths)
        assert c["ingest.batch_reads"] == n
        assert c["ingest.single_reads"] == 0
        assert {"kq.ingest.parse", "kq.ingest.views",
                "kq.ingest.pack"} <= set(job["spans"])
        assert job["spans"]["kq.ingest.views"]["calls"] == 2
    else:
        assert "ingest.reads" not in c
        assert c["ingest.batch_reads"] == 0
        assert c["ingest.single_reads"] == n
    assert c["build.chunks"] > 2


@pytest.mark.parametrize("crash_after", [1, 2])
def test_checkpointed_resume_equals_an_unbroken_build(tmp_path, monkeypatch,
                                                     crash_after):
    from kreeq_tpu_torch.core.table import KmerTable

    monkeypatch.setenv("KREEQ_TPU_BUILD_CKPT_BATCH", "2")
    paths, _ap, lengths = _job_files(tmp_path)
    chunk = 4096
    dev = torch.device("cpu")
    with log.job() as unbroken_job:
        unbroken = KmerTable.from_reads(paths, K, dev, chunk=chunk)
    assert unbroken_job["counters"]["ingest.batch_reads"] == len(lengths)

    monkeypatch.setenv("KREEQ_TPU_BUILD_CKPT", str(tmp_path / "ck"))
    monkeypatch.setenv("KREEQ_TPU_BUILD_CKPT_CRASH_AFTER", str(crash_after))
    for attempts in range(1, 100):
        try:
            resumed = KmerTable.from_reads(paths, K, dev, chunk=chunk)
            break
        except RuntimeError as e:
            assert "fault injection" in str(e)
    else:
        raise AssertionError("the build never finished")
    assert attempts > 2
    for a, b in zip(resumed.to_numpy(), unbroken.to_numpy()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
