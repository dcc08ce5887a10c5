"""The port's spans and counters (kreeq_tpu_torch/utils/log.py): self
time and parents, the bounded job records, no profiler annotation while
no profiler runs, the annotations a traced job leaves, the counters
against the inputs, and the benchmark's readers of them on a tiny
traced cell (CPU; plain versions of the kernels)."""

import collections
import contextlib
import importlib.util
import io
import json
import os
import time

import numpy as np
import pytest
import torch

from kreeq_tpu_torch.utils import log

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv):
    from kreeq_tpu_torch.cli.main import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run(["kreeq", *argv]) == 0
    return buf.getvalue()


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")


def _reads(tmp_path, n_reads: int, length: int = 150):
    """A FASTQ of `n_reads` reads of `length` bases drawn from one
    random genome, and a FASTA of the genome's first 2 kbp."""
    rng = np.random.default_rng(18)
    genome = "".join(rng.choice(list("ACGT"), 20000))
    starts = rng.integers(0, len(genome) - length, n_reads)
    rp = tmp_path / "reads.fq"
    rp.write_text("".join(f"@r{i}\n{genome[s:s + length]}\n+\n"
                          f"{'I' * length}\n"
                          for i, s in enumerate(starts)))
    ap = tmp_path / "asm.fa"
    ap.write_text(f">a\n{genome[:2000]}\n")
    return str(rp), str(ap)


def test_nested_spans_self_time_and_parents():
    with log.job() as rec:
        with log.span("a"):
            with log.span("b"):
                time.sleep(0.02)
            for _ in range(2):
                with log.span("c"):
                    time.sleep(0.005)
            log.count("things", 3)
            log.count("things")
    assert log.jobs[-1] is rec
    sp = rec["spans"]
    assert sp["kq.job"]["parent"] is None
    assert sp["a"]["parent"] == "kq.job"
    assert sp["b"]["parent"] == sp["c"]["parent"] == "a"
    assert sp["c"]["calls"] == 2 and sp["a"]["calls"] == 1
    # self = total less what the children cover
    a = sp["a"]
    assert a["self_s"] == pytest.approx(
        a["total_s"] - sp["b"]["total_s"] - sp["c"]["total_s"], abs=1e-9)
    assert sp["b"]["self_s"] == sp["b"]["total_s"] >= 0.02
    assert sp["kq.job"]["self_s"] == pytest.approx(
        sp["kq.job"]["total_s"] - a["total_s"], abs=1e-9)
    assert rec["counters"]["things"] == 4
    assert rec["counters"]["launches.count"] == 0


def test_jobs_are_bounded_and_a_raising_job_is_kept(monkeypatch):
    assert log.jobs.maxlen == 4096
    monkeypatch.setattr(log, "jobs", collections.deque(maxlen=3))
    for _ in range(5):
        with log.job():
            pass
    ids = [j["id"] for j in log.jobs]
    assert len(ids) == 3 and ids == sorted(ids)
    with pytest.raises(RuntimeError):
        with log.job():
            with log.span("failing"):
                raise RuntimeError("job failed")
    assert log.jobs[-1]["id"] == ids[-1] + 1
    assert log.jobs[-1]["spans"]["failing"]["calls"] == 1
    assert "kq.job" in log.jobs[-1]["spans"]
    # outside a job, spans and counters record nothing
    with log.span("outside"):
        log.count("outside")
    assert "outside" not in log.jobs[-1]["spans"]
    assert "outside" not in log.jobs[-1]["counters"]


def test_no_annotation_without_a_profiler(tmp_path, monkeypatch, cpu):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    rp, ap = _reads(tmp_path, 200)
    _run(["validate", "-r", rp, "-f", ap])
    assert "kq.ingest.pack" in log.jobs[-1]["spans"]
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with log.span("traced"):
            pass
    assert entered == ["traced"]


def test_trace_dir_holds_the_spans(tmp_path, monkeypatch, cpu):
    monkeypatch.setenv("KREEQ_TPU_CHUNK", "4096")  # several merges
    rp, ap = _reads(tmp_path, 200)
    trace = tmp_path / "trace"
    _run(["validate", "-r", rp, "-f", ap, "--trace-dir", str(trace)])
    with open(trace / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"kq.job", "phase:build k-mer DB", "kq.ingest.parse",
            "kq.ingest.views", "kq.ingest.pack", "kq.build.count",
            "kq.build.merge"} <= names


def test_counters_match_the_inputs(tmp_path, monkeypatch, cpu):
    from kreeq_tpu_torch.io.fastx import iter_reads
    from kreeq_tpu_torch.io.kreeqdb import read_kreeq
    from kreeq_tpu_torch.ops.kmers import pack_reads

    chunk = 262144
    monkeypatch.setenv("KREEQ_TPU_CHUNK", str(chunk))
    n_reads, length = 6000, 150
    rp, ap = _reads(tmp_path, n_reads, length)
    db = str(tmp_path / "reads.kreeq")
    _run(["validate", "-r", rp, "-f", ap, "-o", db])
    built = log.jobs[-1]
    # the same packing outside a job records nothing
    chunks = list(pack_reads(iter_reads(rp), 21, chunk))
    assert log.jobs[-1] is built
    c = built["counters"]
    assert c["ingest.files"] == 1
    assert c["ingest.reads"] == n_reads
    assert c["ingest.bases"] == n_reads * length
    assert len(chunks) > 1 and c["build.chunks"] == len(chunks)
    assert c["build.chunk_bytes"] == sum(b.nbytes for b in chunks)
    assert c["build.device_merges"] == len(chunks) - 1
    assert built["spans"]["kq.build.count"]["calls"] == len(chunks)
    assert built["spans"]["kq.build.upload"]["calls"] == len(chunks)

    _run(["validate", "-d", db, "-f", ap])
    loaded = log.jobs[-1]
    for name in ("kq.db.parse", "kq.db.assemble", "kq.db.upload"):
        assert loaded["spans"][name]["parent"] == "phase:load k-mer DB"
    rows = len(read_kreeq(db, torch.device("cpu")))
    assert loaded["counters"]["db.rows"] == rows == c["build.rows"]
    assert loaded["counters"]["db.maps"] == 129  # 128 maps and the hc map
    assert loaded["counters"]["db.bytes"] == sum(
        os.path.getsize(os.path.join(db, f)) for f in os.listdir(db)
        if f.startswith(".map."))


def _kq_tiny():
    path = os.path.join(ROOT, "kqbench", "tests", "kq_tiny.py")
    spec = importlib.util.spec_from_file_location("kq_tiny", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("traffic,metrics", [
    ("reads_qv", ["parse_s_per_gbase.reads_qv",
                  "views_s_per_gbase.reads_qv",
                  "pack_s_per_gbase.reads_qv"]),
    ("db_tracks", ["db_parse_s.db_tracks", "db_assemble_s.db_tracks",
                   "db_upload_s.db_tracks"])])
def test_readers_on_a_tiny_traced_cell(tmp_path, monkeypatch, cpu, traffic,
                                       metrics):
    from kqbench import run, spec

    tiny = _kq_tiny()
    monkeypatch.setenv("KREEQ_TPU_CHUNK", str(1 << 18))
    bench = spec.load()
    cell = next(w for w in bench["workloads"] if w["traffic"] == traffic)
    cfg = tiny.config(tiny.SHORT_READS if traffic == "reads_qv"
                      else tiny.LONG_READS)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    result, _lines = run.run_cell(
        cell, cfg, str(path), spec.traffic(traffic),
        spec.metrics(bench, "end_to_end", cell["name"]),
        spec.metrics(bench, "per_layer", cell["name"]), 4200000018, 0.5,
        True, require_cuda=False, cache=False)
    assert result["correct"]
    got = {m: result["metrics"][m]["value"] for m in metrics}
    assert all(v > 0 for v in got.values()), got
    if traffic == "reads_qv":
        # the three split the same pulls of the packing generator
        whole = result["metrics"]["ingest_s_per_gbase.reads_qv"]["value"]
        assert sum(got.values()) <= 1.05 * whole
