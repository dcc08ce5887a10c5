"""A whole run of each cell's traffic at a tiny size on the CPU, past
the harness's look for a card, with the timed path broken underneath:
each fault the cell can have must make `correct` false, and the sound
program must make it true.  Then the control: the reference with 8-bit
counters must fail the comparison too."""

import json

import pytest

from kqbench import control, run, spec

from kq_tiny import LONG_READS, SHORT_READS, config

BENCH = spec.load()
CELLS = {"reads_qv": (BENCH["workloads"][0], SHORT_READS),
         "db_tracks": (BENCH["workloads"][1], LONG_READS)}


def run_tiny(tmp_path, traffic: str, trace: bool = False):
    cell, reads = CELLS[traffic]
    cfg = config(reads)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    result, lines = run.run_cell(
        cell, cfg, str(path), spec.traffic(traffic),
        spec.metrics(BENCH, "end_to_end", cell["name"]),
        spec.metrics(BENCH, "per_layer", cell["name"]), 5, 0.5, trace,
        require_cuda=False, cache=False)
    return result


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    # several chunks a job, so that the build merges
    monkeypatch.setenv("KREEQ_TPU_CHUNK", str(1 << 18))


@pytest.mark.parametrize("traffic", ["reads_qv", "db_tracks"])
def test_sound_program_is_correct(tmp_path, cpu, traffic):
    r = run_tiny(tmp_path, traffic)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_traced_run_reads_its_spans(tmp_path, cpu):
    r = run_tiny(tmp_path, "reads_qv", trace=True)
    assert r["correct"]
    assert r["metrics"]["ingest_s_per_gbase.reads_qv"]["value"] > 0
    assert r["metrics"]["build_s_per_gbase.reads_qv"]["value"] > 0
    # no device here: no device metric is written
    assert "count_step_roofline.reads_qv" not in r["metrics"]
    assert r["breakdown"]["device_ops"] == []


def _answer_altered(monkeypatch):
    from kreeq_tpu_torch.ops import kernels

    count = kernels.count_chunk_cuda

    def altered(codes, k):
        keys, cov, fw, bw, n = count(codes, k)
        cov = cov.clone()
        cov[0] += 1
        return keys, cov, fw, bw, n

    monkeypatch.setattr(kernels, "count_chunk_cuda", altered)


def _half_batch_left_out(monkeypatch):
    from kreeq_tpu_torch.ops import kmers

    pack = kmers.pack_reads

    def half(*args, **kwargs):
        for buf in pack(*args, **kwargs):
            buf = buf.copy()
            buf[len(buf) // 2:] = 4
            yield buf

    monkeypatch.setattr(kmers, "pack_reads", half)


def _state_unchanged(monkeypatch):
    from kreeq_tpu_torch.constants import SENTINEL
    from kreeq_tpu_torch.ops import kernels

    def unchanged(*args):
        # the merge hands back its first table as it was
        return (*args[:4], (args[0] != SENTINEL).sum())

    monkeypatch.setattr(kernels, "merge_sorted_cuda", unchanged)


def _track_altered(monkeypatch):
    from kreeq_tpu_torch.ops import validate

    positions = validate.validate_positions

    def altered(*args, **kwargs):
        out = list(positions(*args, **kwargs))
        out[3] = out[3].clone()
        out[3][len(out[3]) // 2] += 1
        return tuple(out)

    monkeypatch.setattr(validate, "validate_positions", altered)


def _half_table_left_out(monkeypatch):
    from kreeq_tpu_torch.cli import main
    from kreeq_tpu_torch.core.table import KmerTable

    load = main.load_graph

    def half(ui, device):
        t = load(ui, device)
        m = len(t) // 2
        return KmerTable(t.k, t.keys[:m], t.cov[:m], t.fw[:m], t.bw[:m])

    monkeypatch.setattr(main, "load_graph", half)


@pytest.mark.parametrize("traffic,fault", [
    ("reads_qv", _answer_altered),
    ("reads_qv", _half_batch_left_out),
    ("reads_qv", _state_unchanged),
    ("db_tracks", _track_altered),
    ("db_tracks", _half_table_left_out),
], ids=["count-answer-altered", "half-the-reads-left-out",
        "merge-returns-its-state", "track-value-altered",
        "half-the-db-left-out"])
def test_fault_makes_the_run_incorrect(tmp_path, cpu, monkeypatch, traffic,
                                       fault):
    fault(monkeypatch)
    r = run_tiny(tmp_path, traffic)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("traffic", ["reads_qv", "db_tracks"])
def test_control_fails_and_the_reference_passes(traffic):
    _cell, reads = CELLS[traffic]
    got = control.readings(config(reads), spec.traffic(traffic), 13)
    assert all(ref == 0 for ref, _ctl in got.values())
    assert got["summary_fields_off"][1] > 0
    if traffic == "db_tracks":
        assert got["bkwig_values_off"][1] > 0
