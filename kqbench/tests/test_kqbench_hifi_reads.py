"""The cell `ecoli_k12_hifi30x_k21.reads_qv` at the tiny size on the
CPU: `validate -r -f` on long reads.  The sound program is correct and
its traced run reads the ingest and build metrics; each fault of the
build makes `correct` false; the 8-bit control fails."""

import json

import pytest

from kqbench import control, run, spec

from kq_tiny import LONG_READS, config
from test_kqbench_faults import (_answer_altered, _half_batch_left_out,
                                 _state_unchanged)

BENCH = spec.load()
CELL = spec.cell(BENCH, "ecoli_k12_hifi30x_k21.reads_qv")


def run_tiny(tmp_path, trace=False):
    cfg = config(LONG_READS)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    result, _lines = run.run_cell(
        CELL, cfg, str(path), spec.traffic(CELL["traffic"]),
        spec.metrics(BENCH, "end_to_end", CELL["name"]),
        spec.metrics(BENCH, "per_layer", CELL["name"]), 7, 0.5, trace,
        require_cuda=False, cache=False)
    return result


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    # several chunks a job, so that the build merges
    monkeypatch.setenv("KREEQ_TPU_CHUNK", str(1 << 18))


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_sound_program_is_correct(tmp_path, cpu, trace):
    r = run_tiny(tmp_path, trace)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r["checks"]) == ["summary_fields_off", "qv_fields_off"]
    if trace:
        # no device here: the host metrics only
        assert {m for m in r["metrics"]} == {
            "ingest_s_per_gbase.reads_qv", "build_s_per_gbase.reads_qv",
            "parse_s_per_gbase.reads_qv", "views_s_per_gbase.reads_qv",
            "pack_s_per_gbase.reads_qv"}
    else:
        assert set(r["metrics"]) == {"read_bases_per_s", "peak_device_gib",
                                     "setup_s"}


@pytest.mark.parametrize("fault", [
    _answer_altered, _half_batch_left_out, _state_unchanged],
    ids=["count-answer-altered", "half-the-reads-left-out",
         "merge-returns-its-state"])
def test_fault_makes_the_run_incorrect(tmp_path, cpu, monkeypatch, fault):
    fault(monkeypatch)
    r = run_tiny(tmp_path)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_control_fails_and_the_reference_passes():
    got = control.readings(config(LONG_READS),
                           spec.traffic(CELL["traffic"]), 17)
    assert all(ref == 0 for ref, _ctl in got.values())
    assert got["summary_fields_off"][1] > 0
