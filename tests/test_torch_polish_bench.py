"""The polishing cell's files (kqbench/: configuration, generator,
traffic, the `vcf` kind, metric readers) resolve by name, and the
port's variant spans and counters that its readers read (CPU; plain
versions of the kernels)."""

import json

import pytest

from kqbench import compare, kinds, run, spec

from tests.polish_inputs import DRAFT, config, make, port_vcf

CELL = "ecoli_k12_hifi30x_k21_polish1m.polish_vcf"
SPANS = ("variant_search_s.polish_vcf", "variant_scan_s.polish_vcf",
         "search_us_per_branch.polish_vcf")


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")


def test_cell_resolves_by_name():
    bench = spec.load()
    cell = spec.cell(bench, CELL)
    path, cfg = spec.config(bench, cell["config"])
    assert cfg["generator"] == "draft_region" and cfg["k"] == 21
    assert cfg["draft"] == {"sequence": "NC_000913.3", "start": 0,
                            "end": 1_000_000}
    t = spec.traffic(cell["traffic"])
    assert t["files"] == {"asm.vcf": "vcf"} and t["stdout"] == ["summary"]
    assert compare.limits(t) == {"summary_fields_off": 0,
                                 "vcf_records_off": 0}
    mod = kinds.find("vcf")
    assert mod.CHECK == "vcf_records_off" and not mod.TRACKS
    names = [m["name"] for m in spec.metrics(bench, "per_layer", CELL)]
    assert names == [*SPANS, "variant_probe_roofline.polish_vcf",
                     "device_idle.polish_vcf"]
    assert all(callable(spec.reader(n)) for n in names)
    e2e = [m["name"] for m in spec.metrics(bench, "end_to_end", CELL)]
    assert e2e == ["asm_bases_per_s", "peak_device_gib", "setup_s"]


def test_draft_region_keeps_one_region(tmp_path):
    from kqbench import gen

    (tmp_path / "whole").mkdir()
    whole = gen.make({**config(), "generator": "genome_reads"}, 7,
                     str(tmp_path / "whole"))
    cut = make(tmp_path, 7)
    a, b = DRAFT
    assert cut.records == [("NC_000913.3", whole.records[0][1][a:b])]
    assert cut.sizes["asm_bases"] == b - a
    assert cut.sizes["read_bases"] == whole.sizes["read_bases"]
    with open(cut.files["asm"], "rb") as fh:
        text = fh.read().split(b"\n")
    assert text[0] == b">NC_000913.3"
    assert b"".join(text[1:]) == cut.records[0][1]


def test_vcf_job_spans_and_counters(tmp_path, cpu):
    from kreeq_tpu_torch.utils import log

    inputs = make(tmp_path, 4200002111)
    port_vcf(tmp_path, inputs, 21)  # the DB, and a first job
    got = port_vcf(tmp_path, inputs, 21)
    job = log.jobs[-1]
    sp, c = job["spans"], job["counters"]
    assert sp["kq.variants.scan"]["parent"] == "phase:variants"
    assert sp["kq.variants.search"]["parent"] == "phase:variants"
    assert sp["kq.variants.search"]["calls"] == sp["kq.variants.scan"][
        "calls"] == 1
    assert c["variants.branch_points"] > 0
    assert c["variants.paths"] == sum(
        1 for line in got.splitlines() if not line.startswith(b"#"))
    assert c["variants.positions"] == DRAFT[1] - DRAFT[0] - 21 + 1
    assert c["variants.lookups"] > 0 and c["variants.cache_hits"] >= 0


def test_profile_prints_the_variant_spans(tmp_path, cpu, capsys):
    from tests.polish_inputs import cli

    inputs = make(tmp_path, 4200002112)
    port_vcf(tmp_path, inputs, 21)
    cli("validate", "-d", str(tmp_path / "reads.kreeq"), "-f",
        inputs.files["asm"], "-o", str(tmp_path / "b.vcf"), "--profile")
    err = capsys.readouterr().err
    for name in ("kq.variants.scan", "kq.variants.search",
                 "variants.positions", "variants.branch_points",
                 "variants.lookups", "variants.cache_hits",
                 "variants.paths"):
        assert name in err


def test_readers_on_a_tiny_traced_polish_cell(tmp_path, monkeypatch, cpu):
    monkeypatch.setenv("KREEQ_TPU_CHUNK", str(1 << 18))
    bench = spec.load()
    cell = spec.cell(bench, CELL)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config()))
    result, lines = run.run_cell(
        cell, config(), str(path), spec.traffic(cell["traffic"]),
        spec.metrics(bench, "end_to_end", CELL),
        spec.metrics(bench, "per_layer", CELL), 4200002113, 0.5, True,
        require_cuda=False, cache=False)
    assert result["correct"], lines
    assert result["checks"]["vcf_records_off"] == {"value": 0, "limit": 0}
    got = {m: result["metrics"][m]["value"] for m in SPANS}
    assert all(v > 0 for v in got.values()), got
