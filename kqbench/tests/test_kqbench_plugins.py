"""What a later cell adds as files only: a file kind found by name from
a module outside kqbench/, and a job argument for every input role the
generator wrote.  Both run through run.run_cell at the tiny size."""

import json
import os

import pytest

from kqbench import gen, kinds, run, spec

from kq_tiny import SHORT_READS, config

BENCH = spec.load()
END_TO_END = [m for m in BENCH["end_to_end"]
              if m["name"] in ("read_bases_per_s", "setup_s")]
CELL = {"name": "tiny.plugin", "chips": 1}

# `-o x.hist`: one `cov\tcount` line a coverage the table holds
HIST_KIND = '''
import numpy as np

CHECK = "hist_lines_off"
LIMIT = 0


def expected(table, records, score):
    cov, n = np.unique(table.cov, return_counts=True)
    return "".join(f"{c}\\t{m}\\n" for c, m in zip(cov.tolist(),
                                                  n.tolist())).encode()


def values_off(got, want):
    g, w = got.splitlines(), want.splitlines()
    return sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))
'''


def traffic(job, files=None):
    return {"setup": [], "job": job, "stdout": ["summary", "qv"],
            "files": files or {}, "rates": {"read_bases_per_s": "read_bases"}}


def run_tiny(tmp_path, t):
    cfg = config(SHORT_READS)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    result, _lines = run.run_cell(CELL, cfg, str(path), t, END_TO_END, [],
                                  5, 0.5, False, require_cuda=False,
                                  cache=False)
    return result


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("KREEQ_TPU_CHUNK", str(1 << 18))


@pytest.fixture
def hist_kind(tmp_path, monkeypatch):
    d = tmp_path / "kinds"
    d.mkdir()
    (d / "hist.py").write_text(HIST_KIND)
    monkeypatch.setattr(kinds, "DIRS", (*kinds.DIRS, str(d)))
    return d


def kqbench_files():
    out = {}
    for root, dirs, files in os.walk(spec.KQBENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            st = os.stat(os.path.join(root, f))
            out[os.path.join(root, f)] = (st.st_size, st.st_mtime_ns)
    return out


def _alter_first_hist_line(monkeypatch):
    keep = run.keep_files

    def altered(job, work, prefix, files):
        keep(job, work, prefix, files)
        for path in job.files.values():
            with open(path) as fh:
                lines = fh.readlines()
            cov, n = lines[0].split()
            lines[0] = f"{cov}\t{int(n) + 1}\n"
            with open(path, "w") as fh:
                fh.writelines(lines)

    monkeypatch.setattr(run, "keep_files", altered)


@pytest.mark.parametrize("altered", [False, True],
                         ids=["sound", "hist-line-altered"])
def test_a_kind_from_outside_kqbench_judges_its_file(
        tmp_path, cpu, monkeypatch, hist_kind, altered):
    before = kqbench_files()
    if altered:
        _alter_first_hist_line(monkeypatch)
    r = run_tiny(tmp_path, traffic(
        ["validate", "-r", "{reads}", "-f", "{asm}", "-k", "{k}", "-o",
         "{work}/reads.hist"], {"reads.hist": "hist"}))
    assert list(r["checks"]) == ["summary_fields_off", "qv_fields_off",
                                 "hist_lines_off"]
    assert r["checks"]["hist_lines_off"]["limit"] == 0
    if altered:
        assert not r["correct"]
        assert r["checks"]["hist_lines_off"]["value"] == 1
        assert r["checks"]["summary_fields_off"]["value"] == 0
    else:
        assert r["correct"] and r["failed"] == 0
        assert all(c["value"] == 0 for c in r["checks"].values())
    assert kqbench_files() == before


def test_an_unknown_kind_fails_before_any_work(tmp_path, cpu, monkeypatch):
    def no_inputs(*args):
        raise AssertionError("inputs generated for an unknown kind")

    monkeypatch.setattr(gen, "make", no_inputs)
    with pytest.raises(ValueError, match="no file kind 'hist'"):
        run_tiny(tmp_path, traffic(["validate", "-r", "{reads}"],
                                   {"x.hist": "hist"}))


def test_the_cache_key_covers_the_kinds(tmp_path, hist_kind):
    cfg = tmp_path / "config.json"
    cfg.write_text("{}")
    t = traffic([], {"x.hist": "hist"})
    key = run._digest(str(cfg), t, 1)
    (hist_kind / "hist.py").write_text(HIST_KIND + "\n# edited\n")
    assert run._digest(str(cfg), t, 1) != key


@pytest.fixture
def two_read_files(monkeypatch):
    """The generator's reads written as two files, roles `reads` and
    `reads2`, each with half of the records."""
    make = gen.make

    def split(cfg, seed, workdir):
        inputs = make(cfg, seed, workdir)
        with open(inputs.files["reads"]) as fh:
            lines = fh.readlines()
        half = len(lines) // 8 * 4
        second = os.path.join(workdir, "reads2.fq")
        with open(second, "w") as fh:
            fh.writelines(lines[half:])
        with open(inputs.files["reads"], "w") as fh:
            fh.writelines(lines[:half])
        inputs.files["reads2"] = second
        return inputs

    monkeypatch.setattr(gen, "make", split)


@pytest.mark.parametrize("reads,correct", [
    (["{reads}", "{reads2}"], True), (["{reads}"], False)],
    ids=["both-roles", "second-role-left-out"])
def test_every_input_role_is_a_job_argument(tmp_path, cpu, two_read_files,
                                            reads, correct):
    r = run_tiny(tmp_path, traffic(
        ["validate", "-r", *reads, "-f", "{asm}", "-k", "{k}"]))
    assert r["correct"] is correct


def test_a_role_the_generator_did_not_write_fails_the_set_up(
        tmp_path, cpu, monkeypatch):
    ran = []
    monkeypatch.setattr(run, "run_job", lambda *a: ran.append(a))
    with pytest.raises(ValueError, match="'reads2' names no input role"):
        run_tiny(tmp_path, traffic(
            ["validate", "-r", "{reads}", "{reads2}", "-f", "{asm}"]))
    assert ran == []
