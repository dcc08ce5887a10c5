"""PyTorch port, the at-scale soak harness (kreeq_tpu_torch/soak.py)
against scripts/soak_round5.py's contract on the CPU: the phase
runner's stall watchdog, exact-group kill and relaunch loop (with the
watchdog's poll shortened, so the hang case takes seconds), the
generated data byte for byte against the JAX harness's, a mirror that
never names the repository's SOAK_r05.log, and one whole run at the
smallest genome `plant` accepts, out of core, whose QV stdout, .bkwig
and VCF equal the JAX CLI's on the same files.  chip_ok is stubbed out:
these tests exercise the harness, not the device."""

import contextlib
import io
import json
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


@pytest.fixture()
def soak(monkeypatch, tmp_path):
    """The port's harness with test-speed knobs."""
    from kreeq_tpu_torch import soak as mod

    monkeypatch.setattr(mod, "COOLDOWN_S", 0)
    monkeypatch.setattr(mod, "MAX_ATTEMPTS", 3)
    monkeypatch.setattr(mod, "POLL_S", 0.25)
    monkeypatch.setattr(mod, "MIRROR", str(tmp_path / "mirror.log"))
    monkeypatch.setattr(mod, "chip_ok", lambda timeout_s=0: True)
    return mod


def test_run_phase_success(soak, tmp_path):
    wall, attempts, rss = soak.run_phase(
        str(tmp_path), "ok", [sys.executable, "-c", "print('hello')"],
        stall_s=30)
    assert attempts == 1 and rss > 0
    assert (tmp_path / "phase_ok.out").read_text() == "hello\n"
    assert "==== attempt 1:" in (tmp_path / "phase_ok.log").read_text()


def test_run_phase_kills_silent_hang_and_resumes(soak, tmp_path):
    """Attempt 1 prints nothing and sleeps past the stall window; the
    harness must kill its process group (the grandchild it started
    too) and relaunch; attempt 2, which sees the attempt counter the
    fake phase keeps, succeeds."""
    marker = tmp_path / "attempts"
    grandchild = tmp_path / "grandchild.pid"
    prog = (
        "import os, subprocess, sys, time\n"
        f"p = {str(marker)!r}\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        "if n == 0:\n"
        "    g = subprocess.Popen([sys.executable, '-c', "
        "'import time; time.sleep(600)'])\n"
        f"    open({str(grandchild)!r}, 'w').write(str(g.pid))\n"
        "    time.sleep(600)\n"  # silent: no output -> stall
        "print('resumed fine')\n"
    )
    t0 = time.time()
    wall, attempts, _rss = soak.run_phase(
        str(tmp_path), "hang", [sys.executable, "-u", "-c", prog],
        stall_s=2)
    assert attempts == 2
    assert time.time() - t0 < 30  # killed by the watchdog, not by wait
    assert (tmp_path / "phase_hang.out").read_text() == "resumed fine\n"
    assert "no output for 2s" in (tmp_path / "mirror.log").read_text()
    assert "no output for 2s" in (tmp_path / "soak.log").read_text()
    pid = int(grandchild.read_text())
    for _ in range(50):  # the kill reaches the grandchild; init reaps it
        try:
            with open(f"/proc/{pid}/stat") as fh:
                if fh.read().split(") ", 1)[1].startswith("Z"):
                    break
        except OSError:
            break
        time.sleep(0.1)
    else:
        raise AssertionError("the group's grandchild survived the kill")


def test_run_phase_retries_nonzero_exit(soak, tmp_path):
    marker = tmp_path / "attempts"
    prog = (
        "import os, sys\n"
        f"p = {str(marker)!r}\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        "print('attempt', n)\n"
        "sys.exit(0 if n >= 1 else 7)\n"
    )
    wall, attempts, _rss = soak.run_phase(
        str(tmp_path), "rc", [sys.executable, "-u", "-c", prog], stall_s=30)
    assert attempts == 2
    assert "rc=7" in (tmp_path / "mirror.log").read_text()
    assert (tmp_path / "phase_rc.out").read_text() == "attempt 1\n"


def test_run_phase_gives_up_after_max_attempts(soak, tmp_path):
    with pytest.raises(SystemExit) as ei:
        soak.run_phase(str(tmp_path), "fail",
                       [sys.executable, "-c", "raise SystemExit(5)"],
                       stall_s=30)
    assert ei.value.code == 2
    mirror = (tmp_path / "mirror.log").read_text()
    assert "FAILED after 3 attempts" in mirror
    assert mirror.count("rc=5") == 3


def _jax_harness(monkeypatch, tmp_path):
    """scripts/soak_round5.py, its mirror pointed into tmp_path."""
    import importlib

    monkeypatch.setenv("KREEQ_TPU_SOAK_MIRROR", str(tmp_path / "jax.log"))
    monkeypatch.syspath_prepend(SCRIPTS)
    import soak_round5

    return importlib.reload(soak_round5)


def test_datagen_bytes_match_jax_harness(monkeypatch, tmp_path):
    """gen_reads, write_fasta and plant give the JAX harness's bytes and
    planted lists, and leave the generator in the same state."""
    from kreeq_tpu_torch import soak

    jax_soak = _jax_harness(monkeypatch, tmp_path)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    genome = np.random.default_rng(2026).integers(0, 4, 30_011).astype(
        np.uint8)
    assert soak.gen_reads(str(mine), genome, 7).split(" in ")[0] == \
        jax_soak.gen_reads(str(theirs), genome, 7).split(" in ")[0]
    assert (mine / "reads.fastq").read_bytes() == \
        (theirs / "reads.fastq").read_bytes()
    rp, rj = np.random.default_rng(5), np.random.default_rng(5)
    asm_p, planted_p = soak.plant(genome, rp, n_var=12)
    asm_j, planted_j = jax_soak.plant(genome, rj, n_var=12)
    assert np.array_equal(asm_p, asm_j) and planted_p == planted_j
    assert rp.integers(0, 1 << 62) == rj.integers(0, 1 << 62)
    for n in (0, 79, 80, 81, 1000):
        soak.write_fasta(str(mine / "a.fa"), "chr1", asm_p[:n])
        jax_soak.write_fasta(str(theirs / "a.fa"), "chr1", asm_j[:n])
        assert (mine / "a.fa").read_bytes() == (theirs / "a.fa").read_bytes()
    # the whole run's generation, at the smallest genome plant accepts
    g, a, planted = soak.make_genome(1.002)
    rng = np.random.default_rng(2026)
    gj = rng.integers(0, 4, 1_002_000).astype(np.uint8)
    aj, pj = jax_soak.plant(gj, rng)
    assert np.array_equal(g, gj) and np.array_equal(a, aj) and planted == pj


def test_mirror_never_names_repo_log(monkeypatch, tmp_path):
    """Unset, the mirror is the workdir's own log: soaklog appends there
    only, and the repository's SOAK_r05.log is untouched."""
    import importlib

    from kreeq_tpu_torch import soak

    monkeypatch.delenv("KREEQ_TPU_SOAK_MIRROR", raising=False)
    repo_log = os.path.join(ROOT, "SOAK_r05.log")
    before = os.stat(repo_log) if os.path.exists(repo_log) else None
    try:
        mod = importlib.reload(soak)
        assert mod.MIRROR == ""
        mod.soaklog(str(tmp_path), "line one")
        mod.soaklog(str(tmp_path), "line two")
    finally:
        importlib.reload(soak)
    assert sorted(os.listdir(tmp_path)) == ["soak.log"]
    lines = (tmp_path / "soak.log").read_text().splitlines()
    assert [ln.split(" ", 1)[1] for ln in lines] == ["line one", "line two"]
    after = os.stat(repo_log) if os.path.exists(repo_log) else None
    assert (before is None) == (after is None)
    if before is not None:
        assert (before.st_size, before.st_mtime_ns) == (after.st_size,
                                                        after.st_mtime_ns)
    with open(soak.__file__) as fh:
        assert "SOAK_r05" not in fh.read()


def _jax_stdout(argv, cwd):
    from kreeq_tpu.cli.main import run

    buf = io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            assert run(argv) == 0
    finally:
        os.chdir(here)
    return buf.getvalue()


def test_soak_main_small_out_of_core_matches_jax(soak, monkeypatch,
                                                 tmp_path, capsys):
    """One whole run at 1.002 Mbp, 10x, on the CPU, with caps so low that
    the table is held on the host in windows, the build's merges run on
    the host and the checkpoint records several parts and a merge.  It
    completes in one attempt a phase; every planted variant without a
    VCF row has a k-mer on its path that no read holds; the QV stdout,
    the .bkwig and the VCF equal the JAX CLI's on the same DB and
    assembly."""
    wd = tmp_path / "soak"
    for name, value in (("PLATFORM", "cpu"), ("MAX_TABLE_ROWS", "400000"),
                        ("HOST_MERGE_ROWS", "200000"),
                        ("CHUNK", str(1 << 21))):
        monkeypatch.setenv(f"KREEQ_TPU_{name}", value)
    for name in ("SOAK_REUSE", "SOAK_VCF_SLICE", "BUILD_CKPT"):
        monkeypatch.delenv(f"KREEQ_TPU_{name}", raising=False)
    soak.main([str(wd), "1.002", "10"])
    last = capsys.readouterr().out.splitlines()[-1]
    rec = json.loads(last.split(" ", 1)[1])
    assert rec["soak"] == "complete" and rec["mbp"] == 1.002
    assert rec["coverage"] == 10
    assert all(p["attempts"] == 1 for p in rec["phases"].values())
    assert sorted(rec["phases"]) == ["bkwig", "build", "qv", "vcf"]
    found, total = rec["recall"]
    assert total == 500 and found == total - len(rec["missed"])
    assert all(m[3] == 0 for m in rec["missed"])
    assert rec["ckpt_parts"] >= 2 and rec["ckpt_merges"] >= 1
    assert rec["host_merges"]["build"] >= 1
    assert rec["table_windows"] == [
        "table of 1001521 rows held on the host in 3 windows"]
    assert "soak.log" in os.listdir(wd)
    # the JAX CLI on the same files
    monkeypatch.delenv("KREEQ_TPU_MAX_TABLE_ROWS")
    monkeypatch.delenv("KREEQ_TPU_HOST_MERGE_ROWS")
    want = _jax_stdout(["kreeq", "validate", "-d", "soak.kreeq", "-f",
                        "asm.fasta", "-o", "jax.bkwig"], wd)
    assert (wd / "phase_qv.out").read_text() == want
    assert (wd / "asm.bkwig").read_bytes() == (wd / "jax.bkwig").read_bytes()
    _jax_stdout(["kreeq", "validate", "-d", "soak.kreeq", "-f",
                 "asm10.fasta", "-o", "jax.vcf", "--search-depth", "50",
                 "--max-span", "32"], wd)
    assert (wd / "asm10.vcf").read_bytes() == (wd / "jax.vcf").read_bytes()
    assert soak.recall(str(wd), 1.002, 1_002_000)[:3] == (
        rec["vcf_rows"], found, total)
