"""PyTorch port, whole slices through the CLIs on the CPU: `validate -r
reads [-f asm]`, every ported output (-o x.bed/csv/csvtable/kwig/bkwig/
hist/kreeq/vcf/gfa/gfa2/gfa.gz, `-o vcf` to stdout, --detect-anomalies),
DB reuse (-d), `union` with its fatal paths and the bkwig decompressor
must print and write byte for byte what the JAX package's CLIs do, on
generated inputs with planted SNV/INS/DEL, IUPAC bases, an N run, a
segment shorter than k, several read chunks and validate window
seams."""

import contextlib
import gzip
import io
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CHUNK = 4096  # bases per read chunk: several chunks and tree merges
WINDOW = 777  # positions per validate window: seams inside segments


def _write_inputs(tmp_path, seed):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 2000))
    reads = []
    for s in rng.integers(0, 1900, 100):
        r = list(genome[s:s + 100])
        for j in np.nonzero(rng.random(100) < 0.003)[0]:
            r[j] = "ACGT"[("ACGT".index(r[j]) + 1) % 4]
        reads.append("".join(r))
    rp = tmp_path / "reads.fq"
    # FASTQ under 8 chunks of bytes, so the JAX build stays on one device
    rp.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    asm = list(genome[:1800])
    asm[300] = "ACGT"[("ACGT".index(asm[300]) + 2) % 4]  # SNV
    # SNV pairs k + 1 apart (k = 21, 31, 32): the k-mer between them is
    # found, but neither of its neighbours is (edge-missing)
    for x, d in ((400, 22), (550, 32), (700, 33)):
        for y in (x, x + d):
            asm[y] = "ACGT"[("ACGT".index(asm[y]) + 1) % 4]
    asm.insert(900, "T")  # INS
    del asm[1400]  # DEL
    asm[1000:1003] = "RYK"  # IUPAC bases
    asm[1200:1210] = "N" * 10  # N run: splits the path into segments
    ap = tmp_path / "asm.fa"
    ap.write_text(">chr1 planted\n" + "".join(asm[:1500]) + "\n"
                  + "".join(asm[1500:]) + "\n>tiny\nACGTACGTAC\n"
                  + ">chr2\n" + genome[1500:1990] + "\n")
    return str(rp), str(ap)


def _stdout(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("opts", [[], ["-k", "31", "-c", "2"],
                                  ["-k", "32"]])
def test_validate_stdout_matches_jax(tmp_path, monkeypatch, opts):
    from kreeq_tpu.cli.main import run as jax_run
    from kreeq_tpu.core.dbg import DBG as JaxDBG
    from kreeq_tpu_torch.cli.main import run
    from kreeq_tpu_torch.core.dbg import DBG

    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("KREEQ_TPU_CHUNK", str(CHUNK))
    monkeypatch.setattr(JaxDBG, "VALIDATE_WINDOW", WINDOW)
    monkeypatch.setattr(DBG, "VALIDATE_WINDOW", WINDOW)
    rp, ap = _write_inputs(tmp_path, len(opts))
    argv = ["kreeq", "validate", "-r", rp, "-f", ap, *opts]
    want = _stdout(jax_run, argv)
    assert "Kreeq" in want and "Distinct kmers" in want
    merqury, kreeq = (int(line.split("\t")[0])
                      for line in want.splitlines()[-2:])
    assert 0 < merqury < kreeq  # planted differences, edge-missing too
    assert _stdout(run, argv) == want


def test_reads_only_prints_db_summary(tmp_path, monkeypatch):
    from kreeq_tpu.cli.main import run as jax_run
    from kreeq_tpu_torch.cli.main import run

    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("KREEQ_TPU_CHUNK", str(CHUNK))
    rp, _ap = _write_inputs(tmp_path, 0)
    argv = ["kreeq", "validate", "-r", rp]
    assert _stdout(run, argv) == _stdout(jax_run, argv)


def _same_output(got, want):
    """A file or a `.kreeq` directory, byte for byte; or both absent."""
    assert os.path.exists(got) == os.path.exists(want)
    if os.path.isdir(want):
        names = sorted(os.listdir(want))
        assert sorted(os.listdir(got)) == names and names
        for name in names:
            _same_output(os.path.join(got, name), os.path.join(want, name))
    elif os.path.exists(want):
        with open(got, "rb") as g, open(want, "rb") as w:
            assert g.read() == w.read(), got


@pytest.fixture
def both(tmp_path, monkeypatch):
    """(jax_run, port_run) on the CPU at the small chunk and window."""
    from kreeq_tpu.cli.main import run as jax_run
    from kreeq_tpu.core.dbg import DBG as JaxDBG
    from kreeq_tpu_torch.cli.main import run
    from kreeq_tpu_torch.core.dbg import DBG

    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("KREEQ_TPU_CHUNK", str(CHUNK))
    monkeypatch.setattr(JaxDBG, "VALIDATE_WINDOW", WINDOW)
    monkeypatch.setattr(DBG, "VALIDATE_WINDOW", WINDOW)
    return jax_run, run


@pytest.mark.parametrize("ext", ["bed", "csv", "csvtable", "kwig", "bkwig",
                                 "hist", "kreeq"])
def test_validate_outputs_match_jax(tmp_path, both, ext):
    """`-o x.csv` writes no file in either package: the reference's
    output table has no csv entry."""
    jax_run, run = both
    rp, ap = _write_inputs(tmp_path, 3)
    outs = []
    for name, fn in (("jax", jax_run), ("port", run)):
        out = str(tmp_path / f"{name}.{ext}")
        argv = ["kreeq", "validate", "-r", rp, "-f", ap, "-o", out]
        outs.append((out, _stdout(fn, argv)))
    (want, want_stdout), (got, got_stdout) = outs
    assert got_stdout == want_stdout and "Kreeq" in want_stdout
    assert os.path.exists(want) == (ext != "csv")
    _same_output(got, want)


def test_db_reuse_matches_jax(tmp_path, both):
    """A DB written with -o x.kreeq is read back with -d: summary, QV
    table and per-base tracks as in the JAX package."""
    jax_run, run = both
    rp, ap = _write_inputs(tmp_path, 4)
    db = str(tmp_path / "reads.kreeq")
    _stdout(jax_run, ["kreeq", "validate", "-r", rp, "-k", "31", "-o", db])
    for extra in ([], ["-f", ap], ["-f", ap, "-c", "2"]):
        argv = ["kreeq", "validate", "-d", db, *extra]
        assert _stdout(run, argv) == _stdout(jax_run, argv)
    outs = [str(tmp_path / f"{name}.bkwig") for name in ("jax", "port")]
    for out, fn in zip(outs, (jax_run, run)):
        _stdout(fn, ["kreeq", "validate", "-d", db, "-f", ap, "-o", out])
    with open(outs[0], "rb") as fh:
        assert fh.read(1) == bytes([31])
    _same_output(outs[1], outs[0])


def test_union_matches_jax(tmp_path, both):
    jax_run, run = both
    dbs = []
    for seed in (0, 5):
        sub = tmp_path / f"s{seed}"
        sub.mkdir()
        rp, _ap = _write_inputs(sub, seed)
        dbs.append(str(sub / "r.kreeq"))
        _stdout(jax_run, ["kreeq", "validate", "-r", rp, "-o", dbs[-1]])
    argv = ["kreeq", "union", "-d", *dbs]
    assert _stdout(run, argv) == _stdout(jax_run, argv)
    outs = [str(tmp_path / f"{name}.kreeq") for name in ("jax", "port")]
    stdouts = [_stdout(fn, argv + ["-o", out])
               for out, fn in zip(outs, (jax_run, run))]
    assert stdouts[0] == stdouts[1] and "Distinct kmers" in stdouts[0]
    _same_output(outs[1], outs[0])


def _read_text(path):
    """A text output; a .gz one decompressed (its header holds a time)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return fh.read()


def _vcf_rows(text):
    return [line.split("\t") for line in text.splitlines()
            if line and not line.startswith("#")]


@pytest.mark.parametrize("k", ["21", "31", "32"])
@pytest.mark.parametrize("ext,opts", [
    ("vcf", []),
    ("vcf", ["--search-depth", "50", "--max-span", "32"]),
    ("gfa", []),
    ("gfa2", []),
    ("gfa.gz", []),
])
def test_variants_outputs_match_jax(tmp_path, both, k, ext, opts):
    """Candidate errors as VCF rows or as a bubble graph: no QV table on
    stdout, the same file."""
    jax_run, run = both
    rp, ap = _write_inputs(tmp_path, 9)
    outs = []
    for name, fn in (("jax", jax_run), ("port", run)):
        out = str(tmp_path / f"{name}.{ext}")
        argv = ["kreeq", "validate", "-r", rp, "-f", ap, "-k", k, "-o", out,
                *opts]
        outs.append((_stdout(fn, argv), _read_text(out)))
    (want_stdout, want), (got_stdout, got) = outs
    assert got_stdout == want_stdout and "Kreeq" not in want_stdout
    assert got == want
    if ext == "vcf":
        assert len(_vcf_rows(want)) >= 3  # the planted differences
    else:
        assert want.count("\nS\t") > 10  # segments split into bubbles


@pytest.mark.parametrize("k", ["21", "31", "32"])
def test_vcf_to_stdout_matches_jax(tmp_path, both, k):
    """`-o vcf` (no dot) streams the VCF to stdout, with no DB summary."""
    jax_run, run = both
    rp, ap = _write_inputs(tmp_path, 10)
    argv = ["kreeq", "validate", "-r", rp, "-f", ap, "-k", k, "-o", "vcf"]
    want = _stdout(jax_run, argv)
    assert want.startswith("##fileformat=VCF") and len(_vcf_rows(want)) >= 3
    assert _stdout(run, argv) == want


@pytest.mark.parametrize("k", ["21", "31", "32"])
def test_detect_anomalies_matches_jax(tmp_path, both, k):
    jax_run, run = both
    rp, ap = _write_inputs(tmp_path, 11)
    outs = []
    for name, fn in (("jax", jax_run), ("port", run)):
        out = str(tmp_path / f"{name}.anom.bed")
        argv = ["kreeq", "validate", "-r", rp, "-f", ap, "-k", k,
                "--detect-anomalies", out]
        outs.append((_stdout(fn, argv), _read_text(out)))
    (want_stdout, want), (got_stdout, got) = outs
    assert got_stdout == want_stdout and "Kreeq" in want_stdout
    assert got == want and want.count("\n") >= 4


@pytest.mark.parametrize("k", ["21", "31", "32"])
def test_db_reuse_vcf_matches_jax(tmp_path, both, k):
    """A DB written with -o x.kreeq, read back with -d for -o x.vcf."""
    jax_run, run = both
    rp, ap = _write_inputs(tmp_path, 12)
    db = str(tmp_path / "reads.kreeq")
    _stdout(jax_run, ["kreeq", "validate", "-r", rp, "-k", k, "-o", db])
    outs = []
    for name, fn in (("jax", jax_run), ("port", run)):
        out = str(tmp_path / f"{name}.vcf")
        outs.append((_stdout(fn, ["kreeq", "validate", "-d", db, "-f", ap,
                                  "-o", out]), _read_text(out)))
    assert outs[1] == outs[0] and len(_vcf_rows(outs[0][1])) >= 3


def test_iupac_variants_and_anomalies_match_jax(tmp_path, both):
    """The IUPAC case of tests/test_misc_features.py: k-mers holding the
    R are anomalous and never seed a search; the search from the last
    valid k-mer corrects the R."""
    jax_run, run = both
    left = "ACGGTTCAGCATGCGTTAGCATCGGATCCA"   # 30 bases
    right = "GTTCAACGGTCAGGCATTCCGAATGCCTT"   # 29 bases
    rp = tmp_path / "reads.fastq"
    rp.write_text("".join(f"@r{i}\n{left}A{right}\n+\n{'I' * 60}\n"
                          for i in range(4)))
    ap = tmp_path / "asm.fasta"
    ap.write_text(f">seqN\n{left}R{right}\n")
    outs = []
    for name, fn in (("jax", jax_run), ("port", run)):
        anom, vcf = (str(tmp_path / f"{name}.{e}") for e in ("bed", "vcf"))
        stdout = _stdout(fn, ["kreeq", "validate", "-f", str(ap), "-r",
                              str(rp), "--detect-anomalies", anom, "-o",
                              vcf])
        outs.append((stdout, _read_text(anom), _read_text(vcf)))
    assert outs[1] == outs[0]
    assert outs[0][1] == "seqN\t11\t31\n"
    assert [(r[0], r[1], r[3], r[4]) for r in _vcf_rows(outs[0][2])] == [
        ("seqN", "31", "R", "A")]


@pytest.mark.parametrize("ks,msg", [
    ((21, 22), "Cannot merge databases with different kmer length.\n"),
    ((33, 33), "Invalid kmer length.\n"),
])
def test_union_fatal_paths_match_jax(tmp_path, both, capsys, ks, msg):
    """Reference: src/input.cpp:137-145."""
    dbs = []
    for name, k in zip("ab", ks):
        d = tmp_path / f"{name}.kreeq"
        d.mkdir()
        (d / ".index").write_text(f"{k}\n128\n")
        dbs.append(str(d))
    for fn in both:
        with pytest.raises(SystemExit) as exc:
            fn(["kreeq", "union", "-d", *dbs])
        assert exc.value.code == 1
        assert capsys.readouterr().err == msg


@pytest.mark.parametrize("name,value,ext", [
    ("KREEQ_TPU_MAX_TABLE_ROWS", "300", "bkwig"),
    ("KREEQ_TPU_MAX_TABLE_ROWS", "300", "vcf"),
    ("KREEQ_TPU_HOST_MERGE_ROWS", "800", "kreeq"),
    ("KREEQ_TPU_BUILD_CKPT", "ckpt", "kreeq"),
    ("KREEQ_TPU_FORCE_SHARDED", "1", "kreeq"),
])
def test_ported_switch_matches_jax(tmp_path, both, monkeypatch, name, value,
                                   ext):
    """The out-of-core, resume and sharding switches, set as the JAX
    package takes them: `validate -r -f -o x.ext` prints and writes what
    the JAX CLI does under the same switch (and BUILD_CKPT leaves the
    same checkpoint directory).  FORCE_SHARDED shards the JAX build over
    its 8 devices; the port's process alone has no group to shard over
    (tests/test_torch_multihost.py launches several)."""
    jax_run, run = both
    rp, ap = _write_inputs(tmp_path, 0)
    outs = []
    for pkg, fn in (("jax", jax_run), ("port", run)):
        ckpt = str(tmp_path / f"{pkg}.ckpt")
        monkeypatch.setenv(name, ckpt if name.endswith("CKPT") else value)
        out = str(tmp_path / f"{pkg}.{ext}")
        outs.append((out, _stdout(fn, ["kreeq", "validate", "-r", rp, "-f",
                                       ap, "-o", out]), ckpt))
    (want, want_stdout, want_ckpt), (got, got_stdout, got_ckpt) = outs
    assert got_stdout == want_stdout and "DBG Summary" in want_stdout
    _same_output(got, want)
    assert os.path.isdir(want_ckpt) == name.endswith("CKPT")
    _same_output(got_ckpt, want_ckpt)


@pytest.mark.parametrize("name,value", [
    ("KREEQ_TPU_BUILD_CKPT", ""), ("KREEQ_TPU_MAX_TABLE_ROWS", ""),
    ("KREEQ_TPU_HOST_MERGE_ROWS", ""), ("KREEQ_TPU_FORCE_SHARDED", ""),
    ("KREEQ_TPU_FORCE_SHARDED", "0")])
def test_switch_value_jax_ignores_runs(tmp_path, monkeypatch, name, value):
    """A switch set to a value the JAX package does not act on (empty,
    or FORCE_SHARDED other than "1") is not refused: the run prints
    what it prints without the switch."""
    from kreeq_tpu_torch.cli.main import run

    reads, asm = _write_inputs(tmp_path, 0)
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    argv = ["kreeq", "validate", "-r", reads, "-f", asm]
    want = _stdout(run, argv)
    monkeypatch.setenv(name, value)
    assert _stdout(run, argv) == want


@pytest.fixture(scope="module")
def bkwig(tmp_path_factory):
    """A .bkwig written by the JAX CLI, and a coordinate file."""
    from kreeq_tpu.cli.main import run as jax_run
    from kreeq_tpu.core.dbg import DBG as JaxDBG

    tmp = tmp_path_factory.mktemp("bkwig")
    rp, ap = _write_inputs(tmp, 6)
    out = str(tmp / "asm.bkwig")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KREEQ_TPU_CHUNK", str(CHUNK))
        mp.setattr(JaxDBG, "VALIDATE_WINDOW", WINDOW)
        _stdout(jax_run, ["kreeq", "validate", "-r", rp, "-f", ap, "-o",
                          out])
    coords = tmp / "coords.bed"
    coords.write_text("chr1\t40\t90\nchr2\t7\t30\nchr1\t1300\t1350\n")
    return out, str(coords)


@pytest.mark.parametrize("args", [
    ["inflate"],
    ["inflate", "--expand"],
    ["lookup", "chr1:100-180", "chr2:5-60", "-s", "3"],
    ["lookup", "-c", "COORDS", "--expand", "-s", "2"],
])
def test_decompressor_matches_jax(bkwig, args):
    from kreeq_tpu.cli.decompressor import run as jax_run
    from kreeq_tpu_torch.cli.decompressor import run

    path, coords = bkwig
    argv = ["kreeq-decompressor", args[0], "-i", path,
            *(coords if a == "COORDS" else a for a in args[1:])]
    want = _stdout(jax_run, argv)
    assert want.count("\n") > 40
    assert _stdout(run, argv) == want
