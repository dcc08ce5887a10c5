"""PyTorch port, whole slice: `validate -r reads -f asm` through the
port's CLI on the CPU must print byte for byte what the JAX package's
CLI prints, on generated inputs with planted SNV/INS/DEL, IUPAC bases,
an N run, a segment shorter than k, several read chunks and validate
window seams."""

import contextlib
import io

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
