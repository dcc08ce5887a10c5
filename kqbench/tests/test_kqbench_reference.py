"""The plain reference against hand-built cases, and against the
program's CLI on the CPU at a tiny size."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from kqbench import gen, spec
from kqbench.reference import expected, kmers, outputs, table_of
from kqbench.reference.validate import paths_of, score

from kq_tiny import LONG_READS, SHORT_READS, config


def codes(s: str) -> np.ndarray:
    return kmers.CTOI[np.frombuffer(s.encode(), np.uint8)]


def reads_of(*seqs):
    c = [codes(s) for s in seqs]
    offsets = np.zeros(len(c) + 1, np.int64)
    np.cumsum([len(x) for x in c], out=offsets[1:])
    return np.concatenate(c) if c else np.zeros(0, np.uint8), offsets


def packed(s: str) -> int:
    return sum("ACGT".index(b) << (2 * i) for i, b in enumerate(s))


def revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.mark.parametrize("s", ["ACG", "TTT", "GATTACA", "CGCGAAT"])
def test_canonical_key(s):
    w = kmers.windows(codes(s), len(s))
    fw, rc = packed(s), packed(revcomp(s))
    assert int(w.key[0]) == min(fw, rc)
    assert bool(w.isfw[0]) == (fw <= rc)


def test_edge_bits_and_counts():
    # ACGTT, k = 3: ACG (fw; next T), CGT (rc ACG; its base before is
    # the complement of the next, A), GTT (rc AAC; prev C -> next G)
    reads, offsets = reads_of("ACGTT")
    t = table_of(reads, offsets, 3)
    rows = {int(key): i for i, key in enumerate(t.keys)}
    acg = rows[packed("ACG")]
    assert t.cov[acg] == 2  # ACG and CGT
    # ACG: next T (fw[3]); CGT read as ACG: the base before ACG is the
    # complement of the base after CGT, T -> A (bw[0]), and the base
    # after ACG is the complement of the base before CGT, A -> T (fw[3])
    assert list(t.fw[acg]) == [0, 0, 0, 2]
    assert list(t.bw[acg]) == [1, 0, 0, 0]
    aac = rows[packed("AAC")]
    assert t.cov[aac] == 1
    # GTT read as AAC: the base after AAC is the complement of G's
    # neighbour before GTT, C -> G (fw[2]); nothing after GTT
    assert list(t.fw[aac]) == [0, 0, 1, 0]
    assert list(t.bw[aac]) == [0, 0, 0, 0]


def test_counts_past_255_and_the_control():
    # ACGTA and TACGT are one canonical key
    reads, offsets = reads_of(*["ACGTACGAT"] * 300)
    t = table_of(reads, offsets, 5)
    assert int(t.cov.max()) == 600
    assert int(t.saturated(kmers.U8_MAX).cov.max()) == 255
    parts, _f, _facts = outputs(t, [("x", b"ACGTACGAT")], ["summary"], {})
    assert "Total kmers: 1500\n" in parts["summary"]


def test_short_reads_and_n_runs():
    # a read shorter than k adds nothing; an N breaks windows and edges
    reads, offsets = reads_of("ACG", "AAAAANCCCCC", "")
    t = table_of(reads, offsets, 5)
    assert sorted(int(k) for k in t.keys) == sorted(
        min(packed(s), packed(revcomp(s))) for s in ("AAAAA", "CCCCC"))
    assert int(t.fw.sum() + t.bw.sum()) == 0
    assert list(t.cov) == [1, 1]


def test_segments_gaps_and_iupac():
    recs = [("p", b"ACGTA" + b"NNN" + b"CCGTAR" + b"nn" + b"GG")]
    paths = paths_of(recs)
    assert [(pos, seq) for pos, seq in paths[0].segments] == [
        (0, b"ACGTA"), (8, b"CCGTAR"), (16, b"GG")]
    reads, offsets = reads_of("ACGTA", "CCGTA")
    t = table_of(reads, offsets, 3)
    sc = score(t, recs, tracks=True)
    # windows: 3 + 4 + 0; the one with R is missing
    assert sc.kcount == 7 and sc.missing == 1
    assert [len(x) for x in sc.tracks] == [5, 6, 2]
    # coverage by brute force: ACG and CGT are one key
    cov = {}
    for r in ("ACGTA", "CCGTA"):
        for j in range(len(r) - 2):
            w = r[j:j + 3]
            key = min(packed(w), packed(revcomp(w)))
            cov[key] = cov.get(key, 0) + 1
    seg = "CCGTA"
    want = [cov[min(packed(seg[j:j + 3]), packed(revcomp(seg[j:j + 3])))]
            for j in range(3)]
    assert list(sc.tracks[1][:, 0]) == want + [0, 0, 0]


def test_bkwig_layout():
    recs = [("ab", b"ACGTNNACG")]
    reads, offsets = reads_of("ACGT", "ACG")
    parts, files, facts = expected(reads, offsets, recs, 3, ["summary", "qv"],
                                   {"x.bkwig": "bkwig"})
    b = files["x.bkwig"]
    assert b[0] == 3
    assert struct.unpack_from("<IH", b, 1) == (1, 2)
    assert b[7:9] == b"ab"
    assert struct.unpack_from("<I", b, 9)[0] == 2
    assert struct.unpack_from("<QQB", b, 13) == (0, 4, 1)
    assert struct.unpack_from("<QQB", b, 30) == (6, 3, 1)
    assert len(b) == 47 + 12 * 7
    assert facts["asm_windows"] == 3
    assert parts["qv"].splitlines()[1].startswith("0\t3\tinf\t0\t3\tMerqury")


@pytest.mark.parametrize("reads", [SHORT_READS, LONG_READS],
                         ids=["short", "long"])
def test_reference_matches_the_program_on_the_cpu(tmp_path, reads):
    inp = gen.make(config(reads), 23, str(tmp_path))
    parts, files, _facts = expected(inp.reads, inp.offsets, inp.records, 21,
                                    ["summary", "qv"], {"asm.bkwig": "bkwig"})
    env = dict(os.environ, KREEQ_TPU_PLATFORM="cpu",
               PYTHONPATH=spec.ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "kreeq_tpu_torch.cli.main", "validate", "-r",
         inp.files["reads"], "-f", inp.files["asm"], "-k", "21", "-o",
         str(tmp_path / "asm.bkwig")], env=env, capture_output=True,
        text=True, check=True)
    assert out.stdout == "".join(parts.values())
    assert (tmp_path / "asm.bkwig").read_bytes() == files["asm.bkwig"]
