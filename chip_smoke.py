#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kreeq_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Phases, each of which raises on failure (the process then exits
non-zero and never prints the final line):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compile the CUDA kernels from ops/csrc/ with nvcc;
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes: the build's extraction + sort + count + merge
     on the card, timed;
     the same build again with every merge exact against the plain
     version and timed with CUDA events (the sum of the kernel's times
     and of its bound); the sort (sort_records) on the first 8M-base
     read chunk's records, with a poly-A pile of 10^6 records and on as
     many random canonical keys, each beside torch.sort of its keys;
     count_runs on that chunk, as it is, with a poly-A pile of 10^6
     records and as sorted random keys (every tile full of heads); the
     build's largest merge; the table's bucket
     directory (bits, build time, mean and largest bucket); one full
     4,194,304-position validate window for each validate probe and
     one full variants window of per-position sentinel keys for the
     generic probe, all three through the directory, also at 20, 21 and
     22 bits, and B3 and B5 on a table with a 10^6-row poly-A pile; the
     extraction (kmer_extract) on the first read chunk (records and
     count forms) and on the validate window (qv and track forms);
     exact equality, median device times (torch.profiler: the card's
     own time a call, over runs of 10 calls), each beside its bound (the bytes these inputs need at 3.35 TB/s: a SENTINEL row's
     key only) and, for the probes, the sector floor (the sectors their
     reads touch, per array, counted once);
  4. end to end: `kreeq validate -r reads.fq -f asm.fa -k 21` through
     the port's CLI on the card, on a generated yeast-scale assembly
     (planted SNV/INS/DEL, an N run, IUPAC bases, short contigs) and
     30x of 150-bp reads at 0.2% substitutions; every kernel of the path
     must have launched, the extraction once a read chunk and once a
     QV window (B1's launches plus B3's), the sort once a read chunk
     (B1's launches), and Total must equal the assembly's k-mer count;
  5. the whole slice at 0.5 Mbp on the card and on the CPU (plain
     versions), with 4,096-position variants windows: stdout and every
     output file (-o x.kreeq, x.bed, x.kwig, x.bkwig, x.hist, `union`,
     --detect-anomalies; -o x.vcf, x.gfa, x.gfa2, x.gfa.gz and the
     `subgraph` runs (best-first, traversal, --no-collapse
     --no-reference --search-depth 5, -p) on the first 100 kbp, since
     the host search of every branch point runs twice per output) must
     be byte-equal, .gz files after decompression;
  6. DB reuse with per-base tracks, end to end on phase 4's inputs:
     `validate -r reads.fq -k 21 -o reads.kreeq`, then `validate -d
     reads.kreeq -f asm.fa -o asm.bkwig`, then the decompressor's
     `inflate`; the QV rows must equal phase 4's, the .bkwig must hold
     12 bytes per assembly base after its index, and every kernel of
     each path must have launched;
  7. only with --profile DIR: a cProfile of `write_kreeq` on phase 6's
     DB, loaded back onto the card (the rewritten DB must be
     byte-equal), and a torch.profiler trace of a second, warm `-d -f -o
     asm.bkwig` run; summaries and the trace go to DIR;
  8. the variants path against phase 6's DB: `validate -d reads.kreeq
     -f asm.fa --detect-anomalies asm.anom.bed` on the whole assembly
     (QV rows must equal phase 4's; the generic probe's calls timed
     with CUDA events and summed), then `validate -d reads.kreeq -f
     chr2_1mbp.fa -o asm.vcf` on the first 1,000,000 bases of chr2 (the
     host search of every branch point bounds its size; the table and
     the scan window are full size): the VCF must have rows, each REF
     must equal the assembly at its POS, and the generic probe must have
     launched on both paths;
  9. subgraph mode against phase 6's DB on the same 1,000,000 bases of
     chr2: `subgraph -d reads.kreeq -f chr2_1mbp.fa --traversal-algorithm
     traversal -o sub.gfa2`, then the default best-first `-o sub.gfa`;
     per traversal round the new nodes and the survivor scan's and the
     probe's milliseconds (CUDA events), the best-first boundary sources
     and their host search seconds; the GFA's S and L/E lines must match
     stdout's segment and edge counts, at least 90% of the cut's k-mers
     must be blue seed nodes, and the generic probe must have launched.
 10. out of core, on phase 4's reads and assembly and phase 6's DB,
     with KREEQ_TPU_MAX_TABLE_ROWS = 10^7 (3 windows of the
     24,756,385-row table, held on the host) and
     KREEQ_TPU_HOST_MERGE_ROWS = 2 * 10^7: (a) `validate -r -f` (stdout
     equal to phase 4's; B1, B2 and B4 launched, a merge on the host),
     (b) `-d -f -o asm.bkwig` (the DB loaded host-resident; the .bkwig
     equal to phase 6's), (c) --detect-anomalies (the BED equal to
     phase 8's; B5 once per window), (d) phase 8's VCF (equal), (e)
     subgraph traversal on 100 kbp of chr2, windowed and in core
     (equal GFA2), (f) KmerTable.merge of the DB with itself on the
     host (equal to the in-core merge), (g) a checkpointed build of 4
     parts killed after 2 and resumed (equal to (a)'s table); per step
     the wall, launches, peak device memory, each window's upload (ms,
     GB/s), directory and B4/B5 ms (CUDA events), host fold and
     classify s, each host merge's rows and s, each checkpoint write.
 11. several ranks, on phase 4's reads cut into 4 FASTQ files of
     unequal size, phase 4's assembly and phase 6's DB: (a) `validate
     -r r0.fq r1.fq r2.fq r3.fq -f asm.fa` as 2 ranks sharing the card
     over gloo (this script's --rank-worker processes, launched with
     KREEQ_TPU_COORDINATOR, _NUM_PROCESSES, _PROCESS_ID; rank 0's stdout
     equal to phase 4's, rank 1's empty), (b) build_table_distributed
     in a 1-rank NCCL group in this process (equal to phase 6's DB),
     and again under phase 10's caps (gathered into host memory
     through card buffers, the table on the host, equal too),
     (c) full_pipeline across the 2 ranks on a full validate window of
     chr1 (sums equal to B3's on one card; every B1 and B5 call exact
     against its plain version), (d) merge_sharded of the DB with
     itself (equal to phase 10 (f)'s in-core merge; B2 exact), (e) (a)
     under phase 10's caps (the table gathered into host memory, as
     it is only there); per rank the wall, chunks and rounds, records
     and bytes routed, route and gather ms (CUDA events), where the
     gather went, launches, peak device memory and backend.
 12. the golden harness and the warmup (cli/validate_runner.py,
     cli/generate_tests.py, cli/warmup.py): (a) a golden corpus made
     from --seed with every name the generator's matrix reads
     (write_corpus: 66 .tst; DBs, tracks and goldens written by the
     port on the CPU) run by the port's runner on the card with 4,096-
     base read chunks, so merges run: every .tst must PASS, rc 0; (b)
     one changed golden line must FAIL with rc 1; (c) phase 4's
     `validate -r reads.fq -f asm.fa` and `validate -d reads.kreeq -f
     asm.fa` on phase 6's DB, each a .tst whose line 2 names phase 4's
     stdout as the golden: both must PASS (walls beside phase 4's); (d)
     `kreeq warmup` at its default shapes in this process, where every
     kernel must launch, and as a fresh process (its wall).
 13. the entry points and the soak (entry.py, soak.py): (a)
     entry()'s step on the card (B1, B4), its four numbers equal to the
     same step on the CPU's plain versions; (b) dryrun_multichip(2), two
     ranks sharing the card over gloo (B1, B5); (c) cli_golden_sharded
     over phase 12's corpus on 2 ranks: its QV, union, subgraph and VCF
     .tst must pass; (d) `python -m kreeq_tpu_torch.soak` as
     subprocesses at 10 Mbp, 10x, k = 31, with the JAX soak's caps in
     the same ratio to the genome (MAX_TABLE_ROWS 5 * 10^6,
     HOST_MERGE_ROWS 2.5 * 10^6) and a 3 Mbp VCF slice: every phase in
     one attempt, every planted variant without a VCF row in a gap of
     the reads, and the DB, the QV stdout, the .bkwig and the VCF equal
     to the same commands run in core in this process.
 14. the bench (kreeq_tpu_torch/bench.py): `python -m
     kreeq_tpu_torch.bench` as a fresh process under its watchdog's
     deadline (KREEQ_TPU_BENCH_DEADLINE = 300 s): bench.py's count,
     QV-probe, track-probe and merge stages at bench.py's shapes, the
     CPU oracle built and run on this host; its last line must be
     complete (no "incomplete"), with a value above 0, every stage exact
     against its plain version, the QV window's #missing 0, and B1-B4
     launched.
 15. the path benches (kreeq_tpu_torch/bench_variants.py,
     bench_subgraph.py): each as a fresh process at its script's size
     (n = 1,000,000, k = 21), one after the other: it must exit 0 with
     the script's lines, the batched variants equal to the per-position
     loop, the batched traversal equal to the scalar loop (insertion
     order and fields), the prefiltered best-first equal to the
     exhaustive one in key order, and B5 launched and exact against its
     plain version at the scan window, the largest traversal round and
     the extraction, each timed beside its bound and sector floor.
The eighth-to-last line is a JSON object of phase 15's records, the
seventh-to-last the bench's last line (phase 14), the
sixth-to-last a JSON object of phase 13's records, the fifth-to-last
one of phase 12's, the fourth-to-last one of phase 10's, the
third-to-last one of phase 11's; the second-to-last one with each
kernel's launches (and its launches in phases 10-15),
error, times, bound and shape; the last is {"ok": true, "device":
{...}}.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import hashlib
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from kreeq_tpu_torch.ops.bounds import (bound_ms, compare, count_bound_ms,
                                        cuda_times, device_ms,
                                        extract_bound_ms, merge_bound_ms,
                                        probe_sorted_bound_ms,
                                        rows_floor_ms, sector_floor_ms,
                                        sort_bound_ms, sort_passes,
                                        sort_passes_ms, touched_rows)

K = 21
GENOME_MBP = 12.0  # yeast scale
COVERAGE = 30
READ_LEN = 150
SUB_RATE = 0.002
WINDOW = 1 << 22  # positions of one validate window (DBG.VALIDATE_WINDOW)
CHUNK = 1 << 23  # bases of one read chunk (KREEQ_TPU_CHUNK default)
# chromosome shares of the genome: ~3 Mbp each at 12 Mbp, the first one
# long enough for a full validate window and a window seam
CHROM_SHARES = (0.42, 0.25, 0.2, 0.13)
LUT = np.frombuffer(b"ACGTN", np.uint8)
CUT_CPU_VS_CUDA = 100_000  # bases of phase 5's variants outputs
CUT_VCF = 1_000_000  # bases of chr2 in phase 8's VCF run and phase 9
PILE = 1_000_000  # records of phase 3's poly-A run

# (name, LAUNCHES key, source, TPU kernel, the main path whose launches
# the JSON line reports: phase 4's `-r -f` run, phase 6's track run or
# phase 8's VCF run)
KERNELS = (
    ("count_runs", "count", "kreeq_tpu_torch/ops/csrc/count_runs.cu",
     "kreeq_tpu/ops/pallas_kernels.py:59", "validate"),
    ("merge_sorted", "merge", "kreeq_tpu_torch/ops/csrc/merge_sorted.cu",
     "kreeq_tpu/ops/pallas_kernels.py:1223", "validate"),
    ("probe_qv", "probe_qv", "kreeq_tpu_torch/ops/csrc/probe_qv.cu",
     "kreeq_tpu/ops/pallas_kernels.py:844", "validate"),
    ("probe_select", "probe_select",
     "kreeq_tpu_torch/ops/csrc/probe_select.cu",
     "kreeq_tpu/ops/pallas_kernels.py:696", "tracks"),
    ("probe_sorted", "probe_sorted",
     "kreeq_tpu_torch/ops/csrc/probe_sorted.cu",
     "kreeq_tpu/ops/pallas_kernels.py:342", "variants"),
    # the jitted extraction (XLA, not a pl.pallas_call); also
    # kreeq_tpu/ops/validate.py:131 and :214
    ("kmer_extract", "extract", "kreeq_tpu_torch/ops/csrc/kmer_extract.cu",
     "kreeq_tpu/ops/kmers.py:40", "validate"),
    # the count step's sort: jax.lax.sort in _sort_keys_edges (XLA)
    ("sort_records", "sort", "kreeq_tpu_torch/ops/csrc/sort_records.cu",
     "kreeq_tpu/ops/kmers.py:158", "validate"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# generated inputs


def make_inputs(rng, genome_mbp: float, coverage: float, path: str,
                k: int = K):
    """Write asm.fa and reads.fq under `path`.  Returns (fasta, fastq,
    read bases, the assembly's k-mer count)."""
    total = int(genome_mbp * 1e6)
    sizes = [int(total * s) for s in CHROM_SHARES]
    chroms = [rng.integers(0, 4, n).astype(np.uint8) for n in sizes]

    records = []
    for ci, truth in enumerate(chroms):
        asm = truth.copy()
        # about one SNV, INS or DEL per 10 kbp
        nvar = max(len(asm) // 10_000, 3)
        pos = rng.choice(len(asm) - 1, size=nvar, replace=False)
        kind = rng.integers(0, 3, nvar)
        snv = pos[kind == 0]
        asm[snv] = (asm[snv] + rng.integers(1, 4, len(snv))) % 4
        dele = set(pos[kind == 2].tolist())
        ins = pos[kind == 1]
        asm = np.insert(asm, ins, rng.integers(0, 4, len(ins)).astype(
            np.uint8))
        asm = np.delete(asm, sorted(i + int((ins < i).sum()) for i in dele))
        text = LUT[asm].copy()
        if ci == 0:
            # an N run near the end, so the segment before it still
            # holds a full validate window at 12 Mbp; IUPAC bases
            end = len(text) - len(text) // 20
            text[end:end + 500] = ord("N")
            for j, c in enumerate(b"RYKMSW"):
                text[len(text) // 2 + 997 * j] = c
        records.append((f"chr{ci + 1}", text.tobytes().decode()))
    # short contigs, one of them shorter than k
    for j, n in enumerate((900, 650, 300, k - 5)):
        c = chroms[j % len(chroms)]
        s = int(rng.integers(0, len(c) - n))
        records.append((f"ctg{j + 1}", LUT[c[s:s + n]].tobytes().decode()))

    fa = os.path.join(path, "asm.fa")
    with open(fa, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")
    kcount = sum(max(len(s) - k + 1, 0) for _n, seq in records
                 for s in re.split("[Nn]+", seq) if s)

    fq = os.path.join(path, "reads.fq")
    nreads = int(coverage * total / READ_LEN)
    head, mid = b"@r\n", b"\n+\n"
    row = len(head) + READ_LEN + len(mid) + READ_LEN + 1
    with open(fq, "wb") as fh:
        for ci, truth in enumerate(chroms):
            todo = int(nreads * sizes[ci] / total)
            while todo > 0:
                nb = min(todo, 200_000)
                todo -= nb
                starts = rng.integers(0, len(truth) - READ_LEN + 1, nb)
                reads = truth[starts[:, None] + np.arange(READ_LEN)]
                rc = rng.random(nb) < 0.5
                reads[rc] = 3 - reads[rc, ::-1]
                err = rng.random(reads.shape) < SUB_RATE
                reads[err] = (reads[err]
                              + rng.integers(1, 4, int(err.sum()))) % 4
                out = np.empty((nb, row), np.uint8)
                out[:, :3] = np.frombuffer(head, np.uint8)
                out[:, 3:3 + READ_LEN] = LUT[reads]
                out[:, 3 + READ_LEN:6 + READ_LEN] = np.frombuffer(mid,
                                                                  np.uint8)
                out[:, 6 + READ_LEN:6 + 2 * READ_LEN] = ord("I")
                out[:, -1] = ord("\n")
                fh.write(out.tobytes())
    read_bases = sum(int(nreads * n / total) for n in sizes) * READ_LEN
    return fa, fq, read_bases, kcount


def _mutate(rng, seq: str, snv: int, ins: int, dele: int) -> str:
    """`seq` with the planted SNV, then INS, then DEL at those offsets."""
    s = list(seq)
    s[snv] = "ACGT"[("ACGT".index(s[snv]) + 1 + int(rng.integers(0, 3)))
                    % 4]
    s.insert(ins, "ACGT"[int(rng.integers(0, 4))])
    del s[dele]
    return "".join(s)


def _reads(rng, genome: str, n: int, length: int, err: float) -> list:
    """`n` reads of `length` bases from random places of `genome`, half
    reverse-complemented, with substitutions at rate `err`."""
    g = np.frombuffer(genome.encode(), np.uint8)
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), g)
    starts = rng.integers(0, len(codes) - length + 1, n)
    reads = codes[starts[:, None] + np.arange(length)]
    rc = rng.random(n) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    hit = rng.random(reads.shape) < err
    reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return [LUT[r].tobytes().decode() for r in reads]


def write_corpus(root: str, seed: int, cli) -> None:
    """A golden-corpus tree under `root`: testFiles/ with every name the
    matrix of cli/generate_tests.py reads, and an empty validateFiles/.

    Assemblies and reads come from `seed`: random1 (FASTA, .fasta.gz,
    a GFA with a path, links and a segment outside it), random1/2
    FASTQ and .fastq.gz, random2.fasta, random3 (.fasta and .fasta.gz:
    IUPAC bases, an N run, a contig shorter than k), random5/11/12
    FASTA and FASTQ, random6-10 FASTQ,
    to_correct FASTA and FASTQ (a planted SNV, INS and DEL), and
    decompressor1.fasta.  `cli(argv)` writes the DBs (test1, test2 and
    random5-12.kreeq; random11 at k = 31, random12 at k = 32) and the
    two .bkwig tracks, as the CLI a caller passes in.

    Ten of the files are validated (50 .tst), so test.50 is the union,
    whose 8 lines the KNOWN_DIFF pin of test.50's line 21
    (validate_runner.py) cannot touch."""
    rng = np.random.default_rng(seed)
    tf = os.path.join(root, "testFiles")
    os.makedirs(tf)
    os.makedirs(os.path.join(root, "validateFiles"))

    def path(name: str) -> str:
        return os.path.join(tf, name)

    def genome(n: int) -> str:
        return LUT[rng.integers(0, 4, n)].tobytes().decode()

    def fasta(name: str, records) -> None:
        text = "".join(f">{h}\n{s}\n" for h, s in records)
        with open(path(name), "w") as fh:
            fh.write(text)

    def fastq(name: str, reads) -> None:
        text = "".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                       for i, r in enumerate(reads))
        with open(path(name), "w") as fh:
            fh.write(text)

    def gz(name: str) -> None:
        with open(path(name), "rb") as src, \
                gzip.open(path(name + ".gz"), "wb") as dst:
            dst.write(src.read())

    g1 = genome(1600)
    asm1 = _mutate(rng, g1[:1500], 300, 700, 1100)
    fasta("random1.fasta", [("chr1", asm1[:900]), ("chr2", asm1[900:])])
    with open(path("random1.gfa"), "w") as fh:
        fh.write(f"H\tVN:Z:1.2\nS\tseg1\t{asm1[:700]}\nS\tseg2\t"
                 f"{asm1[700:1300]}\nS\tseg3\t{asm1[1300:]}\n"
                 "L\tseg1\t+\tseg2\t+\t0M\nL\tseg2\t+\tseg3\t-\t0M\n"
                 "P\tpath1\tseg1+,seg2+\t*\n")
    fastq("random1.fastq", _reads(rng, g1, 160, 100, 0.004))
    fastq("random2.fastq", _reads(rng, g1, 120, 100, 0.01))
    fasta("random2.fasta", [("ctg1", _mutate(rng, g1[200:1000], 50, 400,
                                             700)), ("ctg2", g1[1000:])])
    iupac = list(_mutate(rng, g1[100:1300], 200, 500, 900))
    iupac[400:403] = "RYK"
    iupac[800:812] = "N" * 12
    fasta("random3.fasta", [("seq1", "".join(iupac)),
                            ("tiny", g1[:15]), ("seq2", g1[1300:1560])])
    for name in ("random1.fasta", "random1.fastq", "random2.fastq",
                 "random3.fasta"):
        gz(name)

    # subgraph DBs: random5 at several depths and error rates (random9
    # and random10 hold a second haplotype too), random11 and 12 at
    # k = 31 and 32
    g5 = genome(700)
    fasta("random5.fasta", [("scaffold1", _mutate(rng, g5, 150, 350, 520))])
    g5b = _mutate(rng, g5, 250, 450, 600)
    for i, (n, err, alt) in enumerate(((70, 0.002, 0), (30, 0.01, 0),
                                       (120, 0.005, 0), (50, 0.0, 0),
                                       (60, 0.003, 30), (90, 0.008, 60)),
                                      start=5):
        reads = _reads(rng, g5, n, 100, err)
        reads += _reads(rng, g5b, alt, 100, err) if alt else []
        fastq(f"random{i}.fastq", reads)
    for i in (11, 12):
        g = genome(600)
        fasta(f"random{i}.fasta", [(f"ctg{i}", _mutate(rng, g, 120, 300,
                                                       450))])
        fastq(f"random{i}.fastq", _reads(rng, g, 80, 100, 0.003))

    g6 = genome(1200)
    fasta("to_correct.fasta",
          [("sequence1", _mutate(rng, g6[:700], 200, 400, 600)),
           ("sequence2", g6[700:])])
    fastq("to_correct.fastq", _reads(rng, g6, 240, 100, 0.0))
    fasta("decompressor1.fasta", [("chr1", asm1[:900]),
                                  ("chr2", asm1[900:])])
    with open(path("decompressor1.bed"), "w") as fh:
        fh.write("chr1\t10\t60\nchr2\t100\t130\nchr1\t700\t720\n")

    dbs = [("test1", "random1", 21), ("test2", "random2", 21)]
    dbs += [(f"random{i}", f"random{i}", 21) for i in range(5, 11)]
    dbs += [("random11", "random11", 31), ("random12", "random12", 32)]
    for db, reads, k in dbs:
        cli(["kreeq", "validate", "-r", path(reads + ".fastq"), "-k",
             str(k), "-o", path(db + ".kreeq")])
    cli(["kreeq", "validate", "-r", path("random1.fastq"), "-f",
         path("decompressor1.fasta"), "-o", path("decompressor1.bkwig")])
    cli(["kreeq", "validate", "-r", path("random2.fastq"), "-f",
         path("random3.fasta"), "-o", path("decompressor2.bkwig")])


# ---------------------------------------------------------------------------
# helpers


def run_cli(argv):
    from kreeq_tpu_torch.cli.main import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run(argv)
    if rc != 0:
        raise AssertionError(f"{argv} returned {rc}")
    return buf.getvalue()


def check_launches(launches, keys, path: str) -> None:
    for key in keys:
        if launches[key] <= 0:
            raise AssertionError(f"kernel {key} never launched on the "
                                 f"{path} path")


def drive(argv, keys, name: str, device):
    """One CLI run as a main path: the launch counts and the variants and
    subgraph search counts are set to 0 just before it and read just
    after; every kernel in `keys` must have launched.  Returns (stdout,
    launches, phases, wall seconds, peak device GiB)."""
    import torch

    from kreeq_tpu_torch.core import subgraph, variants
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.utils import log as klog

    kernels.reset_launches()
    klog._phases.clear()
    variants.SEARCH_STATS.update(branch_points=0, search_s=0.0)
    subgraph.SUBGRAPH_STATS.update(seed=0, blue=0, rounds=[], sources=0,
                                   search_s=0.0)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = run_cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, keys, name)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    return out, launches, dict(klog._phases), wall, peak


def same_output(a: str, b: str) -> None:
    """A file or a `.kreeq` directory, byte for byte; a .gz file after
    decompression (its header holds a time)."""
    if os.path.isdir(a):
        names = sorted(os.listdir(a))
        if not names or names != sorted(os.listdir(b)):
            raise AssertionError(f"{a} and {b} hold other files")
        for name in names:
            same_output(os.path.join(a, name), os.path.join(b, name))
        return
    opener = gzip.open if a.endswith(".gz") else open
    with opener(a, "rb") as fa, opener(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{a} and {b} differ")


def head_fasta(src: str, dst: str, name: str, nbases: int) -> str:
    """Write the first `nbases` bases of record `name` of `src` (one line
    per record, as make_inputs writes) to `dst`; returns them."""
    with open(src) as fh:
        lines = fh.read().split("\n")
    seq = lines[lines.index(f">{name}") + 1][:nbases]
    with open(dst, "w") as fh:
        fh.write(f">{name}\n{seq}\n")
    return seq


# ---------------------------------------------------------------------------
# phases


def phase_card():
    import torch

    from kreeq_tpu_torch.bench import card_line

    # no number of this run may stand without the card's name and limit
    card = card_line()
    log(card)
    log(f"[1 card] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return card


def phase_build():
    from kreeq_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    _build.library()
    log(f"[2 build] nvcc build of ops/csrc in "
        f"{time.perf_counter() - t0:.1f} s")
    name = None
    for line in report.splitlines():
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)'", line)
        if m:
            name = m.group(2)[:int(m.group(1))]
        elif "registers" in line and name:
            log(f"    {name}: {line.split(':', 1)[1].strip()}")


@contextlib.contextmanager
def timed_calls(module, name: str, keep=lambda args, got: (args, got)):
    """Within the block, each call of module.<name> runs as it is between
    two CUDA events; yields the list of (keep(args, result), start, end)
    of the calls (read the events after a synchronize).  What `keep`
    returns stays alive until the list goes."""
    import torch

    wrapped = getattr(module, name)
    calls = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = wrapped(*args, **kwargs)
        end.record()
        calls.append((keep(args, got), start, end))
        return got

    setattr(module, name, timed)
    try:
        yield calls
    finally:
        setattr(module, name, wrapped)


def sort_record(kernels, Km, keys, edges, what: str) -> dict:
    """The sort kernel at k = K on (keys, edges), exact against its plain
    version (a stable torch.sort and the edge gather), then timed beside
    its bound, the plain version and the one library call, a stable
    torch.sort of the keys alone; logged, and returned as a kernels-line
    record."""
    import torch

    p = keys.shape[0]
    rec = dict(
        shape=f"P={p} k={K}, {sort_passes(K)} passes of 8-bit digits",
        bound_ms=sort_bound_ms(p),
        passes_ms=sort_passes_ms(p, K),
        max_abs_err=compare(f"sort_records ({what})",
                            kernels.sort_records_cuda(keys, edges, K),
                            Km.sort_keys_edges(keys, edges)),
        ms=device_ms(lambda: kernels.sort_records_cuda(keys, edges, K)),
        plain_ms=device_ms(lambda: Km.sort_keys_edges(keys, edges)),
        library_ms=device_ms(lambda: torch.sort(keys, stable=True)))
    log(f"    sort_records, {what}, {rec['shape']}: kernel {rec['ms']:.3f} "
        f"ms  plain {rec['plain_ms']:.3f} ms  torch.sort "
        f"{rec['library_ms']:.3f} ms  bound {rec['bound_ms']:.3f} ms "
        f"({rec['bound_ms'] / rec['ms']:.1%} of the kernel's time; its "
        f"passes' least traffic {rec['passes_ms']:.3f} ms)  exact")
    return rec


def phase_kernels(fq: str, fa: str, device):
    """Kernel against plain version at the main path's shapes."""
    import torch

    from kreeq_tpu_torch.config import UserInput
    from kreeq_tpu_torch.constants import KEY_BIAS
    from kreeq_tpu_torch.core.dbg import DBG
    from kreeq_tpu_torch.core.table import KmerTable, TreeMerger
    from kreeq_tpu_torch.core.variants import _extract_sentinel
    from kreeq_tpu_torch.io.fastx import iter_reads, load_genome
    from kreeq_tpu_torch.io.sequence import Genome
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops import kmers as Km
    from kreeq_tpu_torch.ops import validate as V
    from kreeq_tpu_torch.ops.index import bucket_index

    class CheckingMerger(TreeMerger):
        """Holds every merge of the build exactly against the plain
        version: TreeMerger.merge runs as it is, with the kernel's wrapper
        wrapped to time each call with CUDA events and keep its operands
        (the largest merge's for the timing below)."""

        def __init__(self):
            super().__init__(device)
            self.merges = []  # (na, nb, kernel ms, bound ms)
            self.largest = None

        def merge(self, stored, fresh):
            with timed_calls(kernels, "merge_sorted_cuda") as calls:
                got = super().merge(stored, fresh)
            if len(calls) != 1 or calls[0][0][1] is not got:
                raise AssertionError(f"TreeMerger.merge made {len(calls)} "
                                     f"kernel calls, not one")
            (args, _got), start, end = calls[0]
            end.synchronize()
            ms = start.elapsed_time(end)
            a, b = args[:4], args[4:]
            na, nb = a[0].shape[0], b[0].shape[0]
            compare(f"merge_sorted (merge {len(self.merges) + 1}, na={na} "
                    f"nb={nb})", got, Km.merge_sorted(*a, *b))
            self.merges.append((na, nb, ms, merge_bound_ms(a[0], b[0])))
            if self.largest is None or na + nb > sum(
                    t[0].shape[0] for t in self.largest):
                self.largest = (a, b)
            return got

    # the build of the main path, driven step by step: host ingest
    # first, then count and merge on the card
    t0 = time.perf_counter()
    bufs = list(Km.pack_reads(iter_reads(fq), K, CHUNK))
    t1 = time.perf_counter()

    def build(tm):
        for buf in bufs:
            tm.push(kernels.count_chunk_cuda(torch.from_numpy(buf).to(device),
                                             K))
        return KmerTable(K, *tm.finalize())

    table = build(TreeMerger(device))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[3 kernels] ingest (parse + pack, host) {t1 - t0:.2f} s for "
        f"{len(bufs)} chunks; count + merge on the card {t2 - t1:.2f} s; "
        f"{len(table)} rows")
    res = {"ingest_s": t1 - t0}

    # the same build again, every merge held against the plain version
    tm = CheckingMerger()
    again = build(tm)
    compare("the checked build's table", (again.keys, again.cov, again.fw,
                                          again.bw),
            (table.keys, table.cov, table.fw, table.bw))
    del again
    kms = sum(t[2] for t in tm.merges)
    bms = sum(t[3] for t in tm.merges)
    na, nb, lms, lbound = max(tm.merges, key=lambda t: t[0] + t[1])
    log(f"    {len(tm.merges)} merges of the build, each exact against the "
        f"plain version: kernel {kms:.3f} ms in all against a bound of "
        f"{bms:.3f} ms ({bms / kms:.1%}); the largest na={na} nb={nb} "
        f"{lms:.3f} ms (bound {lbound:.3f} ms)")

    # the first chunk's records, as the count step sorts them
    rkeys, redges = kernels.extract_cuda(torch.from_numpy(bufs[0]).to(
        device), K, "count")
    p = rkeys.shape[0]
    res["sort_records"] = sort_record(kernels, Km, rkeys, redges, "chunk")
    skeys, sedges = kernels.sort_records_cuda(rkeys, redges, K)
    res["count_runs"] = dict(
        shape=f"P={p}", bound_ms=count_bound_ms(skeys),
        max_abs_err=compare("count_runs", kernels.count_runs_cuda(
            skeys, sedges), Km.count_runs(skeys, sedges)),
        ms=device_ms(lambda: kernels.count_runs_cuda(skeys, sedges)),
        plain_ms=device_ms(lambda: Km.count_runs(skeys, sedges)))
    # the sort on a poly-A pile (the chunk's first PILE records one key,
    # all-A's, the least) and on P random canonical keys (all but surely
    # distinct)
    pkeys = rkeys.clone()
    pkeys[:PILE] = torch.iinfo(torch.int64).min
    sort_record(kernels, Km, pkeys, redges, f"poly-A pile of {PILE}")
    gen = torch.Generator(device=device).manual_seed(5)
    dkeys = KEY_BIAS + torch.randint(0, 4 ** K, (p,), device=device,
                                     generator=gen)
    sort_record(kernels, Km, dkeys, redges, "random keys")
    del pkeys, dkeys
    # long runs: the chunk's first PILE records become one poly-A run
    # (its key, code 0, is the least key, so the order holds)
    pkeys = skeys.clone()
    pkeys[:PILE] = torch.iinfo(torch.int64).min
    compare("count_runs (pile)", kernels.count_runs_cuda(pkeys, sedges),
            Km.count_runs(pkeys, sedges))
    log(f"    count_runs with a poly-A pile of {PILE} records, P={p}: "
        f"kernel {device_ms(lambda: kernels.count_runs_cuda(pkeys, sedges)):.3f}"
        f" ms  plain {device_ms(lambda: Km.count_runs(pkeys, sedges)):.3f} ms"
        f"  exact")
    # every tile full of heads: P sorted, all but surely distinct keys
    gen = torch.Generator(device=device).manual_seed(7)
    dkeys = torch.randint(0, 1 << 62, (p,), device=device,
                          generator=gen).sort().values
    compare("count_runs (distinct)", kernels.count_runs_cuda(dkeys, sedges),
            Km.count_runs(dkeys, sedges))
    log(f"    count_runs on {p} sorted random keys "
        f"({int(Km.count_runs(dkeys, sedges)[4])} distinct): kernel "
        f"{device_ms(lambda: kernels.count_runs_cuda(dkeys, sedges)):.3f} ms"
        f"  plain {device_ms(lambda: Km.count_runs(dkeys, sedges)):.3f} ms"
        f"  bound {count_bound_ms(dkeys):.3f} ms  exact")
    del pkeys, dkeys

    a, b = tm.largest
    res["merge_sorted"] = dict(
        shape=f"na={a[0].shape[0]} nb={b[0].shape[0]}",
        bound_ms=merge_bound_ms(a[0], b[0]),
        max_abs_err=compare("merge_sorted", kernels.merge_sorted_cuda(
            *a, *b), Km.merge_sorted(*a, *b)),
        ms=device_ms(lambda: kernels.merge_sorted_cuda(*a, *b)),
        plain_ms=device_ms(lambda: Km.merge_sorted(*a, *b)))
    del tm, a, b

    genome = Genome()
    load_genome(fa, genome)
    seg = max(genome.segments, key=len)
    kcount = len(seg) - K + 1
    if kcount < WINDOW:
        raise AssertionError(f"longest segment {len(seg)} < one window")
    dbg = DBG(UserInput(kmer_len=K), table)
    wbuf = torch.from_numpy(dbg._window_buf(seg.codes, 0, WINDOW,
                                            kcount)).to(device)
    qkeys, qctx = kernels.extract_cuda(wbuf, K, "qv")
    tab = (table.keys, table.cov, table.fw, table.bw)
    # the extraction at the main path's shapes: the first 8M-base read
    # chunk's records and count forms, one validate window's qv and track
    # forms
    chunk0 = torch.from_numpy(bufs[0]).to(device)
    ext = {}
    for form, codes in (("records", chunk0), ("count", chunk0),
                        ("qv", wbuf), ("track", wbuf)):
        plain = kernels.plain_extract(form)
        ext[form] = dict(
            shape=f"{form} N={codes.shape[0]} k={K}",
            bound_ms=extract_bound_ms(codes.shape[0], K, form),
            max_abs_err=compare(f"kmer_extract ({form})",
                                kernels.extract_cuda(codes, K, form),
                                plain(codes, K)),
            ms=device_ms(lambda: kernels.extract_cuda(codes, K, form)),
            plain_ms=device_ms(lambda: plain(codes, K)))
    del codes, chunk0
    res["kmer_extract"] = dict(ext["records"], forms={
        form: ext[form] for form in ("count", "qv", "track")})
    for form in ("count", "qv", "track"):
        r = ext[form]
        log(f"    kmer_extract {r['shape']}: kernel {r['ms']:.3f} ms  plain "
            f"{r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms "
            f"({r['bound_ms'] / r['ms']:.1%} of the kernel's time)  exact")
    # the validate probes' bucket directory, as the CLI builds it: once
    # per table, on the table (KmerTable.bucket_index)
    index = table.bucket_index()
    starts = index[0]
    bits = (starts.shape[0] - 1).bit_length() - 1
    sizes = starts[1:] - starts[:-1]
    log(f"    bucket directory: {bits} bits, {starts.shape[0]} int64 "
        f"entries; build {device_ms(lambda: bucket_index(table.keys, K)):.3f}"
        f" ms; rows a bucket: mean {len(table) / sizes.shape[0]:.2f}, "
        f"largest {int(sizes.max())}")
    window = (qkeys[1:1 + WINDOW], qctx[1:1 + WINDOW])
    args = (*tab, qkeys, qctx, 1, 1 + WINDOW, 0)
    # queries (key, ctx); per found row its key, cov and the two selected
    # counters; two int64 sums out
    res["probe_qv"] = dict(
        shape=f"q={WINDOW} t={len(table)} bits={bits}",
        bound_ms=bound_ms(9 * WINDOW + 32 * touched_rows(
            table.keys, qkeys[1:1 + WINDOW]) + 16),
        sector_ms=sector_floor_ms(table.keys, index, *window,
                                  9 * WINDOW + 16),
        max_abs_err=compare("probe_qv", (kernels.probe_qv_cuda(
            *args, index),), (V.qv_sums(*args),)),
        ms=device_ms(lambda: kernels.probe_qv_cuda(*args, index)),
        plain_ms=device_ms(lambda: V.qv_sums(*args)))
    # the track path probes every position of the window buffer: the
    # window plus one position of context on each side
    skeys, _isfw, _valid, sctx = kernels.extract_cuda(wbuf, K, "track")
    sargs = (*tab, skeys, sctx)
    q = skeys.shape[0]
    # queries; per found row key, cov and two counters; found, cov,
    # right, left out
    res["probe_select"] = dict(
        shape=f"q={q} t={len(table)} bits={bits}",
        bound_ms=bound_ms(9 * q + 32 * touched_rows(table.keys, skeys)
                          + 25 * q),
        sector_ms=sector_floor_ms(table.keys, index, skeys, sctx, 34 * q),
        max_abs_err=compare("probe_select",
                            kernels.probe_select_cuda(*sargs, index),
                            V.probe_select(*sargs)),
        ms=device_ms(lambda: kernels.probe_select_cuda(*sargs, index)),
        plain_ms=device_ms(lambda: V.probe_select(*sargs)))
    # the variants scan probes one window of positions, invalid windows
    # carrying their per-position sentinels
    vbuf = torch.from_numpy(seg.codes[:WINDOW + K - 1]).to(device)
    vkeys, _visfw, _vvalid = _extract_sentinel(vbuf, K)
    vargs = (*tab, vkeys)
    vq = vkeys.shape[0]
    res["probe_sorted"] = dict(
        shape=f"q={vq} t={len(table)} bits={bits}",
        bound_ms=probe_sorted_bound_ms(table.keys, vkeys),
        sector_ms=rows_floor_ms(table.keys, index, vkeys, 81 * vq),
        max_abs_err=compare("probe_sorted",
                            kernels.probe_sorted_cuda(*vargs, index),
                            Km.probe_sorted(*vargs)),
        ms=device_ms(lambda: kernels.probe_sorted_cuda(*vargs, index)),
        plain_ms=device_ms(lambda: Km.probe_sorted(*vargs)))
    # the directory's size: each probe exact and timed at 20, 21 and 22
    # bits, in turns
    qb, sb = res["probe_qv"]["bound_ms"], res["probe_select"]["bound_ms"]
    vb = res["probe_sorted"]["bound_ms"]
    for nbits in (20, 21, 22, 21, 20):
        idx = bucket_index(table.keys, K, nbits)
        compare(f"probe_qv ({nbits} bits)", (kernels.probe_qv_cuda(
            *args, idx),), (V.qv_sums(*args),))
        compare(f"probe_select ({nbits} bits)",
                kernels.probe_select_cuda(*sargs, idx),
                V.probe_select(*sargs))
        compare(f"probe_sorted ({nbits} bits)",
                kernels.probe_sorted_cuda(*vargs, idx),
                Km.probe_sorted(*vargs))
        qms = device_ms(lambda: kernels.probe_qv_cuda(*args, idx))
        sms = device_ms(lambda: kernels.probe_select_cuda(*sargs, idx))
        vms = device_ms(lambda: kernels.probe_sorted_cuda(*vargs, idx))
        qfloor = sector_floor_ms(table.keys, idx, *window, 9 * WINDOW + 16)
        sfloor = sector_floor_ms(table.keys, idx, skeys, sctx, 34 * q)
        vfloor = rows_floor_ms(table.keys, idx, vkeys, 81 * vq)
        log(f"    {nbits} bits: probe_qv {qms:.3f} ms ({qb / qms:.1%} of its "
            f"bound, sector floor {qfloor:.3f} ms)  probe_select {sms:.3f} "
            f"ms ({sb / sms:.1%}, sector floor {sfloor:.3f} ms)  "
            f"probe_sorted {vms:.3f} ms ({vb / vms:.1%}, sector floor "
            f"{vfloor:.3f} ms)  exact")
        del idx
    # a poly-A pile: the table's first PILE rows become the keys just
    # above AA..A, all in bucket 0, and one query in 8 lands in that
    # bucket (half of them in the pile)
    pkeys = table.keys.clone()
    pkeys[:PILE] = KEY_BIAS + torch.arange(1, PILE + 1, device=device)
    if not bool(pkeys[PILE - 1] < pkeys[PILE]):
        raise AssertionError("the pile does not sort below the table")
    pidx = bucket_index(pkeys, K)
    gen = torch.Generator(device=device).manual_seed(11)
    pq, pvq = qkeys.clone(), vkeys.clone()
    for keys in (pq, pvq):
        keys[1::8] = KEY_BIAS + torch.randint(1, 2 * PILE, keys[1::8].shape,
                                              device=device, generator=gen)
    pargs = (pkeys, *tab[1:], pq, qctx, 1, 1 + WINDOW, 0)
    pvargs = (pkeys, *tab[1:], pvq)
    compare("probe_qv (pile)", (kernels.probe_qv_cuda(*pargs, pidx),),
            (V.qv_sums(*pargs),))
    compare("probe_sorted (pile)", kernels.probe_sorted_cuda(*pvargs, pidx),
            Km.probe_sorted(*pvargs))
    log(f"    a poly-A pile of {PILE} rows in one bucket (largest "
        f"{int((pidx[0][1:] - pidx[0][:-1]).max())}), one query in 8 in "
        f"that bucket: probe_qv kernel "
        f"{device_ms(lambda: kernels.probe_qv_cuda(*pargs, pidx)):.3f} ms  "
        f"plain {device_ms(lambda: V.qv_sums(*pargs)):.3f} ms; probe_sorted "
        f"kernel "
        f"{device_ms(lambda: kernels.probe_sorted_cuda(*pvargs, pidx)):.3f} "
        f"ms  plain {device_ms(lambda: Km.probe_sorted(*pvargs)):.3f} ms  "
        f"exact")
    del pkeys, pidx, pq, pvq, pargs, pvargs
    for name, *_rest in KERNELS:
        r = res[name]
        floor = (f"; sector floor {r['sector_ms']:.3f} ms"
                 if "sector_ms" in r else "")
        log(f"    {name:13s} {r['shape']:36s} kernel {r['ms']:9.3f} ms  "
            f"plain {r['plain_ms']:9.3f} ms  bound {r['bound_ms']:7.3f} ms "
            f"({r['bound_ms'] / r['ms']:.1%} of the kernel's time{floor})  "
            f"exact")
    return res


def phase_end_to_end(fq, fa, read_bases, kcount, ingest_s, device):
    os.environ.pop("KREEQ_TPU_PLATFORM", None)
    out, launches, phases, wall, peak = drive(
        ["kreeq", "validate", "-r", fq, "-f", fa, "-k", str(K)],
        ("extract", "sort", "count", "merge", "probe_qv"), "validate",
        device)
    for line in out.splitlines():
        log("    | " + line)
    # one extraction and one sort a read chunk (before its B1) and one
    # extraction a QV window (before its B3: every window holds a
    # position, so B3 launches)
    if launches["extract"] != launches["count"] + launches["probe_qv"]:
        raise AssertionError(f"{launches['extract']} extractions, not one "
                             f"a chunk and one a window: {launches}")
    if launches["sort"] != launches["count"]:
        raise AssertionError(f"{launches['sort']} sorts, not one a chunk: "
                             f"{launches}")
    build_s = phases["build k-mer DB"]
    log(f"[4 end to end] wall {wall:.2f} s: build (ingest + count + "
        f"merge) {build_s:.2f} s = {read_bases / build_s / 1e6:.2f} M "
        f"read bases/s (ingest alone, timed in phase 3: {ingest_s:.2f} "
        f"s); load genome {phases['load genome']:.2f} s; "
        f"validate + report {phases['report']:.2f} s; peak device "
        f"memory {peak:.2f} GiB; launches {launches}")
    lines = out.splitlines()
    rows = [ln.split("\t") for ln in lines[-2:]]
    for row in rows:
        missing, total, qv, err = (row[0], row[1], row[2], row[3])
        if int(total) != kcount:
            raise AssertionError(f"Total {total} != assembly k-mers "
                                 f"{kcount}")
        if not (0 < int(missing) < int(total)) or not (
                np.isfinite(float(qv)) and np.isfinite(float(err))):
            raise AssertionError(f"implausible QV row {row}")
    if not lines[0].startswith("DBG Summary statistics:"):
        raise AssertionError("no DB summary")
    return launches, out, wall


def phase_cuda_vs_cpu(seed: int):
    """Every ported command and output at 0.5 Mbp, on the card and on
    the CPU; bed/csvtable write k values per base, so they stay at this
    size."""
    from kreeq_tpu_torch.core.dbg import DBG

    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory() as tmp:
        fa, fq, _rb, _kc = make_inputs(rng, 0.5, 30, tmp)
        other = os.path.join(tmp, "other")
        os.mkdir(other)
        _fa2, fq2, _rb2, _kc2 = make_inputs(rng, 0.2, 10, other)
        fa_cut = os.path.join(tmp, "chr1_cut.fa")
        head_fasta(fa, fa_cut, "chr1", CUT_CPU_VS_CUDA)
        spans = os.path.join(tmp, "spans.bed")
        with open(spans, "w") as fh:
            fh.write("chr1\t1000\t60000\n")

        def commands(out):
            """argv of each command, with its output written under
            `out`: the DBs first, since later commands read them."""
            a, b = (os.path.join(out, f"{x}.kreeq") for x in "ab")
            yield ["kreeq", "validate", "-r", fq, "-f", fa, "-k", str(K)]
            yield ["kreeq", "validate", "-r", fq, "-k", str(K), "-o", a]
            yield ["kreeq", "validate", "-r", fq2, "-k", str(K), "-o", b]
            for ext in ("bed", "kwig", "bkwig", "hist"):
                yield ["kreeq", "validate", "-d", a, "-f", fa, "-o",
                       os.path.join(out, f"asm.{ext}")]
            yield ["kreeq", "union", "-d", a, b, "-o",
                   os.path.join(out, "ab.kreeq")]
            yield ["kreeq", "validate", "-d", a, "-f", fa,
                   "--detect-anomalies", os.path.join(out, "asm.anom.bed")]
            for ext in ("vcf", "gfa", "gfa2", "gfa.gz"):
                yield ["kreeq", "validate", "-d", a, "-f", fa_cut, "-o",
                       os.path.join(out, f"asm.{ext}")]
            sub = ["kreeq", "subgraph", "-d", a, "-f", fa_cut]
            yield sub + ["-o", os.path.join(out, "asm.sub.gfa")]
            yield sub + ["--traversal-algorithm", "traversal", "-o",
                         os.path.join(out, "asm.trav.gfa2")]
            yield sub + ["--no-collapse", "--no-reference",
                         "--search-depth", "5"]
            yield sub + ["-p", spans, "-o",
                         os.path.join(out, "asm.span.gfa.gz")]

        outs, stdouts, secs = {}, {}, {}
        old = DBG.VALIDATE_WINDOW
        DBG.VALIDATE_WINDOW = 100_003  # window seams at this size too
        # and in the variants scan
        os.environ["KREEQ_TPU_VARIANTS_WINDOW"] = "4096"
        try:
            for platform in ("cuda", "cpu"):
                os.environ["KREEQ_TPU_PLATFORM"] = platform
                outs[platform] = os.path.join(tmp, platform)
                os.mkdir(outs[platform])
                t0 = time.perf_counter()
                stdouts[platform] = [run_cli(argv) for argv in
                                     commands(outs[platform])]
                secs[platform] = time.perf_counter() - t0
        finally:
            os.environ.pop("KREEQ_TPU_PLATFORM", None)
            os.environ.pop("KREEQ_TPU_VARIANTS_WINDOW", None)
            DBG.VALIDATE_WINDOW = old
        for argv, gpu, cpu in zip(commands(""), stdouts["cuda"],
                                  stdouts["cpu"]):
            if gpu != cpu:
                raise AssertionError(f"{argv[1:]}: CUDA and CPU stdout "
                                     f"differ:\n{gpu}\n---\n{cpu}")
        names = sorted(os.listdir(outs["cuda"]))
        if names != sorted([
                "a.kreeq", "ab.kreeq", "asm.anom.bed", "asm.bed",
                "asm.bkwig", "asm.gfa", "asm.gfa.gz", "asm.gfa2", "asm.hist",
                "asm.kwig", "asm.vcf", "b.kreeq", "asm.sub.gfa",
                "asm.trav.gfa2", "asm.span.gfa.gz"]):
            raise AssertionError(f"unexpected outputs {names}")
        same_output(outs["cuda"], outs["cpu"])
        with open(os.path.join(outs["cpu"], "asm.vcf")) as fh:
            vcf_rows = sum(1 for line in fh if not line.startswith("#"))
        if vcf_rows == 0:
            raise AssertionError("phase 5's VCF has no rows")
        segs = [_graph_stats(out)["# segments"]
                for out in stdouts["cpu"][-4:]]
        if min(segs) < 100:
            raise AssertionError(f"phase 5's subgraphs hold {segs} segments")
    log(f"[5 cuda vs cpu] 0.5 Mbp, 30x: stdout of {len(stdouts['cpu'])} "
        f"commands and {', '.join(names)} byte-equal (vcf/gfa/subgraph on "
        f"the first {CUT_CPU_VS_CUDA} bases, {vcf_rows} VCF rows, "
        f"subgraphs of {segs} segments; cuda {secs['cuda']:.2f} s, cpu "
        f"{secs['cpu']:.2f} s)")


def phase_db_tracks(fq, fa, tmp, qv_rows, device):
    """DB reuse and per-base tracks at full width: build and keep the
    DB, validate the assembly against it with a .bkwig track, inflate
    the track.  Each CLI run is a main path: launch counts are set to 0
    just before it and read just after."""
    from kreeq_tpu_torch.cli.decompressor import BkwigIndex, read_index
    from kreeq_tpu_torch.cli.decompressor import run as decompress

    os.environ.pop("KREEQ_TPU_PLATFORM", None)
    db = os.path.join(tmp, "reads.kreeq")
    bkwig = os.path.join(tmp, "asm.bkwig")

    _out, l_db, ph_db, wall_db, peak_db = drive(
        ["kreeq", "validate", "-r", fq, "-k", str(K), "-o", db],
        ("extract", "count", "merge"), "DB build", device)
    db_mib = sum(os.path.getsize(os.path.join(db, f))
                 for f in os.listdir(db)) / 2**20
    out, l_tr, ph_tr, wall_tr, peak_tr = drive(
        ["kreeq", "validate", "-d", db, "-f", fa, "-o", bkwig],
        ("extract", "probe_select"), "tracks", device)
    rows = out.splitlines()[-2:]
    if rows != qv_rows:
        raise AssertionError(f"QV rows of the DB-reuse track run {rows} "
                             f"differ from the -r run's {qv_rows}")

    with open(bkwig, "rb") as fh:
        data = fh.read()
    idx = BkwigIndex()
    idx.k = data[0]
    read_index(data, 1, idx)
    bases = sum(ln for comps in idx.paths.values()
                for _bp, _abs, ln, _step in comps)
    asm_bases = 0
    with open(fa) as fh:
        for line in fh:
            if not line.startswith(">"):
                s = line.strip()
                asm_bases += len(s) - s.count("N") - s.count("n")
    tail = len(data) - 1 - idx.index_byte_size
    if idx.k != K or bases != asm_bases or tail != 12 * asm_bases:
        raise AssertionError(f".bkwig: k {idx.k}, {bases} indexed bases, "
                             f"{tail} data bytes for {asm_bases} "
                             "assembly bases")
    vals = np.frombuffer(data, "<u4", 3 * asm_bases,
                         1 + idx.index_byte_size).reshape(-1, 3)
    found = float((vals[:, 0] > 0).mean())
    if not 0.9 < found < 1.0:
        raise AssertionError(f"implausible share of found bases {found}")

    inflated = os.path.join(tmp, "asm.inflated")
    t0 = time.perf_counter()
    with open(inflated, "w") as fh, contextlib.redirect_stdout(fh):
        if decompress(["kreeq-decompressor", "inflate", "-i", bkwig]):
            raise AssertionError("inflate failed")
    inflate_s = time.perf_counter() - t0
    with open(inflated) as fh:
        first = fh.readline().strip()
        nrows = sum(1 for line in fh if not line.startswith("fixedStep"))
    if first != str(K) or nrows != asm_bases:
        raise AssertionError(f"inflate: k line {first!r}, {nrows} rows "
                             f"for {asm_bases} bases")

    for row in rows:
        log("    | " + row)
    log(f"[6 db + tracks] `-r -o reads.kreeq` wall {wall_db:.2f} s: build "
        f"{ph_db['build k-mer DB']:.2f} s, DB write "
        f"{ph_db['write output']:.2f} s ({len(os.listdir(db))} files, "
        f"{db_mib:.0f} MiB), peak device memory {peak_db:.2f} GiB; "
        f"launches {l_db}")
    log(f"    `-d -f -o asm.bkwig` wall {wall_tr:.2f} s: DB load "
        f"{ph_tr['load k-mer DB']:.2f} s, load genome "
        f"{ph_tr['load genome']:.2f} s, tracks (validate) "
        f"{ph_tr['validate']:.2f} s, bkwig write "
        f"{ph_tr['write output']:.2f} s ({len(data) / 2**20:.0f} MiB, "
        f"{asm_bases} bases, {found:.4f} found), peak device memory "
        f"{peak_tr:.2f} GiB; launches {l_tr}")
    log(f"    inflate {inflate_s:.2f} s ({nrows} rows); QV rows equal "
        "phase 4's")
    return l_tr


def phase_variants(fa, tmp, qv_rows, device):
    """The variants path at full table size, against phase 6's DB: the
    anomaly scan of the whole assembly, then candidate errors as VCF rows
    on the first CUT_VCF bases of chr2.  Each CLI run is a main path
    (`drive`)."""
    import torch

    from kreeq_tpu_torch.core import variants
    from kreeq_tpu_torch.ops import kernels

    os.environ.pop("KREEQ_TPU_PLATFORM", None)
    db = os.path.join(tmp, "reads.kreeq")

    def path(argv, keys, name):
        out, launches, phases, wall, peak = drive(argv, keys, name, device)
        log(f"    `{' '.join(os.path.basename(a) for a in argv[2:])}`: "
            f"wall {wall:.2f} s; "
            + ", ".join(f"{n} {t:.2f} s" for n, t in phases.items())
            + f"; peak device memory {peak:.2f} GiB; launches {launches}")
        return out, launches

    anom = os.path.join(tmp, "asm.anom.bed")
    # each call's query count only: its tensors are freed as the CLI
    # frees them, so the run's peak device memory is its own
    with timed_calls(kernels, "probe_sorted_cuda",
                     lambda args, _got: args[4].shape[0]) as calls:
        out, l_anom = path(["kreeq", "validate", "-d", db, "-f", fa,
                            "--detect-anomalies", anom],
                           ("extract", "probe_qv", "probe_sorted"),
                           "anomalies")
    torch.cuda.synchronize()
    b5 = [(q, s.elapsed_time(e)) for q, s, e in calls]
    if len(b5) != l_anom["probe_sorted"]:
        raise AssertionError(f"{len(b5)} probe_sorted calls, "
                             f"{l_anom['probe_sorted']} launches")
    log(f"    probe_sorted over the anomaly run's {len(b5)} launches "
        f"({sum(q for q, _ms in b5)} queries): "
        f"{sum(ms for _q, ms in b5):.3f} ms in all (wrapper time: CUDA "
        f"events around each call, its host checks and allocations "
        f"included)")
    rows = out.splitlines()[-2:]
    if rows != qv_rows:
        raise AssertionError(f"QV rows of the anomalies run {rows} differ "
                             f"from the -r run's {qv_rows}")
    with open(anom) as fh:
        ranges = [line.split("\t") for line in fh]
    flagged = sum(int(b) - int(a) + 1 for _p, a, b in ranges)
    if not ranges or any(int(a) > int(b) for _p, a, b in ranges):
        raise AssertionError(f"implausible anomaly ranges ({len(ranges)})")

    cut = os.path.join(tmp, "chr2_1mbp.fa")
    seq = head_fasta(fa, cut, "chr2", CUT_VCF)
    vcf = os.path.join(tmp, "asm.vcf")
    _out, l_vcf = path(["kreeq", "validate", "-d", db, "-f", cut, "-o",
                        vcf], ("extract", "probe_sorted"), "variants")
    stats = dict(variants.SEARCH_STATS)
    with open(vcf) as fh:
        recs = [line.rstrip("\n").split("\t") for line in fh
                if not line.startswith("#")]
    if not recs:
        raise AssertionError("the VCF has no rows")
    for rec in recs:
        pos, ref = int(rec[1]), rec[3]
        if rec[0] != "chr2" or seq[pos - 1:pos - 1 + len(ref)] != ref:
            raise AssertionError(f"VCF row {rec[:5]}: REF is not the "
                                 "assembly at POS")
    snvs = sum(1 for rec in recs if len(rec[3]) == len(rec[4]) == 1)
    log(f"[8 variants] anomalies over {len(ranges)} ranges "
        f"({flagged} positions), QV rows equal phase 4's; VCF of "
        f"{CUT_VCF} bases of chr2: {stats['branch_points']} branch points "
        f"({stats['branch_points'] / (CUT_VCF - K + 1):.2%} of positions), "
        f"host search {stats['search_s']:.2f} s, {len(recs)} rows ({snvs} "
        "SNV), "
        "every REF equal to the assembly at its POS")
    return l_vcf


def _graph_stats(stdout: str) -> dict:
    """The subgraph summary's and the graph statistics' integer lines of
    a `subgraph` run's stdout (the DB summary after them is left out)."""
    lines = stdout.splitlines()
    end = lines.index("DBG Summary statistics:") \
        if "DBG Summary statistics:" in lines else len(lines)
    out = {}
    for line in lines[:end]:
        name, _sep, val = line.partition(": ")
        if val.isdigit():
            out[name] = int(val)
    return out


def _snapshot(sub):
    return [(k, tuple(n.fw), tuple(n.bw), n.cov, n.color)
            for k, n in sub.items()]


def _subgraph_probes(db, cut, device):
    """B5 against its plain version at the subgraph path's own shapes,
    none a multiple of the kernel's block: the cut's extraction keys,
    the first traversal round's survivors, the best-first prefilter's
    unique survivors, and one key, all against the full table.  Also
    extraction with native/subnode_ext and with the pure-Python nodes,
    which must give the same dict."""
    import torch

    from kreeq_tpu_torch.config import UserInput
    from kreeq_tpu_torch.core import subgraph
    from kreeq_tpu_torch.core.dbg import DBG
    from kreeq_tpu_torch.io.fastx import load_genome
    from kreeq_tpu_torch.io.kreeqdb import read_kreeq
    from kreeq_tpu_torch.io.sequence import Genome
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops import kmers as Km
    from kreeq_tpu_torch.ops.frontier import survivors

    table = read_kreeq(db, device)
    genome = Genome()
    load_genome(cut, genome)
    dbg = DBG(UserInput(kmer_len=K), table)
    dbg.load_genome(genome)
    ext = subgraph.get_module() is not None
    if not ext:
        raise AssertionError("native/subnode_ext did not build")
    t0 = time.perf_counter()
    sub = subgraph.extract_subgraph(dbg)
    ext_s = time.perf_counter() - t0
    saved = subgraph.get_module
    subgraph.get_module = lambda: None
    try:
        t0 = time.perf_counter()
        plain = subgraph.extract_subgraph(dbg)
        py_s = time.perf_counter() - t0
    finally:
        subgraph.get_module = saved
    if _snapshot(plain) != _snapshot(sub):
        raise AssertionError("extraction: pure-Python nodes differ from "
                             "native/subnode_ext's")
    log(f"[9 subgraph] native/subnode_ext loaded; extraction of "
        f"{len(sub)} nodes {ext_s:.2f} s with it, {py_s:.2f} s with the "
        f"pure-Python nodes, the same dict")

    seg = max(genome.segments, key=len)
    qkeys = kernels.extract_cuda(torch.from_numpy(seg.codes).to(device),
                                 K)[0]
    fkeys, ffw, fbw = subgraph._node_arrays(sub, device)
    members = torch.sort(fkeys).values
    rkeys = survivors(fkeys, ffw, fbw, members, K, 0, dedup=True)[0]
    pkeys = torch.unique(survivors(fkeys, ffw, fbw, members, K,
                                   dbg.ui.cov_cutoff, dedup=False)[0])
    tab = (table.keys, table.cov, table.fw, table.bw)
    index = table.bucket_index()
    # one key: the kernel's floor on the card, below which no shape here
    # can read
    for name, q in (("extraction", qkeys), ("round 1", rkeys),
                    ("prefilter", pkeys), ("one key", qkeys[:1])):
        args = (*tab, q)
        compare(f"probe_sorted ({name})",
                kernels.probe_sorted_cuda(*args, index),
                Km.probe_sorted(*args))
        ms = device_ms(lambda: kernels.probe_sorted_cuda(*args, index))
        log(f"    probe_sorted {name:10s} q={q.shape[0]} t={len(table)} "
            f"kernel {ms:.3f} ms  plain "
            f"{device_ms(lambda: Km.probe_sorted(*args)):.3f} ms  exact")


def phase_subgraph(tmp, device):
    """Subgraph mode at full table size, against phase 6's DB, on phase
    8's CUT_VCF bases of chr2: B5 held against its plain version at this
    path's shapes, then traversal and best-first.  Each CLI run is a
    main path (`drive`)."""
    from kreeq_tpu_torch.core import subgraph

    os.environ.pop("KREEQ_TPU_PLATFORM", None)
    db = os.path.join(tmp, "reads.kreeq")
    cut = os.path.join(tmp, "chr2_1mbp.fa")
    kmers = CUT_VCF - K + 1
    _subgraph_probes(db, cut, device)
    for alg, out in (("traversal", "sub.gfa2"), ("best-first", "sub.gfa")):
        gfa = os.path.join(tmp, out)
        argv = ["kreeq", "subgraph", "-d", db, "-f", cut,
                "--traversal-algorithm", alg, "-o", gfa]
        stdout, launches, phases, wall, peak = drive(
            argv, ("extract", "probe_sorted"), f"subgraph {alg}", device)
        st = dict(subgraph.SUBGRAPH_STATS)
        stats = _graph_stats(stdout)
        with open(gfa) as fh:
            kinds = [line[0] for line in fh]
        edge = "E" if out.endswith("gfa2") else "L"
        if (kinds.count("S") != stats["# segments"]
                or kinds.count(edge) != stats["# edges"]):
            raise AssertionError(
                f"{out}: {kinds.count('S')} S and {kinds.count(edge)} "
                f"{edge} lines, stdout {stats['# segments']} segments and "
                f"{stats['# edges']} edges")
        if st["blue"] < 0.9 * kmers or stats["Distinct kmers"] < st["seed"]:
            raise AssertionError(
                f"{alg}: {st['blue']} blue of {st['seed']} seed nodes for "
                f"{kmers} k-mers; {stats['Distinct kmers']} distinct")
        log(f"[9 subgraph] {alg}: wall {wall:.2f} s; "
            + ", ".join(f"{n} {t:.2f} s" for n, t in phases.items())
            + f"; peak device memory {peak:.2f} GiB; launches {launches}")
        log(f"    seed {st['seed']} nodes ({st['blue']} blue), distinct "
            f"{stats['Distinct kmers']}, {stats['# segments']} segments, "
            f"{stats['# edges']} edges, {stats['# bubbles']} bubbles")
        for i, (found, scan_ms, probe_ms) in enumerate(st["rounds"]):
            log(f"    round {i + 1}: {found} new nodes, survivor scan "
                f"{scan_ms:.3f} ms, probe {probe_ms:.3f} ms")
        if st["sources"]:
            log(f"    boundary sources {st['sources']} "
                f"({st['sources'] / st['seed']:.2%} of the seed), host "
                f"search {st['search_s']:.2f} s "
                f"({st['search_s'] / st['sources'] * 1e3:.3f} ms each)")


OOC_ROWS = 10_000_000  # phase 10's KREEQ_TPU_MAX_TABLE_ROWS
OOC_MERGE_ROWS = 20_000_000  # phase 10's KREEQ_TPU_HOST_MERGE_ROWS
CUT_SUBGRAPH = 100_000  # bases of chr2 in phase 10's subgraph runs
CKPT_BATCH = 11  # chunks a checkpoint part: 4 parts of 44 chunks


@contextlib.contextmanager
def env(**values):
    """The KREEQ_TPU_<name> switches set (a value) or unset (None) in
    the block, restored after it."""
    names = {f"KREEQ_TPU_{k}": v for k, v in values.items()}
    old = {k: os.environ.get(k) for k in names}
    try:
        for k, v in names.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ooc_report(device) -> dict:
    """What the out-of-core path recorded since the last call
    (core/table.OOC_STATS, core/build_ckpt.CKPT_STATS), in ms, GB/s and
    s per window and per host merge; clears the records."""
    import torch

    from kreeq_tpu_torch.core.build_ckpt import CKPT_STATS
    from kreeq_tpu_torch.core.table import OOC_STATS
    from kreeq_tpu_torch.device import elapsed_ms

    torch.cuda.synchronize(device)
    st = OOC_STATS
    probes = {}
    for name, w, q, a, b in st["probe"]:
        ms, n, queries = probes.get((name, w), (0.0, 0, 0))
        probes[name, w] = (ms + elapsed_ms(a, b), n + 1, queries + q)
    out = {
        "uploads": [{"window": w, "rows": rows, "ms": elapsed_ms(a, b),
                     "GB_per_s": nbytes / elapsed_ms(a, b) / 1e6}
                    for w, rows, nbytes, a, b in st["upload"]],
        "index_ms": [elapsed_ms(a, b) for _w, a, b in st["index"]],
        "probes": [{"kernel": name, "window": w, "calls": n,
                    "queries": q, "ms": ms}
                   for (name, w), (ms, n, q) in sorted(probes.items())],
        "host_merges": [{"rows_a": a, "rows_b": b, "rows_out": m, "s": t}
                        for a, b, m, t in st["host_merge"]],
        "pin": [{"bytes": b, "s": t} for b, t in st["pin"]],
        "fold_s": list(st["fold"]), "classify_s": list(st["classify"]),
        "ckpt_writes": [{"op": op, "name": name, "rows": rows, "s": t}
                        for op, name, rows, t in CKPT_STATS["write"]],
    }
    for v in st.values():
        v.clear()
    CKPT_STATS["write"] = []
    return out


def phase_out_of_core(fq, fa, tmp, validate_out, card, device):
    """The out-of-core path at full table size: phase 4's reads and
    assembly and phase 6's 24,756,385-row DB under
    KREEQ_TPU_MAX_TABLE_ROWS = 10^7 (3 windows of about 8.25M rows) and
    KREEQ_TPU_HOST_MERGE_ROWS = 2 * 10^7 (the JAX soak's ratio of the
    two caps).  Each step's output must equal the in-core one; its
    launches, per-window times, host merges and checkpoint writes go to
    the JSON line.  Returns (launches summed over the steps, report)."""
    import torch

    from kreeq_tpu_torch.core import build_ckpt
    from kreeq_tpu_torch.core.table import KmerTable, max_device_rows
    from kreeq_tpu_torch.io.kreeqdb import read_kreeq
    from kreeq_tpu_torch.ops import kernels

    os.environ.pop("KREEQ_TPU_PLATFORM", None)
    db = os.path.join(tmp, "reads.kreeq")
    with env(MAX_TABLE_ROWS=None):
        default_rows = max_device_rows(device)
    report = {"card": card, "max_device_rows_default": default_rows,
              "max_table_rows": OOC_ROWS, "host_merge_rows": OOC_MERGE_ROWS,
              "steps": {}}
    total = {key: 0 for key in kernels.LAUNCHES}
    ooc_report(device)

    def step(name, wall, launches, peak, **extra):
        rec = {"wall_s": wall, "launches": launches, "peak_gib": peak,
               **ooc_report(device), **extra}
        report["steps"][name] = rec
        for key, n in launches.items():
            total[key] += n
        merges = rec["host_merges"]
        ups = rec["uploads"] or [{"ms": 0.0, "GB_per_s": 0.0}]
        log(f"    ({name}) wall {wall:.2f} s, peak device memory "
            f"{peak:.2f} GiB; launches {launches}; "
            f"{len(rec['uploads'])} window uploads of "
            f"{min(u['ms'] for u in ups):.2f}-{max(u['ms'] for u in ups):.2f}"
            f" ms ({min(u['GB_per_s'] for u in ups):.2f}-"
            f"{max(u['GB_per_s'] for u in ups):.2f} GB/s); "
            f"{len(merges)} host merges, {sum(m['s'] for m in merges):.2f}"
            " s in all"
            + "".join(f"; {k} {v}" for k, v in extra.items()))
        return rec

    def windows_of(rec):
        return sorted({u["window"] for u in rec["uploads"]})

    built = []
    plain_from_reads = KmerTable.from_reads.__func__

    def keep_table(cls, *args, **kwargs):
        built.append(plain_from_reads(cls, *args, **kwargs))
        return built[-1]

    with env(MAX_TABLE_ROWS=OOC_ROWS, HOST_MERGE_ROWS=OOC_MERGE_ROWS):
        # (a) the build with host merges, then the windowed validate
        KmerTable.from_reads = classmethod(keep_table)
        try:
            out, la, ph, wall, peak = drive(
                ["kreeq", "validate", "-r", fq, "-f", fa, "-k", str(K)],
                ("extract", "count", "merge", "probe_select"),
                "out-of-core validate", device)
        finally:
            KmerTable.from_reads = classmethod(plain_from_reads)
        rec = step("a", wall, la, peak, build_s=ph["build k-mer DB"],
                   report_s=ph["report"])
        (table,) = built
        table._win = table._win_bucket = None  # kept on the host only
        if out != validate_out:
            raise AssertionError("out-of-core `validate -r -f` stdout "
                                 "differs from phase 4's")
        if not rec["host_merges"] or not table.on_host:
            raise AssertionError("(a): no merge ran on the host, or the "
                                 "table is not host-resident")
        nwin = len(table.window_ranges())
        if windows_of(rec) != list(range(nwin)) or nwin != 3:
            raise AssertionError(f"(a): windows {windows_of(rec)}, "
                                 f"expected {nwin} = 3")

        # (b) the DB loaded host-resident, the track path
        bkwig = os.path.join(tmp, "asm.ooc.bkwig")
        _out, lb, ph, wall, peak = drive(
            ["kreeq", "validate", "-d", db, "-f", fa, "-o", bkwig],
            ("extract", "probe_select"), "out-of-core tracks", device)
        rec = step("b", wall, lb, peak, load_s=ph["load k-mer DB"],
                   validate_s=ph["validate"])
        if len(rec["pin"]) != 1 or windows_of(rec) != list(range(nwin)):
            raise AssertionError("(b): the DB did not load host-resident")
        same_output(bkwig, os.path.join(tmp, "asm.bkwig"))

        # (c) the anomaly scan: B5 once per window
        anom = os.path.join(tmp, "asm.ooc.anom.bed")
        out, lc, ph, wall, peak = drive(
            ["kreeq", "validate", "-d", db, "-f", fa, "--detect-anomalies",
             anom], ("probe_select", "probe_sorted"), "out-of-core anomalies",
            device)
        step("c", wall, lc, peak, anomalies_s=ph["detect anomalies"])
        if lc["probe_sorted"] != nwin:
            raise AssertionError(f"(c): {lc['probe_sorted']} probe_sorted "
                                 f"launches for {nwin} windows")
        if out.splitlines()[-2:] != validate_out.splitlines()[-2:]:
            raise AssertionError("(c): QV rows differ from phase 4's")
        same_output(anom, os.path.join(tmp, "asm.anom.bed"))

        # (d) the VCF of phase 8's cut: the inverted two-pass scan
        vcf = os.path.join(tmp, "asm.ooc.vcf")
        _out, ld, ph, wall, peak = drive(
            ["kreeq", "validate", "-d", db, "-f",
             os.path.join(tmp, "chr2_1mbp.fa"), "-o", vcf],
            ("extract", "probe_sorted"), "out-of-core variants", device)
        step("d", wall, ld, peak, variants_s=ph["variants"])
        if ld["probe_sorted"] != nwin:
            raise AssertionError(f"(d): {ld['probe_sorted']} probe_sorted "
                                 f"launches for {nwin} windows")
        same_output(vcf, os.path.join(tmp, "asm.vcf"))

    # (e) subgraph traversal on 100 kbp of chr2, windowed and in core
    cut = os.path.join(tmp, "chr2_100kbp.fa")
    head_fasta(fa, cut, "chr2", CUT_SUBGRAPH)
    gfas = []
    for windowed in (True, False):
        gfa = os.path.join(tmp, f"sub.ooc{int(windowed)}.gfa2")
        with env(MAX_TABLE_ROWS=OOC_ROWS if windowed else None):
            _out, le, ph, wall, peak = drive(
                ["kreeq", "subgraph", "-d", db, "-f", cut,
                 "--traversal-algorithm", "traversal", "-o", gfa],
                ("extract", "probe_sorted"), "subgraph", device)
        if windowed:
            step("e", wall, le, peak, search_s=ph["search"])
        else:
            ooc_report(device)
        gfas.append(gfa)
    same_output(*gfas)

    # (f) KmerTable.merge of the DB with itself: spilled to the host,
    # against the in-core merge
    with env(MAX_TABLE_ROWS=None, HOST_MERGE_ROWS=None):
        incore = read_kreeq(db, device)
        want = incore.merge(incore).to_numpy()
    report["merge_digest"] = table_digest(want)  # phase 11 (d)'s reference
    with env(MAX_TABLE_ROWS=OOC_ROWS, HOST_MERGE_ROWS=OOC_MERGE_ROWS):
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        spilled = incore.merge(incore)
        wall = time.perf_counter() - t0
        lf = dict(kernels.LAUNCHES)
        got = spilled.to_numpy()
        for g, w in zip(got, want):
            if not np.array_equal(g, w):
                raise AssertionError("(f): the host merge differs from the "
                                     "in-core merge")
        if not spilled.on_host:
            raise AssertionError("(f): the merged table is not "
                                 "host-resident")
        # one window's upload from the pinned rows and from a pageable
        # copy of them, in turns
        pageable = KmerTable(K, *(x.clone() for x in (
            spilled.keys, spilled.cov, spilled.fw, spilled.bw)),
            compute=device)
        ms = {}
        for name, t in (("pinned", spilled), ("pageable", pageable),
                        ("pageable", pageable), ("pinned", spilled)):
            t._win = None
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t.device_arrays(0)
            end.record()
            end.synchronize()
            ms.setdefault(name, []).append(start.elapsed_time(end))
            t._win = None
        del pageable, spilled, incore, want, got
        step("f", wall, lf, torch.cuda.max_memory_allocated(device) / 2**30,
             window0_upload_ms=ms)

        # (g) the checkpointed build: killed after its second part, then
        # resumed; the same table as (a)'s
        ckpt = os.path.join(tmp, "ckpt")
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with env(BUILD_CKPT=ckpt, BUILD_CKPT_BATCH=CKPT_BATCH,
                 BUILD_CKPT_CRASH_AFTER=2):
            try:
                KmerTable.from_reads([fq], K, device)
            except RuntimeError as e:
                if "fault injection" not in str(e):
                    raise
            else:
                raise AssertionError("(g): the fault hook did not fire")
        crash_s = time.perf_counter() - t0
        parts_before = sorted(f for f in os.listdir(ckpt)
                              if f.endswith(".keys.npy"))
        t0 = time.perf_counter()
        with env(BUILD_CKPT=ckpt, BUILD_CKPT_BATCH=CKPT_BATCH):
            resumed = KmerTable.from_reads([fq], K, device)
        resume_wall = time.perf_counter() - t0
        lg = dict(kernels.LAUNCHES)
        for g, w in zip(resumed.to_numpy(), table.to_numpy()):
            if not np.array_equal(g, w):
                raise AssertionError("(g): the resumed build differs from "
                                     "(a)'s table")
        with open(os.path.join(ckpt, build_ckpt.MANIFEST)) as fh:
            recs = [json.loads(line) for line in fh]
        parts = [r for r in recs if r["op"] == "part"]
        if len(parts) != 4 or parts_before != ["p00000.keys.npy",
                                               "p00001.keys.npy"]:
            raise AssertionError(f"(g): parts {[r['name'] for r in parts]}"
                                 f", {parts_before} before the resume")
        step("g", crash_s + resume_wall, lg,
             torch.cuda.max_memory_allocated(device) / 2**30,
             crash_run_s=crash_s, resume_run_s=resume_wall,
             replay_s=build_ckpt.CKPT_STATS["resume_s"])
        del resumed, table, built[:]
        shutil.rmtree(ckpt)
    log(f"[10 out of core] caps {OOC_ROWS} rows a window, host merges "
        f"above {OOC_MERGE_ROWS} rows (default cap on this card "
        f"{default_rows} rows); {nwin} windows; validate stdout, .bkwig, "
        f"anomaly BED, VCF, subgraph GFA2 and the merged and resumed "
        f"tables equal the in-core ones; launches {total}")
    return total, report


# ---------------------------------------------------------------------------
# phase 11: several ranks

RANKS = 2  # phase 11's ranks, sharing the one card over gloo
# records of phase 11's 4 FASTQ files: rank 0 reads files 0 and 2, rank
# 1 files 1 and 3, so rank 0 counts more chunks and rank 1 enters the
# last rounds with empty ones
SHARD_SHARES = (0.4, 0.3, 0.2, 0.1)
PIPE_CHUNK = 1 << 25  # bases of each rank's read chunk in phase 11 (c)


def table_digest(arrays) -> str:
    """sha256 of a table's (keys, cov, fw, bw) in the JAX package's
    dtypes."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


def split_fastq(fq: str, tmp: str) -> list:
    """phase 4's reads as 4 FASTQ files of SHARD_SHARES of its records
    (make_inputs writes records of one length)."""
    row = 3 + READ_LEN + 3 + READ_LEN + 1
    nrec, rest = divmod(os.path.getsize(fq), row)
    if rest:
        raise AssertionError(f"{fq} is not made of {row}-byte records")
    cuts = [0]
    for share in SHARD_SHARES[:-1]:
        cuts.append(cuts[-1] + int(nrec * share))
    cuts.append(nrec)
    files = []
    with open(fq, "rb") as src:
        for i in range(len(SHARD_SHARES)):
            path = os.path.join(tmp, f"r{i}.fq")
            left = (cuts[i + 1] - cuts[i]) * row
            with open(path, "wb") as dst:
                while left:
                    buf = src.read(min(left, 64 << 20))
                    dst.write(buf)
                    left -= len(buf)
            files.append(path)
    return files


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(name: str, job: dict, tmp: str, **switches):
    """RANKS processes of this script's --rank-worker mode, launched as
    the port's CLI is (KREEQ_TPU_COORDINATOR on a free local port,
    _NUM_PROCESSES, _PROCESS_ID) with the KREEQ_TPU_<name> `switches`;
    every one is waited for, and killed if the run fails.  Returns per
    rank (stdout, stderr, the worker's result, wall s from the spawn)."""
    port = free_port()
    procs, files = [], []
    t0 = time.perf_counter()
    try:
        for r in range(RANKS):
            base = os.path.join(tmp, f"{name}.rank{r}")
            with open(base + ".json", "w") as fh:
                json.dump({**job, "out": base + ".res.json"}, fh)
            environ = {**os.environ,
                       "KREEQ_TPU_COORDINATOR": f"127.0.0.1:{port}",
                       "KREEQ_TPU_NUM_PROCESSES": str(RANKS),
                       "KREEQ_TPU_PROCESS_ID": str(r),
                       **{f"KREEQ_TPU_{k}": str(v)
                          for k, v in switches.items()}}
            out = open(base + ".out", "wb")
            err = open(base + ".err", "wb")
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker",
                 base + ".json"], env=environ, stdout=out, stderr=err))
        walls = [None] * len(procs)
        while None in walls:
            for r, p in enumerate(procs):
                if walls[r] is None and p.poll() is not None:
                    walls[r] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 300:
                raise TimeoutError(f"({name}) the ranks ran past 300 s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in files:
            fh.close()
    runs = []
    for r, p in enumerate(procs):
        base = os.path.join(tmp, f"{name}.rank{r}")
        with open(base + ".out") as fh:
            out = fh.read()
        with open(base + ".err") as fh:
            err = fh.read()
        if p.returncode != 0:
            raise AssertionError(f"({name}) rank {r} exited {p.returncode}:"
                                 f"\n{err[-4000:]}")
        with open(base + ".res.json") as fh:
            runs.append((out, err, json.load(fh), walls[r]))
    return runs


def build_records(err: str) -> list:
    """The `distributed build` records a rank's --verbose stderr holds."""
    return [json.loads(line.split("distributed build ", 1)[1])
            for line in err.splitlines() if "distributed build " in line]


def rank_worker(spec_path: str) -> int:
    """One rank of phase 11: job "cli" runs the port's CLI (rank 0's
    stdout is the CLI's); job "checks" runs (c) and (d).  Writes the
    result, with the launches, wall and peak device memory, to the
    job's "out" file."""
    import torch

    from kreeq_tpu_torch.ops import kernels

    with open(spec_path) as fh:
        spec = json.load(fh)
    t0 = time.perf_counter()
    if spec["kind"] == "cli":
        from kreeq_tpu_torch.cli.main import run

        from kreeq_tpu_torch.utils import log as klog

        res = {"rc": run(["kreeq", *spec["argv"]])}
        sys.stdout.flush()
        res["launches"] = dict(kernels.LAUNCHES)
        res["build_s"] = dict(klog._phases)["build k-mer DB"]
    else:
        res = rank_checks(spec)
    res["wall_s"] = time.perf_counter() - t0
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(spec["out"], "w") as fh:
        json.dump(res, fh)
    return 0


def _checked(name: str, plain, calls) -> dict:
    """Each recorded call of a kernel wrapper held exactly against its
    plain version on the same inputs; its shapes and CUDA-event ms."""
    import torch

    torch.cuda.synchronize()
    shapes, ms = [], []
    for (args, got), start, end in calls:
        compare(name, got, plain(*args))
        shapes.append([tuple(a.shape)[0] for a in args
                       if isinstance(a, torch.Tensor)])
        ms.append(start.elapsed_time(end))
    return {"calls": len(calls), "shapes": shapes, "ms": ms,
            "max_abs_err": 0.0}


def rank_checks(spec: dict) -> dict:
    """(c) full_pipeline on one PIPE_CHUNK read chunk per rank (chunk r)
    and, on rank 0, one full validate window of chr1 (rank 1's assembly
    chunk is empty; its share of the queries still reaches its
    sub-table); (d) merge_sharded of phase 6's DB with itself.  Every
    B1, B2 and B5 call is held against its plain version."""
    import torch
    import torch.distributed as dist

    from kreeq_tpu_torch.constants import seq_to_codes
    from kreeq_tpu_torch.device import resolve_device
    from kreeq_tpu_torch.io.fastx import iter_reads
    from kreeq_tpu_torch.io.kreeqdb import read_kreeq
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops import kmers as KM
    from kreeq_tpu_torch.parallel import multihost, sharded

    if not multihost.maybe_initialize():
        raise AssertionError("no launch: the KREEQ_TPU_* variables are "
                             "unset")
    device = resolve_device()
    group = dist.group.WORLD
    rank = dist.get_rank()
    res = {"rank": rank, "backend": dist.get_backend(), "device":
           str(device)}

    # (c)
    chunks = KM.pack_reads(iter_reads(spec["reads"]), K, PIPE_CHUNK)
    for _ in range(rank + 1):
        buf = next(chunks)
    reads = torch.from_numpy(buf).to(device)
    with open(spec["window"]) as fh:
        seq = fh.read().split("\n")[1]
    asm = torch.from_numpy(seq_to_codes(seq if rank == 0 else "")).to(
        device)
    kernels.reset_launches()
    sharded.stats_report(device)
    with timed_calls(kernels, "count_runs_cuda") as counts, \
            timed_calls(kernels, "probe_sorted_cuda") as probes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _qf, _qc, tot, miss, emiss = sharded.full_pipeline(reads, asm, K,
                                                           group)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res["c"] = {"wall_s": wall, "sums": [tot, miss, emiss],
                "read_bases": int(buf.shape[0]),
                "window": max(int(asm.shape[0]) - K + 1, 0),
                "launches": dict(kernels.LAUNCHES),
                **sharded.stats_report(device),
                "count_runs": _checked("count_runs", KM.count_runs, counts),
                "probe_sorted": _checked(
                    "probe_sorted", lambda *a: KM.probe_sorted(*a[:5]),
                    probes)}
    check_launches(res["c"]["launches"], ("extract", "count", "probe_sorted"),
                   f"rank {rank}'s full_pipeline")
    del counts, probes, reads, asm

    # (d)
    db = read_kreeq(spec["db"], device)
    kernels.reset_launches()
    with timed_calls(kernels, "merge_sorted_cuda") as merges:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = db.merge_sharded(db, group)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res["d"] = {"wall_s": wall, "rows": len(merged),
                "launches": dict(kernels.LAUNCHES),
                **sharded.stats_report(device),
                "merge_sorted": _checked("merge_sorted", KM.merge_sorted,
                                         merges),
                "digest": table_digest(merged.to_numpy())}
    check_launches(res["d"]["launches"], ("merge",),
                   f"rank {rank}'s merge_sharded")
    dist.destroy_process_group()
    res["launches"] = {key: res["c"]["launches"][key]
                       + res["d"]["launches"][key] for key in kernels.LAUNCHES}
    return res


def phase_sharded(fq, fa, tmp, validate_out, ooc, card, device):
    """Several ranks at full size, on phase 4's reads and assembly and
    phase 6's DB: (a) `validate -r r0.fq r1.fq r2.fq r3.fq -f asm.fa`
    as RANKS processes sharing the card over gloo (rank 0's stdout
    equal to phase 4's, rank 1's empty); (b) build_table_distributed of
    the 4 files in a 1-rank NCCL group in this process (equal to phase
    6's DB), in core and under phase 10's caps (gathered into host
    memory);
    (c) full_pipeline across the ranks on a full validate
    window of chr1 (the sums equal B3's on one card); (d) merge_sharded
    of phase 6's DB with itself (equal to phase 10 (f)'s in-core
    merge); (e) (a) again with phase 10's caps, KREEQ_TPU_MAX_TABLE_ROWS
    = OOC_ROWS and KREEQ_TPU_HOST_MERGE_ROWS = OOC_MERGE_ROWS (stdout
    equal to phase 4's; the gathered table on the host; B4 once per
    table window and sequence window, as in phase 10 (a)).  Returns (launches summed over the
    runs, report)."""
    import torch
    import torch.distributed as dist

    from kreeq_tpu_torch.constants import seq_to_codes
    from kreeq_tpu_torch.core.table import TreeMerger
    from kreeq_tpu_torch.io.fastx import iter_reads
    from kreeq_tpu_torch.io.kreeqdb import read_kreeq
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops import kmers as KM
    from kreeq_tpu_torch.ops.index import bucket_index
    from kreeq_tpu_torch.ops.validate import validate_qv_sums
    from kreeq_tpu_torch.parallel import multihost, sharded

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    db = os.path.join(tmp, "reads.kreeq")
    files = split_fastq(fq, tmp)
    report = {"card": card, "ranks": RANKS, "files_bytes":
              [os.path.getsize(f) for f in files]}
    total = {key: 0 for key in kernels.LAUNCHES}

    def add(launches):
        for key, n in launches.items():
            total[key] += n

    def cli_ranks(name, keys, **switches):
        argv = ["validate", "-r", *files, "-f", fa, "-k", str(K),
                "--verbose"]
        runs = spawn_ranks(name, {"kind": "cli", "argv": argv}, tmp,
                           **switches)
        if runs[0][0] != validate_out:
            raise AssertionError(f"({name}) rank 0's stdout differs from "
                                 "phase 4's")
        recs = []
        for r, (out, err, res, wall) in enumerate(runs):
            if r and out:
                raise AssertionError(f"({name}) rank {r} printed {out!r}")
            if f"rank {r} of {RANKS}: cuda:0, gloo backend" not in err:
                raise AssertionError(f"({name}) rank {r} logged no gloo "
                                     "group on cuda:0")
            (build,) = build_records(err)
            # the gathered table goes into host memory above a quarter
            # of the row cap (table.device_gather_rows), and only there
            if build["gather"]["host_calls"] != (name == "e"):
                raise AssertionError(
                    f"({name}) rank {r} gathered into host memory "
                    f"{build['gather']['host_calls']} times")
            check_launches(res["launches"], keys, f"({name}) rank {r}")
            add(res["launches"])
            rec = {"wall_s": wall, "run_s": res["wall_s"],
                   "build_s": res["build_s"],
                   "peak_gib": res["peak_gib"],
                   "launches": res["launches"], "build": build}
            recs.append(rec)
            log(f"    ({name}) rank {r}: wall {wall:.2f} s from the "
                f"spawn, {res['wall_s']:.2f} s in the CLI (build "
                f"{res['build_s']:.2f} s), "
                f"{build['chunks']} chunks in {build['rounds']} rounds, "
                f"routed {build['route']['rows']} records "
                f"({build['route']['bytes'] / 1e6:.1f} MB) in "
                f"{build['route']['ms']:.1f} ms, gathered "
                f"{build['gather']['rows']} rows "
                f"({build['gather']['bytes'] / 1e6:.1f} MB) in "
                f"{build['gather']['ms']:.1f} ms (into host memory: "
                f"{build['gather']['host_calls']}); B1 "
                f"{build['launches']['count']}, B2 "
                f"{build['launches']['merge']} launches in the build; "
                f"peak device memory {res['peak_gib']:.2f} GiB; "
                f"{build['backend']} on {build['device']}")
        return recs

    # (a)
    report["a"] = cli_ranks("a", ("extract", "count", "merge", "probe_qv"))

    # (b) a 1-rank NCCL group in this process: in core, then with phase
    # 10's caps, so the table is gathered into host memory through card
    # buffers (sharded._gather_rows_host) and stays on the host
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=device)
    want_db = read_kreeq(db, device).to_numpy()
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"(b) backend {dist.get_backend()}")
        for name, caps in (("b", {}), ("b_host", {
                "MAX_TABLE_ROWS": OOC_ROWS,
                "HOST_MERGE_ROWS": OOC_MERGE_ROWS})):
            kernels.reset_launches()
            sharded.stats_report(device)
            torch.cuda.reset_peak_memory_stats(device)
            with env(**caps):
                t0 = time.perf_counter()
                built = multihost.build_table_distributed(
                    files, K, device, group=dist.group.WORLD)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            lb = dict(kernels.LAUNCHES)
            rec = {"wall_s": wall, "rows": len(built), "launches": lb,
                   "on_host": built.on_host, "peak_gib":
                   torch.cuda.max_memory_allocated(device) / 2**30,
                   **sharded.stats_report(device)}
            check_launches(lb, ("extract", "count", "merge"),
                           f"({name}) NCCL build")
            add(lb)
            if (rec["gather"]["host_calls"], built.on_host) != (
                    (1, True) if caps else (0, False)):
                raise AssertionError(
                    f"({name}) gathered into host memory "
                    f"{rec['gather']['host_calls']} times, the table on "
                    f"the host: {built.on_host}")
            for g, w in zip(built.to_numpy(), want_db):
                if not np.array_equal(g, w):
                    raise AssertionError(f"({name}) the NCCL build differs "
                                         "from phase 6's DB")
            del built
            report[name] = rec
            log(f"    ({name}) NCCL, 1 rank, caps {caps}: wall "
                f"{wall:.2f} s, {rec['rows']} rows equal phase 6's DB, on "
                f"the host: {rec['on_host']}; route "
                f"{rec['route']['calls']} calls {rec['route']['ms']:.1f} ms, "
                f"gather {rec['gather']['ms']:.1f} ms (into host memory: "
                f"{rec['gather']['host_calls']}); peak device memory "
                f"{rec['peak_gib']:.2f} GiB; launches {lb}")
    finally:
        dist.destroy_process_group()
    del want_db

    # (c) and (d): the expected sums, B3 on one card over the same window
    window = os.path.join(tmp, "chr1_window.fa")
    seq = head_fasta(fa, window, "chr1", WINDOW + K - 1)
    chunks = KM.pack_reads(iter_reads(fq), K, PIPE_CHUNK)
    tm = TreeMerger(device)
    for _ in range(RANKS):
        tm.push(kernels.count_chunk_cuda(torch.from_numpy(next(chunks)).to(
            device), K))
    tab = tm.finalize()
    codes = torch.from_numpy(seq_to_codes(seq)).to(device)
    p = codes.shape[0] - K + 1
    b3 = validate_qv_sums(*tab, codes, K, 0, 0, p,
                          bucket_index(tab[0], K)).tolist()
    valid = int(kernels.extract_cuda(codes, K)[3].sum())
    want = [valid, b3[0] - (p - valid), b3[1]]
    del tm, tab, codes
    torch.cuda.empty_cache()
    runs = spawn_ranks("cd", {"kind": "checks", "reads": fq,
                              "window": window, "db": db}, tmp)
    report["c"], report["d"] = [], []
    for r, (out, _err, res, wall) in enumerate(runs):
        if out:
            raise AssertionError(f"(c) rank {r} printed {out!r}")
        if res["c"]["sums"] != want:
            raise AssertionError(f"(c) rank {r}: sums {res['c']['sums']}, "
                                 f"B3 on one card {want}")
        if res["d"]["digest"] != ooc["merge_digest"]:
            raise AssertionError(f"(d) rank {r}: merge_sharded differs from "
                                 "phase 10 (f)'s in-core merge")
        add(res["launches"])
        report["c"].append({"wall_s": wall, **res["c"]})
        report["d"].append(res["d"])
        c, d = res["c"], res["d"]
        log(f"    (c) rank {r} ({res['backend']} on {res['device']}): "
            f"full_pipeline {c['wall_s']:.2f} s, sums {c['sums']} (B3: "
            f"{want}); B1 {c['count_runs']['calls']} calls "
            f"{sum(c['count_runs']['ms']):.2f} ms, B5 "
            f"{c['probe_sorted']['calls']} calls of "
            f"{c['probe_sorted']['shapes']} "
            f"{sum(c['probe_sorted']['ms']):.2f} ms, exact; route "
            f"{c['route']['ms']:.1f} ms, back {c['back']['ms']:.1f} ms")
        log(f"    (d) rank {r}: merge_sharded {d['wall_s']:.2f} s, "
            f"{d['rows']} rows equal phase 10 (f)'s; B2 "
            f"{d['merge_sorted']['calls']} calls of "
            f"{d['merge_sorted']['shapes']} "
            f"{sum(d['merge_sorted']['ms']):.2f} ms, exact; gather "
            f"{d['gather']['ms']:.1f} ms; peak device memory "
            f"{res['peak_gib']:.2f} GiB")

    # (e) sharded and windowed
    report["e"] = cli_ranks("e", ("extract", "count", "merge", "probe_select"),
                            MAX_TABLE_ROWS=OOC_ROWS,
                            HOST_MERGE_ROWS=OOC_MERGE_ROWS)
    want_b4 = ooc["steps"]["a"]["launches"]["probe_select"]
    for r, rec in enumerate(report["e"]):
        if not rec["build"]["on_host"]:
            raise AssertionError(f"(e) rank {r}: the table is not "
                                 "host-resident")
        if rec["launches"]["probe_select"] != want_b4:
            raise AssertionError(
                f"(e) rank {r}: {rec['launches']['probe_select']} B4 "
                f"launches, phase 10 (a) {want_b4}")
    report["wall_s"] = time.perf_counter() - t_phase
    report["launches"] = total
    log(f"[11 sharded] {RANKS} ranks sharing the card over gloo, and 1 "
        f"NCCL rank: validate stdout (in core and windowed), the NCCL "
        f"build, the pipeline's sums and the sharded merge equal their "
        f"one-card counterparts; {report['wall_s']:.1f} s; launches "
        f"{total}")
    return total, report


RUNNER_CHUNK = 4096  # bases a read chunk in phase 12's corpus: B2 runs
KERNEL_KEYS = tuple(key for _n, key, _s, _t, _p in KERNELS)


def run_runner(args, keys=()):
    """The port's golden harness, in-process on `args`, as a main path:
    the launch counts are set to 0 just before it and read just after,
    and every kernel in `keys` must have launched.  Returns (stdout,
    exit code, wall seconds, launches)."""
    import torch

    from kreeq_tpu_torch.cli import validate_runner
    from kreeq_tpu_torch.ops import kernels

    kernels.reset_launches()
    buf = io.StringIO()
    rc = None
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            validate_runner.main(list(args))
        except SystemExit as e:
            rc = e.code
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, keys, f"runner {args}")
    return buf.getvalue(), rc, wall, launches


def _passed(out: str, n: int, what: str) -> None:
    lines = out.splitlines()
    bad = [ln for ln in lines if not ln.startswith("\033[0;32mPASS\033[0m ")]
    if len(lines) != n or bad:
        raise AssertionError(f"{what}: {len(lines)} lines for {n} tests, "
                             f"not passed: {bad[:6]}")


WARMUP_LINE = re.compile(r"warmup: (\d+) programs compiled/cached in "
                         r"([0-9.]+)s \(k=21, chunk=8388608, "
                         r"window=4194304\)")


def phase_runner(fq, fa, tmp, validate_out, wall4, seed, device):
    """Phase 12: the golden harness and the warmup on the card.  (a) a
    golden corpus from `seed` (chip_smoke.write_corpus), its DBs and
    tracks and its goldens written by the port on the CPU
    (cli/generate_tests), run on the card by the port's runner
    (cli/validate_runner) at RUNNER_CHUNK bases a chunk: every test
    must pass; (b) one golden line changed must fail; (c) phase 4's
    `validate -r -f` and `validate -d reads.kreeq -f` at full size,
    each a .tst naming phase 4's stdout as its external golden; (d)
    `kreeq warmup` at its default shapes in this process (every kernel
    must launch) and as a fresh process (its wall: the cold start)."""
    from kreeq_tpu_torch.cli import generate_tests
    from kreeq_tpu_torch.cli.main import run as cli_run

    start = time.perf_counter()
    rec = {}
    total = {key: 0 for key in KERNEL_KEYS}

    def add(launches):
        for key in total:
            total[key] += launches[key]

    # (a)
    root = os.path.join(tmp, "corpus")
    vf = os.path.join(root, "validateFiles")
    t0 = time.perf_counter()
    with env(PLATFORM="cpu", CHUNK=RUNNER_CHUNK):
        write_corpus(root, seed, run_cli)
        stdin, sys.stdin = sys.stdin, io.StringIO("Y\n")
        cwd = os.getcwd()
        os.chdir(root)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                generate_tests.main()
        finally:
            os.chdir(cwd)
            sys.stdin = stdin
    cpu_s = time.perf_counter() - t0
    n_tst = len(os.listdir(vf))
    with env(PLATFORM=None, CHUNK=RUNNER_CHUNK):
        out, rc, wall, launches = run_runner(
            [vf], ("extract", "count", "merge", "probe_qv", "probe_sorted"))
    _passed(out, n_tst, "(a) the corpus on the card")
    if rc != 0:
        raise AssertionError(f"(a) runner exit code {rc}")
    add(launches)
    rec["corpus"] = {"tests": n_tst, "passed": n_tst, "rc": rc,
                     "cpu_s": cpu_s, "wall_s": wall, "launches": launches}
    log(f"[12 runner] (a) {n_tst} .tst written on the CPU (corpus, DBs, "
        f"tracks and goldens) in {cpu_s:.2f} s, all {n_tst} PASS on the "
        f"card in {wall:.2f} s (rc 0); launches {launches}")

    # (b)
    with open(os.path.join(vf, "test.0.tst")) as fh:
        lines = fh.read().split("\n")
    lines[3] = lines[3].replace("kmers: ", "kmers: 1")
    planted = os.path.join(root, "planted", "test.0.tst")
    os.makedirs(os.path.dirname(planted))
    with open(planted, "w") as fh:
        fh.write("\n".join(lines))
    with env(PLATFORM=None, CHUNK=RUNNER_CHUNK):
        out, rc, wall, launches = run_runner([planted])
    fail = f"\033[0;31mFAIL\033[0m {planted} expected output did not match"
    if rc != 1 or not out.startswith(fail):
        raise AssertionError(f"(b) planted line: rc {rc}, stdout {out!r}")
    add(launches)
    rec["planted"] = {"rc": rc, "wall_s": wall}
    log(f"    (b) a changed golden line: FAIL, rc {rc}")

    # (c) and (d) on the card at the default chunk
    os.environ.pop("KREEQ_TPU_PLATFORM", None)
    db = os.path.join(tmp, "reads.kreeq")
    full = os.path.join(tmp, "full")
    os.makedirs(full)
    golden = os.path.join(full, "phase4.out")
    with open(golden, "w") as fh:
        fh.write(validate_out)
    rec["full"] = []
    for name, cmd, keys in (
            ("validate_r", f"kreeq validate -r {fq} -f {fa} -k {K}",
             ("extract", "count", "merge", "probe_qv")),
            ("validate_d", f"kreeq validate -d {db} -f {fa}",
             ("probe_qv",))):
        tst = os.path.join(full, name + ".tst")
        with open(tst, "w") as fh:
            fh.write(f"{cmd}\n{golden}\n")
        out, rc, wall, launches = run_runner([tst], keys)
        _passed(out, 1, f"(c) {name}")
        add(launches)
        rec["full"].append({"tst": name, "cmd": cmd, "rc": rc,
                            "wall_s": wall, "launches": launches})
        log(f"    (c) {name} `{cmd.split(' ', 3)[-1][:60]}...` PASS in "
            f"{wall:.2f} s (phase 4's wall {wall4:.2f} s); launches "
            f"{launches}")
    rec["phase4_wall_s"] = wall4

    # (d)
    from kreeq_tpu_torch.ops import kernels

    kernels.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_run(["kreeq", "warmup"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, KERNEL_KEYS, "warmup")
    m = WARMUP_LINE.fullmatch(buf.getvalue().splitlines()[-1])
    if rc != 0 or not m:
        raise AssertionError(f"warmup: rc {rc}, {buf.getvalue()!r}")
    add(launches)
    rec["warmup"] = {"programs": int(m.group(1)), "s": float(m.group(2)),
                     "wall_s": wall, "launches": launches}
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "kreeq_tpu_torch.cli.main",
                          "warmup"], cwd=here, capture_output=True,
                         text=True, timeout=600)
    wall_p = time.perf_counter() - t0
    last = res.stdout.splitlines()[-1] if res.stdout.strip() else ""
    mp = WARMUP_LINE.fullmatch(last)
    if res.returncode != 0 or not mp:
        raise AssertionError(f"warmup process: rc {res.returncode}, "
                             f"{res.stdout[-500:]!r} {res.stderr[-2000:]}")
    # each program's seconds in the fresh process, from its stderr
    ticks = [(t.group(1), float(t.group(2))) for t in re.finditer(
        r"warmup: (.+) \(([0-9.]+)s\)$", res.stderr, re.MULTILINE)]
    rec["warmup_process"] = {"programs": int(mp.group(1)),
                             "s": float(mp.group(2)), "wall_s": wall_p,
                             "ticks": ticks}
    rec["phase_s"] = time.perf_counter() - start
    log(f"    (d) `kreeq warmup` in this process: {m.group(1)} programs "
        f"in {m.group(2)} s (wall {wall:.2f} s); launches {launches}; as "
        f"a fresh process: {mp.group(1)} programs in {mp.group(2)} s, "
        f"wall {wall_p:.2f} s from the spawn; its slowest: "
        f"{sorted(ticks, key=lambda t: -t[1])[:4]}; phase 12 in "
        f"{rec['phase_s']:.1f} s")
    return total, rec


# ---------------------------------------------------------------------------
# phase 13: the entry points and the soak

ENTRY_RANKS = 2  # ranks of (b) and (c), sharing the one card over gloo
SOAK_MBP = 10  # genome of (d): the JAX soak's 100 Mbp cut to a tenth
SOAK_COVERAGE = 10
# the JAX soak's caps (5 * 10^7 and 2.5 * 10^7 rows at 100 Mbp) in the
# same ratio to the genome, so the table windows and host merges engage
SOAK_CAPS = {"MAX_TABLE_ROWS": 5_000_000, "HOST_MERGE_ROWS": 2_500_000}
SOAK_VCF_SLICE = 3_000_000
SOAK_TIMEOUT_S = 600


def _descendants(pid: int) -> list:
    """Every living descendant of `pid`, from /proc (the soak's phases
    run in sessions of their own, out of reach of a group kill)."""
    children = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as fh:
                    ppid = int(fh.read().rsplit(") ", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            children.setdefault(ppid, []).append(int(name))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def run_soak(workdir: str) -> dict:
    """`python -m kreeq_tpu_torch.soak workdir SOAK_MBP SOAK_COVERAGE` as
    a subprocess under SOAK_CAPS, one attempt a phase; the record of its
    last line.  On a failure or past SOAK_TIMEOUT_S it and every process
    it started are killed."""
    here = os.path.dirname(os.path.abspath(__file__))
    environ = {**os.environ, **{f"KREEQ_TPU_{k}": str(v)
                                for k, v in SOAK_CAPS.items()},
               "KREEQ_TPU_SOAK_VCF_SLICE": str(SOAK_VCF_SLICE),
               "KREEQ_TPU_SOAK_ATTEMPTS": "1",
               "KREEQ_TPU_SOAK_COOLDOWN_S": "0",
               "KREEQ_TPU_SOAK_STALL_S": "300"}
    for name in ("PLATFORM", "CHUNK", "BUILD_CKPT", "SOAK_REUSE",
                 "SOAK_MIRROR"):
        environ.pop(f"KREEQ_TPU_{name}", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kreeq_tpu_torch.soak", workdir,
         str(SOAK_MBP), str(SOAK_COVERAGE)], cwd=here, env=environ,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=SOAK_TIMEOUT_S)
    finally:
        for pid in _descendants(proc.pid) + [proc.pid]:
            try:
                os.kill(pid, 9)
            except OSError:
                pass
        proc.wait()
    lines = out.splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"(d) the soak exited {proc.returncode}:\n"
                             + "\n".join(lines[-30:]))
    for line in lines[:-1]:
        log(f"    {line}")
    return json.loads(lines[-1].split(" ", 1)[1])


def phase_entry(tmp, device):
    """Phase 13: the entry points (entry.py) and the soak
    (soak.py) on the card.  (a) entry()'s step on the card and its four
    numbers against the same step on the CPU's plain versions; (b)
    dryrun_multichip(ENTRY_RANKS), its ranks sharing the card over gloo;
    (c) cli_golden_sharded over phase 12's corpus on as many ranks: the
    four .tst must pass; (d) the soak at SOAK_MBP Mbp, SOAK_COVERAGE x,
    k = 31, under SOAK_CAPS, as subprocesses: every phase in one
    attempt, every planted variant without a VCF row in a gap of the
    reads, and the DB, the QV stdout, the .bkwig and the VCF equal to
    the same commands run in core in this process, with no caps and no
    checkpoint, on the same files.  Returns (launches of (a) and (b)
    summed, the record)."""
    import torch

    from kreeq_tpu_torch import entry
    from kreeq_tpu_torch.ops import kernels

    start = time.perf_counter()
    rec = {}

    # (a)
    fn, args = entry.entry()
    if any(a.device != device for a in args):
        raise AssertionError(f"(a) entry() put its inputs on "
                             f"{[str(a.device) for a in args]}")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [int(x) for x in fn(*args)]
    wall = time.perf_counter() - t0
    la = dict(kernels.LAUNCHES)
    check_launches(la, ("extract", "count", "probe_select"), "entry()")
    want = [int(x) for x in fn(*(a.cpu() for a in args))]
    if got != want:
        raise AssertionError(f"(a) entry() on the card {got}, on the CPU "
                             f"{want}")
    # the step again, warm: its own time, not its first call's
    warm_ms = statistics.median(cuda_times(lambda: fn(*args)))
    rec["entry"] = {"numbers": got, "wall_s": wall, "warm_ms": warm_ms,
                    "launches": la}
    log(f"[13 entry] (a) entry(): (n, valid, missing, edge-missing) = "
        f"{got} on the card, equal to the CPU's plain versions; first "
        f"call {wall * 1e3:.1f} ms, warm {warm_ms:.2f} ms; launches {la}")

    # (b)
    res = entry.dryrun_multichip(ENTRY_RANKS)
    lb = res["launches"]
    check_launches(lb, ("extract", "count", "probe_sorted"),
                   "dryrun_multichip")
    if any(r["device"] == "cpu" for r in res["per_rank"]):
        raise AssertionError(f"(b) a rank ran on the CPU: {res}")
    rec["dryrun"] = {k: res[k] for k in ("ranks", "sums", "launches",
                                         "wall_s")}
    rec["dryrun"]["backend"] = res["per_rank"][0]["backend"]
    log(f"    (b) dryrun_multichip({ENTRY_RANKS}): (tot, missing, "
        f"edge-missing) = {res['sums']} over {ENTRY_RANKS} ranks "
        f"({rec['dryrun']['backend']}), {res['wall_s']:.2f} s from the "
        f"spawn; launches {lb}")

    # (c)
    t0 = time.perf_counter()
    ran = entry.cli_golden_sharded(os.path.join(tmp, "corpus"),
                                   ENTRY_RANKS)
    if ran != 4:
        raise AssertionError(f"(c) {ran} .tst run, not 4")
    picks = [os.path.basename(t) for t in
             entry.golden_picks(os.path.join(tmp, "corpus"))]
    rec["golden_sharded"] = {"tst": picks, "passed": ran,
                             "wall_s": time.perf_counter() - t0}
    log(f"    (c) cli_golden_sharded: {picks} PASS as {ENTRY_RANKS} ranks "
        f"under KREEQ_TPU_FORCE_SHARDED=1 in "
        f"{rec['golden_sharded']['wall_s']:.2f} s")

    # (d)
    wd = os.path.join(tmp, "soak")
    t0 = time.perf_counter()
    soak = run_soak(wd)
    soak_s = time.perf_counter() - t0
    if soak.get("soak") != "complete":
        raise AssertionError(f"(d) {soak}")
    if any(p["attempts"] != 1 for p in soak["phases"].values()):
        raise AssertionError(f"(d) a phase ran again: {soak['phases']}")
    found, total = soak["recall"]
    if found != total - len(soak["missed"]) or any(
            m[3] != 0 for m in soak["missed"]):
        raise AssertionError(f"(d) missed a variant the reads hold: "
                             f"{soak['missed']}")
    if not soak["table_windows"] or soak["host_merges"]["build"] < 1 \
            or soak["ckpt_parts"] < 2:
        raise AssertionError(f"(d) not out of core: {soak}")
    with env(PLATFORM=None, CHUNK=None, BUILD_CKPT=None,
             MAX_TABLE_ROWS=None, HOST_MERGE_ROWS=None):
        incore = {}
        db = os.path.join(wd, "incore.kreeq")
        for name, argv, keys in (
                ("build", ["-r", os.path.join(wd, "reads.fastq"), "-k", "31",
                           "-o", db], ("extract", "count", "merge")),
                ("qv", ["-d", db, "-f", os.path.join(wd, "asm.fasta"), "-o",
                        os.path.join(wd, "incore.bkwig")],
                 ("extract", "probe_select")),
                ("vcf", ["-d", db, "-f", os.path.join(wd, "asm10.fasta"),
                         "-o", os.path.join(wd, "incore.vcf"),
                         "--search-depth", "50", "--max-span", "32"],
                 ("extract", "probe_sorted"))):
            out, launches, _ph, wall, _peak = drive(
                ["kreeq", "validate", *argv], keys, f"(d) in core {name}",
                device)
            incore[name] = {"wall_s": wall, "launches": launches}
            if name == "qv":
                with open(os.path.join(wd, "phase_qv.out")) as fh:
                    if fh.read() != out:
                        raise AssertionError("(d) the soak's QV stdout "
                                             "differs from the in-core one")
    same_output(os.path.join(wd, "soak.kreeq"), db)
    same_output(os.path.join(wd, "asm.bkwig"),
                os.path.join(wd, "incore.bkwig"))
    same_output(os.path.join(wd, "asm10.vcf"),
                os.path.join(wd, "incore.vcf"))
    soak["wall_s"] = soak_s
    soak["in_core"] = incore
    rec["soak"] = soak
    rec["phase_s"] = time.perf_counter() - start
    log(f"    (d) soak at {SOAK_MBP} Mbp, {SOAK_COVERAGE}x, caps "
        f"{SOAK_CAPS}: {soak_s:.1f} s; phases "
        + ", ".join(f"{n} {p['wall_s']:.1f} s ({p['peak_rss_gb']:.1f} GB)"
                    for n, p in soak["phases"].items())
        + f"; recall {found}/{total}, missed {soak['missed']}; "
        f"{soak['ckpt_parts']} parts, {soak['ckpt_merges']} merges, host "
        f"merges {soak['host_merges']}, {soak['table_windows']}; DB, QV "
        f"stdout, .bkwig and VCF equal to the in-core run ("
        + ", ".join(f"{n} {r['wall_s']:.1f} s" for n, r in incore.items())
        + f"); phase 13 in {rec['phase_s']:.1f} s")
    total_launches = {key: la[key] + lb[key] for key in la}
    return total_launches, rec


def run_module(module: str, timeout: float, **switches):
    """`python -m module` as a fresh process on the card (no
    KREEQ_TPU_PLATFORM; `switches` added to the environment), from the
    repository root; (stdout, stderr, wall s).  Raises unless it exits 0
    with some output; on a failure or past `timeout` it and every
    process it started are killed."""
    import torch

    torch.cuda.empty_cache()  # the process needs the card too
    environ = {**os.environ, **switches}
    environ.pop("KREEQ_TPU_PLATFORM", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", module],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=environ,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        for pid in _descendants(proc.pid) + [proc.pid]:
            try:
                os.kill(pid, 9)
            except OSError:
                pass
        proc.wait()
    if proc.returncode != 0 or not out.strip():
        raise AssertionError(f"{module} exited {proc.returncode}:\n"
                             + "\n".join((out + err).splitlines()[-30:]))
    return out, err, time.perf_counter() - t0


BENCH_DEADLINE_S = 300  # phase 14's deadline for the bench's watchdog
BENCH_STAGES = ("count", "probe_qv", "probe_track", "merge")


def phase_bench():
    """Phase 14: `python -m kreeq_tpu_torch.bench` as a fresh process
    under its watchdog, with the deadline BENCH_DEADLINE_S: its last
    line must be complete, with a value above 0, every stage exact, the
    QV window's #missing 0 and B1-B4 launched.  On a failure or past the
    deadline it and every process it started are killed.  Returns (the
    bench's launches, its last line)."""
    out, err, wall = run_module(
        "kreeq_tpu_torch.bench", BENCH_DEADLINE_S + 60,
        KREEQ_TPU_BENCH_DEADLINE=str(BENCH_DEADLINE_S))
    lines = out.splitlines()
    for line in err.splitlines():
        log(f"    | {line}")
    last = json.loads(lines[-1])
    extra = last["extra"]
    if extra.get("incomplete") or not last["value"] > 0:
        raise AssertionError(f"the bench did not complete: {lines[-1]}")
    stages = extra["stages"]
    if not all(stages[name]["exact"] for name in BENCH_STAGES) \
            or stages["probe_qv"]["missing"] != 0:
        raise AssertionError(f"the bench's stages: {stages}")
    launches = extra["launches"]
    check_launches(launches, ("extract", "sort", "count", "merge",
                              "probe_qv", "probe_select"), "bench")
    log(f"[14 bench] {last['value']:.0f} {last['unit']} "
        f"({last['vs_baseline']:.3f}x the CPU oracle on "
        f"{extra['host_cores']} cores); steps (median ms): count "
        f"{extra['count_step_ms']:.3f}, directory {extra['index_ms']:.3f}, "
        f"QV {extra['probe_qv_step_ms']:.3f}, track "
        f"{extra['probe_track_step_ms']:.3f}, merge "
        f"{extra['merge_step_ms']:.3f}; kernels "
        + ", ".join(f"{stages[s]['kernel']} {stages[s]['kernel_ms']:.3f} ms "
                    f"(bound {stages[s]['bound_ms']:.3f} ms, "
                    f"{stages[s]['share_of_bound']:.1%})"
                    for s in BENCH_STAGES)
        + f"; exact; launches {launches}; {len(lines)} lines in "
        f"{wall:.1f} s")
    return launches, last


# phase 15: the path benches, as the scripts they port name their lines
PATH_BENCHES = {
    "variants": ("DB build:", "batched:", "per-position:", "speedup:",
                 "outputs identical"),
    "subgraph": ("DB build:", "seed subgraph:", "batched traversal (cold):",
                 "batched traversal (warm):", "scalar traversal:",
                 "speedup:", "prefiltered best-first:",
                 "exhaustive best-first:", "best-first speedup:"),
}
PATH_BENCH_TIMEOUT_S = 400


def phase_paths():
    """Phase 15: `python -m kreeq_tpu_torch.bench_variants` and
    `bench_subgraph` as fresh processes at the scripts' sizes (n =
    1,000,000, k = 21), one after the other, each under
    PATH_BENCH_TIMEOUT_S: each must exit 0 with the script's lines and
    a JSON last line from the card, every batched path equal to its
    scalar loop, and B5 launched on the path and exact against its plain
    version at the path's shapes.  On a failure or past the timeout a
    bench and every process it started are killed.  Returns (the
    launches of both, summed; {name: its record})."""
    launches, records = {}, {}
    for name, heads in PATH_BENCHES.items():
        out, _err, wall = run_module(f"kreeq_tpu_torch.bench_{name}",
                                     PATH_BENCH_TIMEOUT_S)
        lines = out.splitlines()
        rec = json.loads(lines[-1])
        if [h for h in heads if not any(line.startswith(h)
                                         for line in lines)]:
            raise AssertionError(f"bench_{name}: the script's lines are "
                                 f"missing:\n{out}")
        if not all(v is True for v in rec["identical"].values()):
            raise AssertionError(f"bench_{name}: {rec['identical']}")
        if rec["device"]["type"] != "cuda":
            raise AssertionError(f"bench_{name} ran on {rec['device']}")
        for what, b5 in rec["b5"].items():
            if b5["max_abs_err"] != 0.0 or not b5["ms"] > 0:
                raise AssertionError(f"bench_{name}: B5 {what} {b5}")
        check_launches(rec["launches"], ("extract", "sort", "count",
                                         "probe_sorted"), f"bench_{name}")
        for key, n in rec["launches"].items():
            launches[key] = launches.get(key, 0) + n
        rec["wall_s"] = wall
        records[name] = rec
        for line in lines[:-1]:
            log(f"    | {line}")
        log(f"[15 {name}] exit 0 in {wall:.1f} s; steps (s) "
            + ", ".join(f"{k} {v:.3f}" for k, v in rec["steps_s"].items())
            + "; B5 " + ", ".join(
                f"{w} q={b['q']} {b['ms']:.4f} ms (bound {b['bound_ms']:.4f}"
                f" ms, sector floor {b['sector_floor_ms']:.4f} ms)"
                for w, b in rec["b5"].items())
            + f"; launches {rec['launches']}")
    return launches, records


def _busy_s(events) -> float:
    """Seconds in which the card ran at least one kernel, copy or set,
    from the device events of a chrome trace."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy / 1e6


def phase_profile(fa, tmp, out_dir, device):
    """Where the time of phase 6 goes: the DB writer on the host, and the
    card's share of a warm track run."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from kreeq_tpu_torch.io.kreeqdb import read_kreeq, write_kreeq

    os.makedirs(out_dir, exist_ok=True)
    db = os.path.join(tmp, "reads.kreeq")
    table = read_kreeq(db, device)
    again = os.path.join(tmp, "again.kreeq")
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    write_kreeq(again, table)
    prof.disable()
    write_s = time.perf_counter() - t0
    same_output(db, again)
    with open(os.path.join(out_dir, "db_write_profile.txt"), "w") as fh:
        for order in ("tottime", "cumulative"):
            pstats.Stats(prof, stream=fh).sort_stats(order).print_stats(30)
    stats = pstats.Stats(prof).stats
    own = sorted(((tt, nc, fn) for (_f, _l, fn), (_cc, nc, tt, _ct, _c)
                  in stats.items()), reverse=True)
    cum = {fn: ct for (_f, _l, fn), (_cc, _nc, _tt, ct, _c) in stats.items()}
    log(f"[7 profile] write_kreeq of {len(table)} rows under cProfile "
        f"{write_s:.2f} s, rewritten DB byte-equal; inside _write_phmap "
        f"{cum['_write_phmap']:.2f} s "
        f"({cum['_write_phmap'] / write_s:.1%}); own time:")
    for tt, nc, fn in own[:8]:
        log(f"    {tt:7.2f} s {tt / write_s:6.1%} {nc:8d} calls  {fn}")
    del table
    shutil.rmtree(again)

    bkwig = os.path.join(tmp, "asm.again.bkwig")
    argv = ["kreeq", "validate", "-d", db, "-f", fa, "-o", bkwig]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = os.path.join(out_dir, "tracks_trace.json")
    tprof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise AssertionError("the trace holds no device event")
    busy = _busy_s(events)
    by_name = {}
    for e in events:
        tot, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (tot + e["dur"] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    with open(os.path.join(out_dir, "tracks_profile.txt"), "w") as fh:
        fh.write(f"wall {wall:.3f} s, device busy {busy:.4f} s, idle "
                 f"{1 - busy / wall:.2%}\n")
        for name, (ms, n) in top:
            fh.write(f"{ms:10.3f} ms {n:6d}  {name}\n")
    log(f"    warm `-d -f -o asm.bkwig` under torch.profiler: wall "
        f"{wall:.2f} s, device busy {busy:.4f} s, idle "
        f"{1 - busy / wall:.2%}; device time by name:")
    for name, (ms, n) in top[:8]:
        log(f"    {ms:9.3f} ms {n:5d}x  {name[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the DB write and a warm track run "
                    "(phase 7), writing summaries and a trace to DIR")
    ap.add_argument("--rank-worker", metavar="JOB", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import kreeq_tpu_torch  # noqa: F401  (run from the repository root)

    if args.rank_worker:
        return rank_worker(args.rank_worker)

    device = torch.device("cuda", 0)

    start = time.perf_counter()
    card = phase_card()
    phase_build()
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fa, fq, read_bases, kcount = make_inputs(rng, GENOME_MBP, COVERAGE,
                                                 tmp)
        log(f"[data] {GENOME_MBP} Mbp assembly ({kcount} k-mers), "
            f"{read_bases / 1e6:.0f} Mbp of reads in "
            f"{os.path.getsize(fq) / 2**20:.0f} MiB FASTQ, generated in "
            f"{time.perf_counter() - t0:.1f} s")
        res = phase_kernels(fq, fa, device)
        launches = {}
        launches["validate"], validate_out, wall4 = phase_end_to_end(
            fq, fa, read_bases, kcount, res["ingest_s"], device)
        qv_rows = validate_out.splitlines()[-2:]
        phase_cuda_vs_cpu(args.seed)
        launches["tracks"] = phase_db_tracks(fq, fa, tmp, qv_rows, device)
        if args.profile:
            phase_profile(fa, tmp, args.profile, device)
        launches["variants"] = phase_variants(fa, tmp, qv_rows, device)
        phase_subgraph(tmp, device)
        ooc_launches, ooc = phase_out_of_core(fq, fa, tmp, validate_out,
                                              card, device)
        shard_launches, shard = phase_sharded(fq, fa, tmp, validate_out,
                                              ooc, card, device)
        runner_launches, runner = phase_runner(fq, fa, tmp, validate_out,
                                               wall4, args.seed, device)
        entry_launches, entry = phase_entry(tmp, device)
    bench_launches, bench = phase_bench()
    path_launches, paths = phase_paths()
    log(f"[done] all phases in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"paths": paths}))
    print(json.dumps(bench))
    print(json.dumps(entry))
    print(json.dumps({"runner": runner}))
    print(json.dumps({"out_of_core": ooc}))
    print(json.dumps({"sharded": shard}))

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[path][key],
         "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"],
         "bound_ms": res[name]["bound_ms"], "bound_by": "bytes",
         # no one PyTorch call computes any of the first six (PERF.md);
         # the sort's is torch.sort of its keys
         "library_ms": res[name].get("library_ms"),
         "shape": res[name]["shape"],
         **({"forms": res[name]["forms"]} if "forms" in res[name] else {}),
         "ooc_launches": ooc_launches[key],
         "sharded_launches": shard_launches[key],
         "runner_launches": runner_launches[key],
         "entry_launches": entry_launches[key],
         "bench_launches": bench_launches[key],
         "paths_launches": path_launches[key]}
        for name, key, src, tpu, path in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
