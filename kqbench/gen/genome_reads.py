"""A genome, an assembly of it with planted errors, and reads of it.

Grown from the repository's first generator (chip_smoke.make_inputs:
uniform bases, one SNV, INS or DEL per 10 kbp of assembly, reads at
random places, half reverse-complemented, with substitutions), with the
skew that real genomes and reads have:
  - base composition: each sequence draws its bases at its own GC;
  - tandem repeats: a unit held `assembly_copies` times in the assembly
    and `genome_copies` times in the genome the reads come from (an
    rDNA array collapsed by the assembler);
  - dispersed repeats: identical copies of a unit at random places and
    orientations (rRNA operons, insertion sequences);
  - organelles: a sequence held `copies` times in the cell, so its
    reads come at that multiple of the coverage;
  - reads: short reads of one length with substitutions, or long reads
    of a length distribution with substitutions and 1-base indels.
Reads come in random order, as a sequencer's file holds them.

Every seed gets the same amount of work: the numbers of reads, of
errors of each kind and of repeat copies are fixed by the
configuration, and a long-read set's lengths are one fixed draw that
the seed only shuffles.  The seed moves what differs between two runs
of a real job: the bases, the places, the orientations.
"""

from __future__ import annotations

import os

import numpy as np

from . import Inputs

ASCII = np.frombuffer(b"ACGT", np.uint8)
# the fixed draw of long-read lengths
_LENGTH_SEED = 0


def _bases(rng, n: int, gc: float) -> np.ndarray:
    cdf = np.array([(1 - gc) / 2, 0.5, (1 + gc) / 2])
    return np.searchsorted(cdf, rng.random(n), side="right").astype(np.uint8)


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return 3 - codes[::-1]


def _free_place(rng, lengths, taken, size: int):
    """A (sequence, start) where `size` bases overlap nothing in
    `taken` (per sequence, a list of (start, end)); sequences are
    drawn by length."""
    p = np.asarray(lengths, float)
    p /= p.sum()
    for _ in range(10_000):
        s = int(rng.choice(len(lengths), p=p))
        if lengths[s] <= size:
            continue
        a = int(rng.integers(0, lengths[s] - size))
        if all(a + size <= x or a >= y for x, y in taken[s]):
            taken[s].append((a, a + size))
            return s, a
    raise ValueError(f"no room for a repeat of {size} bases")


def _plant_errors(rng, seq: np.ndarray, n: int) -> np.ndarray:
    """`seq` with n planted errors, a third each SNV, INS and DEL."""
    if n == 0:
        return seq
    pos = rng.choice(len(seq) - 1, size=n, replace=False)
    kind = rng.permutation(np.arange(n) % 3)
    out = seq.copy()
    snv = pos[kind == 0]
    out[snv] = (out[snv] + rng.integers(1, 4, len(snv))) % 4
    ins = np.sort(pos[kind == 1])
    dele = np.sort(pos[kind == 2])
    out = np.insert(out, ins, rng.integers(0, 4, len(ins)).astype(np.uint8))
    # a deletion's place after the insertions before it
    return np.delete(out, dele + np.searchsorted(ins, dele, side="right"))


def genome(config: dict, rng):
    """(assembly sequences, read-source sequences, read weights): the
    assembly's sequences as codes by name, the genome the reads come
    from (tandem arrays at their genome copy number), and each
    sequence's copies in the cell."""
    g = config["genome"]
    names = [s["name"] for s in g["sequences"]]
    asm = {s["name"]: _bases(rng, s["length"], s.get("gc", g["gc"]))
           for s in g["sequences"]}
    copies = {s["name"]: s.get("copies", 1) for s in g["sequences"]}
    nuclear = [n for n in names if copies[n] == 1]
    taken = {i: [] for i in range(len(nuclear))}
    tandems = {}
    for t in g.get("tandem", []):
        unit = _bases(rng, t["unit"], t.get("gc", g["gc"]))
        seq = asm[t["sequence"]]
        a = t["start"]
        span = t["unit"] * t["assembly_copies"]
        seq[a:a + span] = np.tile(unit, t["assembly_copies"])
        taken[nuclear.index(t["sequence"])].append((a, a + span))
        tandems[t["sequence"]] = (a, span, np.tile(unit, t["genome_copies"]))
    lengths = [len(asm[n]) for n in nuclear]
    for d in g.get("dispersed", []):
        unit = _bases(rng, d["length"], d.get("gc", g["gc"]))
        for _ in range(d["copies"]):
            s, a = _free_place(rng, lengths, taken, d["length"])
            asm[nuclear[s]][a:a + d["length"]] = (
                unit if rng.random() < 0.5 else _revcomp(unit))
    source = dict(asm)
    for name, (a, span, array) in tandems.items():
        seq = asm[name]
        source[name] = np.concatenate([seq[:a], array, seq[a + span:]])
    return asm, source, copies


def _short_reads(rng, source, copies, r: dict):
    """Reads of r["length"] bases at r["coverage"] of every copy, half
    reverse-complemented, with substitutions at r["substitution_rate"],
    in random order: codes [n, length]."""
    ln = r["length"]
    counts = {n: int(round(r["coverage"] * len(s) * copies[n] / ln))
              for n, s in source.items()}
    reads = np.empty((sum(counts.values()), ln), np.uint8)
    at = 0
    for name, seq in source.items():
        m = counts[name]
        starts = rng.integers(0, len(seq) - ln + 1, m)
        # gather in slices: an index array of every base would be large
        for i in range(0, m, 1 << 18):
            s = starts[i:i + (1 << 18)]
            reads[at + i:at + i + len(s)] = seq[s[:, None] + np.arange(ln)]
        at += m
    rc = np.flatnonzero(rng.random(len(reads)) < 0.5)
    reads[rc] = 3 - reads[rc, ::-1]
    flat = reads.reshape(-1)
    nsub = int(round(flat.size * r["substitution_rate"]))
    pos = rng.choice(flat.size, size=nsub, replace=False)
    flat[pos] = (flat[pos] + rng.integers(1, 4, nsub)) % 4
    return reads[rng.permutation(len(reads))]


def _long_lengths(r: dict, total: int) -> np.ndarray:
    """One fixed draw of read lengths whose sum first reaches `total`."""
    fixed = np.random.default_rng(_LENGTH_SEED)
    n = int(total / r["length_mean"] * 1.2) + 16
    lens = np.clip(np.rint(fixed.normal(r["length_mean"], r["length_sd"],
                                        n)),
                   r["length_min"], r["length_max"]).astype(np.int64)
    return lens[:int(np.searchsorted(np.cumsum(lens), total)) + 1]


def _long_reads(rng, source, copies, r: dict):
    """Reads of a fixed set of lengths at r["coverage"], half
    reverse-complemented, with r["error_rate"] errors per base, of
    which r["indel_share"] are 1-base indels split evenly between
    insertions and deletions; (codes, offsets)."""
    names = list(source)
    weight = np.array([len(source[n]) * copies[n] for n in names], float)
    lens = rng.permutation(_long_lengths(r, int(r["coverage"]
                                                * weight.sum())))
    which = rng.choice(len(names), size=len(lens), p=weight / weight.sum())
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = np.empty(offsets[-1], np.uint8)
    rc = rng.random(len(lens)) < 0.5
    for i, (ln, s) in enumerate(zip(lens, which)):
        seq = source[names[s]]
        a = int(rng.integers(0, len(seq) - ln + 1))
        read = seq[a:a + ln]
        codes[offsets[i]:offsets[i + 1]] = _revcomp(read) if rc[i] else read
    nerr = int(round(codes.size * r["error_rate"]))
    nindel = int(round(nerr * r["indel_share"]))
    nins = nindel // 2
    pos = rng.choice(codes.size, size=nerr, replace=False)
    sub, ins, dele = np.split(pos, [nerr - nindel, nerr - nindel + nins])
    codes[sub] = (codes[sub] + rng.integers(1, 4, len(sub))) % 4
    def per_read(p):
        return np.bincount(np.searchsorted(offsets, p, side="right") - 1,
                           minlength=len(lens))

    grow = per_read(ins) - per_read(dele)
    ins, dele = np.sort(ins), np.sort(dele)
    # an insertion goes before its base; a deletion drops its own base
    keep = np.ones(codes.size, bool)
    keep[dele] = False
    extra = rng.integers(0, 4, len(ins)).astype(np.uint8)
    codes = np.insert(codes, ins, extra)
    keep = np.insert(keep, ins, True)
    codes = codes[keep]
    np.cumsum(lens + grow, out=offsets[1:])
    return codes, offsets


def _write_fastq(path: str, reads, offsets) -> None:
    """Four-line FASTQ, reads named read000000001 on, quality 'I'."""
    n = len(offsets) - 1
    with open(path, "wb") as fh:
        if reads.ndim == 2:
            ln = reads.shape[1]
            head = 14  # "@read" + 9 digits
            row = head + 1 + ln + 3 + ln + 1
            for a in range(0, n, 1 << 18):
                m = min(n - a, 1 << 18)
                out = np.empty((m, row), np.uint8)
                out[:, :5] = np.frombuffer(b"@read", np.uint8)
                idx = np.arange(a + 1, a + m + 1)
                for d in range(9):
                    out[:, 13 - d] = ord("0") + (idx // 10 ** d) % 10
                out[:, head] = ord("\n")
                out[:, head + 1:head + 1 + ln] = ASCII[reads[a:a + m]]
                out[:, head + 1 + ln:head + 4 + ln] = np.frombuffer(
                    b"\n+\n", np.uint8)
                out[:, head + 4 + ln:row - 1] = ord("I")
                out[:, -1] = ord("\n")
                fh.write(out.tobytes())
            return
        for i in range(n):
            seq = ASCII[reads[offsets[i]:offsets[i + 1]]].tobytes()
            fh.write(b"@read%09d\n%s\n+\n%s\n"
                     % (i + 1, seq, b"I" * len(seq)))


def _write_fasta(path: str, records, width: int) -> None:
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(b">" + name.encode() + b"\n")
            n = len(seq)
            full = n - n % width
            body = np.frombuffer(seq, np.uint8)
            rows = np.empty((full // width, width + 1), np.uint8)
            rows[:, :width] = body[:full].reshape(-1, width)
            rows[:, width] = ord("\n")
            fh.write(rows.tobytes())
            if n % width:
                fh.write(seq[full:] + b"\n")


def make(config: dict, seed: int, workdir: str) -> Inputs:
    rng = np.random.default_rng(seed)
    asm, source, copies = genome(config, rng)
    records = []
    rate = config["assembly"]["errors_per_bp"]
    for name, seq in asm.items():
        planted = _plant_errors(rng, seq, int(round(len(seq) * rate)))
        records.append((name, ASCII[planted].tobytes()))
    r = config["reads"]
    if r["model"] == "short":
        reads = _short_reads(rng, source, copies, r)
        offsets = np.arange(len(reads) + 1, dtype=np.int64) * reads.shape[1]
        flat = reads.reshape(-1)
    elif r["model"] == "long":
        flat, offsets = _long_reads(rng, source, copies, r)
        reads = flat
    else:
        raise ValueError(f"unknown read model {r['model']!r}")
    files = {"reads": os.path.join(workdir, "reads.fq"),
             "asm": os.path.join(workdir, "asm.fa")}
    _write_fastq(files["reads"], reads, offsets)
    _write_fasta(files["asm"], records, config["assembly"]["line_width"])
    sizes = {"read_bases": int(offsets[-1]), "reads": len(offsets) - 1,
             "asm_bases": sum(len(s) for _n, s in records)}
    return Inputs(files, flat, offsets, records, sizes)
