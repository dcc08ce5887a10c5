"""FASTA/FASTQ/GFA ingest (gfalibs StreamObj + loadGenome equivalent).

Format detection by first byte ('>' FASTA, '@' FASTQ, else GFA), as in
the reference (reference: src/input.cpp:206-293).  Transparent gzip by
magic bytes (reference uses zlib streams).
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, Tuple, Union

from .. import native
from .sequence import Genome


def open_text(path: str) -> io.TextIOBase:
    """Open a possibly-gzipped text file; path "-" reads stdin.

    The reference's StreamObj supports plain/gzip/stdin pipes
    (gfalibs stream-obj.h; the snapshot CLI's isPipe branch at
    src/main.cpp:55 is never taken, so "-" here is a strict superset).
    """
    if path == "-":
        import sys

        data = sys.stdin.buffer.read()
        if data[:2] == b"\x1f\x8b":
            data = gzip.decompress(data)
        return io.StringIO(data.decode("latin-1"))
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="latin-1")
    return open(path, "r", encoding="latin-1")


def _split_header(line: str) -> Tuple[str, str]:
    """Header token + optional comment (reference: src/input.cpp:214-221)."""
    parts = line.split(None, 1)
    if not parts:
        return "", ""
    return parts[0], (parts[1] if len(parts) > 1 else "")


def iter_fasta(stream) -> Iterator[Tuple[str, str, str]]:
    header, comment, chunks = None, "", []
    for line in stream:
        line = line.rstrip("\r\n")
        if line.startswith(">"):
            if header is not None:
                yield header, comment, "".join(chunks)
            header, comment = _split_header(line[1:])
            chunks = []
        elif line:
            chunks.append(line)
    if header is not None:
        yield header, comment, "".join(chunks)


def iter_fastq(stream) -> Iterator[Tuple[str, str, str, str]]:
    while True:
        h = stream.readline()
        if not h:
            return
        h = h.rstrip("\r\n")
        if not h:
            continue
        seq = stream.readline().rstrip("\r\n")
        stream.readline()  # '+'
        qual = stream.readline().rstrip("\r\n")
        header, comment = _split_header(h[1:])
        yield header, comment, seq, qual


def iter_reads(path: str) -> Iterator[Union[str, native.ReadBatch]]:
    """Yield the reads of a FASTA or FASTQ (possibly .gz) file.

    The native C++ parser, when available, yields the whole file as one
    native.ReadBatch (every read's codes followed by one BAD, and the
    reads' ends), from which ops/kmers.pack_reads cuts chunks with one
    copy each; iterating the batch gives per-read code arrays.  The
    pure-Python fallback (no compiler or zlib, or "-") yields one string
    a read.
    """
    from . import native_enabled

    if native_enabled() and path != "-":
        batch = native.parse_fastx(path)
        if batch is not None:
            yield batch
            return
    with open_text(path) as stream:
        first = stream.read(1)
        if not first:
            return
        stream_all = io.StringIO(first + stream.read())
        if first == ">":
            for _h, _c, seq in iter_fasta(stream_all):
                yield seq
        else:
            for _h, _c, seq, _q in iter_fastq(stream_all):
                yield seq


def load_genome(path: str, genome: Genome) -> Genome:
    """Load an assembly (FASTA/FASTQ/GFA, possibly .gz) into a Genome."""
    with open_text(path) as stream:
        data = stream.read()
    if not data:
        return genome
    first = data[0]
    buf = io.StringIO(data)
    if first == ">":
        for pos, (h, c, seq) in enumerate(iter_fasta(buf)):
            genome.append_sequence(h, c, seq, pos)
    elif first == "@":
        for pos, (h, c, seq, _q) in enumerate(iter_fastq(buf)):
            genome.append_sequence(h, c, seq, pos)
    else:
        load_gfa(buf, genome)
    return genome


def load_gfa(stream, genome: Genome) -> Genome:
    """Minimal GFA1/GFA2 reader covering the reference test corpus.

    Reference: gfalibs readGFA (called from src/input.cpp:289).  Supports
    S/L/E/P lines; P lines bind existing segments into paths (fixture:
    testFiles/random1.gfa).  Segments not referenced by any P line get a
    single-segment path of the same header (gfastar convention).
    """
    from .sequence import SEGMENT, PathComponent, Path, Edge

    s_lines = []
    p_lines = []
    link_lines = []  # (name1, or1, name2, or2, cigar)
    for line in stream:
        line = line.rstrip("\r\n")
        if not line:
            continue
        f = line.split("\t")
        if f[0] == "S":
            if len(f) >= 4 and f[2].isdigit():
                # GFA2: S <sid> <slen> <sequence|*>
                seq = "" if f[3] == "*" else f[3]
                s_lines.append((f[1], seq, f[4:]))
            else:
                seq = "" if f[2] == "*" else f[2]
                s_lines.append((f[1], seq, f[3:]))
        elif f[0] == "P":
            p_lines.append(f[1:])
        elif f[0] == "L" and len(f) >= 5:
            link_lines.append((f[1], f[2], f[3], f[4],
                               f[5] if len(f) > 5 else "0M"))
        elif f[0] == "E" and len(f) >= 4:
            # GFA2: E <eid> <sid1><or> <sid2><or> [coords...] [aln]
            n1, o1 = f[2][:-1], f[2][-1]
            n2, o2 = f[3][:-1], f[3][-1]
            if o1 in "+-" and o2 in "+-":
                link_lines.append((n1, o1, n2, o2,
                                   f[8] if len(f) > 8 else "0M"))

    seg_by_name = {}
    for pos, (name, seq, tags) in enumerate(s_lines):
        seg = genome.add_segment(name, seq, seq_pos=pos, tags=list(tags))
        seg_by_name[name] = seg

    in_path = set()
    for pos, pf in enumerate(p_lines):
        name, comps = pf[0], pf[1]
        comment = ""
        for extra in pf[2:]:
            if extra.startswith("CM:Z:"):
                comment = extra[5:]
        path = Path(name, seq_pos=pos, comment=comment)
        for token in comps.split(","):
            orientation = token[-1] if token[-1] in "+-" else "+"
            sname = token[:-1] if token[-1] in "+-" else token
            seg = seg_by_name[sname]
            path.components.append(PathComponent(SEGMENT, seg.uid,
                                                 orientation))
            in_path.add(sname)
        genome.paths.append(path)

    for name1, or1, name2, or2, cigar in link_lines:
        if name1 in seg_by_name and name2 in seg_by_name:
            genome.add_edge(Edge(genome.next_uid(), len(genome.edges),
                                 seg_by_name[name1].uid,
                                 seg_by_name[name2].uid, or1, or2, cigar))

    # segments not referenced by any P line become single-segment paths
    # (gfastar convention), so path-driven outputs still cover them
    for pos, (name, _seq, _tags) in enumerate(s_lines):
        if name not in in_path:
            seg = seg_by_name[name]
            genome.paths.append(
                Path(name, [PathComponent(SEGMENT, seg.uid, "+")],
                     seq_pos=len(genome.paths)))
    return genome
