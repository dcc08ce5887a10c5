"""GFA1/GFA2 writers (gfalibs Report::outFile GFA cases, reference:
src/kreeq-output.cpp:107-122)."""

from __future__ import annotations

import gzip
import sys

from ..config import get_file_ext
from .sequence import SEGMENT


def _fmt_tags(tags) -> str:
    return "".join(f"\t{name}:{typ}:{val}" for typ, name, val in tags)


def write_gfa(genome, out_file: str, ui) -> None:
    ext = get_file_ext("." + out_file)
    gfa2 = ext.startswith("gfa2")
    if "." in out_file:
        opener = gzip.open if ext.endswith(".gz") else open
        fh = opener(out_file, "wt")
        close = True
    else:
        fh, close = sys.stdout, False

    hdr = {}
    if gfa2:
        fh.write("H\tVN:Z:2.0\n")
    else:
        fh.write("H\tVN:Z:1.2\n")
    for seg in genome.segments:
        hdr[seg.uid] = seg.header
        if gfa2:
            fh.write(f"S\t{seg.header}\t{len(seg.seq)}\t{seg.seq}"
                     f"{_fmt_tags(seg.tags)}\n")
        else:
            fh.write(f"S\t{seg.header}\t{seg.seq}{_fmt_tags(seg.tags)}\n")
    for e in genome.edges:
        if e.sid1 not in hdr or e.sid2 not in hdr:
            continue
        if gfa2:
            fh.write(f"E\t{e.header}\t{hdr[e.sid1]}{e.or1}\t"
                     f"{hdr[e.sid2]}{e.or2}\t*\t*\t*\t*\t{e.cigar}"
                     f"{_fmt_tags(e.tags)}\n")
        else:
            fh.write(f"L\t{hdr[e.sid1]}\t{e.or1}\t{hdr[e.sid2]}\t{e.or2}"
                     f"\t{e.cigar}{_fmt_tags(e.tags)}\n")
    if not gfa2:
        for path in genome.paths:
            names = []
            intact = True
            for c in path.components:
                if c.ctype != SEGMENT:
                    continue
                if c.id not in hdr:
                    intact = False  # segment replaced by a bubble graph
                    break
                names.append(f"{hdr[c.id]}{c.orientation}")
            if intact and names:
                fh.write(f"P\t{path.header}\t{','.join(names)}\t*\n")
    if close:
        fh.close()
