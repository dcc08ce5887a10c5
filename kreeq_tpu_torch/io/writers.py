"""Output writers: the bed/csv/kwig/bkwig/hist/gfa/vcf dispatch targets
(reference: src/kreeq-output.cpp:138-407).

Counterpart of kreeq_tpu/io/writers.py, host numpy on the per-segment
tracks that DBG.validate_sequences copied back from the device, and on
the variants that core/variants.py left on the segments; the bytes
written are the JAX package's.
"""

from __future__ import annotations

import struct
from typing import TextIO

import numpy as np

from .sequence import SEGMENT


def _iter_path_segments(dbg):
    """Yield (path, absPos, segment, track) walking path components
    (reference absPos bookkeeping: src/kreeq-output.cpp:156-238)."""
    genome = dbg.genome
    if genome is None:
        return
    genome.sort_paths_by_original()
    seg_index = {seg.uid: i for i, seg in enumerate(genome.segments)}
    for path in genome.paths:
        abs_pos = 0
        for comp, obj in genome.path_components(path):
            if comp.ctype == SEGMENT:
                track = dbg.tracks[seg_index[obj.uid]] if dbg.tracks else None
                yield path, abs_pos, obj, track
                abs_pos += len(obj)
            else:
                abs_pos += obj.dist


def print_table(dbg, ext: str, out: TextIO = None) -> None:
    """Per-base sliding-window table, .bed/.csv[table] (reference:
    src/kreeq-output.cpp:138-241).  Row i shows the k kmer/edge windows
    covering base i, zero-padded near segment starts."""
    if ext == "bed":
        col_sep, entry_sep = "\t", ":"
    elif ext == "csv":
        col_sep, entry_sep = ",", " "
    else:
        col_sep, entry_sep = ",", ","
    close = False
    if out is None:
        out = open(dbg.ui.out_file, "w")
        close = True
    k = dbg.k
    for path, abs_pos, seg, track in _iter_path_segments(dbg):
        ln = len(seg)
        z = np.zeros(k - 1, np.uint32)
        # each value renders k times (once per window covering it);
        # convert once up front instead of per row
        cov = [str(v) for v in np.concatenate([z, track.cov]).tolist()]
        # track.right/left are orientation-normalized already; the
        # reference stores raw fw/bw and swaps on output
        # (src/kreeq-output.cpp:197-207) — net effect identical.
        right = [str(v) for v in
                 np.concatenate([z, track.right]).tolist()]
        left = [str(v) for v in np.concatenate([z, track.left]).tolist()]
        hdr = path.header
        for i in range(ln):
            row = [hdr, str(abs_pos + i),
                   entry_sep.join(cov[i:i + k]),
                   entry_sep.join(right[i:i + k]),
                   entry_sep.join(left[i:i + k])]
            out.write(col_sep.join(row) + "\n")
    if close:
        out.close()


def write_csv_rows3(cols, out) -> None:
    """Write a [n,3] uint32 array as n 'a,b,c' lines (shared by the
    kwig writer and the bkwig decompressor)."""
    arr = np.asarray(cols, np.uint32).reshape(-1, 3)
    if arr.shape[0] == 0:
        return
    cells = arr.astype(str)
    rows = cells[:, 0]
    for c in range(1, 3):
        rows = np.char.add(np.char.add(rows, ","), cells[:, c])
    out.write("\n".join(rows.tolist()))
    out.write("\n")


def print_kwig(dbg, out: TextIO = None) -> None:
    """fixedStep text track (reference: src/kreeq-output.cpp:243-303)."""
    close = False
    if out is None:
        out = open(dbg.ui.out_file, "w")
        close = True
    out.write(f"{dbg.k}\n")
    for path, abs_pos, seg, track in _iter_path_segments(dbg):
        out.write(f"fixedStep chrom={path.header} start={abs_pos} step=1\n")
        write_csv_rows3(
            np.stack([track.cov, track.right, track.left], axis=1), out)
    if close:
        out.close()


def write_bkwig_index(dbg, fh) -> None:
    """Binary path index (reference: src/kreeq-output.cpp:305-354)."""
    genome = dbg.genome
    fh.write(struct.pack("<I", len(genome.paths)))
    for path in genome.paths:
        hdr = path.header.encode()
        fh.write(struct.pack("<H", len(hdr)))
        fh.write(hdr)
        ncomp = sum(1 for c in path.components if c.ctype == SEGMENT)
        fh.write(struct.pack("<I", ncomp))
        abs_pos = 0
        for comp, obj in genome.path_components(path):
            if comp.ctype == SEGMENT:
                fh.write(struct.pack("<QQB", abs_pos, len(obj), 1))
                abs_pos += len(obj)
            else:
                abs_pos += obj.dist


def print_bkwig(dbg) -> None:
    """Binary kwig (reference: src/kreeq-output.cpp:356-399): the index,
    then 12 bytes (u32 cov, right, left) per segment base."""
    if dbg.genome is None:
        return
    with open(dbg.ui.out_file, "wb") as fh:
        fh.write(struct.pack("<B", dbg.k))
        dbg.genome.sort_paths_by_original()
        write_bkwig_index(dbg, fh)
        for _path, _abs, seg, track in _iter_path_segments(dbg):
            arr = np.stack([track.cov, track.right, track.left],
                           axis=1).astype("<u4")
            fh.write(arr.tobytes())


def print_hist(dbg) -> None:
    """Coverage histogram (reference: src/kreeq-output.cpp:128-134)."""
    st = dbg.table.stats()
    with open(dbg.ui.out_file, "w") as fh:
        for cov in sorted(st.histogram):
            fh.write(f"{cov}\t{st.histogram[cov]}\n")


def print_gfa(dbg) -> None:
    """validate: the assembly graph, with segments split into bubbles at
    their variants; subgraph: the collapsed subgraph."""
    from .gfa_write import write_gfa

    if dbg.ui.mode == 0:
        dbg.genome.sort_segments_by_original()
        write_gfa(dbg.genome, dbg.ui.out_file, dbg.ui)
    else:
        write_gfa(dbg.subgraph_gfa, dbg.ui.out_file, dbg.ui)


def print_vcf(dbg, out: TextIO = None) -> None:
    if dbg.genome is None:
        return
    from .vcf import write_vcf

    dbg.genome.sort_paths_by_original()
    write_vcf(dbg, dbg.ui.out_file, out=out)
