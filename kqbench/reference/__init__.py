"""The plain reference: kreeq's outputs worked out again in NumPy from
the sequences the benchmark generated.

It imports nothing of the program under test and takes nothing the
program made.  `expected` gives the stdout and the files a traffic's
job should produce; kqbench/control.py gives the same from a table
whose counters saturate at 8 bits.
"""

from __future__ import annotations

from .. import kinds
from .kmers import count_table, read_blocks, separated
from .validate import qv_text, score, summary_text

# bases of reads counted in one block of the table's build
BLOCK_BASES = 1 << 23

STDOUT_PARTS = ("summary", "qv")


def table_of(reads, offsets, k: int, threads=None):
    """The k-mer table of the reads (read i at offsets[i]:offsets[i + 1]
    of the base codes `reads`)."""
    stream = separated(reads, offsets)
    return count_table(stream, k, read_blocks(offsets, BLOCK_BASES),
                       threads)


def outputs(table, records, stdout, files):
    """(stdout parts, files, facts) of a job over `table` and the
    assembly `records` ((name, sequence bytes) each).

    stdout: the parts of stdout in order (STDOUT_PARTS); files: {file
    name: kind} (kqbench/kinds/).  The assembly is scored once, with
    the per-base tracks where a kind needs them.  Returns ({part:
    text}, {file name: bytes}, {"table_rows", "rows_found",
    "asm_windows"})."""
    for part in stdout:
        if part not in STDOUT_PARTS:
            raise ValueError(f"no reference for the stdout part {part!r}")
    mods = {name: kinds.find(kind) for name, kind in files.items()}
    k = table.k
    sc = score(table, records, tracks=any(
        getattr(m, "TRACKS", False) for m in mods.values()))
    text = {"summary": summary_text(table), "qv": qv_text(sc, k)}
    out = {name: m.expected(table, records, sc) for name, m in mods.items()}
    facts = {"table_rows": len(table.keys), "rows_found": sc.rows_found,
             "asm_windows": sc.kcount}
    return {p: text[p] for p in stdout}, out, facts


def expected(reads, offsets, records, k: int, stdout, files, threads=None):
    """outputs() of the table of these reads."""
    return outputs(table_of(reads, offsets, k, threads), records, stdout,
                   files)
