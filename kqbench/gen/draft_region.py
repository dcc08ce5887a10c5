"""A draft assembly cut to one region, with reads of the whole genome.

`genome_reads.make` writes the genome's reads and its whole assembly
with planted errors; this keeps `config["draft"]`'s region of one
assembly sequence, [start, end) after the errors are planted, as the
one FASTA record, under the sequence's name.  The reads, and so the
read DB, stay those of the whole genome.
"""

from __future__ import annotations

from . import Inputs
from .genome_reads import _write_fasta, make as whole


def make(config: dict, seed: int, workdir: str) -> Inputs:
    inputs = whole(config, seed, workdir)
    d = config["draft"]
    seq = dict(inputs.records)[d["sequence"]]
    if not 0 <= d["start"] < d["end"] <= len(seq):
        raise ValueError(f"the draft region [{d['start']}, {d['end']}) "
                         f"lies outside {d['sequence']} ({len(seq)} bp)")
    inputs.records = [(d["sequence"], seq[d["start"]:d["end"]])]
    _write_fasta(inputs.files["asm"], inputs.records,
                 config["assembly"]["line_width"])
    inputs.sizes["asm_bases"] = d["end"] - d["start"]
    return inputs
