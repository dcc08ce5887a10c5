"""VCF writer for candidate-error variants (gfalibs Report VCF writer
equivalent; format pinned by validateFiles/test.50.tst).

POS conventions (reconstructed from the golden):
  * SNV/COM: POS = pos+1 (1-based changed base), REF starts at the
    changed base, case preserved from the assembly;
  * INS (assembly has extra bases): POS = pos (1-based anchor), REF =
    anchor + removed bases, ALT = anchor;
  * DEL (assembly missing bases): POS = pos, REF = anchor + next base,
    ALT = anchor + inserted sequence + next base.
"""

from __future__ import annotations

import sys

from ..core.variants import COM, INS, SNV

HEADER = (
    "##fileformat=VCFv4.2\n"
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description='
    '"Genotype Quality">\n'
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n")


def write_vcf(dbg, out_file: str, out=None) -> None:
    genome = dbg.genome
    close = False
    if out is None:
        if "." in out_file:
            out = open(out_file, "w")
            close = True
        else:
            out = sys.stdout  # `-o vcf` streams the format to stdout
    out.write(HEADER)
    seg_index = {seg.uid: seg for seg in genome.segments}
    for path in genome.paths:
        abs_pos = 0
        for comp, obj in genome.path_components(path):
            if comp.ctype != "S":
                abs_pos += obj.dist
                continue
            seg = seg_index[obj.uid]
            seq = seg.seq
            for group in seg.variants:
                for var in group:
                    pos = var.pos
                    if var.type in (SNV, COM):
                        ref = seq[pos:pos + (var.ref_len
                                             if var.type == COM else 1)]
                        alt = var.sequence
                        vcf_pos = abs_pos + pos + 1
                    elif var.type == INS:
                        n = max(var.ref_len, 1)
                        ref = seq[pos - 1:pos + n]
                        alt = seq[pos - 1]
                        vcf_pos = abs_pos + pos
                    else:  # DEL
                        ref = seq[pos - 1:pos + 1]
                        alt = seq[pos - 1] + var.sequence + seq[pos]
                        vcf_pos = abs_pos + pos
                    out.write(f"{path.header}\t{vcf_pos}\t.\t{ref}\t{alt}"
                              f"\t0\tPASS\t.\tGT:GQ\t1/1:0\n")
            abs_pos += len(obj)
    if close:
        out.close()
