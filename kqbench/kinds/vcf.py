"""`.vcf`, kreeq's candidate errors (`-o x.vcf`): the gfalibs header,
then a row a record of each segment's searches, in path and position
order (kqbench/reference/variants.py)."""

from __future__ import annotations

from kqbench.reference.variants import vcf

CHECK = "vcf_records_off"
LIMIT = 0
TRACKS = False


def expected(table, records, score) -> bytes:
    """The reference's VCF at the CLI's defaults: `max_span` 5, search
    depth k (best-first), cutoff 0."""
    return vcf(table, records)


def values_off(got: bytes, want: bytes) -> int:
    """Lines of a `.vcf` that differ from the reference's, the header's
    and then the records', line by line in order; a missing or extra
    line counts once."""
    g = got.decode("ascii", "replace").splitlines()
    w = want.decode("ascii", "replace").splitlines()
    gh = [x for x in g if x.startswith("#")]
    wh = [x for x in w if x.startswith("#")]
    gr = [x for x in g if not x.startswith("#")]
    wr = [x for x in w if not x.startswith("#")]
    return sum(sum(a != b for a, b in zip(x, y)) + abs(len(x) - len(y))
               for x, y in ((gh, wh), (gr, wr)))
