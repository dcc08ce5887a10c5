"""The least bytes of the variant scan's table probe (B5,
`KmerTable.probe_device`) a `-o x.vcf` job, counted from its contract
and the problem's sizes, as kqbench/bounds/ counts the others: every
assembly window is one query of an 8-byte key; each distinct table row
some window finds is read once, 44 bytes; each query writes 37 bytes,
whether it was found and its u32 cov, four fw and four bw counters."""

from . import ROW_BYTES

KEY_BYTES = 8
RESULT_BYTES = 37


def probe_bytes(windows: int, rows_found: int) -> float:
    return windows * (KEY_BYTES + RESULT_BYTES) + rows_found * ROW_BYTES
