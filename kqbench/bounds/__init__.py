"""The least bytes of each timed function, and the card's peak.

A roofline share here is the least time the card could take, the least
bytes at its published memory rate, over the device time measured.  The
bytes are what the function's contract needs, counted from the
problem's sizes and never from the tensors an implementation happens
to choose, so that the share reads the same work whatever implements
it, cannot pass 100% for a real implementation, and stays valid when a
kernel is fused or replaced:
  - a base read in takes 2 bits: four bases pack into a byte;
  - a table row takes 44 bytes: an 8-byte key and nine 4-byte
    counters (cov, four fw, four bw edges), what kreeq's 32-bit map
    holds for a k-mer;
  - a per-base track takes 12 bytes a base: u32 cov, right and left,
    what `.bkwig` holds.
Every function reads each input once and writes each output once, at
least.  These are a frozen copy: the program's own bounds
(kreeq_tpu_torch/ops/bounds.py) count its kernels' passes and may
change with them, which must not move the yardstick.
"""

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12

BASE_BYTES = 0.25
ROW_BYTES = 44
TRACK_BYTES = 12


def seconds(nbytes: float) -> float:
    """The least time to move `nbytes` at the card's peak rate."""
    return nbytes / HBM_BYTES_PER_S


def count_bytes(bases: int, rows_out: int) -> float:
    """A count step: read the chunk's bases, write its table of distinct
    k-mers."""
    return bases * BASE_BYTES + rows_out * ROW_BYTES


def merge_bytes(rows_a: int, rows_b: int, rows_out: int) -> float:
    """A merge of two tables: read both, write their union."""
    return (rows_a + rows_b + rows_out) * ROW_BYTES


def track_probe_bytes(bases: int, windows: int, rows_found: int) -> float:
    """The per-base tracks of an assembly: read its bases and each
    distinct table row some window finds, write 12 bytes a window."""
    return (bases * BASE_BYTES + windows * TRACK_BYTES
            + rows_found * ROW_BYTES)


def share(nbytes: float, device_s: float):
    """The roofline share in percent, or None without device time."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * seconds(nbytes) / device_s
