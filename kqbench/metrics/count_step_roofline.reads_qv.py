"""The count steps' share of their roofline: the least bytes of every
ops/kernels.count_chunk_cuda call in the window (each read base once
at 2 bits, each row of a chunk's table once at 44 B) at the card's
peak, over the device time of every kernel those calls launched."""

from kqbench import bounds
from kqbench.spans import COUNT


def read(run):
    if run.trace is None or not run.count_rows:
        return None
    nbytes = bounds.count_bytes(run.jobs * run.sizes["read_bases"],
                                sum(run.count_rows))
    return bounds.share(nbytes, run.trace.device_s(COUNT))
