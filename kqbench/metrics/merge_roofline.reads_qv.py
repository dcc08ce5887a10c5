"""The build's merges' share of their roofline: the least bytes of
every ops/kernels.merge_sorted_cuda call in the window (both input
tables' rows and the output's, 44 B each) at the card's peak, over the
device time of every kernel those calls launched."""

from kqbench import bounds
from kqbench.spans import MERGE


def read(run):
    if run.trace is None or not run.merge_rows:
        return None
    nbytes = sum(bounds.merge_bytes(*m) for m in run.merge_rows)
    return bounds.share(nbytes, run.trace.device_s(MERGE))
