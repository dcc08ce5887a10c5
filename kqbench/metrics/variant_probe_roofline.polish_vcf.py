"""The variant scan's table probe's share of its roofline: the least
bytes of the window's jobs (kqbench/bounds/variants.py: a key and a
result an assembly window, each distinct row found) at the
card's peak, over the device time of the window's `probe_sorted`
kernels (B5), found by name."""

from kqbench import bounds
from kqbench.bounds.variants import probe_bytes

KERNEL = "probe_sorted"


def read(run):
    tr = run.trace
    if tr is None or not len(tr.dev_start):
        return None
    lo, hi = tr.window
    device_s = sum(e - s for n, s, e in zip(tr.dev_name, tr.dev_start,
                                            tr.dev_end)
                   if KERNEL in n and s >= lo and e <= hi) / 1e6
    nbytes = run.jobs * probe_bytes(run.facts["asm_windows"],
                                    run.facts["rows_found"])
    return bounds.share(nbytes, device_s)
