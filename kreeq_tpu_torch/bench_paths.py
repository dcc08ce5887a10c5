"""What the two path benches share (bench_variants.py, bench_subgraph.py).

  card          - the device a run measured: on CUDA the card's name and
                  power limit (nvidia-smi) and the torch and CUDA
                  versions;
  Steps         - the wall seconds of a bench's steps, each less any
                  table host copy (`KmerTable.lookup`'s first call) that
                  ran inside it; the copies are kept apart, with the step
                  that paid them;
  probes        - within a block, the size of every query batch that a
                  table's `probe_device` (the generic probe, B5) was
                  given, and the largest batch itself;
  hold_b5       - B5 on such a batch against its plain version
                  (ops/kmers.probe_sorted), exact, then its device
                  time (ops/bounds.device_ms) beside its bound and
                  sector floor.
"""

from __future__ import annotations

import contextlib
import time

from .bench import device_record

HOST_COPY = "table host copy"  # KmerTable.lookup's log phase


def card(device) -> dict:
    """{"type": "cpu"}, or on CUDA the card's record (bench.py's
    device_record: name, count, the nvidia-smi line, power limit, torch
    and CUDA versions)."""
    if device.type != "cuda":
        return {"type": device.type}
    return {"type": "cuda", **device_record(device)}


class Steps:
    """`with steps("name"): ...` records the block's wall seconds in
    `steps.s["name"]`, less the table host copies that ran inside it,
    which go to `steps.host_copy` as {"step", "s"}."""

    def __init__(self):
        self.s = {}
        self.host_copy = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        from .utils.log import phase_times

        before = len(phase_times(HOST_COPY))
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        copies = phase_times(HOST_COPY)[before:]
        self.host_copy += [{"step": name, "s": c} for c in copies]
        self.s[name] = dt - sum(copies)


@contextlib.contextmanager
def probes(table):
    """Yields {"sizes": [], "largest": None}; after the block "sizes"
    holds the size of each query batch that table.probe_device got
    inside it (a table's own `probe` calls it too), in order, and
    "largest" a copy of the largest batch, or None."""
    seen = {"sizes": [], "largest": None}
    inner = table.probe_device

    def probe(qkeys):
        seen["sizes"].append(int(qkeys.shape[0]))
        if seen["largest"] is None or \
                qkeys.shape[0] > seen["largest"].shape[0]:
            seen["largest"] = qkeys.clone()
        return inner(qkeys)

    table.probe_device = probe
    try:
        yield seen
    finally:
        del table.probe_device


def hold_b5(table, qkeys) -> dict:
    """B5 (ops/kernels.probe_sorted_cuda, through the table's bucket
    directory) on `qkeys` against the plain ops/kmers.probe_sorted on the
    same inputs: raises unless exact.  On CUDA both are then timed on
    the card (ops/bounds.device_ms: median of 5 runs under
    torch.profiler, after a warm-up); on the CPU the wrapper is
    the plain version and nothing is timed.  Beside the times stand the
    bound (ops/bounds.probe_sorted_bound_ms) and the sector floor
    (rows_floor_ms)."""
    from .ops.bounds import (compare, device_ms, probe_sorted_bound_ms,
                             rows_floor_ms)
    from .ops.kernels import probe_sorted_cuda
    from .ops.kmers import probe_sorted

    if qkeys is None:
        raise AssertionError("the path never probed the table")
    tab = (table.keys, table.cov, table.fw, table.bw)
    index = table.bucket_index()
    q = int(qkeys.shape[0])
    rec = {"q": q, "t": len(table), "bits": 2 * table.k - index[1],
           "max_abs_err": compare("probe_sorted",
                                  probe_sorted_cuda(*tab, qkeys, index),
                                  probe_sorted(*tab, qkeys)),
           "bound_ms": probe_sorted_bound_ms(table.keys, qkeys),
           "sector_floor_ms": rows_floor_ms(table.keys, index, qkeys,
                                            81 * q),
           "ms": None, "plain_ms": None, "share_of_bound": None}
    if qkeys.is_cuda:
        rec["ms"] = device_ms(lambda: probe_sorted_cuda(*tab, qkeys, index))
        rec["plain_ms"] = device_ms(lambda: probe_sorted(*tab, qkeys))
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    return rec


def b5_line(name: str, rec: dict) -> str:
    """One line of a hold_b5 record."""
    if rec["ms"] is None:
        times = "not timed on the CPU"
    else:
        times = (f"kernel {rec['ms']:.4f} ms ({rec['share_of_bound']:.1%} "
                 f"of its bound), plain {rec['plain_ms']:.4f} ms")
    return (f"B5 {name}: q={rec['q']} t={rec['t']} bits={rec['bits']}; "
            f"{times}; bound {rec['bound_ms']:.4f} ms, sector floor "
            f"{rec['sector_floor_ms']:.4f} ms; exact")
