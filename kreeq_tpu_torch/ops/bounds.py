"""Timing, exactness and least-time bounds of the kernels on the card.

One copy of the arithmetic that the bench (kreeq_tpu_torch/bench.py)
and chip_smoke.py both report beside a kernel's time:
  cuda_times           - times of a call, from runs of BATCH calls
                         between CUDA events, after a warm-up: a
                         step's time with its host work;
  device_times /       - the card's own time a call: the summed
  device_ms              durations of the kernels, copies and fills
                         that torch.profiler records over runs of BATCH
                         calls (a kernel's time, not its wrapper's);
  compare              - exact equality of a kernel's outputs with its
                         plain version's;
  *_bound_ms           - the least time of a kernel: the bytes its
                         inputs need (each input read once, each output
                         written once; a SENTINEL row's key only, not
                         its counters) at the H100's 3.35 TB/s (the
                         extraction's: its codes and its outputs; the
                         sort's: 9 B a record read and written);
  sort_passes_ms       - the least time of the sort kernel's own
                         passes, beside (not in place of) its bound;
  sector_floor_ms,     - a probe's floor under random access: the
  rows_floor_ms          32-byte sectors its reads touch, per array,
                         each counted once.
The bounds are computed from this run's inputs and work on either
device; the timings need a CUDA device.
"""

from __future__ import annotations

import statistics

import torch

from ..constants import SENTINEL
from .index import bucket_of

HBM_BYTES_PER_S = 3.35e12  # the H100's peak memory rate (data sheet)


# calls of a function in one timed run: the card runs them back to back
BATCH = 10


def cuda_times(fn, reps: int = 5) -> list:
    """Milliseconds a call of fn() in each of `reps` runs of BATCH calls
    between CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BATCH):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BATCH)
    return times


def device_times(fn, reps: int = 5) -> list:
    """Milliseconds of the card's time a call of fn() in each of `reps`
    runs of BATCH calls under torch.profiler, after a warm-up call: the
    summed durations of the device events (kernels, copies, fills) a
    run recorded, over BATCH.  A run that records no device event (seen
    on the H100 in a process's first profiled run) is made again, at
    most twice; then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run() -> float:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(BATCH):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA)

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        us = run() or run() or run()
        if us <= 0:
            raise RuntimeError("torch.profiler recorded no device time")
        times.append(us / 1e3 / BATCH)
    return times


def device_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of the card's time a call of fn()
    (device_times)."""
    return statistics.median(device_times(fn, reps))


def compare(name: str, got, want) -> float:
    """Exact equality of two output tuples; returns the max abs error
    (0.0: any other raises)."""
    if any(t.is_cuda for t in got):
        torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if not torch.equal(g, w):
            err = float((g.double() - w.double()).abs().max())
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"version (max abs err {err})")
    return 0.0


def bound_ms(nbytes: float) -> float:
    """The least milliseconds to move `nbytes` at the H100's 3.35 TB/s."""
    return nbytes / HBM_BYTES_PER_S * 1e3


# bytes the extraction writes a window, by form: the int64 key, then
# isfw, the edge bits and valid (records), the ctx (qv), isfw, valid and
# the ctx (track), or the edge bits (count)
EXTRACT_OUT_BYTES = {"records": 11, "qv": 9, "track": 11, "count": 9}


def extract_bound_ms(n: int, k: int, form: str) -> float:
    """The extraction's bound: each of the n codes read once (1 B), the
    outputs of each of the n - k + 1 windows written once."""
    return bound_ms(n + EXTRACT_OUT_BYTES[form] * max(n - k + 1, 0))


def sort_passes(k: int) -> int:
    """The sort kernel's passes at k: 8-bit digits over the 2k bits a
    canonical key can set."""
    return -(-2 * k // 8)


def sort_bound_ms(p: int) -> float:
    """The sort's bound: each of the p records (an 8-byte key and its
    edge byte) read once and written once."""
    return bound_ms(18 * p)


def sort_passes_ms(p: int, k: int) -> float:
    """The least time of the sort kernel's own passes with 8-bit digits:
    the histogram's read of every key (8 B a record), then per pass each
    record read once and written once (9 + 9 B).  Not the function's
    bound (sort_bound_ms): the traffic this design cannot go below."""
    return bound_ms((8 + 18 * sort_passes(k)) * p)


def real_rows(keys) -> int:
    """Rows that hold a key: the rows whose counters must be read."""
    return int((keys != SENTINEL).sum())


def merge_rows_bound_ms(rows: int, real: int) -> float:
    """A merge's bound from its row counts: every key of the `rows`
    input rows read (8 B), the counters of the `real` ones only (72 B; a
    SENTINEL row yields no row), every output row written (80 B)."""
    return bound_ms(8 * rows + 72 * real + 80 * rows)


def merge_bound_ms(ka, kb) -> float:
    """merge_rows_bound_ms of the merge of tables keyed `ka` and `kb`."""
    return merge_rows_bound_ms(ka.shape[0] + kb.shape[0],
                               real_rows(ka) + real_rows(kb))


def count_rows_bound_ms(records: int, real: int) -> float:
    """count_runs' bound from its record counts: every key read (8 B),
    the edge byte of the `real` records only, every output row written
    (80 B)."""
    return bound_ms(8 * records + real + 80 * records)


def count_bound_ms(skeys) -> float:
    """count_rows_bound_ms of the sorted records keyed `skeys`."""
    return count_rows_bound_ms(skeys.shape[0], real_rows(skeys))


def probe_sorted_bound_ms(tkeys, qkeys) -> float:
    """The generic probe's bound: every query read (8 B), every row it
    finds read whole once (80 B), found and a whole row written per
    query (73 B)."""
    q = qkeys.shape[0]
    return bound_ms(8 * q + 80 * touched_rows(tkeys, qkeys) + 73 * q)


def touched_rows(tkeys, qkeys) -> int:
    """Distinct table rows that the queries find: the rows a probe must
    read at the least."""
    row = torch.searchsorted(tkeys, qkeys).clamp_(max=tkeys.shape[0] - 1)
    found = (tkeys[row] == qkeys) & (qkeys != SENTINEL)
    return int(torch.unique(row[found]).shape[0])


def _distinct(x) -> int:
    return int(torch.unique(x).shape[0])


def _search_sectors(tkeys, index, qkeys):
    """What the directory searches of `qkeys` read at the least: the
    distinct 32-byte sectors of each searched query's two directory
    entries and of the key at the row its search ends on (SENTINEL
    queries and keys past the directory are not searched).  Returns
    (sectors, searched mask, found mask over the searched, found rows)."""
    starts, shift = index
    b = bucket_of(qkeys, shift)
    keep = (qkeys != SENTINEL) & (b < starts.shape[0] - 1)
    q, b = qkeys[keep], b[keep]
    row = torch.searchsorted(tkeys, q).clamp_(max=max(tkeys.shape[0] - 1,
                                                      0))
    found = tkeys[row] == q
    sectors = _distinct(torch.cat([b, b + 1]) >> 2) + _distinct(row >> 2)
    return sectors, keep, found, row[found]


def sector_floor_ms(tkeys, index, qkeys, qctx, streamed: int) -> float:
    """A validate probe's floor under random access: the 32-byte sectors
    of each array that the queries touch at the least, each counted
    once (the search's, then a found row's cov and the fw or bw row of
    each selected counter, 32 B a row), plus the `streamed` bytes of
    queries and outputs, at the H100's 3.35 TB/s."""
    sectors, keep, found, frow = _search_sectors(tkeys, index, qkeys)
    fctx = qctx[keep][found].to(torch.int64)
    # a selector's sector: its row of fw (1-4) or of bw (5-8)
    counters = [2 * frow[sel != 0] + (sel[sel != 0] > 4)
                for sel in (fctx & 15, fctx >> 4)]
    return bound_ms(32 * (sectors + _distinct(frow >> 2)
                          + _distinct(torch.cat(counters))) + streamed)


def rows_floor_ms(tkeys, index, qkeys, streamed: int) -> float:
    """The generic probe's floor, as sector_floor_ms with each found row
    read whole: its cov sector, its fw row and its bw row (32 B, one
    sector each)."""
    sectors, _keep, _found, frow = _search_sectors(tkeys, index, qkeys)
    return bound_ms(32 * (sectors + _distinct(frow >> 2)
                          + 2 * _distinct(frow)) + streamed)
