"""Sharded counting, probing and merging over a torch.distributed group.

Counterpart of kreeq_tpu/parallel/sharded.py.  The table is sharded by
owner, a multiplicative mix of the canonical key (`owner_of`), across
the ranks of a process group: every rank extracts the k-mers of its own
read chunk, `route` sends each record to its owner with
`all_to_all_single`, and each owner counts what it received into its
sorted sub-table (`sharded_count`, B1 on the card).  Probes route the
same way and return by the inverse exchange (`sharded_probe`, B5
through the sub-table's bucket directory); the QV totals are summed
with `all_reduce`.  Shards are disjoint by construction, so a union of
two tables is a merge of key-range slice pairs, one pair a rank, whose
results concatenate in key order (`sharded_merge`, B2).

The JAX package routes into fixed-capacity bins (a static shape) and
retries a block with full-size bins when a bin overflows.  Here the
exchange sizes are data: the sizes go first, then exactly the records
that exist, so nothing is dropped and nothing is retried.

The collectives take tensors on the rank's compute device: CUDA
tensors on the card, with NCCL or with gloo (gloo's all_to_all_single,
all_gather and all_reduce took CUDA tensors on the H100's torch build,
chip_smoke phase 11), and CPU tensors on the CPU with gloo.  The one
exception is a gather too large for the device (`gather_table`), which
fills host memory.  Every exchange and gather is recorded in
SHARD_STATS (`stats_report`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..constants import KEY_BIAS, SENTINEL
from ..device import stamp

# Fibonacci multiplicative mix of the JAX package's owner_of: canonical
# keys are skewed in their low bits, so `key % n` would load shards
# unevenly; the mix spreads them
_OWNER_MIX = 0x9E3779B97F4A7C15
_OWNER_MIX_I64 = _OWNER_MIX - (1 << 64)  # the same bits as an int64

# what the collectives did, until stats_report() clears the lists:
#   route  - (records sent, bytes sent, start, end) per route(): its
#            sizes exchange and the all_to_all of keys and payload
#   back   - (rows sent, bytes sent, start, end) per Route.back()
#   gather - (rows gathered, bytes gathered, start, end, into host
#            memory) per gather_table(): all_gather_rows on the
#            device, or _gather_rows_host
# start and end are device.stamp()s: CUDA events on the card (read them
# after a synchronize), host clock readings elsewhere
SHARD_STATS = {"route": [], "back": [], "gather": []}


def group_size(group) -> int:
    return dist.get_world_size(group)


def owner_of(keys, n: int):
    """Owner rank of each canonical key, the JAX owner_of's: the u64 key
    times the mix, wrapping, bits 40-63, mod n.

    `keys` are the port's biased int64 keys (constants.py), as a tensor
    (int64 owners on its device) or numpy (int64 owners).  int64 has no
    logical right shift, so the tensor path masks the 24 bits after an
    arithmetic shift; its multiply wraps as the u64 one does."""
    if isinstance(keys, torch.Tensor):
        mixed = ((keys ^ KEY_BIAS) * _OWNER_MIX_I64) >> 40
        return (mixed & 0xFFFFFF) % n
    u = np.asarray(keys, np.int64).view(np.uint64) ^ np.uint64(1 << 63)
    with np.errstate(over="ignore"):  # the wrap is the mix
        mixed = (u * np.uint64(_OWNER_MIX)) >> np.uint64(40)
    return (mixed % np.uint64(n)).astype(np.int64)


def _exchange(x: torch.Tensor, send, recv, group) -> torch.Tensor:
    """all_to_all_single of the rows of `x`: send[j] rows (in order) to
    rank j; returns the recv[j] rows from each rank j, by rank."""
    out = x.new_empty((sum(recv), *x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), recv, send, group=group)
    return out


class Route:
    """Where `route` sent each record, so that answers computed at the
    owners come back in the records' own order (`back`)."""

    def __init__(self, order, send, recv, group):
        self.order = order  # records in the order they were sent
        self.send = send  # records sent to each rank
        self.recv = recv  # records received from each rank
        self.group = group

    def back(self, x: torch.Tensor) -> torch.Tensor:
        """Rows of answers, one per received record in received order,
        returned to the records' ranks and put in their original
        order."""
        t0 = stamp(x.device)
        y = _exchange(x, self.recv, self.send, self.group)
        SHARD_STATS["back"].append((x.shape[0], x.nbytes, t0,
                                    stamp(x.device)))
        out = torch.empty_like(y)
        out[self.order] = y
        return out


def split(keys: torch.Tensor, n: int):
    """(order, sizes): the records sorted stably by the owner of their
    key, and the records that each of the n owners gets (bincount)."""
    owner = owner_of(keys, n)
    return torch.argsort(owner, stable=True), torch.bincount(owner,
                                                             minlength=n)


def route(keys: torch.Tensor, payload, group):
    """Send every record (key and its rows of each payload tensor) to
    the owner of its key.  Replaces the JAX _bucket_by_owner and its
    capacity bins: `split`, the sizes exchanged first, then the records
    with uneven splits.

    Returns (keys received, payload tensors received, Route); received
    records come by sending rank, each rank's in its sending order."""
    order, send_t = split(keys, group_size(group))
    recv_t = torch.empty_like(send_t)
    t0 = stamp(keys.device)
    dist.all_to_all_single(recv_t, send_t, group=group)
    send, recv = send_t.tolist(), recv_t.tolist()
    rkeys = _exchange(keys[order], send, recv, group)
    rpay = tuple(_exchange(p[order], send, recv, group) for p in payload)
    SHARD_STATS["route"].append((
        keys.shape[0], keys.nbytes + sum(p.nbytes for p in payload), t0,
        stamp(keys.device)))
    return rkeys, rpay, Route(order, send, recv, group)


def sharded_count(codes: torch.Tensor, k: int, group):
    """Count one chunk per rank into the rank's sorted sub-table
    (counterpart of sharded_count_fn).

    codes: this rank's packed chunk, uint8 on the compute device (an
    empty tensor for a rank without one: every rank of the group must
    call).  Its valid records go to their owners; the records this
    rank receives are sorted by sort_records_cuda and run-aggregated by
    count_runs_cuda (the sort kernel and B1 on the card).  Returns
    (keys, cov, fw, bw, n) as count_runs does: the sub-table of the keys
    this rank owns, with a SENTINEL tail."""
    from ..ops.kernels import (count_runs_cuda, extract_cuda,
                               sort_records_cuda)

    # a chunk shorter than k (an empty one included) has no record
    keys, _isfw, edges, valid = extract_cuda(codes, k)
    rkeys, (redges,), _route = route(keys[valid], (edges[valid],), group)
    return count_runs_cuda(*sort_records_cuda(rkeys, redges, k))


def sharded_probe(table, index, codes: torch.Tensor, k: int, group,
                  cutoff: int = 0):
    """Route one assembly chunk's k-mers to their owners, look them up
    in the owners' sub-tables and classify each position (counterpart
    of sharded_probe_fn, reference: src/kreeq.cpp:143-219).

    table: this rank's sub-table (keys, cov, fw, bw), a SENTINEL tail
    allowed; index: its bucket directory (ops/index.bucket_index) for
    probe_sorted_cuda (B5) on the card, None on the CPU.  Each valid
    position goes to its owner with its selection context (the track
    form of ops/kernels.extract_cuda); the owner probes it and selects
    the right and left edge counters, and (found, cov, right, left) come
    back to validate._classify_sel.  Returns (qfound bool [P], qcov int64 [P],
    tot, missing, edge_missing): the positions of this rank's chunk,
    and the three totals over every rank's chunk (all_reduce, int64)."""
    from ..ops.kernels import extract_cuda, probe_sorted_cuda
    from ..ops.validate import _classify_sel, _select

    dev = codes.device
    # a chunk shorter than k has no position; the collectives still run
    keys, isfw, valid, ctx = extract_cuda(codes, k, "track")
    at = torch.nonzero(valid).squeeze(1)
    rkeys, (rctx,), back = route(keys[at], (ctx[at],), group)
    found, cov, fw, bw = probe_sorted_cuda(*table, rkeys, index)
    row = torch.arange(rkeys.shape[0], device=dev)
    sel = rctx.to(torch.int64)
    ans = back.back(torch.stack([found.to(torch.int64), cov,
                                 _select(fw, bw, row, sel & 15),
                                 _select(fw, bw, row, sel >> 4)], 1))
    p = keys.shape[0]
    got = torch.zeros((p, 4), dtype=torch.int64, device=dev)
    got[at] = ans
    if p:
        valid, missing, edge_missing, qcov = _classify_sel(
            codes, (got[:, 0].bool(), got[:, 1], got[:, 2], got[:, 3]), k,
            cutoff, isfw, valid)[:4]
        qfound = got[:, 0].bool()
        sums = torch.stack([valid.sum(), (valid & missing).sum(),
                            edge_missing.sum()])
    else:
        qfound, qcov = valid, keys
        sums = torch.zeros(3, dtype=torch.int64, device=dev)
    dist.all_reduce(sums, group=group)
    tot, miss, emiss = sums.tolist()
    return qfound, qcov, tot, miss, emiss


def full_pipeline(read_codes: torch.Tensor, asm_codes: torch.Tensor,
                  k: int, group, cutoff: int = 0):
    """Count one read chunk per rank and validate one assembly chunk per
    rank against the sharded table in one step (counterpart of
    full_pipeline_fn): sharded_count, the sub-table's bucket directory
    on the card, then sharded_probe."""
    from ..ops.index import bucket_index

    keys, cov, fw, bw, _n = sharded_count(read_codes, k, group)
    index = bucket_index(keys, k) if keys.device.type == "cuda" else None
    return sharded_probe((keys, cov, fw, bw), index, asm_codes, k, group,
                         cutoff)


def _sizes(m: int, group, device) -> list:
    """Every rank's row count m, in rank order."""
    t = torch.tensor([m], dtype=torch.int64, device=device)
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.cat(out).tolist()


def all_gather_rows(keys: torch.Tensor, vals: torch.Tensor, group,
                    sizes: list):
    """Every rank's rows, on every rank's device, concatenated in rank
    order.

    keys int64 [m] and vals [m, c] of this rank, `sizes` every rank's m
    (_sizes): all_gather of the rows padded to the largest."""
    n = group_size(group)
    dev = keys.device
    pad = max(sizes) - keys.shape[0]
    kpad = torch.cat([keys, keys.new_full((pad,), SENTINEL)])
    vpad = torch.cat([vals, vals.new_zeros((pad, *vals.shape[1:]))])
    ks = [torch.empty_like(kpad) for _ in range(n)]
    vs = [torch.empty_like(vpad) for _ in range(n)]
    t0 = stamp(dev)
    dist.all_gather(ks, kpad, group=group)
    dist.all_gather(vs, vpad, group=group)
    SHARD_STATS["gather"].append((sum(sizes),
                                  n * (kpad.nbytes + vpad.nbytes), t0,
                                  stamp(dev), False))
    return (torch.cat([x[:s] for x, s in zip(ks, sizes)]),
            torch.cat([x[:s] for x, s in zip(vs, sizes)]))


# rows a step of a host gather under NCCL, staged through the card
_HOST_GATHER_STEP = 1 << 22


def _gather_rows_host(keys: torch.Tensor, vals: torch.Tensor, group,
                      sizes: list, device):
    """all_gather_rows into host memory: each rank's rows (host tensors)
    in turn, broadcast from that rank into their place in one host
    buffer.  gloo broadcasts the host rows themselves; NCCL takes card
    tensors only, so there the rows go through a card buffer of at most
    _HOST_GATHER_STEP rows into pinned memory, and the card never holds
    more than one step of the whole."""
    nccl = dist.get_backend(group) == "nccl"
    total = sum(sizes)
    out = (torch.empty(total, dtype=keys.dtype, pin_memory=nccl),
           torch.empty((total, *vals.shape[1:]), dtype=vals.dtype,
                       pin_memory=nccl))
    me = dist.get_rank(group)
    t0 = stamp(device)
    base = 0
    for s, m in enumerate(sizes):
        src = dist.get_global_rank(group, s)
        step = _HOST_GATHER_STEP if nccl else max(m, 1)
        for lo in range(0, m, step):
            hi = min(m, lo + step)
            for mine, whole in zip((keys, vals), out):
                dst = whole[base + lo:base + hi]
                if s == me:
                    dst.copy_(mine[lo:hi])
                if not nccl:
                    dist.broadcast(dst, src, group=group)
                    continue
                buf = (dst.to(device) if s == me else
                       torch.empty(dst.shape, dtype=dst.dtype, device=device))
                dist.broadcast(buf, src, group=group)
                if s != me:
                    dst.copy_(buf)
        base += m
    SHARD_STATS["gather"].append((total, out[0].nbytes + out[1].nbytes, t0,
                                  stamp(device), True))
    return out


def gather_table(part, group, device, sort: bool):
    """Every rank's trimmed part (host arrays or device tensors) as one
    trimmed part on every rank: the rows in rank order, or with `sort`
    sorted by key; None when no rank holds a row.

    The row counts go first.  A whole of at most
    table.device_gather_rows(device) rows is gathered on the device
    (all_gather_rows) and comes back in the device form; a larger one
    is gathered into host memory (_gather_rows_host) and sorted there,
    as the JAX drain concatenates and sorts on the host, and comes back
    as host arrays, which KmerTable.placed keeps on the host above the
    cap."""
    from ..core.table import (device_gather_rows, part_to_rows,
                              rows_to_host_part, rows_to_part)

    sizes = _sizes(len(part[0]), group, device)
    if not sum(sizes):
        return None
    host = sum(sizes) > device_gather_rows(device)
    if host:
        keys, vals = _gather_rows_host(*part_to_rows(part, "cpu"), group,
                                       sizes, device)
    else:
        keys, vals = all_gather_rows(*part_to_rows(part, device), group,
                                     sizes)
    if sort:
        keys, order = torch.sort(keys)
        vals = vals[order]
    return rows_to_host_part(keys, vals) if host else rows_to_part(keys,
                                                                   vals)


def sharded_merge(a, b, group, device):
    """Union of two sorted unique tables across the group (counterpart
    of sharded_merge_fn with KmerTable.merge_sharded; reference:
    src/graph-builder.cpp:338-432).  Every rank holds both tables
    (trimmed parts, host arrays or device tensors).  Both are cut at
    the same keys, the quantiles of the larger one; rank r merges slice
    pair r (TreeMerger's policy: merge_sorted_cuda, or on the host above
    the host-merge threshold), and the disjoint, ascending results are
    gathered in rank order (gather_table).  Returns the merged table as
    a trimmed part, in the device form on `device` or, above
    table.device_gather_rows, as host arrays."""
    from ..core.table import TreeMerger

    n, r = group_size(group), dist.get_rank(group)
    src = a[0] if len(a[0]) >= len(b[0]) else b[0]
    at = (np.arange(1, n) * len(src)) // n
    if isinstance(src, torch.Tensor):
        cut = src[torch.as_tensor(at, device=src.device)].cpu().numpy()
    else:
        cut = src[at]

    def my_slice(part):
        keys = part[0]
        if isinstance(keys, torch.Tensor):
            bnd = torch.as_tensor(cut, device=keys.device)
            at = [0, *torch.searchsorted(keys, bnd).tolist(), len(keys)]
        else:
            at = [0, *np.searchsorted(keys, cut).tolist(), len(keys)]
        lo, hi = at[r], at[r + 1]
        return tuple(x[lo:hi] for x in part[:4])

    sa, sb = my_slice(a), my_slice(b)
    if not len(sa[0]) or not len(sb[0]):
        mine = sa if len(sa[0]) else sb
    else:
        mine = TreeMerger._trim(TreeMerger(device).merge(
            (*sa, len(sa[0])), (*sb, len(sb[0]))))[:4]
    return gather_table(mine, group, device, sort=False)


def stats_report(device) -> dict:
    """SHARD_STATS since the last call, summed: for each of route, back
    and gather, the calls, rows, bytes and milliseconds, and for gather
    the calls that gathered into host memory; clears it."""
    from ..device import elapsed_ms

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {}
    for name, recs in SHARD_STATS.items():
        out[name] = {"calls": len(recs),
                     "rows": sum(r[0] for r in recs),
                     "bytes": sum(r[1] for r in recs),
                     "ms": sum(elapsed_ms(r[2], r[3]) for r in recs)}
        if name == "gather":
            out[name]["host_calls"] = sum(r[4] for r in recs)
        recs.clear()
    return out
