"""Resumable DB build: chunk-batch checkpoints + a merge manifest.

Counterpart of kreeq_tpu/core/build_ckpt.py, with its on-disk format:
the same manifest records and the same `.npy` parts (u64 keys, u32
counters), so a checkpoint directory of either package can be compared
file for file.  The plain build (KmerTable.from_reads) holds every
partial tree level in memory, so a death mid-build (OOM kill, a lost
machine) loses everything; the reference is no better (reference:
src/graph-builder.cpp:134-216).  This build is restartable at
chunk-batch granularity:

  stage 1 - parts: the packed-chunk stream is consumed in batches of B
    chunks; each batch is counted and tree-merged (TreeMerger, the
    policy of from_reads, host spill included) and its sorted unique
    table is written to `<ckpt>/<name>.*.npy` (atomic: tmp + rename),
    THEN recorded in `manifest.jsonl`.  A death mid-batch resumes by
    replaying the manifest, skipping the recorded number of chunks in
    the (deterministic) stream, and re-counting only the interrupted
    batch.

  stage 2 - merges: recorded parts are pairwise merged smallest-first;
    every merge output is itself a recorded part and its inputs are
    deleted, so a death mid-merge re-pays at most one merge.  Merges
    route device/host as TreeMerger does (host above
    KREEQ_TPU_HOST_MERGE_ROWS).

Saturating adds are associative only below the 0xFFFFFFFF clamp, so a
checkpointed build equals the plain build bit for bit unless a counter
crosses 2^32 - 1 across a different merge order.

Under a process group of several ranks (KmerTable.from_reads with
`group`, the JAX package's sharded branch), every rank reads the whole
stream, each batch is a ShardedCounter.drain(), and every rank replays
the manifest and runs the same merges (sharded_merge where the JAX
package's merge would shard); rank 0 alone writes parts, merge outputs
and manifest records and deletes merged parts, and every rank passes a
barrier after each, so the directory is the single-process one.  The
ranks must share the checkpoint directory's filesystem.

Enabled by KREEQ_TPU_BUILD_CKPT=<dir> (KmerTable.from_reads delegates
here); KREEQ_TPU_BUILD_CKPT_BATCH sets the chunks per part (default 4);
KREEQ_TPU_BUILD_CKPT_CRASH_AFTER=<n> raises after the n-th manifest
append (fault injection for tests).  The directory is left in place on
success, holding the manifest and the final part, so a death between
build and `.kreeq` write still resumes cheaply.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..constants import keys_from_u64, keys_to_u64
from ..utils import log

MANIFEST = "manifest.jsonl"
_ARRS = ("keys", "cov", "fw", "bw")


def _append_manifest(ckpt_dir: str, rec: dict) -> None:
    """Durable append: the record is the commit point for the files it
    names, so fsync both the line and the directory."""
    path = os.path.join(ckpt_dir, MANIFEST)
    with open(path, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
        os.fsync(fh.fileno())
    dfd = os.open(ckpt_dir, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _read_manifest(ckpt_dir: str) -> list:
    path = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(path):
        return []
    recs = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except ValueError:
                break  # torn tail line: everything before it stands
    return recs


def _write_part(ckpt_dir: str, name: str, arrs) -> None:
    """Write host arrays (int64 keys, u32 counters) as the JAX
    package's part files (u64 keys): the span kq.ckpt.write (counter
    ckpt.rows)."""
    keys, cov, fw, bw = arrs
    with log.span("kq.ckpt.write"):
        for field, a in zip(_ARRS, (keys_to_u64(keys), cov, fw, bw)):
            tmp = os.path.join(ckpt_dir, f".{name}.{field}.tmp.npy")
            np.save(tmp, np.ascontiguousarray(a))
            with open(tmp, "rb") as fh:
                os.fsync(fh.fileno())
            os.replace(tmp, os.path.join(ckpt_dir, f"{name}.{field}.npy"))
    log.count("ckpt.rows", len(keys))


def _read_part(ckpt_dir: str, name: str):
    """A part's files as host arrays (int64 keys, u32 counters)."""
    keys, cov, fw, bw = (
        np.load(os.path.join(ckpt_dir, f"{name}.{field}.npy"))
        for field in _ARRS)
    return keys_from_u64(keys), cov, fw, bw


def _delete_part(ckpt_dir: str, name: str) -> None:
    for field in _ARRS:
        try:
            os.remove(os.path.join(ckpt_dir, f"{name}.{field}.npy"))
        except OSError:
            pass


def _clean_tmp(ckpt_dir: str) -> None:
    for f in os.listdir(ckpt_dir):
        if f.startswith(".") and ".tmp.npy" in f:
            try:
                os.remove(os.path.join(ckpt_dir, f))
            except OSError:
                pass


class _CrashHook:
    """Fault injection: KREEQ_TPU_BUILD_CKPT_CRASH_AFTER=<n> aborts the
    build after the n-th manifest append (parts and merges both count),
    so tests resume from the wreckage."""

    def __init__(self):
        v = os.environ.get("KREEQ_TPU_BUILD_CKPT_CRASH_AFTER")
        self.left = int(v) if v else None

    def tick(self):
        if self.left is None:
            return
        self.left -= 1
        if self.left <= 0:
            raise RuntimeError(
                "KREEQ_TPU_BUILD_CKPT_CRASH_AFTER fault injection")


def from_reads_checkpointed(read_files, k: int, ckpt_dir: str, device,
                            chunk: Optional[int] = None, group=None):
    """KmerTable.from_reads on `device` with on-disk resume state in
    `ckpt_dir`; sharded over `group` (a group of several ranks, or
    None)."""
    from ..io.fastx import iter_reads
    from ..ops import kmers as K
    from ..ops.kernels import count_chunk_cuda
    from ..parallel.sharded import sharded_merge
    from .table import (KmerTable, ShardedCounter, TreeMerger, _to_host,
                        shard_merge)

    if chunk is None:
        chunk = int(os.environ.get("KREEQ_TPU_CHUNK", 1 << 23))
    read_files = list(read_files)
    device = torch.device(device)
    batch = int(os.environ.get("KREEQ_TPU_BUILD_CKPT_BATCH", "4"))
    writer = group is None or dist.get_rank(group) == 0

    def barrier():
        if group is not None:
            dist.barrier(group=group)

    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        _clean_tmp(ckpt_dir)
    crash = _CrashHook()
    with log.span("kq.ckpt.resume"):  # replay and reclaim
        sizes = []
        for p in read_files:
            try:
                sizes.append(os.path.getsize(p))
            except OSError:
                sizes.append(-1)
        header = {"op": "header", "k": k, "chunk": chunk, "batch": batch,
                  "files": [os.path.abspath(p) for p in read_files],
                  "sizes": sizes}

        barrier()  # the directory exists
        recs = _read_manifest(ckpt_dir)
        fresh = not recs
        if recs:
            h = recs[0]
            stale = {kk: vv for kk, vv in h.items() if kk != "op"} != \
                {kk: vv for kk, vv in header.items() if kk != "op"}
            if h.get("op") != "header" or stale:
                raise RuntimeError(
                    f"checkpoint dir {ckpt_dir} belongs to a different "
                    "build (k/chunk/batch/files mismatch); remove it or "
                    "point KREEQ_TPU_BUILD_CKPT elsewhere")
            recs = recs[1:]
        # every rank has read the manifest before rank 0 writes
        barrier()
        if fresh and writer:
            _append_manifest(ckpt_dir, header)

        # replay: live part set + chunks already consumed + name counter
        live: dict[str, int] = {}  # name -> rows
        chunks_done = 0
        seq = 0
        stream_done = False
        for r in recs:
            if r["op"] == "part":
                live[r["name"]] = r["rows"]
                chunks_done += r["chunks"]
                seq += 1
            elif r["op"] == "merge":
                for name in r["ins"]:
                    live.pop(name, None)
                live[r["out"]] = r["rows"]
                seq += 1
            elif r["op"] == "eof":
                stream_done = True
        if recs:
            log.verbose(
                f"build checkpoint: resuming with {len(live)} parts, "
                f"{chunks_done} chunks done, stream_done={stream_done}")
        if recs and writer:
            # reclaim orphans: files of parts already consumed by a
            # recorded merge (death between record and delete) and
            # unrecorded merge outputs (death between write and record;
            # they are re-created atomically)
            keep = {f"{name}.{field}.npy" for name in live
                    for field in _ARRS}
            for f in os.listdir(ckpt_dir):
                if (f.endswith(".npy") and not f.startswith(".")
                        and f not in keep):
                    try:
                        os.remove(os.path.join(ckpt_dir, f))
                    except OSError:
                        pass

    def record_part(name: str, arrs, nchunks: int) -> None:
        rows = len(arrs[0])
        if writer:
            _write_part(ckpt_dir, name, arrs)
            _append_manifest(ckpt_dir, {"op": "part", "name": name,
                                        "rows": rows, "chunks": nchunks})
        barrier()
        live[name] = rows
        crash.tick()

    # ---- stage 1: consume the chunk stream into batch parts --------
    if not stream_done:
        def read_iter():
            for path in read_files:
                yield from iter_reads(path)

        chunks = K.pack_reads(read_iter(), k, chunk)
        for _ in range(chunks_done):  # deterministic stream: skip
            next(chunks, None)

        if group is not None:
            sc = ShardedCounter(group, k, device)
        else:
            tm = TreeMerger(device)
        in_batch = 0

        def close_batch():
            nonlocal in_batch, seq, chunks_done
            if in_batch == 0:
                return
            arrs = sc.drain() if group is not None else tm.finalize()
            if arrs is not None:
                record_part(f"p{seq:05d}", _to_host(arrs), in_batch)
                seq += 1
            chunks_done += in_batch
            in_batch = 0

        for buf in chunks:
            if group is not None:
                sc.add(buf)
            else:
                tm.push(count_chunk_cuda(torch.from_numpy(buf).to(device),
                                         k))
            in_batch += 1
            if log.verbose_flag:
                log.verbose(f"counted chunk {chunks_done + in_batch - 1} "
                            f"(batch {in_batch}/{batch})")
            if in_batch == batch:
                close_batch()
        close_batch()
        if writer:
            _append_manifest(ckpt_dir, {"op": "eof", "chunks": chunks_done})

    # ---- stage 2: merge the recorded parts, smallest first ---------
    while len(live) > 1:
        a, b = sorted(live, key=lambda nm: (live[nm], nm))[:2]
        pa = _read_part(ckpt_dir, a)
        pb = _read_part(ckpt_dir, b)
        barrier()  # every rank has read both before rank 0 deletes them
        if shard_merge(group, len(pa[0]) + len(pb[0])):
            out = _to_host(sharded_merge(pa, pb, group, device))
        else:
            out = _to_host(TreeMerger._trim(TreeMerger(device).merge(
                (*pa, len(pa[0])), (*pb, len(pb[0])))))
        del pa, pb
        name = f"m{seq:05d}"
        seq += 1
        if writer:
            _write_part(ckpt_dir, name, out)
            _append_manifest(ckpt_dir, {"op": "merge", "out": name,
                                        "ins": [a, b], "rows": len(out[0])})
            # inputs are dead only once the merge record is durable
            _delete_part(ckpt_dir, a)
            _delete_part(ckpt_dir, b)
        barrier()  # the output is on disk before any rank reads it
        live.pop(a)
        live.pop(b)
        live[name] = len(out[0])
        if log.verbose_flag:
            log.verbose(f"checkpoint merge {a}+{b} -> {name} "
                        f"({len(out[0])} rows)")
        crash.tick()
        del out

    if not live:
        return KmerTable.empty(k, device)
    (final,) = live
    return KmerTable.placed(k, _read_part(ckpt_dir, final), device)
