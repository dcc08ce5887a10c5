"""Multi-process build: every rank counts its own read files, and every
rank ends with the whole table.

Counterpart of kreeq_tpu/parallel/multihost.py.  The reference scales
across machines by building one .kreeq DB per job and merging them with
`kreeq union` through the filesystem (reference: README.md:31-39,
src/graph-builder.cpp:297-351).  Here one torch.distributed group spans
the processes: each rank streams its share of the read files, records
go to their owner ranks (parallel/sharded.py), and each rank keeps the
sub-table of the keys it owns; the gather at the end gives every rank
the whole table, the union of the shards.

Launch: KREEQ_TPU_COORDINATOR (host:port of rank 0),
KREEQ_TPU_NUM_PROCESSES and KREEQ_TPU_PROCESS_ID, as for the JAX
package; torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK stand
in when the three are unset.  The rank's device and the group's backend
follow device.py's rules, on the count of ranks that share the rank's
host (maybe_initialize).

Lockstep: a collective must be entered by every rank, but ranks hold
different numbers of chunks.  Before each round the ranks agree with an
all_reduce whether any still has data; a rank that has none enters the
round with an empty chunk.
"""

from __future__ import annotations

import json
import os
import socket
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

_COORD_ENV = "KREEQ_TPU_COORDINATOR"  # host:port of process 0
_NPROCS_ENV = "KREEQ_TPU_NUM_PROCESSES"
_PID_ENV = "KREEQ_TPU_PROCESS_ID"


def launch():
    """(init_method, processes, this process's rank) of a launch, or
    None: tcp:// to KREEQ_TPU_COORDINATOR, or env:// under torchrun
    (whose agent may already serve the store at MASTER_PORT)."""
    coord = os.environ.get(_COORD_ENV)
    if coord is not None:
        return (f"tcp://{coord}", int(os.environ[_NPROCS_ENV]),
                int(os.environ[_PID_ENV]))
    if all(os.environ.get(v) for v in ("MASTER_ADDR", "MASTER_PORT",
                                       "WORLD_SIZE", "RANK")):
        return ("env://", int(os.environ["WORLD_SIZE"]),
                int(os.environ["RANK"]))
    return None


def host_ranks(hosts: List[str], rank: int):
    """(rank among its host's ranks, ranks on its host) of rank `rank`
    of a launch whose ranks run on `hosts` (one host name a rank)."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return mine.index(rank), len(mine)


def maybe_initialize() -> bool:
    """Join the launch's process group, if there is a launch of more
    than one process; True then.  Call before any work (the CLI does).
    Under the KREEQ_TPU_* variables the ranks meet at a TCPStore on the
    coordinator (what tcp:// initialization builds), and each writes
    its host name there first, so that device.py knows how many ranks
    share this host (host_ranks) before it picks the card and the
    backend; torchrun's LOCAL_RANK and LOCAL_WORLD_SIZE say it where
    they are set.  The rank's device is device.resolve_device()'s, the
    backend device.collective_backend's; --verbose logs both."""
    from ..device import (collective_backend, local_ranks, resolve_device,
                          set_host_ranks)
    from ..utils import log

    spec = launch()
    if spec is None or spec[1] <= 1:
        return False
    init, nprocs, pid = spec
    store = None
    if init.startswith("tcp://"):
        host, port = init[len("tcp://"):].rsplit(":", 1)
        store = dist.TCPStore(host, int(port), nprocs, is_master=pid == 0)
        store.set(f"kreeq_host/{pid}", socket.gethostname())
        set_host_ranks(*host_ranks(
            [store.get(f"kreeq_host/{r}").decode() for r in range(nprocs)],
            pid))
    device = resolve_device()
    backend = collective_backend(device)
    log.verbose(f"rank {pid} of {nprocs}: {device}, {backend} backend, "
                f"{init}, {local_ranks()} rank(s) on this host")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    if store is None:
        kwargs["init_method"] = init
    else:
        kwargs["store"] = store
    dist.init_process_group(backend, world_size=nprocs, rank=pid, **kwargs)
    return True


def world():
    """The launch's group when this process joined one of several
    ranks, else None."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def shard_read_files(files: Iterable[str], num_processes: int,
                     process_id: int) -> List[str]:
    """This rank's read files: round-robin by position (reference
    analog: one read set per job, README.md:31-39).  A rank may get
    none; the lockstep build handles that."""
    return [f for i, f in enumerate(files)
            if i % num_processes == process_id]


def build_table_distributed(read_files, k: int, device,
                            chunk: Optional[int] = None, group=None):
    """Count the k-mers of every rank's `read_files` (this rank's share,
    see shard_read_files); every rank returns the whole table, bit for
    bit what one process builds from all the files.

    `group` defaults to the launch's (dist.group.WORLD).  Each round,
    each rank counts its next packed chunk, or an empty one when its
    files are done, through ShardedCounter.step, until no rank has a
    chunk left.  A read longer than the chunk stops every rank with the
    JAX package's ValueError."""
    from ..core.table import KmerTable, ShardedCounter
    from ..io.fastx import iter_reads
    from ..ops.kmers import pack_reads
    from ..utils import log

    if chunk is None:
        chunk = int(os.environ.get("KREEQ_TPU_CHUNK", 1 << 23))
    if group is None:
        group = dist.group.WORLD
    device = torch.device(device)

    def read_iter():
        for path in read_files:
            yield from iter_reads(path)

    counter = ShardedCounter(group, k, device)
    chunks = pack_reads(read_iter(), k, chunk)
    rounds = 0
    while True:
        buf = next(chunks, None)
        # (has a chunk, longest chunk) of every rank this round
        state = torch.tensor([buf is not None,
                              0 if buf is None else len(buf)],
                             dtype=torch.int64, device=device)
        dist.all_reduce(state, op=dist.ReduceOp.MAX, group=group)
        more, longest = state.tolist()
        if longest > chunk:
            raise ValueError(
                "multi-host build requires chunk >= longest read "
                f"({longest} > {chunk}); raise KREEQ_TPU_CHUNK")
        if not more:
            break
        counter.step(buf)
        rounds += 1
    acc = counter.drain()
    table = (KmerTable.empty(k, device) if acc is None
             else KmerTable.placed(k, acc, device))
    if log.verbose_flag:
        log.verbose("distributed build " + json.dumps(build_report(
            device, group, rounds=rounds, chunks=counter.chunks,
            rows=len(table), on_host=table.on_host)))
    return table


def build_report(device, group, **extra) -> dict:
    """This rank's view of a distributed build: its rank, backend and
    device, `extra`, the kernels' launches so far and peak device
    memory.  What the collectives did is in the job's record (spans
    kq.shard.*, counters shard.*; --profile prints them)."""
    from ..ops.kernels import LAUNCHES

    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    return {"rank": dist.get_rank(group), "ranks": dist.get_world_size(group),
            "backend": dist.get_backend(group), "device": str(device),
            **extra, "launches": dict(LAUNCHES), "peak_gib": peak}
