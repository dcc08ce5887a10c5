"""Device selection for the port.

KREEQ_TPU_PLATFORM names the device, as it names the JAX platform in
the JAX package:
  unset or "cuda" - the first CUDA device; an error if there is none;
  "cpu"           - the CPU, where every kernel wrapper runs its plain
                    PyTorch version.
The CPU is never chosen silently: a run that asked for the card and
finds none stops.

Under a multi-process launch (parallel/multihost.py), each rank takes
the card `local_rank() % device_count()`, and its collectives run on
the backend that `collective_backend` names by rule: gloo on the CPU;
NCCL on cards when every rank of the host has a card of its own, gloo
when the host's ranks outnumber its cards (NCCL refuses two ranks on
one card).  A rank's place on its host is torchrun's LOCAL_RANK and
LOCAL_WORLD_SIZE where they are set; under the JAX package's launch
variables, multihost reads every rank's host name from the launch's
store and sets it here (`set_host_ranks`), so a launch across hosts
counts only its own host's ranks.  No backend is tried and then
replaced.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

# (rank among this host's ranks, ranks on this host) of a launch whose
# hosts multihost read from its store; None outside one
_HOST_RANKS: Optional[Tuple[int, int]] = None


def set_host_ranks(rank: int, ranks: int) -> None:
    global _HOST_RANKS
    _HOST_RANKS = (rank, ranks)


def local_rank():
    """This process's rank among its host's ranks, or None outside a
    launch: LOCAL_RANK (torchrun), else the launch's (set_host_ranks)."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return None if _HOST_RANKS is None else _HOST_RANKS[0]


def local_ranks() -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE (torchrun), else the
    launch's (set_host_ranks), else 1."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return 1 if _HOST_RANKS is None else _HOST_RANKS[1]


def resolve_device() -> torch.device:
    platform = os.environ.get("KREEQ_TPU_PLATFORM", "") or "cuda"
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "cuda":
        raise ValueError(
            f"KREEQ_TPU_PLATFORM={platform!r} is not a platform of the "
            "PyTorch port (use 'cuda', or 'cpu' for the plain versions)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; set KREEQ_TPU_PLATFORM=cpu to "
            "run the plain PyTorch versions on the CPU")
    rank = local_rank()
    if rank is None:
        return torch.device("cuda", torch.cuda.current_device())
    index = rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def collective_backend(device: torch.device) -> str:
    """The torch.distributed backend of a rank computing on `device`."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_ranks() <= torch.cuda.device_count() else "gloo"
