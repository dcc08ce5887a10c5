"""Device selection for the port.

KREEQ_TPU_PLATFORM names the device, as it names the JAX platform in
the JAX package:
  unset or "cuda" - the first CUDA device; an error if there is none;
  "cpu"           - the CPU, where every kernel wrapper runs its plain
                    PyTorch version.
The CPU is never chosen silently: a run that asked for the card and
finds none stops.
"""

from __future__ import annotations

import os
import time

import torch


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
    return torch.device("cuda", torch.cuda.current_device())


def stamp(device: torch.device):
    """A point in time on the device's own clock: a recorded CUDA event
    on the card, the host clock elsewhere."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def elapsed_ms(a, b) -> float:
    """Milliseconds between two stamp()s; on the card the later event
    must have completed."""
    return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)
