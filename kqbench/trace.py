"""The traced run's reading of the card: a torch.profiler session over
the window, and its reduction to what the per-layer metrics read.

The session records the host's annotations (the benchmark's spans, the
CLI's phases, each job, the window) and the card's kernels, copies and
fills.  A device event belongs to the span that was open on the
launching thread when its launch call ran (the launch and the device
event share a correlation id).  The card is busy over the union of its
events' intervals; an idle gap is named after the innermost annotation
open on the host at its middle.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
WINDOW = "kqbench.window"


def warm_profiler(device) -> None:
    """Open and close a few profiler sessions over a small CUDA op until
    one records a device event: a process's first session can record
    none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1 << 16, device=device).sum().item()
            torch.cuda.synchronize()
        if any(e.device_type.name == "CUDA" for e in prof.events()):
            return
    raise RuntimeError("torch.profiler records no device event")


def start(cuda: bool = True):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


@dataclass
class Trace:
    window: tuple  # (start, end) of the window annotation, us
    # annotation name -> sorted starts, ends (us), thread ids
    spans: dict = field(default_factory=dict)
    # device events: name, start, end (us), and the span that launched
    # each (None outside the spans of interest)
    dev_name: list = field(default_factory=list)
    dev_start: np.ndarray = None
    dev_end: np.ndarray = None
    dev_span: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self):
        """Merged busy intervals of the card inside the window (us)."""
        lo, hi = self.window
        a = np.clip(self.dev_start, lo, hi)
        b = np.clip(self.dev_end, lo, hi)
        keep = b > a
        a, b = a[keep], b[keep]
        order = np.argsort(a, kind="stable")
        out = []
        for s, e in zip(a[order].tolist(), b[order].tolist()):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def device_s(self, span: str) -> float:
        """Seconds of the device events launched inside `span`."""
        return sum(e - s for s, e, sp in zip(self.dev_start, self.dev_end,
                                             self.dev_span)
                   if sp == span) / 1e6

    def device_ops(self, top: int = 10):
        by = defaultdict(float)
        lo, hi = self.window
        for n, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            if s >= lo and e <= hi:
                by[n] += (e - s) / 1e6
        return sorted(([n[:200], v] for n, v in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10):
        """Idle seconds of the card by what the host was doing: each gap
        between busy intervals goes to the innermost annotation open at
        its middle."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(hi)
        by = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                by[self.open_at((a + b) / 2)] += (b - a) / 1e6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda x: -x[1])[:top]

    def open_at(self, t: float) -> str:
        best, width = "outside any span", None
        for name, (starts, ends, _tids) in self.spans.items():
            if name == WINDOW:
                continue
            # spans of one name follow each other and never nest
            i = int(np.searchsorted(starts, t, side="right")) - 1
            if i >= 0 and ends[i] >= t and (width is None
                                            or ends[i] - starts[i] < width):
                best, width = name, ends[i] - starts[i]
        return best


def read(prof, path: str, spans_of_interest) -> Trace:
    """Stop `prof`, export its trace to `path`, and reduce it; the file
    is deleted afterwards."""
    prof.stop()
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    ann = defaultdict(list)
    launches = []
    dev = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation":
            ann[e["name"]].append((float(e["ts"]), float(e["ts"])
                                   + float(e.get("dur", 0)), e.get("tid")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches.append((float(e["ts"]), e.get("tid"), corr))
        elif cat in DEVICE_CATS:
            dev.append((e["name"], float(e["ts"]),
                        float(e["ts"]) + float(e.get("dur", 0)),
                        e.get("args", {}).get("correlation")))
    spans = {}
    for name, iv in ann.items():
        iv.sort()
        spans[name] = (np.array([a for a, _b, _t in iv]),
                       np.array([b for _a, b, _t in iv]),
                       [t for _a, _b, t in iv])
    if WINDOW not in spans:
        raise RuntimeError("the trace holds no window annotation")
    window = (float(spans[WINDOW][0][0]), float(spans[WINDOW][1][-1]))
    # the span each launch ran in, among the spans of interest
    launched_in = {}
    for ts, tid, corr in launches:
        for name in spans_of_interest:
            if name not in spans:
                continue
            starts, ends, tids = spans[name]
            i = int(np.searchsorted(starts, ts, side="right")) - 1
            if i >= 0 and ends[i] >= ts and tids[i] == tid:
                launched_in[corr] = name
                break
    tr = Trace(window, spans)
    tr.dev_name = [d[0] for d in dev]
    tr.dev_start = np.array([d[1] for d in dev], float)
    tr.dev_end = np.array([d[2] for d in dev], float)
    tr.dev_span = [launched_in.get(d[3]) for d in dev]
    return tr
