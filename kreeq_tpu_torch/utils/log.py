"""Verbose logging, per-phase timing, and the job's spans and counters
(reference: gfalibs Log `lg` with --verbose, src/main.cpp:36-37; the
reference has no profiler — SURVEY.md §5.1 — so phase timers are
first-class here).

A span (`span(name)`) times a block on the host clock and adds, for its
name, the calls, the total seconds, the self seconds (the total less
what its child spans cover) and its parent's name to the open job's
record; a counter (`count(name, n)`) adds to it.  A job (`job()`, one a
CLI run) is itself the root span `kq.job`; its record goes to `jobs`
when it ends.  Outside a job, spans and counters record nothing.  While
a torch.profiler session runs, a span is also a profiler annotation of
its name, on the timeline of the card's kernels and copies.  No span
synchronises the card: its seconds are the host's."""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from contextlib import contextmanager

import torch

verbose_flag = False
profile_flag = False
_start = time.perf_counter()
_phases: list = []
# records of the finished jobs, oldest first: {"id", "spans": {name:
# {"parent", "calls", "total_s", "self_s"}}, "counters": {name: n}}
jobs: collections.deque = collections.deque(maxlen=4096)
_job: dict | None = None  # the open job's record
_job_ids = 0
_lock = threading.Lock()  # guards the open job's record
_open = threading.local()  # .stack: this thread's open spans
_last_write = time.monotonic()
_last_real = time.monotonic()
_hb_thread: threading.Thread | None = None


def _heartbeat_loop(interval: float, max_silent: float) -> None:
    """Emit a liveness line whenever nothing has been printed for
    `interval` seconds, so watchdogs that key on log growth (soak
    harnesses, CI wrappers) do not kill a long but healthy phase.

    Bounded: a heartbeat cannot tell a long step from a hang (both are
    silent Python-side), so after `max_silent` seconds with no REAL
    message the loop announces it is standing down and exits — the log
    stops growing and the watchdog's hang detection works again."""
    global _last_write
    while True:
        time.sleep(interval)
        if not verbose_flag:
            continue
        silent = time.monotonic() - _last_real
        if silent > max_silent:
            elapsed = time.perf_counter() - _start
            sys.stderr.write(f"[{elapsed:8.2f}s] ... heartbeat: no real "
                             f"output for {silent:.0f}s (> bound "
                             f"{max_silent:.0f}s); standing down so the "
                             f"stall watchdog can act\n")
            sys.stderr.flush()
            return
        idle = time.monotonic() - _last_write
        if idle >= interval:
            elapsed = time.perf_counter() - _start
            sys.stderr.write(f"[{elapsed:8.2f}s] ... heartbeat: alive, "
                             f"{silent:.0f}s since last message "
                             f"(likely compiling or in a long device "
                             f"step)\n")
            sys.stderr.flush()
            _last_write = time.monotonic()


def _maybe_start_heartbeat() -> None:
    global _hb_thread
    if _hb_thread is not None and _hb_thread.is_alive():
        return
    interval = float(os.environ.get("KREEQ_TPU_HEARTBEAT_S", "120"))
    if interval <= 0:
        return
    max_silent = float(
        os.environ.get("KREEQ_TPU_HEARTBEAT_MAX_SILENT_S", "3000"))
    _hb_thread = threading.Thread(
        target=_heartbeat_loop, args=(interval, max_silent), daemon=True)
    _hb_thread.start()


def set_flags(verbose: bool = False, profile: bool = False) -> None:
    global verbose_flag, profile_flag
    verbose_flag = verbose
    profile_flag = profile
    if verbose:
        _maybe_start_heartbeat()


def verbose(msg: str) -> None:
    if verbose_flag:
        global _last_write, _last_real
        elapsed = time.perf_counter() - _start
        sys.stderr.write(f"[{elapsed:8.2f}s] {msg}\n")
        _last_write = _last_real = time.monotonic()
        # A real message proves the phase is making progress; re-arm
        # the heartbeat if a previous long silence stood it down.
        if _hb_thread is not None and not _hb_thread.is_alive():
            _maybe_start_heartbeat()


class span:
    """Time the block as span `name` of the open job (see the module's
    docstring)."""

    __slots__ = ("name", "_t0", "_child", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = None
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        stack.append(self)
        self._child = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        stack = _open.stack
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent._child += dt
        if _job is not None:
            with _lock:
                spans = _job["spans"]
                rec = spans.get(self.name)
                if rec is None:
                    rec = spans[self.name] = {
                        "parent": parent.name if parent else None,
                        "calls": 0, "total_s": 0.0, "self_s": 0.0}
                rec["calls"] += 1
                rec["total_s"] += dt
                rec["self_s"] += dt - self._child
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to the open job's counter `name`."""
    if _job is not None:
        with _lock:
            counters = _job["counters"]
            counters[name] = counters.get(name, 0) + n


@contextmanager
def job():
    """One job (a CLI run): the root span `kq.job`, and a record of its
    spans, its counters and the kernel launches it made
    (`launches.<kernel>`: ops/kernels.LAUNCHES's deltas), appended to
    `jobs` when the block ends, also when it raises."""
    global _job, _job_ids
    from ..ops.kernels import LAUNCHES

    _job_ids += 1
    rec = {"id": _job_ids, "spans": {}, "counters": {}}
    before = dict(LAUNCHES)
    outer, _job = _job, rec
    try:
        with span("kq.job"):
            yield rec
    finally:
        _job = outer
        for name, n in LAUNCHES.items():
            rec["counters"]["launches." + name] = n - before[name]
        jobs.append(rec)


@contextmanager
def phase(name: str):
    """Time a pipeline phase, as the span `phase:<name>` too; report
    with print_profile()."""
    t0 = time.perf_counter()
    verbose(f"{name}...")
    try:
        with span("phase:" + name):
            yield
    finally:
        dt = time.perf_counter() - t0
        _phases.append((name, dt))
        verbose(f"{name} done in {dt:.3f}s")


def phase_times(name: str) -> list:
    """Seconds of each finished phase called `name`, in order."""
    return [dt for n, dt in _phases if n == name]


def print_profile() -> None:
    """--profile: the phases, then the last job's spans (name, parent,
    calls, total and self ms) and counters."""
    if profile_flag and _phases:
        sys.stderr.write("=== phase profile ===\n")
        for name, dt in _phases:
            sys.stderr.write(f"{name:<30s} {dt * 1e3:10.1f} ms\n")
    if not profile_flag or not jobs:
        return
    rec = jobs[-1]
    sys.stderr.write(f"=== spans of job {rec['id']} ===\n"
                     f"{'span':<30s} {'parent':<30s} {'calls':>7s} "
                     f"{'total ms':>10s} {'self ms':>10s}\n")
    spans = rec["spans"]
    children = collections.defaultdict(list)
    for name, s in spans.items():
        children[s["parent"] if s["parent"] in spans else None].append(name)
    todo = children[None][::-1]  # depth first, parents before children
    seen = set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        s = spans[name]
        sys.stderr.write(f"{name:<30s} {s['parent'] or '-':<30s} "
                         f"{s['calls']:7d} {s['total_s'] * 1e3:10.1f} "
                         f"{s['self_s'] * 1e3:10.1f}\n")
        todo += children[name][::-1]
    sys.stderr.write("=== counters ===\n")
    for name, n in rec["counters"].items():
        sys.stderr.write(f"{name:<30s} {n:>16d}\n")


@contextmanager
def trace(trace_dir: str, device):
    """--trace-dir: a torch.profiler trace of the block (host activity,
    plus the card's on CUDA), written to trace_dir/trace.json when the
    block ends, also when it raises."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
