"""The count step and its kernels in several trees of this repository,
timed alike on one card, in turns: the A/B of a change to the count
step.

    python tools/ab_count.py TREE [TREE ...]

For each TREE in turn (list a parent and a change as parent, change,
change, parent), a fresh process run from TREE imports that tree's
kreeq_tpu_torch and, on bench.py's chunk (bench.genome(0, 2^23),
k = 31), times:
  count_step  - its bench.count_step(codes, k), between CUDA events
                (host work included) and by its device time;
  extract_*   - each form its ops.kernels.extract_cuda offers (the qv
                and track forms on the chunk's 4M-base prefix), by
                device time;
  sort        - its ops.kernels.sort_records_cuda on the count form's
                records, where the tree has it, by device time;
  torch_sort  - torch.sort(keys, stable=True) of the records form's
                keys, by device time.
A device time is the summed durations of the device events that
torch.profiler records over a run of 10 back-to-back calls, over 10; a
time between events covers a run of 10 calls likewise.  Each is taken
over 20 runs after a warm-up: median and quartiles, in ms.  The count
step's table must hash alike in every tree.  Prints one JSON line per
run and, last, {"card": ..., "runs": [...]}.  Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# run from a tree: its count step and kernels, timed; the table's digest
CHILD = r"""
import hashlib, json, statistics, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from kreeq_tpu_torch import bench
from kreeq_tpu_torch.ops import kernels

K, RUNS, BATCH = 31, 20, 10

def summary(times):
    q1, _med, q3 = statistics.quantiles(times, n=4)
    return {"median_ms": statistics.median(times), "q1_ms": q1,
            "q3_ms": q3}

def events(fn):
    fn()
    times = []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(BATCH):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / BATCH)
    return summary(times)

def profiled(fn):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BATCH):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)

def device(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        # a run can record no device event (a process's first, at times)
        us = profiled(fn) or profiled(fn) or profiled(fn)
        if us <= 0:
            raise RuntimeError("torch.profiler recorded no device time")
        times.append(us / 1e3 / BATCH)
    return summary(times)

codes = torch.from_numpy(bench.genome(0, 1 << 23)).to("cuda")
h = hashlib.sha256()
for t in bench.count_step(codes, K):
    h.update(t.cpu().numpy().tobytes())
step = lambda: bench.count_step(codes, K)
rec = {"digest": h.hexdigest(),
       "count_step": {"events": events(step), "device": device(step)}}
for form in kernels.EXTRACT_FORMS:
    x = codes if form in ("records", "count") else codes[:1 << 22]
    rec["extract_" + form] = device(lambda: kernels.extract_cuda(x, K, form))
if hasattr(kernels, "sort_records_cuda"):
    recs = kernels.extract_cuda(codes, K, "count")
    rec["sort"] = device(lambda: kernels.sort_records_cuda(*recs, K))
keys = kernels.extract_cuda(codes, K)[0]
rec["torch_sort"] = device(lambda: torch.sort(keys, stable=True))
print(json.dumps(rec))
"""


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__.strip().splitlines()[4].strip(), file=sys.stderr)
        return 2
    runs = []
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        res = subprocess.run([sys.executable, "-c", CHILD],
                             cwd=os.path.abspath(tree), env=env,
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return 1
        rec = {"tree": tree, **json.loads(res.stdout.splitlines()[-1])}
        if runs and rec["digest"] != runs[0]["digest"]:
            raise AssertionError(f"{tree}: the count step's table differs "
                                 f"from {runs[0]['tree']}'s")
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"card": card(), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
