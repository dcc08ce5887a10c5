"""The port's bench: k-mer count, QV-probe, track-probe and merge
throughput on one CUDA card (counterpart of bench.py).

    python -m kreeq_tpu_torch.bench [--seed N]      (kreeq-torch-bench)

bench.py's stages at bench.py's shapes, each through the functions the
production path calls:
  count  - one 8M-base random chunk (2^23 codes from default_rng(seed)),
           k = 31: ops/kernels.count_chunk_cuda (the extraction's count
           form, kmer_extract; the sort, sort_records; then count_runs,
           B1), as core/table.from_reads counts each chunk;
  QV     - the chunk's 4M-base prefix (a window drawn from the reads, so
           every k-mer is found) against the counted table, through the
           table's bucket directory (ops/index.bucket_index, timed apart
           as index_ms): ops/validate.validate_qv_sums over the whole
           window (probe_qv, B3);
  track  - the same window through ops/validate.validate_positions
           (probe_select, B4);
  merge  - the counted table's rows [:h] and [h:2h], h = rows // 2, as
           bench.py splits it, through ops/kernels.merge_sorted_cuda
           (B2).  Both halves come from one sorted table, so every key of
           the first lies below every key of the second: the merge does
           not interleave.
Before any timing, each kernel's output must equal its plain version's
on the card (ops/kmers.count_records, sort_keys_edges, count_runs,
merge_sorted, ops/validate._extract_ctx_qv, _extract_ctx, qv_sums,
probe_select),
and the window's #missing must be 0.  Each step is timed with CUDA
events: a warm-up, then REPS runs of ops/bounds.BATCH back-to-back
calls, so a step's time holds its host work.  Each kernel, each plain
version and torch.sort are timed on the card (ops/bounds.device_times:
the device events torch.profiler records over each of REPS runs of
BATCH calls), so a kernel's time is its own and not its wrapper's.  A
stage reports the median and the quartiles.  Beside each kernel's time
stand its bound (ops/bounds.py: the bytes its inputs need at
3.35 TB/s) and, for the probes, the sector floor, as chip_smoke phase 3
computes them; beside the sort's, the least traffic of its passes
(sort_passes_ms).

It prints one JSON line after every stage, each a superset of the one
before:

  {"metric": "read kmers counted/s/chip", "value": N, "unit": "kmers/s",
   "vs_baseline": N, "extra": {...}}

value is the chunk's k-mers over the median count step.  vs_baseline
divides it by the all-core count rate of tools/cpu_oracle/oracle.cpp (a
reference-style CPU count and probe), built with g++ into the
gitignored _build/ and run once per bench on every core of the card's
host.  Diagnostics (`stage: ...`) go to stderr.

The measurements run in a child process under a watchdog: past
KREEQ_TPU_BENCH_DEADLINE seconds (default 1200) it kills the child's
process group, prints a zero-value line with "incomplete" and the stage
it reached, and exits 0, as bench.py's does.  A child that fails ends
the output with that line carrying its error, and the watchdog exits
with the child's code.  There is no CPU mode and no fallback: without a
card (or with KREEQ_TPU_PLATFORM=cpu), or when a kernel fails to build,
to launch or to agree with its plain version, the bench fails.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import queue
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

K = 31
CHUNK = 1 << 23  # bases of the counted chunk (bench.py)
PCHUNK = 1 << 22  # bases of the probed window, the chunk's prefix
REPS = 40  # timed runs a measurement: 10 beyond each quartile
METRIC = "read kmers counted/s/chip"
UNIT = "kmers/s"
DEADLINE_S = 1200.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_SRC = os.path.join(ROOT, "tools", "cpu_oracle", "oracle.cpp")
ORACLE_FLAGS = ["-std=gnu++14", "-O3", "-pthread"]  # its Makefile's
ORACLE_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# the stages' steps, as the production path runs them


def genome(seed: int, bases: int) -> np.ndarray:
    """bench.py's chunk: `bases` codes in 0-3 from default_rng(seed)."""
    return np.random.default_rng(seed).integers(0, 4, bases).astype(np.uint8)


def count_step(codes, k: int):
    """One chunk counted as core/table.from_reads counts it
    (ops/kernels.count_chunk_cuda): the extraction's count form
    (kmer_extract), the sort (sort_records), then B1 (count_runs).
    Returns (keys, cov, fw, bw, n) of P rows, a SENTINEL tail after n."""
    from .ops.kernels import count_chunk_cuda

    return count_chunk_cuda(codes, k)


def qv_step(table, index, asm, k: int):
    """(#missing, #edge-missing) as int64[2] of every position of the
    window `asm` against the table: the sums path of plain `validate`
    (ops/validate.validate_qv_sums, B3 through the directory `index`)."""
    from .ops.validate import validate_qv_sums

    return validate_qv_sums(*table[:4], asm, k, 0, 0, asm.shape[0] - k + 1,
                            index)


def track_step(table, index, asm, k: int):
    """The per-position classification of the window `asm` behind the
    track writers (ops/validate.validate_positions, B4 through `index`):
    valid, missing, edge_missing, cov, isfw, right, left."""
    from .ops.validate import validate_positions

    return validate_positions(*table[:4], asm, k, 0, index)


def halves(table):
    """bench.py's merge operands: rows [:h] and [h:2h] of the table,
    h = rows // 2, SENTINEL rows included."""
    h = table[0].shape[0] // 2
    return (tuple(a[:h] for a in table[:4]),
            tuple(a[h:2 * h] for a in table[:4]))


def merge_step(a, b):
    """The union of two sorted tables (ops/kernels.merge_sorted_cuda,
    B2)."""
    from .ops.kernels import merge_sorted_cuda

    return merge_sorted_cuda(*a, *b)


def summary(times) -> dict:
    """Median and quartiles of a list of milliseconds."""
    q1, _q2, q3 = statistics.quantiles(times, n=4)
    return {"median_ms": statistics.median(times), "q1_ms": q1, "q3_ms": q3,
            "n": len(times)}


class Bench:
    """bench.py's stages on `device`.  Each stage method checks its
    kernel against the plain version, times the step, its kernel and the
    plain version (milliseconds per call: a step's with
    ops/bounds.cuda_times, a kernel's and a plain version's with
    device_times, or both with `timer(fn, reps)` where one is given) and
    records them in `extra`; `line()` is the JSON line of what has been
    measured so far.  The caller puts the card's record ("device") and
    the CPU oracle's ("cpu_oracle") into `extra` before `line()`."""

    def __init__(self, device, seed: int = 0, *, k: int = K,
                 chunk: int = CHUNK, pchunk: int = PCHUNK,
                 reps: int = REPS, timer=None):
        import torch

        from .ops.bounds import BATCH, cuda_times, device_times

        self.k, self.chunk = k, chunk
        self.reps = reps
        self.timer = timer or cuda_times
        self.device_timer = timer or device_times
        self.extra = {"k": k, "chunk_bases": chunk, "probe_bases": pchunk,
                      "seed": seed, "timing": f"a warm-up, then {reps} "
                      f"runs of {BATCH} back-to-back calls: steps between "
                      f"CUDA events, kernels and plain versions by their "
                      f"device events under torch.profiler",
                      "stages": {}}
        self.rate = 0.0
        self.codes = torch.from_numpy(genome(seed, chunk)).to(device)
        self.asm = self.codes[:pchunk]
        self.table = None  # the count step's (keys, cov, fw, bw, n)
        self.index = None  # the table's bucket directory

    def times(self, fn) -> dict:
        """A step's times."""
        return summary(self.timer(fn, self.reps))

    def dtimes(self, fn) -> dict:
        """A kernel's or a plain version's times on the card."""
        return summary(self.device_timer(fn, self.reps))

    def _kernel(self, name, kernel, plain, bound, **more) -> dict:
        """A stage's kernel record: its times, its plain version's, and
        its bound with the kernel's share of it."""
        ms = kernel["median_ms"]
        return {"kernel": name, "kernel_times": kernel, "kernel_ms": ms,
                "plain": plain, "plain_ms": plain["median_ms"],
                "bound_ms": bound, "share_of_bound": bound / ms, **more,
                "exact": True}

    def _extract_parts(self, form: str) -> dict:
        """A probe step's part: the window's extraction in `form`, the
        kernel and the plain version timed, with the kernel's bound."""
        from .ops.bounds import extract_bound_ms
        from .ops.kernels import extract_cuda, plain_extract

        k, asm = self.k, self.asm
        return {"parts": {
                    "extract": self.dtimes(
                        lambda: extract_cuda(asm, k, form)),
                    "extract_plain": self.dtimes(
                        lambda: plain_extract(form)(asm, k))},
                "extract_bound_ms": extract_bound_ms(asm.shape[0], k, form)}

    def count(self) -> None:
        """The count step, its parts (the extraction's count form, the
        sort, B1; torch.sort of the keys beside the sort), the
        extraction against count_records, the sort against
        sort_keys_edges and B1 against count_runs."""
        import torch

        from .ops.bounds import (compare, count_bound_ms, extract_bound_ms,
                                 sort_bound_ms, sort_passes, sort_passes_ms)
        from .ops.kernels import (count_runs_cuda, extract_cuda,
                                  sort_records_cuda)
        from .ops.kmers import count_records, count_runs, sort_keys_edges

        codes, k = self.codes, self.k
        recs = extract_cuda(codes, k, "count")
        compare("kmer_extract (count)", recs, count_records(codes, k))
        skeys, sedges = sort_records_cuda(*recs, k)
        compare("sort_records", (skeys, sedges), sort_keys_edges(*recs))
        got = count_runs_cuda(skeys, sedges)
        compare("count_runs", got, count_runs(skeys, sedges))
        self.table = count_step(codes, k)
        compare("the count step", self.table, got)
        step = self.times(lambda: count_step(codes, k))
        parts = {"extract": self.dtimes(
                     lambda: extract_cuda(codes, k, "count")),
                 "extract_plain": self.dtimes(
                     lambda: count_records(codes, k)),
                 "sort": self.dtimes(lambda: sort_records_cuda(*recs, k)),
                 "sort_plain": self.dtimes(lambda: sort_keys_edges(*recs)),
                 "torch_sort": self.dtimes(
                     lambda: torch.sort(recs[0], stable=True))}
        rec = self._kernel(
            "count_runs (B1)",
            self.dtimes(lambda: count_runs_cuda(skeys, sedges)),
            self.dtimes(lambda: count_runs(skeys, sedges)),
            count_bound_ms(skeys), records=int(skeys.shape[0]),
            n=int(self.table[4]))
        self.extra["stages"]["count"] = {
            "step": step, "parts": parts,
            "extract_bound_ms": extract_bound_ms(codes.shape[0], k,
                                                 "count"),
            "sort_bound_ms": sort_bound_ms(skeys.shape[0]),
            "sort_passes_ms": sort_passes_ms(skeys.shape[0], k),
            "sort_digits": f"{sort_passes(k)} passes of 8-bit digits",
            **rec}
        self.rate = (self.chunk - k + 1) / (step["median_ms"] / 1e3)
        self.extra["count_step_ms"] = step["median_ms"]

    def qv(self) -> None:
        """The table's bucket directory (index_ms), then the QV step and
        B3 against qv_sums; the window's #missing must be 0."""
        from .ops.bounds import (bound_ms, compare, sector_floor_ms,
                                 touched_rows)
        from .ops.index import bucket_index
        from .ops.kernels import extract_cuda, probe_qv_cuda
        from .ops.validate import _extract_ctx_qv, qv_sums

        k, asm, tab = self.k, self.asm, self.table[:4]
        tkeys = tab[0]
        index_t = self.times(lambda: bucket_index(tkeys, k))
        self.index = index = bucket_index(tkeys, k)
        bits = (index[0].shape[0] - 1).bit_length() - 1
        self.extra["stages"]["index"] = {"bits": bits, **index_t}
        self.extra["index_ms"] = index_t["median_ms"]

        p = asm.shape[0] - k + 1
        qkeys, qctx = extract_cuda(asm, k, "qv")
        compare("kmer_extract (qv)", (qkeys, qctx), _extract_ctx_qv(asm, k))
        args = (*tab, qkeys, qctx, 0, p, 0)
        got = probe_qv_cuda(*args, index)
        compare("probe_qv", (got,), (qv_sums(*args),))
        sums = qv_step(self.table, index, asm, k)
        compare("the QV step", (sums,), (got,))
        missing, edge = (int(x) for x in sums.tolist())
        if missing:
            raise AssertionError(f"{missing} k-mers of a window drawn from "
                                 "the counted chunk are missing, not 0")
        step = self.times(lambda: qv_step(self.table, index, asm, k))
        # queries (key, ctx); per found row its key, cov and the two
        # selected counters; two int64 sums out
        rec = self._kernel(
            "probe_qv (B3)",
            self.dtimes(lambda: probe_qv_cuda(*args, index)),
            self.dtimes(lambda: qv_sums(*args)),
            bound_ms(9 * p + 32 * touched_rows(tkeys, qkeys) + 16),
            sector_floor_ms=sector_floor_ms(tkeys, index, qkeys, qctx,
                                            9 * p + 16),
            queries=p, missing=missing, edge_missing=edge)
        self.extra["stages"]["probe_qv"] = {
            "step": step, **self._extract_parts("qv"), **rec}
        self.extra["probe_qv_step_ms"] = step["median_ms"]
        self.extra["probe_kmers_per_s"] = p / (step["median_ms"] / 1e3)

    def track(self) -> None:
        """The track step and B4 against probe_select; its #missing and
        #edge-missing must be the QV step's."""
        from .ops.bounds import (bound_ms, compare, sector_floor_ms,
                                 touched_rows)
        from .ops.kernels import extract_cuda, probe_select_cuda
        from .ops.validate import _extract_ctx, probe_select

        k, asm, tab, index = self.k, self.asm, self.table[:4], self.index
        tkeys = tab[0]
        ext = extract_cuda(asm, k, "track")
        compare("kmer_extract (track)", ext, _extract_ctx(asm, k))
        skeys, _isfw, _valid, sctx = ext
        sargs = (*tab, skeys, sctx)
        compare("probe_select", probe_select_cuda(*sargs, index),
                probe_select(*sargs))
        cls = track_step(self.table, index, asm, k)
        sums = [int(cls[1].sum()), int(cls[2].sum())]
        qv = self.extra["stages"]["probe_qv"]
        if sums != [qv["missing"], qv["edge_missing"]]:
            raise AssertionError(f"the track step's (#missing, "
                                 f"#edge-missing) {sums} differ from the "
                                 f"QV step's")
        step = self.times(lambda: track_step(self.table, index, asm, k))
        q = skeys.shape[0]
        # queries; per found row key, cov and two counters; found, cov,
        # right, left out
        rec = self._kernel(
            "probe_select (B4)",
            self.dtimes(lambda: probe_select_cuda(*sargs, index)),
            self.dtimes(lambda: probe_select(*sargs)),
            bound_ms(9 * q + 32 * touched_rows(tkeys, skeys) + 25 * q),
            sector_floor_ms=sector_floor_ms(tkeys, index, skeys, sctx,
                                            34 * q),
            queries=q)
        self.extra["stages"]["probe_track"] = {
            "step": step, **self._extract_parts("track"), **rec}
        self.extra["probe_track_step_ms"] = step["median_ms"]

    def merge(self) -> None:
        """The merge of the table's two halves (B2) against
        merge_sorted; the step is the kernel's call, timed between CUDA
        events as a step and by its device time as a kernel."""
        from .ops.bounds import compare, merge_bound_ms
        from .ops.kmers import merge_sorted

        a, b = halves(self.table)
        compare("merge_sorted", merge_step(a, b), merge_sorted(*a, *b))
        step = self.times(lambda: merge_step(a, b))
        h = a[0].shape[0]
        rec = self._kernel("merge_sorted (B2)",
                           self.dtimes(lambda: merge_step(a, b)),
                           self.dtimes(lambda: merge_sorted(*a, *b)),
                           merge_bound_ms(a[0], b[0]), na=h,
                           nb=b[0].shape[0])
        self.extra["stages"]["merge"] = {"step": step, **rec}
        self.extra["merge_step_ms"] = step["median_ms"]
        self.extra["merge_kmers_per_s"] = 2 * h / (step["median_ms"] / 1e3)

    def line(self) -> dict:
        """The result line: the count rate, against the CPU oracle's
        all-core count rate; the launches of each kernel so far."""
        from .ops.kernels import LAUNCHES

        oracle = self.extra["cpu_oracle"]
        cores = oracle["threads"]
        if "probe_kmers_per_s" in self.extra:
            self.extra["probe_vs_cpu_oracle"] = (
                self.extra["probe_kmers_per_s"]
                / oracle[f"probe_kmers_per_s_{cores}t"])
        self.extra["launches"] = dict(LAUNCHES)
        return {"metric": METRIC, "value": self.rate, "unit": UNIT,
                "vs_baseline": self.rate
                / oracle[f"count_kmers_per_s_{cores}t"],
                "extra": copy.deepcopy(self.extra)}

    def run(self, emit) -> None:
        """Every stage in turn; emit(line) after each."""
        for name, stage in (("count", self.count), ("QV probe", self.qv),
                            ("track probe", self.track),
                            ("merge", self.merge)):
            say(f"stage: {name}")
            stage()
            emit(self.line())


# ---------------------------------------------------------------------------
# the card and the CPU oracle


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (the
    first card's line); raises when nvidia-smi cannot say."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed ({smi.returncode}): "
                           f"{smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def device_record(device) -> dict:
    """The card a run measured: its name, the card count, the power
    limit, and the torch and CUDA versions."""
    import torch

    line = card_line()
    return {"name": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "power_limit": line.rsplit(",", 1)[-1].strip(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def build_oracle() -> str:
    """tools/cpu_oracle/oracle.cpp built with its Makefile's flags into
    the gitignored _build/, at first use: the executable's name carries a
    hash of the source and the flags, and a build writes a file of its
    own process and renames it into place, so a concurrent build cannot
    race it.  Returns the executable's path."""
    from .ops._build import BUILD_DIR

    with open(ORACLE_SRC, "rb") as fh:
        source = fh.read()
    digest = hashlib.sha256(" ".join(ORACLE_FLAGS).encode() + b"\0"
                            + source).hexdigest()[:16]
    exe = os.path.join(BUILD_DIR, f"cpu_oracle-{digest}")
    if os.path.exists(exe):
        return exe
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the CPU oracle needs it")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{exe}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *ORACLE_FLAGS, "-o", tmp, ORACLE_SRC],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build the CPU oracle:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, exe)
    return exe


def run_oracle(threads: int | None = None) -> dict:
    """One run of the CPU oracle on `threads` threads (every core this
    process may run on by default): its JSON line, whose
    count_kmers_per_s_<threads>t and probe_kmers_per_s_<threads>t are
    the baselines."""
    threads = threads or len(os.sched_getaffinity(0))
    res = subprocess.run([build_oracle(), str(threads)],
                         capture_output=True, text=True,
                         timeout=ORACLE_TIMEOUT_S)
    if res.returncode != 0 or not res.stdout.strip():
        raise RuntimeError(f"the CPU oracle exited {res.returncode}: "
                           f"{res.stderr.strip()}")
    return json.loads(res.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the child and its watchdog


def _measure(seed: int) -> None:
    from .device import resolve_device
    from .ops import _build, kernels

    say("stage: device")
    device = resolve_device()
    if device.type != "cuda":
        raise RuntimeError("the bench measures a CUDA card and has no CPU "
                           "mode: unset KREEQ_TPU_PLATFORM")
    record = device_record(device)
    say(f"card: {record['nvidia_smi']}")
    say("stage: kernel build")
    _build.library()
    say("stage: cpu oracle")
    oracle = run_oracle()
    say("stage: inputs")
    bench = Bench(device, seed)
    bench.extra.update(device=record, host_cores=oracle["threads"],
                       cpu_oracle=oracle)
    kernels.reset_launches()
    bench.run(lambda line: say(json.dumps(line)))


def child(seed: int) -> None:
    """The measurements: JSON lines and `stage: ` markers on stdout.  A
    failure prints `error: "<type>: <message>"` for the watchdog and
    raises."""
    try:
        _measure(seed)
    except Exception as exc:
        say("error: " + json.dumps(f"{type(exc).__name__}: {exc}"))
        raise


def incomplete(stage: str, error: str | None = None) -> dict:
    """The zero-value line of a run that did not reach its end."""
    extra = {"incomplete": True, "stage": stage}
    if error is not None:
        extra["error"] = error
    return {"metric": METRIC, "value": 0, "unit": UNIT, "vs_baseline": 0,
            "extra": extra}


def _pump(stream, lines: queue.Queue) -> None:
    for line in stream:
        lines.put(line)
    lines.put(None)


def watchdog(argv, deadline: float) -> int:
    """Run `argv` in a process group of its own under a deadline of
    `deadline` seconds, forwarding its JSON lines to stdout as they come
    and every other line to stderr (a `stage: X` line names the stage,
    an `error: "..."` line the error).  At the deadline it kills that
    group, prints the incomplete line with the stage and returns 0, as
    bench.py's watchdog does.  A child that fails, or ends without a
    result line, ends the output with the incomplete line carrying its
    error; the return is then the child's code (1 if that was 0)."""
    start = time.monotonic()
    child_proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True,
                                  bufsize=1, start_new_session=True,
                                  cwd=ROOT)
    lines = queue.Queue()
    reader = threading.Thread(target=_pump, args=(child_proc.stdout, lines),
                              daemon=True)
    reader.start()
    stage, error, results, timed_out = "startup", None, 0, False
    try:
        while True:
            remain = deadline - (time.monotonic() - start)
            if remain <= 0:
                timed_out = True
                break
            try:
                line = lines.get(timeout=remain)
            except queue.Empty:
                timed_out = True
                break
            if line is None:
                break
            if line.startswith("{"):
                results += 1
                print(line, end="", flush=True)
                continue
            if line.startswith("stage: "):
                stage = line[len("stage: "):].strip()
            elif line.startswith("error: "):
                text = line[len("error: "):].strip()
                try:
                    error = json.loads(text)
                except ValueError:  # not the child's own error line
                    error = text
            print(line, end="", file=sys.stderr, flush=True)
        if not timed_out:
            try:
                child_proc.wait(timeout=max(
                    deadline - (time.monotonic() - start), 1))
            except subprocess.TimeoutExpired:
                timed_out = True
    finally:
        if child_proc.poll() is None:
            try:
                os.killpg(child_proc.pid, signal.SIGKILL)  # the exact group
            except (ProcessLookupError, PermissionError):
                pass
            child_proc.wait()
        reader.join(timeout=10)
        child_proc.stdout.close()
    if timed_out:
        print(f"# watchdog: deadline {deadline:.0f} s hit at stage "
              f"'{stage}'; the lines above stand", file=sys.stderr,
              flush=True)
        print(json.dumps(incomplete(stage)), flush=True)
        return 0
    rc = child_proc.returncode
    if rc == 0 and results:
        return 0
    if error is None:
        error = (f"exit code {rc}" if rc else "no result line")
    print(json.dumps(incomplete(stage, error)), flush=True)
    return rc if rc > 0 else (128 - rc if rc < 0 else 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random chunk (default 0, bench.py's)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.seed)
        return
    deadline = float(os.environ.get("KREEQ_TPU_BENCH_DEADLINE",
                                    DEADLINE_S))
    sys.exit(watchdog([sys.executable, "-m", "kreeq_tpu_torch.bench",
                       "--child", "--seed", str(args.seed)], deadline))


if __name__ == "__main__":
    main()
