"""Run one cell of the benchmark once and print its result line.

    python3 -m kqbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  The cell,
its configuration (kqbench/configs/<config>.json) and its traffic
(kqbench/traffic/<traffic>.json) are found by name from BENCHMARK.json,
each per-layer metric's reader by its name (kqbench/metrics/), and
each output file's check by its kind (kqbench/kinds/).

Set-up, all counted in `setup_s` (from the process's start): torch and
the program's kernel library (built into the program's own fixed build
directory by the first run of a checkout), the inputs generated from
the seed into a scratch directory under TMPDIR, the traffic's own
set-up jobs, and one warm-up job.  The window then runs the traffic's
job back to back, in this process, as one user runs kreeq one job at a
time, until `--seconds` have passed; it lasts from the start of the
first job to the end of the last.  After it the plain reference
(kqbench/reference/, cached by configuration, traffic and seed under
kqbench/.cache/) gives the outputs every job must have produced.

--trace 1 runs the same window under torch.profiler with the spans of
kqbench/spans.py, and prints the per-layer metrics in place of the
end-to-end ones.  Without a CUDA card, or with fewer cards than the
cell asks for, the run prints nothing on stdout and exits 2; a run
that finds jax, jaxlib, flax or the JAX package loaded exits 3.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

from . import compare, kinds, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "kreeq_tpu"}
CACHE = os.path.join(spec.KQBENCH, ".cache")


def process_age() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> set:
    return {m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN


def power_limit():
    """The card's power limit in watts, from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@dataclass
class Job:
    start: float
    end: float
    rc: int
    stdout: str
    error: str = ""
    # name -> kept path, for a job whose files are judged
    files: dict = field(default_factory=dict)
    judged: bool = False


def run_job(argv, work: str, keep, files) -> Job:
    """One CLI job in this process, stdout captured.  With `keep`, each
    of its output `files` is moved aside to `keep` + name and judged;
    without, the next job writes over them, as a user's next run of the
    same command does."""
    import torch

    from kreeq_tpu_torch.cli.main import run

    buf = io.StringIO()
    err = ""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            rc = run(["kreeq", *argv])
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        except Exception:  # a job that raises is a failed job
            rc, err = -1, traceback.format_exc()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    job = Job(t0, t1, rc, buf.getvalue(), err)
    if keep is not None:
        keep_files(job, work, keep, files)
    return job


def keep_files(job: Job, work: str, keep: str, files) -> None:
    job.judged = True
    for name in files:
        src = os.path.join(work, name)
        if os.path.exists(src):
            job.files[name] = keep + name
            os.replace(src, job.files[name])


# window jobs whose output files are judged: a sample drawn from the
# seed among the first SAMPLE_FROM, and the last
SAMPLE_FROM, SAMPLE = 64, 4


def sampled(seed: int) -> set:
    import numpy as np

    rng = np.random.default_rng(seed)
    return set(rng.choice(SAMPLE_FROM, SAMPLE, replace=False).tolist())


def _argv(template, values: dict):
    """A job's arguments: each `{role}` the generator's file of that
    role, `{k}` the configuration's k, `{work}` the scratch directory."""
    try:
        return [a.format(**values) for a in template]
    except KeyError as e:
        raise ValueError(
            f"the traffic's argument {e.args[0]!r} names no input role: "
            f"the generator wrote {', '.join(sorted(values))}") from None


def _digest(config_path: str, traffic: dict, seed: int) -> str:
    """Cache key of a reference: the configuration file, the traffic's
    outputs, the seed, and the sources of the generator, the reference
    and the file kinds."""
    h = hashlib.sha256()
    with open(config_path, "rb") as fh:
        h.update(fh.read())
    h.update(json.dumps([traffic["stdout"], traffic["files"], seed],
                        sort_keys=True).encode())
    for d in (os.path.join(spec.KQBENCH, "gen"),
              os.path.join(spec.KQBENCH, "reference"), *kinds.DIRS):
        for name in sorted(os.listdir(d)):
            if name.endswith(".py"):
                with open(os.path.join(d, name), "rb") as fh:
                    h.update(name.encode() + fh.read())
    return h.hexdigest()[:24]


def reference(inputs, config: dict, config_path: str, traffic: dict,
              seed: int, cache: bool = True):
    """The reference's (stdout parts, files, facts) for these inputs,
    from kqbench/.cache/ when an earlier run of this checkout made it."""
    from .reference import expected

    d = os.path.join(CACHE, _digest(config_path, traffic, seed))
    meta = os.path.join(d, "expected.json")
    if cache and os.path.exists(meta):
        with open(meta) as fh:
            parts, names, facts = json.load(fh)
        files = {}
        for name in names:
            with open(os.path.join(d, name), "rb") as fh:
                files[name] = fh.read()
        return parts, files, facts
    parts, files, facts = expected(inputs.reads, inputs.offsets,
                                   inputs.records, config["k"],
                                   traffic["stdout"], traffic["files"])
    if cache:
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, data in files.items():
            with open(os.path.join(tmp, name), "wb") as fh:
                fh.write(data)
        with open(os.path.join(tmp, "expected.json"), "w") as fh:
            json.dump([parts, list(files), facts], fh)
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
    return parts, files, facts


def judge(jobs, parts: dict, files: dict, traffic: dict, limits: dict):
    """(whether each job failed, the worst reading of each check, one
    line for each of the first failed jobs)."""
    worst = dict.fromkeys(limits, 0)
    failed, notes = [], []
    for i, job in enumerate(jobs):
        got = compare.stdout_checks(job.stdout, parts)
        for name, kind in traffic["files"].items() if job.judged else ():
            mod = kinds.find(kind)
            path = job.files.get(name)
            if path is None:
                got[mod.CHECK] = len(files[name])
                continue
            with open(path, "rb") as fh:
                got[mod.CHECK] = mod.values_off(fh.read(), files[name])
        for name, v in got.items():
            worst[name] = max(worst[name], v)
        off = {n: v for n, v in got.items() if v > limits[n]}
        failed.append(job.rc != 0 or bool(off))
        if failed[-1] and len(notes) < 5:
            notes.append(f"job {i}: rc {job.rc}, off {off}; "
                         f"{job.error.strip()[-1500:]}")
    return failed, worst, notes


@dataclass
class TracedRun:
    """What a per-layer metric's reader reads (kqbench/metrics/)."""

    jobs: int
    sizes: dict  # the inputs' sizes (gen.Inputs.sizes)
    facts: dict  # the reference's: table_rows, rows_found, asm_windows
    phases: list  # (name, seconds) of every CLI phase in the window
    spans: object  # spans.Spans
    trace: object  # trace.Trace
    count_rows: list = field(default_factory=list)
    merge_rows: list = field(default_factory=list)

    def phase_s(self, name: str) -> float:
        return sum(dt for n, dt in self.phases if n == name)

    def has_phase(self, name: str) -> bool:
        return any(n == name for n, _dt in self.phases)


def end_to_end_value(name: str, setup_s: float, peak: int, rate: float):
    """An end-to-end metric: the set-up seconds, the window's device
    memory peak in GiB, or a rate of the traffic's work a second."""
    if name == "setup_s":
        return setup_s
    if name == "peak_device_gib":
        return peak / 2 ** 30
    if rate > 0:
        return rate
    raise KeyError(f"no way to measure {name} in this cell")


def diagnostics(marks, wrote: int, jobs, phases) -> list:
    """Lines for stderr: the set-up's parts, the window's jobs and the
    CLI's phases in each."""
    spent = [f"{n} {b - a:.3f}" for (_m, a), (n, b)
             in zip([("", 0.0)] + marks, marks)]
    return (["set-up s: " + ", ".join(spent)
             + f"; its files {wrote / 2 ** 20:.1f} MiB",
             "window jobs s: " + " ".join(f"{j.end - j.start:.3f}"
                                          for j in jobs)]
            + [f"phase {n} s: " + " ".join(f"{dt:.3f}" for m, dt in phases
                                           if m == n)
               for n in dict.fromkeys(m for m, _dt in phases)])


def run_cell(cell: dict, config: dict, config_path: str, traffic: dict,
             end_to_end, per_layer, seed: int, seconds: float, trace: bool,
             require_cuda: bool = True, cache: bool = True):
    """One run of a cell.  Returns (result dict, stderr lines)."""
    import torch

    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"{cell['name']} needs {cell['chips']} CUDA "
                         f"card(s); found {found}\n")
        raise SystemExit(2)
    from kreeq_tpu_torch.device import resolve_device
    from kreeq_tpu_torch.utils import log

    from . import gen
    from . import trace as tr
    from .spans import COUNT, MERGE, TRACKS, Spans

    # an unknown file kind fails here, before any work
    limits = compare.limits(traffic)
    device = resolve_device()
    cuda = device.type == "cuda"
    if cuda:
        from kreeq_tpu_torch.native import get_lib
        from kreeq_tpu_torch.ops._build import library

        library()
        get_lib()
    marks = [("library", process_age())]
    work = tempfile.mkdtemp(prefix="kqbench-")
    try:
        inputs = gen.make(config, seed, work)
        marks.append(("inputs", process_age()))
        values = {**inputs.files, "k": config["k"], "work": work}
        argv = _argv(traffic["job"], values)
        for setup in [_argv(a, values) for a in traffic["setup"]]:
            job = run_job(setup, work, "", [])
            if job.rc != 0:
                raise RuntimeError(f"set-up job {setup} failed: rc {job.rc}"
                                   f"\n{job.error}")
        # what set-up wrote reaches the disk now, not in the window
        os.sync()
        wrote = sum(os.path.getsize(os.path.join(d, f))
                    for d, _s, fs in os.walk(work) for f in fs)
        marks.append(("traffic set-up", process_age()))
        files = list(traffic["files"])
        keep = os.path.join(work, "out")
        os.makedirs(keep)
        jobs = [run_job(argv, work, os.path.join(keep, "warm."), files)]
        sample = sampled(seed)
        spans = None
        if trace:
            if cuda:
                tr.warm_profiler(device)
            spans = Spans()
            spans.install()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = process_age()
        marks.append(("warm-up job", setup_s))
        n_phases = len(log._phases)
        prof = tr.start(cuda) if trace else None
        with (torch.profiler.record_function(tr.WINDOW) if trace
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            while True:
                i = len(jobs) - 1
                jobs.append(run_job(argv, work, os.path.join(
                    keep, f"{i}.") if i in sample else None, files))
                if jobs[-1].end - t0 >= seconds:
                    break
        if not jobs[-1].judged:
            keep_files(jobs[-1], work, os.path.join(keep, "last."), files)
        window_s = jobs[-1].end - jobs[1].start
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        phases = log._phases[n_phases:]
        trace_path = os.path.join(work, "trace.json")
        traced = (tr.read(prof, trace_path, (COUNT, MERGE, TRACKS))
                  if trace else None)
        rows = ([], [])
        if spans is not None:
            spans.uninstall()
            rows = spans.rows()
        if cuda:
            torch.cuda.empty_cache()
        parts, files_ref, facts = reference(inputs, config, config_path,
                                            traffic, seed, cache)
        # the warm-up job is judged with the window's
        failed, worst, notes = judge(jobs, parts, files_ref, traffic, limits)
        attempted = len(jobs) - 1
        correct = (not any(failed) and attempted > 0
                   and all(v <= limits[n] for n, v in worst.items()))
        if trace:
            run = TracedRun(attempted, inputs.sizes, facts, phases, spans,
                            traced, *rows)
            values = {m["name"]: spec.reader(m["name"])(run)
                      for m in per_layer}
        else:
            values = {m["name"]: end_to_end_value(
                m["name"], setup_s, peak, attempted * inputs.sizes.get(
                    traffic["rates"].get(m["name"]), 0) / window_s)
                for m in end_to_end}
        units = {m["name"]: m["unit"] for m in end_to_end + per_layer}
        metrics = {n: {"value": v, "unit": units[n]}
                   for n, v in values.items() if v is not None}
        device_rec = {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else "cpu",
                      "count": cell["chips"], "memory_peak_bytes": peak,
                      "power_limit_w": power_limit() if cuda else None}
        result = {"correct": correct, "attempted": attempted,
                  "failed": sum(failed[1:]), "metrics": metrics,
                  "device": device_rec}
        if trace:
            device_rec["busy_s"] = traced.busy_s() if cuda else 0.0
            device_rec["window_s"] = traced.window_s
            result["breakdown"] = {"device_ops": traced.device_ops(),
                                   "idle_gaps": traced.idle_gaps()}
        result["checks"] = {n: {"value": v, "limit": limits[n]}
                            for n, v in worst.items()}
        lines = notes + diagnostics(marks, wrote, jobs[1:], phases) + [
            "reference: " + ", ".join(f"{n} {v}" for n, v in facts.items()),
        ] + [
            f"check {n} {v} limit {limits[n]}"
            for n, v in worst.items()]
        return result, lines
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kqbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    config_path, config = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    try:
        result, lines = run_cell(
            cell, config, config_path, traffic,
            spec.metrics(bench, "end_to_end", args.workload),
            spec.metrics(bench, "per_layer", args.workload), args.seed,
            args.seconds, bool(args.trace))
    except SystemExit as e:
        return int(e.code or 1)
    # after the window: whatever the program loaded is in this process
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"modules of JAX or the JAX package were loaded: "
                         f"{sorted(found)}\n")
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
