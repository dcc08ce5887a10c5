"""Entry points of the port: the flagship step on one device, a
dry run of the sharded step across ranks, and the sharded CLI against
a golden corpus (counterpart of __graft_entry__.py).

    python -m kreeq_tpu_torch.entry

prints `entry: [...]` (the four numbers of `entry()`'s step), runs
`dryrun_multichip(max(2, cards))` and prints `dryrun_multichip OK`.
`cli_golden_sharded(root, n)` needs a generated corpus, so only a
caller that holds one runs it.  The device is KREEQ_TPU_PLATFORM's (device.py): the
card, or the plain versions with KREEQ_TPU_PLATFORM=cpu.

The ranks of a dry run are processes of their own, launched as the
port's CLI is (KREEQ_TPU_COORDINATOR, _NUM_PROCESSES, _PROCESS_ID;
parallel/multihost.py): on one card they share it over gloo, on the
CPU they use gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 21  # the flagship step's k
CHUNK = 1 << 14  # bases of the step's read chunk and assembly chunk
DRY_CHUNK = 128  # bases of a dry-run rank's read and assembly chunks
RANK_TIMEOUT_S = 600  # a launch's ranks are killed past this
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry():
    """(fn, args): the flagship step and its inputs on the device.

    The step is the k-mer engine on one chunk: canonical extraction of
    a random 2^14-base read chunk, its sorted unique table (B1,
    count_runs), the table's bucket directory, and a probe of a random
    2^14-base assembly chunk against it (B4, probe_select) reduced to
    the QV classification.  fn(read_codes, asm_codes) returns (n,
    #valid, #missing, #edge-missing) as int64 scalars.  The JAX step's
    directory bits and search rounds belong to its XLA probe; these
    four numbers do not depend on them, so this one takes the
    directory's own bits (ops/index.bucket_bits)."""
    import torch

    from .device import resolve_device
    from .ops.index import bucket_index
    from .ops.kernels import count_chunk_cuda
    from .ops.validate import validate_positions

    def forward(read_codes, asm_codes):
        tkeys, cov, fw, bw, n = count_chunk_cuda(read_codes, K)
        index = bucket_index(tkeys, K)
        v, missing, edge_missing = validate_positions(
            tkeys, cov, fw, bw, asm_codes, K, 0, index)[:3]
        return n, v.sum(), missing.sum(), edge_missing.sum()

    device = resolve_device()
    rng = np.random.default_rng(0)
    read_codes = rng.integers(0, 4, CHUNK).astype(np.uint8)
    asm_codes = rng.integers(0, 4, CHUNK).astype(np.uint8)
    return forward, (torch.from_numpy(read_codes).to(device),
                     torch.from_numpy(asm_codes).to(device))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch(argv, n: int, cwd: str = ROOT, env=None):
    """Run `argv` as n ranks of one launch (KREEQ_TPU_COORDINATOR on a
    free local port, _NUM_PROCESSES, _PROCESS_ID), the port's package
    on their path and `env` on top of this process's environment.
    Every rank is waited for, and all are killed once one fails or the
    launch passes RANK_TIMEOUT_S.  Returns each rank's (stdout,
    stderr); raises unless every rank exited 0."""
    port = _free_port()
    base = {**os.environ, **(env or {}),
            "PYTHONPATH": os.pathsep.join(
                [ROOT, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep),
            "KREEQ_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "KREEQ_TPU_NUM_PROCESSES": str(n)}
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        outs = [(open(os.path.join(tmp, f"{r}.out"), "w+"),
                 open(os.path.join(tmp, f"{r}.err"), "w+"))
                for r in range(n)]
        t0 = time.monotonic()
        try:
            for r, (out, err) in enumerate(outs):
                procs.append(subprocess.Popen(
                    argv, cwd=cwd, stdout=out, stderr=err,
                    env={**base, "KREEQ_TPU_PROCESS_ID": str(r)}))
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() - t0 > RANK_TIMEOUT_S:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        runs = []
        for fhs in outs:
            for fh in fhs:
                fh.seek(0)
            runs.append(tuple(fh.read() for fh in fhs))
            for fh in fhs:
                fh.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(
                f"rank {r} of `{' '.join(argv[-3:])}` exited "
                f"{p.returncode}:\n{runs[r][1][-4000:]}")
    return runs


def dryrun_layout(n: int, rank: int):
    """(read codes, assembly codes) of one rank of an n-rank dry run:
    the JAX dry run's layout, a random genome of 64n + 128 bases from
    seed 0, rank d's reads genome[64d:64d+120] and its assembly
    genome[64d+7:64d+119], each padded with BAD to DRY_CHUNK."""
    from .constants import BAD, seq_to_codes

    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=64 * n + 128))
    read_codes = np.full(DRY_CHUNK, BAD, np.uint8)
    asm_codes = np.full(DRY_CHUNK, BAD, np.uint8)
    r = genome[rank * 64:rank * 64 + 120]
    a = genome[rank * 64 + 7:rank * 64 + 119]
    read_codes[:len(r)] = seq_to_codes(r)
    asm_codes[:len(a)] = seq_to_codes(a)
    return read_codes, asm_codes


def _dryrun_rank() -> dict:
    """One rank of dryrun_multichip: its layout through full_pipeline
    (sharded_count, B1; the sub-table's directory; sharded_probe, B5),
    the totals and this rank's kernel launches."""
    import torch
    import torch.distributed as dist

    from .device import resolve_device
    from .ops import kernels
    from .parallel import multihost, sharded

    if not multihost.maybe_initialize():
        raise RuntimeError("no launch of several ranks: set "
                           "KREEQ_TPU_COORDINATOR, _NUM_PROCESSES and "
                           "_PROCESS_ID")
    try:
        device = resolve_device()
        rank, n = dist.get_rank(), dist.get_world_size()
        reads, asm = (torch.from_numpy(x).to(device)
                      for x in dryrun_layout(n, rank))
        kernels.reset_launches()
        _qf, _qc, tot, miss, emiss = sharded.full_pipeline(
            reads, asm, K, dist.group.WORLD)
        return {"rank": rank, "ranks": n, "device": str(device),
                "backend": dist.get_backend(), "sums": [tot, miss, emiss],
                "launches": dict(kernels.LAUNCHES)}
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int) -> dict:
    """Run the full sharded count and probe step on n ranks, each a
    process of its own (`python -m kreeq_tpu_torch.entry` in its
    hidden worker mode), on the JAX dry run's layout (dryrun_layout).

    Rank 0's totals must show probed k-mers and none missing.  The
    port routes by exact sizes, so no record can be dropped, and the
    JAX step's `dropped` output has no counterpart here.  Returns
    {"ranks", "sums": [tot, missing, edge_missing], "launches": summed
    over the ranks, "wall_s", "per_rank": each rank's record}."""
    t0 = time.perf_counter()
    runs = launch([sys.executable, "-m", "kreeq_tpu_torch.entry",
                   "--rank-worker"], n)
    recs = [json.loads(out.splitlines()[-1]) for out, _err in runs]
    tot, miss, _emiss = recs[0]["sums"]
    if tot <= 0:
        raise AssertionError("no k-mers probed in dry run")
    if miss:
        raise AssertionError(f"dry-run probe mismatch: {miss}/{tot} missing")
    launches = {key: sum(r["launches"][key] for r in recs)
                for key in recs[0]["launches"]}
    return {"ranks": n, "sums": recs[0]["sums"], "launches": launches,
            "wall_s": time.perf_counter() - t0, "per_rank": recs}


# the four modes the JAX golden check runs
MODES = ("qv", "union", "subgraph", "vcf")


def _mode(argv) -> str:
    """The mode of MODES a .tst's command runs, or ""."""
    if argv[0] != "kreeq" or len(argv) < 2:
        return ""
    out = argv[argv.index("-o") + 1] if "-o" in argv else ""
    if argv[1] == "validate" and "-r" in argv and "-f" in argv:
        if not out:
            return "qv"
        if out == "vcf" or out.endswith(".vcf"):
            return "vcf"
        return ""
    if argv[1] in ("union", "subgraph"):
        return argv[1]
    return ""


def golden_picks(root: str) -> list:
    """The .tst files of `root`/validateFiles that cli_golden_sharded
    runs, in MODES order: the lowest-numbered of each mode, for
    subgraph the lowest-numbered traversal where there is one."""
    from .cli.validate_runner import collect

    def number(path):
        stem = os.path.basename(path)[:-len(".tst")]
        tail = stem.rsplit(".", 1)[-1]
        return (int(tail) if tail.isdigit() else 1 << 62, stem)

    picks = {}
    for tst in sorted(collect([os.path.join(root, "validateFiles")]),
                      key=number):
        with open(tst) as fh:
            argv = shlex.split(fh.readline())
        mode = _mode(argv)
        if not mode:
            continue
        traversal = "traversal" in argv
        if mode not in picks or (mode == "subgraph" and traversal
                                 and not picks[mode][1]):
            picks[mode] = (tst, traversal)
    return [picks[m][0] for m in MODES if m in picks]


def cli_golden_sharded(root: str, n: int) -> int:
    """Full-pipeline stdout parity of the port's CLI under several
    ranks: one .tst of each mode the JAX check runs (QV, union,
    subgraph, VCF; golden_picks) from the golden corpus at `root` (a
    tree with testFiles/ and validateFiles/, as
    cli/generate_tests.py writes it) is run as n launched ranks with
    KREEQ_TPU_FORCE_SHARDED=1, from `root`, and rank 0's stdout must
    equal the .tst's golden line for line (the runner's KNOWN_DIFF pin
    applied).  Returns the number of .tst run; raises if `root` holds
    none of the four, or on the first that differs."""
    from .cli.validate_runner import compared, golden

    picks = golden_picks(root)
    if not picks:
        raise ValueError(f"{root}/validateFiles holds no .tst of the modes "
                         f"{', '.join(MODES)}")
    for tst in picks:
        with open(tst) as fh:
            lines = fh.read().splitlines()
        argv = shlex.split(lines[0])
        runs = launch([sys.executable, "-m", "kreeq_tpu_torch.cli.main",
                       *argv[1:]], n, cwd=root,
                      env={"KREEQ_TPU_FORCE_SHARDED": "1"})
        got, want = compared(tst, runs[0][0], golden(lines))
        if got != want:
            bad = next(i for i in range(max(len(got), len(want)))
                       if i >= len(got) or i >= len(want)
                       or got[i] != want[i])
            raise AssertionError(
                f"sharded CLI stdout diverged from golden "
                f"{os.path.basename(tst)} at line {bad}: expected "
                f"{want[bad] if bad < len(want) else None!r}, got "
                f"{got[bad] if bad < len(got) else None!r}")
        if any(out for out, _err in runs[1:]):
            raise AssertionError(f"{os.path.basename(tst)}: a rank other "
                                 "than 0 printed")
    return len(picks)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank-worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_worker:
        print(json.dumps(_dryrun_rank()))
        return 0

    import torch

    fn, fargs = entry()
    print("entry:", [x.cpu().numpy() for x in fn(*fargs)])
    n = max(2, torch.cuda.device_count()
            if fargs[0].device.type == "cuda" else 0)
    dryrun_multichip(n)
    print("dryrun_multichip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
