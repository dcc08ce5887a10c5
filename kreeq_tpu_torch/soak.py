"""At-scale soak of the port: a generated genome and its reads through
the port's CLI, each phase a process of its own, out of core and with a
resumable build (counterpart of scripts/soak_round5.py, whose contract
it keeps).

    python -m kreeq_tpu_torch.soak [workdir] [genome_mbp] [coverage]
    python -m kreeq_tpu_torch.soak --recall workdir [genome_mbp] [slice]

Data: a random genome of genome_mbp Mbp from seed 2026, an assembly of
it with 500 planted SNV/INS/DEL (`plant`), and error-free 150-bp reads
of the genome at `coverage`x from seed 7 (`gen_reads`); the same bytes
as the JAX harness writes.  Phases, each one line in the append-only
soak log (workdir/soak.log) when it ends:
  1. build: `validate -r reads.fastq -k 31 -o soak.kreeq` under
     KREEQ_TPU_BUILD_CKPT=workdir/ckpt (resumable; skipped when the DB
     exists);
  2. qv: `validate -d soak.kreeq -f asm.fasta -o asm.bkwig`, QV + tracks;
  3. vcf: `validate -d soak.kreeq -f asm10.fasta -o asm10.vcf
     --search-depth 50 --max-span 32` on the assembly's first
     KREEQ_TPU_SOAK_VCF_SLICE bases (default 10^8), then the planted
     variants' recall within 40 bases (`recall`); a planted variant
     with no VCF row is listed with the fewest reads on its path
     (`read_support`: 0 where the reads leave a gap there);
  4. bkwig: the decompressor's `lookup` of chr1:1000-1040.
The table caps are forced (KREEQ_TPU_MAX_TABLE_ROWS 5*10^7,
KREEQ_TPU_HOST_MERGE_ROWS 2.5*10^7, unless set), so the table windows
and the host merges engage.  KREEQ_TPU_SOAK_REUSE=1 keeps the inputs
of an earlier run in the workdir.  The last line is a JSON object:
soak, mbp, coverage, vcf_rows and recall as the JAX harness prints
them, the missed variants, and each phase's wall, attempts and peak RSS, the DB's and the
.bkwig's bytes, the checkpoint's parts and merges, the host merges and
table windows the phases logged, and the card's name and power limit.

`run_phase` runs a phase in its own process group under a stall
watchdog: a phase whose log and stdout stop growing for STALL_S is
killed (its group only) and relaunched, and the build resumes from its
checkpoint; a failed attempt is retried after COOLDOWN_S and a probe
of the device, at most MAX_ATTEMPTS times (KREEQ_TPU_SOAK_STALL_S,
_COOLDOWN_S, _ATTEMPTS).  Its --verbose heartbeat (utils/log.py) keeps
a long silent step, such as the first process's nvcc build, alive.

Where this differs from the JAX harness, as the port requires:
  - `chip_ok` probes the device with a tiny torch op in a bounded
    subprocess (on `cuda`, or on the CPU under KREEQ_TPU_PLATFORM=cpu);
  - KREEQ_TPU_PALLAS is not set: the port has no Pallas switch;
  - the log's mirror is KREEQ_TPU_SOAK_MIRROR where it is set, and
    otherwise the workdir's own log: nothing is appended to a file of
    the repository;
  - the watchdog polls every POLL_S seconds (a constant, so a test can
    shorten it);
  - a phase's stdout goes to workdir/phase_<name>.out (that of its last
    attempt) and its stderr to the appended workdir/phase_<name>.log;
    the JAX harness sends both to the log;
  - the peak RSS is the child's own high-water mark, read from its
    rusage when it exits, so a phase shorter than one poll has one;
  - genome_mbp may be fractional (`plant` needs 1.002 Mbp at least).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.frombuffer(b"ACGT", np.uint8)

STALL_S = int(os.environ.get("KREEQ_TPU_SOAK_STALL_S", "900"))
COOLDOWN_S = int(os.environ.get("KREEQ_TPU_SOAK_COOLDOWN_S", "300"))
MAX_ATTEMPTS = int(os.environ.get("KREEQ_TPU_SOAK_ATTEMPTS", "6"))
MIRROR = os.environ.get("KREEQ_TPU_SOAK_MIRROR", "")
POLL_S = 30.0  # the watchdog's poll
SEED_GENOME = 2026
SEED_READS = 7
WITHIN = 40  # bases between a planted variant and a VCF row that finds it


def soaklog(workdir: str, line: str) -> None:
    """Append-only: the workdir log and the mirror, if one is set."""
    stamped = f"{time.strftime('%H:%M:%S')} {line}"
    print(stamped, flush=True)
    paths = [os.path.join(workdir, "soak.log")]
    if MIRROR and os.path.abspath(MIRROR) != os.path.abspath(paths[0]):
        paths.append(MIRROR)
    for path in paths:
        try:
            with open(path, "a") as fh:
                fh.write(stamped + "\n")
        except OSError:
            pass


# ---- input generation (deterministic; reused across relaunches) ----

def gen_reads(workdir, genome, coverage, read_len=150, seed=SEED_READS):
    """workdir/reads.fastq: n * coverage // read_len error-free reads of
    `genome` (codes 0-3) at uniform starts, quality I, vectorised in
    batches of 2^17 reads.  Returns a summary."""
    rng = np.random.default_rng(seed)
    n = len(genome)
    n_reads = n * coverage // read_len
    t0 = time.time()
    hdr_w = 12  # "@r%09d\n"
    rec_w = hdr_w + read_len + 1 + 2 + read_len + 1
    qual = np.frombuffer(b"I" * read_len, np.uint8)
    batch = 1 << 17
    with open(f"{workdir}/reads.fastq", "wb") as fh:
        for lo in range(0, n_reads, batch):
            m = min(batch, n_reads - lo)
            starts = rng.integers(0, n - read_len, m)
            rec = np.empty((m, rec_w), np.uint8)
            hdrs = "".join(f"@r{i:09d}\n" for i in range(lo, lo + m))
            rec[:, :hdr_w] = np.frombuffer(
                hdrs.encode(), np.uint8).reshape(m, hdr_w)
            rec[:, hdr_w:hdr_w + read_len] = BASES[
                genome[starts[:, None] + np.arange(read_len)]]
            rec[:, hdr_w + read_len] = ord("\n")
            rec[:, hdr_w + read_len + 1] = ord("+")
            rec[:, hdr_w + read_len + 2] = ord("\n")
            rec[:, hdr_w + read_len + 3:rec_w - 1] = qual
            rec[:, rec_w - 1] = ord("\n")
            rec.tofile(fh)
    return (f"{n_reads} x {read_len} bp ({n_reads * read_len / 1e9:.1f} "
            f"Gbp) in {time.time() - t0:.0f}s")


def write_fasta(path, header, codes):
    """One FASTA record of `codes` (0-3) in lines of 80 bases."""
    with open(path, "wb") as fh:
        fh.write(f">{header}\n".encode())
        width = 80
        n = len(codes)
        pad = (-n) % width
        buf = np.full(n + pad, ord("\n"), np.uint8)
        buf[:n] = BASES[codes]
        mat = np.empty((len(buf) // width, width + 1), np.uint8)
        mat[:, :width] = buf.reshape(-1, width)
        mat[:, width] = ord("\n")
        flat = mat.reshape(-1)
        keep = n + n // width + (1 if n % width else 0)
        flat[:keep].tofile(fh)


def plant(genome, rng, n_var=500):
    """(assembly, planted): `genome` with n_var variants at distinct
    sites of the grid 1000, 3000, ... below n - 1000 (3/5 SNV, 1/5
    insertions and 1/5 deletions of 1-5 bases); planted lists (kind,
    genome position, length)."""
    n = len(genome)
    pos = np.sort(rng.choice(np.arange(1000, n - 1000, 2000),
                             size=n_var, replace=False))
    kinds = rng.permutation(["SNV"] * (n_var * 3 // 5)
                            + ["INS"] * (n_var // 5)
                            + ["DEL"] * (n_var - n_var * 3 // 5
                                         - n_var // 5))
    out = []
    prev = 0
    planted = []
    for p, kind in zip(pos, kinds):
        out.append(genome[prev:p])
        if kind == "SNV":
            out.append(np.array([(genome[p] + 1) % 4], np.uint8))
            planted.append(("SNV", int(p), 0))
            prev = p + 1
        elif kind == "INS":
            ln = int(rng.integers(1, 6))
            out.append(rng.integers(0, 4, ln).astype(np.uint8))
            planted.append(("INS", int(p), ln))
            prev = p
        else:
            ln = int(rng.integers(1, 6))
            planted.append(("DEL", int(p), ln))
            prev = p + ln
    out.append(genome[prev:])
    return np.concatenate(out), planted


def genome_bases(mbp: float) -> int:
    return int(round(mbp * 1_000_000))


def make_genome(mbp: float):
    """(genome, assembly, planted) of a soak of mbp Mbp, from the seed."""
    rng = np.random.default_rng(SEED_GENOME)
    genome = rng.integers(0, 4, genome_bases(mbp)).astype(np.uint8)
    asm, planted = plant(genome, rng)
    return genome, asm, planted


def recall_of(planted, vcf_path: str, slice_len: int):
    """(VCF rows, found, total, missed): the planted variants that lie
    in the first slice_len - 1000 bases of the assembly (positions
    shifted by the indels before them), how many have a VCF row within
    WITHIN bases, and those that have none."""
    with open(vcf_path) as fh:
        rows = [ln.split("\t") for ln in fh if not ln.startswith("#")]
    vcf_pos = np.array(sorted(int(r[1]) for r in rows))
    found = total = shift = 0
    missed = []
    for kind, p, ln in planted:
        ap = p + shift
        if kind == "INS":
            shift += ln
        elif kind == "DEL":
            shift -= ln
        if ap >= slice_len - 1000:
            continue
        total += 1
        i = np.searchsorted(vcf_pos, ap - WITHIN)
        if i < len(vcf_pos) and vcf_pos[i] <= ap + WITHIN:
            found += 1
        else:
            missed.append((kind, p, ln))
    return len(rows), found, total, missed


def read_support(mbp: float, coverage: int, sites, k: int = 31,
                 read_len: int = 150):
    """For each planted site (kind, genome position p, length ln), the
    fewest reads of gen_reads (its starts drawn again from its seed)
    that hold one genome k-mer beginning in [p - k, p + ln]: the read
    graph's path through the site and its anchors.  0 means a k-mer
    of that path is in no read, so no caller can find the variant."""
    n = genome_bases(mbp)
    rng = np.random.default_rng(SEED_READS)
    n_reads = n * coverage // read_len
    batch = 1 << 17
    starts = np.sort(np.concatenate(
        [rng.integers(0, n - read_len, min(batch, n_reads - lo))
         for lo in range(0, n_reads, batch)] or [np.zeros(0, np.int64)]))
    out = []
    for _kind, p, ln in sites:
        at = np.arange(max(p - k, 0), min(p + ln, n - k) + 1)
        held = (np.searchsorted(starts, at, side="right")
                - np.searchsorted(starts, at + k - read_len))
        out.append(int(held.min()) if len(held) else 0)
    return out


def recall(workdir: str, mbp: float = 100, slice_len: int = 30_000_000):
    """The soak's recall check out of band (counterpart of
    scripts/soak_vcf_recall.py): the planted set recomputed from the
    seed, checked against workdir/asm10.vcf.  Returns (rows, found,
    total, missed) as recall_of does."""
    _genome, _asm, planted = make_genome(mbp)
    return recall_of(planted, os.path.join(workdir, "asm10.vcf"), slice_len)


# ---- phase runner ---------------------------------------------------

def chip_ok(timeout_s: int = 150) -> bool:
    """A tiny op on the phases' device in a bounded subprocess (a lost
    card can hang its first call)."""
    dev = "cpu" if os.environ.get("KREEQ_TPU_PLATFORM") == "cpu" else "cuda"
    try:
        r = subprocess.run(
            [sys.executable, "-c",
             "import torch; "
             f"print(int(torch.ones(8, device={dev!r}).sum()))"],
            timeout=timeout_s, capture_output=True)
        return r.returncode == 0 and b"8" in r.stdout
    except subprocess.TimeoutExpired:
        return False


def _reap(child, timeout: float):
    """(exit code, peak RSS GB) of `child` once it exits within
    `timeout` seconds, else None; the peak is its rusage's maxrss."""
    end = time.monotonic() + timeout
    while True:
        pid, status, usage = os.wait4(child.pid, os.WNOHANG)
        if pid:
            child.returncode = os.waitstatus_to_exitcode(status)
            return child.returncode, usage.ru_maxrss / 1e6
        left = end - time.monotonic()
        if left <= 0:
            return None
        time.sleep(min(0.1, left))


def _size(*paths) -> int:
    total = 0
    for path in paths:
        try:
            total += os.path.getsize(path)
        except OSError:
            pass
    return total


def run_phase(workdir: str, name: str, cmd, env_extra=None,
              stall_s: float = STALL_S):
    """Run one phase as its own process group with a progress-based
    stall watchdog; relaunch after a stall or a failure (the build
    resumes from its checkpoint).  Returns (wall_s, attempts,
    peak_rss_gb)."""
    logpath = os.path.join(workdir, f"phase_{name}.log")
    outpath = os.path.join(workdir, f"phase_{name}.out")
    t0 = time.time()
    peak = 0.0
    for attempt in range(1, MAX_ATTEMPTS + 1):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        if env_extra:
            env.update(env_extra)
        with open(logpath, "a") as lf, open(outpath, "w") as of:
            lf.write(f"\n==== attempt {attempt}: {' '.join(cmd)}\n")
            lf.flush()
            child = subprocess.Popen(
                cmd, cwd=workdir, env=env, stdout=of, stderr=lf,
                start_new_session=True)
        last_sz = -1
        last_progress = time.time()
        stalled = False
        while True:
            done = _reap(child, POLL_S)
            if done is not None:
                rc, rss = done
                peak = max(peak, rss)
                break
            sz = _size(logpath, outpath)
            if sz != last_sz:
                last_sz = sz
                last_progress = time.time()
            elif time.time() - last_progress > stall_s:
                stalled = True
                soaklog(workdir,
                        f"[{name}] attempt {attempt}: no output for "
                        f"{stall_s}s -> killing pg {child.pid}")
                try:
                    # exactly the group start_new_session made
                    os.killpg(child.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                done = _reap(child, 60)
                if done is not None:
                    peak = max(peak, done[1])
                rc = -9
                break
        if not stalled and rc == 0:
            return time.time() - t0, attempt, peak
        soaklog(workdir, f"[{name}] attempt {attempt} "
                         f"{'stalled' if stalled else f'rc={rc}'}; "
                         f"cooling down {COOLDOWN_S}s")
        time.sleep(COOLDOWN_S)
        probes = 0
        while not chip_ok():
            probes += 1
            if probes > 8:
                soaklog(workdir, f"[{name}] chip unreachable after "
                                 f"{probes} probes; giving up")
                raise SystemExit(3)
            soaklog(workdir, f"[{name}] chip probe {probes} failed; "
                             f"waiting {COOLDOWN_S}s")
            time.sleep(COOLDOWN_S)
    soaklog(workdir, f"[{name}] FAILED after {MAX_ATTEMPTS} attempts")
    raise SystemExit(2)


def card() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or
    None without one."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() or None if r.returncode == 0 else None


def _log_lines(workdir: str, name: str, marker: str) -> list:
    """The lines of phase `name`'s log that hold `marker`."""
    try:
        with open(os.path.join(workdir, f"phase_{name}.log")) as fh:
            return [ln.rstrip("\n") for ln in fh if marker in ln]
    except OSError:
        return []


def _manifest_ops(ckpt: str) -> dict:
    """The checkpoint manifest's records, counted by op."""
    ops = {}
    try:
        with open(os.path.join(ckpt, "manifest.jsonl")) as fh:
            for line in fh:
                if line.strip():
                    op = json.loads(line).get("op")
                    ops[op] = ops.get(op, 0) + 1
    except (OSError, ValueError):
        pass
    return ops


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _d, fs in os.walk(path) for f in fs)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--recall":
        workdir = argv[1]
        mbp = float(argv[2]) if len(argv) > 2 else 100
        slice_len = int(argv[3]) if len(argv) > 3 else 30_000_000
        rows, found, total, _missed = recall(workdir, mbp, slice_len)
        print(f"[VCF recall] {rows} rows; planted recall (+-{WITHIN}bp): "
              f"{found}/{total}")
        return
    workdir = argv[0] if argv else os.path.join(tempfile.gettempdir(),
                                                "kreeq_soak")
    mbp = float(argv[1]) if len(argv) > 1 else 100
    mbp = int(mbp) if mbp.is_integer() else mbp
    coverage = int(argv[2]) if len(argv) > 2 else 10
    os.makedirs(workdir, exist_ok=True)
    workdir = os.path.abspath(workdir)

    # forced out-of-core thresholds: the table windows and the host
    # merges must engage
    os.environ.setdefault("KREEQ_TPU_MAX_TABLE_ROWS", str(50_000_000))
    os.environ.setdefault("KREEQ_TPU_HOST_MERGE_ROWS", str(25_000_000))

    soaklog(workdir, f"=== soak: {mbp:g} Mbp genome, {coverage}x reads, "
                     f"workdir={workdir}, "
                     f"MAX_TABLE_ROWS={os.environ['KREEQ_TPU_MAX_TABLE_ROWS']}, "
                     f"HOST_MERGE_ROWS={os.environ['KREEQ_TPU_HOST_MERGE_ROWS']}")

    t0 = time.time()
    genome, asm, planted = make_genome(mbp)
    slice_len = min(int(os.environ.get("KREEQ_TPU_SOAK_VCF_SLICE",
                                       100_000_000)), len(asm))
    if not (os.environ.get("KREEQ_TPU_SOAK_REUSE") == "1"
            and os.path.exists(f"{workdir}/asm10.fasta")):
        msg = gen_reads(workdir, genome, coverage)
        write_fasta(f"{workdir}/asm.fasta", "chr1", asm)
        write_fasta(f"{workdir}/asm10.fasta", "chr1", asm[:slice_len])
        soaklog(workdir, f"[datagen] {time.time() - t0:.0f}s  reads: {msg}")
    else:
        soaklog(workdir, f"[datagen] reused existing inputs "
                         f"({time.time() - t0:.0f}s genome+asm regen)")
    del genome, asm

    py = [sys.executable, "-u", "-m", "kreeq_tpu_torch.cli.main"]
    ckpt = os.path.join(workdir, "ckpt")
    phases = {}

    def record(name, label, res):
        dt, att, rss = res
        phases[name] = {"wall_s": dt, "attempts": att, "peak_rss_gb": rss}
        soaklog(workdir, f"[{label}] {dt:.1f}s ok "
                         f"(attempts={att}, peak RSS {rss:.1f} GB)")

    # phase 1: build DB + write .kreeq (resumable via the checkpoint)
    if not os.path.exists(f"{workdir}/soak.kreeq/.index"):
        record("build", "build->DB", run_phase(
            workdir, "build",
            py + ["validate", "-r", "reads.fastq", "-k", "31",
                  "-o", "soak.kreeq", "--verbose"],
            env_extra={"KREEQ_TPU_BUILD_CKPT": ckpt}))
    else:
        soaklog(workdir, "[build->DB] skipped (soak.kreeq exists)")

    # phase 2: QV + bkwig from the DB (reuse path, -d)
    record("qv", "QV+bkwig", run_phase(
        workdir, "qv",
        py + ["validate", "-d", "soak.kreeq", "-f", "asm.fasta",
              "-o", "asm.bkwig", "--verbose"]))

    # phase 3: VCF slice
    record("vcf", f"VCF {slice_len / 1e6:g}Mbp", run_phase(
        workdir, "vcf",
        py + ["validate", "-d", "soak.kreeq", "-f", "asm10.fasta",
              "-o", "asm10.vcf", "--search-depth", "50",
              "--max-span", "32", "--verbose"]))

    # phase 4: artifact checks (host-only): recall + bkwig lookup
    rows, found, total, missed = recall_of(planted, f"{workdir}/asm10.vcf",
                                           slice_len)
    missed = [[*site, held] for site, held in zip(
        missed, read_support(mbp, coverage, missed))]
    soaklog(workdir, f"[VCF recall] {rows} rows; planted recall "
                     f"(+-{WITHIN}bp): {found}/{total}; missed (kind, "
                     f"position, length, reads on its path): {missed}")

    dt, att, rss = run_phase(
        workdir, "bkwig",
        [sys.executable, "-u", "-m", "kreeq_tpu_torch.cli.decompressor",
         "lookup", "-i", "asm.bkwig", "chr1:1000-1040"],
        stall_s=600)
    phases["bkwig"] = {"wall_s": dt, "attempts": att, "peak_rss_gb": rss}
    sz = os.path.getsize(f"{workdir}/asm.bkwig")
    dbsz = _tree_bytes(f"{workdir}/soak.kreeq")
    soaklog(workdir, f"[bkwig lookup] {dt:.1f}s ok; bkwig {sz / 1e9:.2f} "
                     f"GB; .kreeq DB {dbsz / 1e9:.2f} GB")
    ops = _manifest_ops(ckpt)
    soaklog(workdir, json.dumps({
        "soak": "complete", "mbp": mbp, "coverage": coverage,
        "vcf_rows": rows, "recall": [found, total], "missed": missed,
        "phases": phases,
        "db_bytes": dbsz, "bkwig_bytes": sz,
        "ckpt_parts": ops.get("part", 0), "ckpt_merges": ops.get("merge", 0),
        "host_merges": {n: len(_log_lines(workdir, n, "host merge "))
                        for n in ("build", "qv", "vcf")},
        "table_windows": [ln.split("] ", 1)[-1] for ln in _log_lines(
            workdir, "qv", "held on the host")],
        "card": card()}))


if __name__ == "__main__":
    main()
