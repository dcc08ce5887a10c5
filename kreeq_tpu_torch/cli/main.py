"""kreeq CLI of the PyTorch port: argv-compatible front end (reference:
src/main.cpp).

The parser is the JAX package's, whole: modes validate, union, subgraph
(reference: src/main.cpp:61-65), and multi-value -r/-d consume following
non-option arguments like the reference's optind loop (reference:
src/main.cpp:169-179); `kreeq warmup` goes to cli/warmup.py before it,
as in the JAX CLI.  This port runs `validate` from reads (-r) or a
`.kreeq` DB (-d), with or without an assembly (-f), to stdout or to
-o x.kreeq|bed|csvtable|kwig|bkwig|hist|gfa|gfa2|gfa.gz|gfa2.gz|vcf (and
`-o vcf` to stdout), with --detect-anomalies; `union`; and `subgraph -d
db -f asm [-o x.gfa|gfa2|gfa.gz|gfa2.gz|gfa]`.  --trace-dir DIR writes a
torch.profiler trace of any mode to DIR.  The device comes from
KREEQ_TPU_PLATFORM (device.py).

Under a multi-process launch (KREEQ_TPU_COORDINATOR, _NUM_PROCESSES,
_PROCESS_ID; parallel/multihost.py), `validate -r` builds the table
across the ranks from each rank's share of the read files and the rest
runs on every rank; rank 0 alone prints and writes output files.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
from typing import List

from ..config import UserInput, get_file_ext

VERSION = "0.1.0"


def _err(msg: str) -> "None":
    sys.stderr.write(msg)
    sys.exit(1)


def print_help() -> None:
    print("kreeq [mode] -h\nfor additional help.\n")
    print("Modes:")
    print("validate")
    print("union")
    print("subgraph")
    sys.exit(0)


_LONG = {
    "--coverage-cutoff": "c", "--database": "d", "--databases": "d",
    "--input-positions": "p", "--input-sequence": "f", "--kmer-length": "k",
    "--out-format": "o", "--input-reads": "r", "--tmp-prefix": "t",
    "--max-memory": "m", "--threads": "j",
}
_FLAGS = {"--verbose": "verbose", "--cmd": "cmd", "--no-collapse":
          "no_collapse", "--no-reference": "no_reference",
          "--profile": "profile"}
_LONG_VALUED = {"--search-depth": "kmer_depth", "--max-span": "max_span",
                "--traversal-algorithm": "trav_algorithm",
                "--detect-anomalies": "anomalies_out",
                "--trace-dir": "trace_dir"}


def parse_args(argv: List[str]) -> UserInput:
    if len(argv) <= 2:
        print_help()
    modes = {"validate": 0, "union": 1, "subgraph": 2}
    if argv[1] not in modes:
        _err(f"mode {argv[1]} does not exist. Terminating\n")
    ui = UserInput(mode=modes[argv[1]])
    cmd_flag = False

    i = 2
    n = len(argv)

    def multi(start: int, dest: list) -> int:
        j = start
        while j < n and (argv[j] == "-" or not argv[j].startswith("-")):
            # "-" = stdin (reference StreamObj pipe support; the
            # snapshot CLI's isPipe branch is dead — see io/fastx.py)
            if argv[j] != "-" and not os.path.exists(argv[j]):
                _err(f"--file {argv[j]} does not exist.\n")
            dest.append(argv[j])
            j += 1
        return j

    def value_of(idx: int, opt: str) -> str:
        if idx >= n:
            _err(f"option {opt} is missing a required argument\n")
        return argv[idx]

    while i < n:
        a = argv[i]
        if a in _FLAGS:
            if a == "--cmd":
                cmd_flag = True
            else:
                setattr(ui, _FLAGS[a], True)
            i += 1
            continue
        if a in _LONG_VALUED:
            val = value_of(i + 1, a)
            dest = _LONG_VALUED[a]
            if dest in ("trav_algorithm", "anomalies_out", "trace_dir"):
                setattr(ui, dest, val)
            else:
                setattr(ui, dest, int(val))
            i += 2
            continue
        short = _LONG.get(a, a[1:] if a.startswith("-") and len(a) == 2
                          else None)
        if short is None:
            _err(f"Unrecognized option: {a}\n")
        if short == "h":
            print("kreeq [command]")
            sys.exit(0)
        if short == "v":
            print(f"kreeq v{VERSION}")
            sys.exit(0)
        if short == "r":
            i = multi(i + 1, ui.in_reads)
            continue
        if short == "d":
            i = multi(i + 1, ui.kmer_db)
            continue
        val = value_of(i + 1, a)
        if short == "c":
            ui.cov_cutoff = int(val)
        elif short == "f":
            if val != "-" and not os.path.exists(val):
                _err(f"--file {val} does not exist.\n")
            ui.in_sequence = val
        elif short == "k":
            ui.kmer_len = int(val)
        elif short == "o":
            ui.out_file = val
        elif short == "p":
            ui.in_bed_include = val
        elif short == "t":
            ui.prefix = val
        elif short == "m":
            ui.max_mem = float(val)
        elif short == "j":
            ui.threads = int(val)
        else:
            _err(f"Unrecognized option: {a}\n")
        i += 2

    if cmd_flag:
        print(" ".join(argv) + " ")
    if ui.mode == 1 and len(ui.kmer_db) < 2:
        _err("At least two databases required (-d).\n")
    if ui.mode == 2 and len(ui.kmer_db) != 1:
        _err("Need to provide one database (-d).\n")
    return ui


def _out_ext(ui: UserInput) -> str:
    return "stdout" if ui.out_file == "" else get_file_ext(
        "." + ui.out_file)


def load_graph(ui: UserInput, device):
    """Load a .kreeq DB onto `device`, overriding -k with the DB's k
    (reference: src/input.cpp:56-74)."""
    from ..io.kreeqdb import read_kreeq

    if len(ui.kmer_db) == 1:
        table = read_kreeq(ui.kmer_db[0], device)
        ui.kmer_len = table.k
        return table
    if len(ui.kmer_db) > 1:
        _err("More than one DBG database provided. Merge them first. "
             "Exiting.\n")
    _err("Cannot load DBG input. Exiting.\n")


class _Sink(io.TextIOBase):
    """stdout of the ranks other than 0: takes and drops every write."""

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        return len(s)


def run(argv: List[str]) -> int:
    if len(argv) > 1 and argv[1] == "warmup":
        # build the kernels and launch each once: the port's cold start
        from .warmup import run as warmup_run

        return warmup_run(argv)
    ui = parse_args(argv)

    import torch.distributed as dist

    from ..device import resolve_device
    from ..parallel import multihost
    from ..utils import log

    log.set_flags(ui.verbose, ui.profile)
    # multi-process launch: the build runs across the ranks, the rest
    # on every rank, and only rank 0 prints
    distributed = multihost.maybe_initialize()
    device = resolve_device()
    stdout = sys.stdout
    if distributed and dist.get_rank() != 0:
        sys.stdout = _Sink()
    try:
        if ui.max_mem or ui.threads:
            log.verbose("Note: -m/--max-memory and -j/--threads are "
                        "accepted for compatibility but not used; batch "
                        "sizes are planned statically (KREEQ_TPU_CHUNK).")
        with (log.trace(ui.trace_dir, device)
              if ui.trace_dir and _writes_output()
              else contextlib.nullcontext()):
            _run_mode(ui, device, multihost.world())
            log.print_profile()
    finally:
        sys.stdout = stdout
        if distributed:
            dist.destroy_process_group()
    return 0


def _writes_output() -> bool:
    """Whether this process writes output files: rank 0 of a launch, or
    a process alone."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _run_mode(ui: UserInput, device, group) -> None:
    from ..core.dbg import DBG
    from ..core.table import KmerTable
    from ..io.fastx import load_genome
    from ..io.sequence import Genome
    from ..utils import log

    def genome_of(dbg) -> None:
        log.verbose("Loading input sequences")
        with log.phase("load genome"):
            genome = Genome()
            load_genome(ui.in_sequence, genome)
            dbg.load_genome(genome)
        log.verbose("Sequences loaded")

    if ui.mode == 0:  # validate (reference: src/input.cpp:86-118)
        if ui.in_reads:
            log.verbose("Loading input reads.")
            with log.phase("build k-mer DB"):
                table = _build(ui, device, group)
            log.verbose("Reads loaded.")
        else:
            with log.phase("load k-mer DB"):
                table = load_graph(ui, device)
        dbg = DBG(ui, table)
        if ui.in_sequence:
            genome_of(dbg)
        with log.phase("report"):
            report(dbg)
        if ui.anomalies_out and _writes_output():
            from ..core.variants import write_anomalies

            with log.phase("detect anomalies"):
                write_anomalies(dbg, ui.anomalies_out)
    elif ui.mode == 1:  # union (reference: src/input.cpp:119-152)
        from ..io.kreeqdb import read_index, read_kreeq

        k = 0
        for db in ui.kmer_db:
            dbk, _mc = read_index(db)
            if k == 0:
                k = dbk
            if k != dbk:
                _err("Cannot merge databases with different kmer length.\n")
        if k == 0 or k > 32:
            _err("Invalid kmer length.\n")
        ui.kmer_len = k
        table = KmerTable.empty(k, device)
        for db in ui.kmer_db:
            table = table.merge(read_kreeq(db, device), group)
        report(DBG(ui, table))
    else:  # subgraph (reference: src/input.cpp:153-181)
        from ..core.subgraph import run_subgraph

        with log.phase("load k-mer DB"):
            table = load_graph(ui, device)
        dbg = DBG(ui, table)
        if ui.in_sequence:
            genome_of(dbg)
        run_subgraph(dbg)
        report(dbg)


def _build(ui: UserInput, device, group):
    """The table of the -r reads.  Under a launch, every rank counts its
    share of the files (build_table_distributed), or, with
    KREEQ_TPU_BUILD_CKPT, every rank reads them all for the resumable
    sharded build, whose files rank 0 writes; alone,
    KmerTable.from_reads."""
    import torch.distributed as dist

    from ..core.table import KmerTable
    from ..parallel import multihost

    if group is None:
        return KmerTable.from_reads(ui.in_reads, ui.kmer_len, device)
    ckpt = os.environ.get("KREEQ_TPU_BUILD_CKPT")
    if ckpt:
        from ..core.build_ckpt import from_reads_checkpointed

        return from_reads_checkpointed(ui.in_reads, ui.kmer_len, ckpt,
                                       device, group=group)
    mine = multihost.shard_read_files(ui.in_reads, dist.get_world_size(),
                                      dist.get_rank())
    return multihost.build_table_distributed(mine, ui.kmer_len, device,
                                             group=group)


def report(dbg) -> None:
    """Output dispatch by extension (reference:
    src/kreeq-output.cpp:34-136)."""
    from ..io import writers
    from ..utils import log

    ui = dbg.ui
    ext = _out_ext(ui)

    if "." in ui.out_file or ui.out_file == "" or ext == "kreeq" \
            or ui.stats_flag:
        dbg.print_db_stats()

    # no "csv" entry, as in the reference's table: `-o x.csv` writes
    # no file (print_table's csv separators are unreachable there too)
    computed = {"kreeq": 1, "bed": 2, "csvtable": 2, "kwig": 3,
                "bkwig": 4, "gfa": 5, "gfa2": 5, "gfa.gz": 5, "gfa2.gz": 5,
                "vcf": 6, "hist": 7}
    case = computed.get(ext, 0)

    if ui.mode == 0:
        if case in (5, 6):
            from ..core.variants import correct_sequences

            with log.phase("variants"):
                correct_sequences(dbg)
        else:
            # per-base tracks feed only the bed/csv/kwig/bkwig writers
            # (reference: src/kreeq-output.cpp:62-83); plain validate /
            # .kreeq / hist take the sums-only path
            with log.phase("validate"):
                dbg.validate_sequences(need_tracks=case in (2, 3, 4))

    if not _writes_output():
        return
    with log.phase("write output"):
        if case == 1:
            from ..io.kreeqdb import write_kreeq

            write_kreeq(ui.out_file, dbg.table)
        elif case == 2:
            writers.print_table(dbg, ext)
        elif case == 3:
            writers.print_kwig(dbg)
        elif case == 4:
            writers.print_bkwig(dbg)
        elif case == 5:
            writers.print_gfa(dbg)
        elif case == 6:
            writers.print_vcf(dbg)
        elif case == 7:
            writers.print_hist(dbg)


def main() -> None:
    sys.exit(run(sys.argv))


if __name__ == "__main__":
    main()
