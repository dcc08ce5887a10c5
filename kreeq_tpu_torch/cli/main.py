"""kreeq CLI of the PyTorch port: argv-compatible front end (reference:
src/main.cpp).

The parser is the JAX package's, whole: modes validate, union, subgraph
(reference: src/main.cpp:61-65), and multi-value -r/-d consume following
non-option arguments like the reference's optind loop (reference:
src/main.cpp:169-179).  This slice of the port runs `validate -r
<reads> [-f <asm>]` with stdout output; every other mode, input or
output raises NotImplementedError.  The device comes from
KREEQ_TPU_PLATFORM (device.py).
"""

from __future__ import annotations

import os
import sys
from typing import List

from ..config import UserInput

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


def _check_ported(ui: UserInput) -> None:
    """Raise for what this slice of the port does not run yet."""
    def missing(what: str) -> None:
        raise NotImplementedError(f"{what} is not yet ported to "
                                  "kreeq_tpu_torch")

    if ui.mode == 1:
        missing("union mode")
    if ui.mode == 2:
        missing("subgraph mode")
    if ui.kmer_db:
        missing("-d (.kreeq databases)")
    if ui.out_file:
        missing("-o (output files)")
    if ui.anomalies_out:
        missing("--detect-anomalies")
    if ui.trace_dir:
        missing("--trace-dir")


def run(argv: List[str]) -> int:
    ui = parse_args(argv)
    _check_ported(ui)
    if not ui.in_reads:
        _err("Cannot load DBG input. Exiting.\n")

    from ..core.dbg import DBG
    from ..core.table import KmerTable
    from ..device import resolve_device
    from ..io.fastx import load_genome
    from ..io.sequence import Genome
    from ..utils import log

    device = resolve_device()
    log.set_flags(ui.verbose, ui.profile)
    if ui.max_mem or ui.threads:
        log.verbose("Note: -m/--max-memory and -j/--threads are "
                    "accepted for compatibility but not used; batch "
                    "sizes are planned statically (KREEQ_TPU_CHUNK).")

    # validate (reference: src/input.cpp:86-118)
    log.verbose("Loading input reads.")
    with log.phase("build k-mer DB"):
        table = KmerTable.from_reads(ui.in_reads, ui.kmer_len, device)
    log.verbose("Reads loaded.")
    dbg = DBG(ui, table)
    if ui.in_sequence:
        log.verbose("Loading input sequences")
        with log.phase("load genome"):
            genome = Genome()
            load_genome(ui.in_sequence, genome)
            dbg.load_genome(genome)
        log.verbose("Sequences loaded")
    with log.phase("report"):
        report(dbg)
    log.print_profile()
    return 0


def report(dbg) -> None:
    """Stdout report of validate (reference: src/kreeq-output.cpp:34-136
    with no -o): the DB summary, then the QV table."""
    dbg.print_db_stats()
    dbg.validate_sequences()


def main() -> None:
    sys.exit(run(sys.argv))


if __name__ == "__main__":
    main()
