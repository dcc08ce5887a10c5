"""User input / run configuration (reference: include/input.h:25-34
UserInputKreeq and the gfalibs UserInput it extends)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List


@dataclass
class UserInput:
    mode: int = 0  # 0 validate, 1 union, 2 subgraph (main.cpp:61-65)
    kmer_len: int = 21  # gfalibs default; every test omitting -k reports 21
    cov_cutoff: int = 0
    kmer_depth: int = -1  # -1 -> derived from traversal algorithm
    max_span: int = 5
    no_collapse: bool = False
    no_reference: bool = False
    trav_algorithm: str = "best-first"
    in_sequence: str = ""
    in_reads: List[str] = field(default_factory=list)
    kmer_db: List[str] = field(default_factory=list)
    out_file: str = ""
    prefix: str = "."
    in_bed_include: str = ""
    max_mem: float = 0.0
    threads: int = 0
    verbose: bool = False
    profile: bool = False
    anomalies_out: str = ""
    trace_dir: str = ""
    stats_flag: bool = False

    def resolved_kmer_depth(self) -> int:
        """Reference: include/kreeq.h:168-177 (DBG ctor)."""
        if self.kmer_depth != -1:
            return self.kmer_depth
        if self.trav_algorithm == "best-first":
            return self.kmer_len
        if self.trav_algorithm == "traversal":
            return math.ceil(self.kmer_len / 2)
        return self.kmer_len


def get_file_ext(name: str) -> str:
    """Reference: include/validate.h:30-45 (".gz" keeps inner ext)."""
    if "." not in name:
        return ""
    last = name.rsplit(".", 1)[1]
    if last == "gz":
        return get_file_ext(name.rsplit(".", 1)[0]) + ".gz"
    return last
