"""Seconds of the CLI's `build k-mer DB` phase (core/table
KmerTable.from_reads: ingest, count steps, TreeMerger) per 10^9 read
bases."""


def read(run):
    if not run.has_phase("build k-mer DB"):
        return None
    return run.phase_s("build k-mer DB") / (run.jobs
                                            * run.sizes["read_bases"] / 1e9)
