"""Seconds of the CLI's `load k-mer DB` phase (io/kreeqdb.read_kreeq and
the native phmap parser) per job."""


def read(run):
    if not run.has_phase("load k-mer DB"):
        return None
    return run.phase_s("load k-mer DB") / run.jobs
