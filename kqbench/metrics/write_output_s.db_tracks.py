"""Seconds of the CLI's `write output` phase (io/writers.print_bkwig)
per job."""


def read(run):
    if not run.has_phase("write output"):
        return None
    return run.phase_s("write output") / run.jobs
