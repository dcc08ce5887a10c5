"""Microseconds of host search a branch point: the self seconds of the
program's `kq.variants.search` span over its `variants.branch_points`
counter, summed over the window's jobs."""

SPAN = "kq.variants.search"
COUNTER = "variants.branch_points"


def read(run):
    from kreeq_tpu_torch.utils import log

    # the window's jobs are the last ones the program recorded
    jobs = list(getattr(log, "jobs", ()))[-run.jobs:] if run.jobs else []
    seconds = sum(j["spans"][SPAN]["self_s"] for j in jobs
                  if SPAN in j["spans"])
    branches = sum(j["counters"].get(COUNTER, 0) for j in jobs)
    if not branches:
        return None
    return 1e6 * seconds / branches
