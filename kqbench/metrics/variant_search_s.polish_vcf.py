"""Host self seconds of the program's `kq.variants.search` span (the
host search from each branch point the scan selected,
core/variants._search_from_scan) a job of the window."""

SPAN = "kq.variants.search"


def read(run):
    from kreeq_tpu_torch.utils import log

    # the window's jobs are the last ones the program recorded
    jobs = list(getattr(log, "jobs", ()))[-run.jobs:] if run.jobs else []
    spans = [j["spans"][SPAN] for j in jobs if SPAN in j["spans"]]
    if not spans:
        return None
    return sum(s["self_s"] for s in spans) / run.jobs
