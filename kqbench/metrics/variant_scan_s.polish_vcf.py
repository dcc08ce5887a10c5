"""Host seconds of the program's `kq.variants.scan` span (a scan
window's extraction, B5 probe, candidate scan and readback,
core/variants._scan_window_variants) a job of the window."""

SPAN = "kq.variants.scan"


def read(run):
    from kreeq_tpu_torch.utils import log

    # the window's jobs are the last ones the program recorded
    jobs = list(getattr(log, "jobs", ()))[-run.jobs:] if run.jobs else []
    spans = [j["spans"][SPAN] for j in jobs if SPAN in j["spans"]]
    if not spans:
        return None
    return sum(s["total_s"] for s in spans) / run.jobs
