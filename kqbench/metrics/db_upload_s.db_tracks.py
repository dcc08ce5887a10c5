"""Host self seconds of the program's `kq.db.upload` span (the rows' copy
to the device, the sort, the gather and the widening,
io/kreeqdb.read_kreeq) a job of the window."""

SPAN = "kq.db.upload"


def read(run):
    from kreeq_tpu_torch.utils import log

    # the window's jobs are the last ones the program recorded
    jobs = list(getattr(log, "jobs", ()))[-run.jobs:] if run.jobs else []
    spans = [j["spans"][SPAN] for j in jobs if SPAN in j["spans"]]
    if not spans:
        return None
    return sum(s["self_s"] for s in spans) / run.jobs
