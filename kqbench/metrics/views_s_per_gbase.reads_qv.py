"""Host self seconds of the program's `kq.ingest.views` span (the read
index of a file's batch, its `ends` array, native.parse_fastx) per 10^9
read bases, the bases the program counted as it parsed them (counter
`ingest.bases`), over the window's jobs."""

SPAN = "kq.ingest.views"


def read(run):
    from kreeq_tpu_torch.utils import log

    # the window's jobs are the last ones the program recorded
    jobs = list(getattr(log, "jobs", ()))[-run.jobs:] if run.jobs else []
    spans = [j["spans"][SPAN] for j in jobs if SPAN in j["spans"]]
    bases = sum(j["counters"].get("ingest.bases", 0) for j in jobs)
    if not spans or not bases:
        return None
    return sum(s["self_s"] for s in spans) / (bases / 1e9)
