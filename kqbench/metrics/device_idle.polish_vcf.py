"""Percent of the traced window in which no kernel, copy or fill ran
on the card."""


def read(run):
    if run.trace is None or not len(run.trace.dev_start):
        return None
    return 100.0 * (1 - run.trace.busy_s() / run.trace.window_s)
