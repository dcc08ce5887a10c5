"""The track probe's share of its roofline: the least bytes of the
window's ops/validate.validate_positions calls (the assembly's bases at
2 bits, 12 B of track a k-mer window, 44 B for each distinct table row
found; per job) at the card's peak, over the device time of every
kernel those calls launched."""

from kqbench import bounds
from kqbench.spans import TRACKS


def read(run):
    if run.trace is None or not run.spans.calls.get(TRACKS):
        return None
    nbytes = run.jobs * bounds.track_probe_bytes(
        run.sizes["asm_bases"], run.facts["asm_windows"],
        run.facts["rows_found"])
    return bounds.share(nbytes, run.trace.device_s(TRACKS))
