"""Host seconds inside the program's read packing (ops/kmers.pack_reads,
which pulls each read from io/fastx.iter_reads and the native parser)
per 10^9 read bases: the ingest layer of `validate -r`."""

from kqbench.spans import PACK


def read(run):
    if not run.spans.calls.get(PACK):
        return None
    return run.spans.host_s[PACK] / (run.jobs * run.sizes["read_bases"]
                                     / 1e9)
