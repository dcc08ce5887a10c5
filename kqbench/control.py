"""The control of `correct`: the reference with its counters cut to 8
bits, put in the program's place and judged as a job is.

The configurations state exact counts in 32 bits: the `.kreeq` format
keeps a count in 8 bits and spills a count past 255 to a 32-bit map.
The step that tempts a change is to keep the 8 bits alone.  The control
saturates every counter at 255 and must come out wrong on every seed:
the repeats of each configuration (rDNA, chrM, IS5) pass 255 at 30x.

    python3 -m kqbench.control --workload <cell> --seeds 1 2 3

prints one JSON line a seed with each check's reading for the
reference (a sound program, 0) and for the control.  It needs no card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from . import compare, gen, kinds, spec
from .reference import outputs, table_of
from .reference.kmers import U8_MAX


def readings(config: dict, traffic: dict, seed: int, top: int = U8_MAX):
    """{check: (reference's reading, control's reading)} on one seed."""
    work = tempfile.mkdtemp(prefix="kqbench-control-")
    try:
        inputs = gen.make(config, seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    table = table_of(inputs.reads, inputs.offsets, config["k"])
    runs = [outputs(t, inputs.records, traffic["stdout"], traffic["files"])
            for t in (table, table.saturated(top))]
    out = {}
    for parts, files, _facts in runs:
        got = compare.stdout_checks("".join(parts.values()), runs[0][0])
        for name, kind in traffic["files"].items():
            mod = kinds.find(kind)
            got[mod.CHECK] = mod.values_off(files[name], runs[0][1][name])
        for n, v in got.items():
            out.setdefault(n, []).append(v)
    return {n: tuple(v) for n, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kqbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    _path, config = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = compare.limits(traffic)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(config, traffic, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reference": {n: v[0] for n, v in r.items()},
                          "control": {n: v[1] for n, v in r.items()},
                          "limits": {n: limits[n] for n in r},
                          "control_fails": any(v[1] > limits[n]
                                               for n, v in r.items()),
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
