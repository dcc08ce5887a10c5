"""1 Mbp error-correction bench: the batched variants path against the
per-position loop (counterpart of scripts/bench_variants.py).

    python -m kreeq_tpu_torch.bench_variants      (kreeq-torch-bench-variants)

The script's data, with the same bytes: a 1,000,000-base genome drawn
from default_rng(42), three rotations of it (by 0, 101 and 211 bases)
as the reads, k = 21, and an assembly with 100 SNVs planted by the same
generator.  Steps:
  DB build      - KmerTable.from_reads on the device (B1; B2 only if
                  the reads take several chunks);
  batched       - core/variants.dbg_to_variants, once to warm up (on the
                  card: the first launches, and the table host copy that
                  the first host search pays), then once timed: the scan
                  (B5) and the host search of its branch points;
  per-position  - old_dbg_to_variants, the script's round-1 loop: a
                  scalar KmerTable.lookup and a search from every found
                  position.
The two must give the same (type, pos, sequence, ref_len) list.  Then B5
is held against its plain version on the scan window's keys and timed
(bench_paths.hold_b5).  It prints the script's lines, then one JSON
object as the last line.

It runs on the card unless KREEQ_TPU_PLATFORM=cpu (device.py); any
mismatch, or no card, raises and the process exits non-zero.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from .bench import say
from .bench_paths import Steps, b5_line, card, hold_b5, probes

N = 1_000_000
K = 21
SEED = 42
N_SNV = 100
ROTATIONS = (0, 101, 211)  # offsets of the three reads


def make_data(n: int):
    """(reads FASTA text, assembly) of the script: the genome's
    rotations as reads, then the SNVs planted into a copy."""
    rng = np.random.default_rng(SEED)
    genome = "".join(rng.choice(list("ACGT"), size=n))
    reads = "".join(f">r{i}\n{genome[off:] + genome[:off]}\n"
                    for i, off in enumerate(ROTATIONS))
    asm = list(genome)
    pos = rng.choice(np.arange(1000, n - 1000), size=N_SNV, replace=False)
    for p in pos:
        asm[p] = "ACGT"[(ord(asm[p]) + 1) % 4]
    return reads, "".join(asm)


def old_dbg_to_variants(dbg, seg) -> None:
    """The script's round-1 per-position loop (scripts/bench_variants.py
    :15-81) over the port: a scalar table.lookup and a search from every
    found position.  Keys are u64 Python ints, invalid windows marked
    (1 << 63) | position."""
    import torch

    from .constants import keys_to_u64
    from .core.variants import search_variants
    from .ops.kernels import extract_cuda

    k = dbg.k
    ln = len(seg)
    if ln < k:
        return
    kcount = ln - k + 1
    max_span = dbg.ui.max_span
    table = dbg.table
    cache = {}
    visited = [False] * ln
    variants = []

    keys, isfw, _e, valid = extract_cuda(
        torch.from_numpy(seg.codes).to(table.device), k)
    all_keys = keys_to_u64(keys.cpu().numpy()).copy()
    all_isfw = isfw.cpu().numpy()
    valid = valid.cpu().numpy()
    invalid = np.nonzero(~valid[:kcount])[0]
    all_keys[invalid] = np.uint64(1 << 63) | invalid.astype(np.uint64)

    def pos_key(p):
        return int(all_keys[p]), bool(all_isfw[p])

    explored_total = 0
    while explored_total < kcount:
        targets_queue = []
        targets_map = {}
        for pos in range(max_span):
            if pos + k < kcount:
                key, _ = pos_key(pos + k)
                targets_queue.append(key)
                targets_map[key] = True
        for c in range(kcount):
            if targets_queue:
                targets_map.pop(targets_queue.pop(0), None)
            if c + k + max_span < kcount:
                key, _ = pos_key(c + k + max_span)
                targets_map[key] = True
                targets_queue.append(key)
            if visited[c]:
                continue
            skey, is_fw = pos_key(c)
            rec = table.lookup(skey)
            if rec is None:
                explored_total += 1
                visited[c] = True
                continue
            ref_key = pos_key(c + 1)[0] if c + 1 <= kcount - 1 else None
            ok, paths = search_variants(
                dbg, skey, rec, is_fw, ref_key, targets_queue,
                targets_map, cache, [0, 0])
            explored_total += ok
            if ok:
                for p in paths:
                    p.pos = c + k
                if paths:
                    variants.append(paths)
                visited[c] = True
    seg.variants = variants


def _paths(seg) -> list:
    return [(p.type, p.pos, p.sequence, p.ref_len)
            for grp in seg.variants for p in grp]


def run(n: int, device):
    """The bench at a genome of `n` bases on `device`.  Returns (the JSON
    record, {"variants": the batched path's (type, pos, sequence,
    ref_len) list}); raises on any mismatch."""
    from .config import UserInput
    from .core import variants as V
    from .core.dbg import DBG
    from .core.table import KmerTable
    from .io.sequence import Genome
    from .ops import kernels
    from .utils import log

    kernels.reset_launches()
    steps = Steps()
    reads, asm = make_data(n)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "reads.fasta")
        with open(path, "w") as fh:
            fh.write(reads)
        with steps("db_build"):
            table = KmerTable.from_reads([path], K, device)
    say(f"DB build: {steps.s['db_build']:.1f}s ({len(table)} distinct)")

    g = Genome()
    g.append_sequence("chr1", "", asm, 0)
    dbg = DBG(UserInput(out_file="out.vcf"), table)
    dbg.load_genome(g)
    seg = dbg.genome.segments[0]

    with steps("batched_warmup"), probes(table) as window:
        V.dbg_to_variants(dbg, seg)
    with steps("batched"), log.job() as job:
        V.dbg_to_variants(dbg, seg)
    search = {"branch_points": job["counters"]["variants.branch_points"],
              "search_s": job["spans"]["kq.variants.search"]["total_s"]}
    t_new = steps.s["batched"]
    n_vars = sum(len(v) for v in seg.variants)
    say(f"batched:      {t_new:8.2f}s  ({len(seg.variants)} variant "
        f"groups, {n_vars} paths)")
    new_result = _paths(seg)

    with steps("per_position"):
        old_dbg_to_variants(dbg, seg)
    t_old = steps.s["per_position"]
    old_result = _paths(seg)
    say(f"per-position: {t_old:8.2f}s")
    say(f"speedup: {t_old / t_new:.1f}x")
    if new_result != old_result:
        raise AssertionError("batched result differs!")
    say("outputs identical")
    launches = dict(kernels.LAUNCHES)

    b5 = {"scan_window": hold_b5(table, window["largest"])}
    say(b5_line("scan window", b5["scan_window"]))
    for c in steps.host_copy:
        say(f"table host copy: {c['s']:.2f}s (in {c['step']})")
    record = {
        "bench": "variants", "device": card(device), "n": n, "k": K,
        "snvs": N_SNV, "table_rows": len(table), "steps_s": steps.s,
        "table_host_copy": steps.host_copy, "search_stats": search,
        "variant_groups": len(seg.variants), "paths": n_vars,
        "batched_s_per_mbp": t_new / (len(seg) / 1e6),
        "speedup": t_old / t_new, "identical": {"variants": True}, "b5": b5,
        "launches": launches}
    return record, {"variants": new_result}


def main() -> None:
    from .device import resolve_device

    record, _ = run(N, resolve_device())
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
