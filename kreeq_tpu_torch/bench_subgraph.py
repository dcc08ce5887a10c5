"""Subgraph bench at 1 Mbp: the batched traversal against the scalar
per-neighbour loop, and the prefiltered best-first against the
exhaustive per-node search (counterpart of scripts/bench_subgraph.py).

    python -m kreeq_tpu_torch.bench_subgraph      (kreeq-torch-bench-subgraph)

The script's data, with the same bytes: 1,000,000 codes from
default_rng(7) mapped through ITOC, one read of the whole genome, k =
21, and the genome less a flank of n / 40 bases (25 kbp) at each end as
the assembly, so the traversal grows the ~950k-node seed subgraph into
the flanks.  Steps:
  DB build          - KmerTable.from_reads on the device (B1);
  extract           - core/subgraph.extract_subgraph (one B5 probe of
                      the assembly's k-mers);
  traversal (cold)  - core/subgraph.traversal on a copy of the seed.
                      Every kernel is built and loaded by the DB build,
                      so on the card this pays the first launches of the
                      frontier scan's torch operations and of B5 at the
                      rounds' shapes, not a compile;
  traversal (warm)  - the same on the seed itself;
  scalar traversal  - old_traversal, the script's round-1 loop, on a
                      third copy: a scalar KmerTable.lookup per new
                      neighbour;
  best-first        - core/subgraph.best_first (the device prefilter,
                      then a host search per boundary source) on a
                      fresh extraction, against exhaustive_best_first,
                      the host search from every seed node.
The traversals must give the same keys in the same order and equal
(fw, bw, cov, color); the best-first runs the same key order; no step
may change a seed node, which the copies share.  Then B5 is held
against its plain version on the largest traversal round's queries and
on the extraction's, and timed (bench_paths.hold_b5).  It prints the
script's lines, then one JSON object as the last line.

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
SEED = 7


def make_data(n: int):
    """(reads FASTA text, assembly) of the script: the genome as one
    read, and the genome less its flanks."""
    from .constants import ITOC

    codes = np.random.default_rng(SEED).integers(0, 4, n).astype(np.uint8)
    genome = "".join(ITOC[codes].tolist())
    flank = n // 40
    return f">r0\n{genome}\n", genome[flank:-flank]


def old_traversal(dbg, sub) -> None:
    """The script's round-1 per-neighbour loop
    (scripts/bench_subgraph.py:16-46) over the port: each round tests
    against the seed and the round's new nodes only, as the JAX
    traversal does."""
    from .core.keys import canonical, next_key_bw, next_key_fw
    from .core.subgraph import _db_node

    k = dbg.k
    table = dbg.table
    depth = dbg.ui.resolved_kmer_depth()
    candidates = {}
    frontier = sub
    for _ in range(depth):
        new = {}
        for key, node in frontier.items():
            for i in range(4):
                if node.fw[i] != 0:
                    nk, _ = canonical(next_key_fw(key, i, k), k)
                    if nk not in sub and nk not in new:
                        found = _db_node(table, nk)
                        if found is not None:
                            new[nk] = found
                if node.bw[i] != 0:
                    nk, _ = canonical(next_key_bw(key, i, k), k)
                    if nk not in sub and nk not in new:
                        found = _db_node(table, nk)
                        if found is not None:
                            new[nk] = found
        for key, node in new.items():
            candidates.setdefault(key, node)
        frontier = new
    for key, node in candidates.items():
        sub.setdefault(key, node)


def exhaustive_best_first(dbg, sub):
    """The script's exhaustive best-first (scripts/bench_subgraph.py
    :131-141): the host search from every node of `sub`, no prefilter."""
    from .core.subgraph import _dijkstra

    cache, candidates, copy = {}, {}, {}
    for key, node in sub.items():
        _e, discovered = _dijkstra(dbg, sub, key, node, cache)
        for dk, dn in discovered.items():
            candidates.setdefault(dk, dn)
        copy[key] = node
    for dk, dn in candidates.items():
        copy.setdefault(dk, dn)
    return copy


def fields(sub) -> list:
    """(key, fw, bw, cov, color) of every node in insertion order, read
    alike from the Python SubNode and native/subnode_ext's records."""
    return [(key, tuple(nd.fw), tuple(nd.bw), int(nd.cov), int(nd.color))
            for key, nd in sub.items()]


def run(n: int, device):
    """The bench at a genome of `n` bases on `device`.  Returns (the JSON
    record, {"traversal": fields() of the batched traversal,
    "best_first": the prefiltered best-first's keys}); raises on any
    mismatch."""
    from .config import UserInput
    from .core import subgraph as S
    from .core.dbg import DBG
    from .core.table import KmerTable
    from .io.sequence import Genome
    from .ops import kernels
    from .utils import log

    kernels.reset_launches()
    steps = Steps()
    reads, asm = make_data(n)
    ui = UserInput()
    ui.kmer_len = K
    ui.trav_algorithm = "traversal"
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "reads.fasta")
        with open(path, "w") as fh:
            fh.write(reads)
        with steps("db_build"):
            table = KmerTable.from_reads([path], K, device)
    say(f"DB build: {steps.s['db_build']:.1f}s ({len(table)} distinct)")

    genome = Genome()
    genome.append_sequence("asm", "", asm, 0)
    dbg = DBG(ui, table)
    dbg.load_genome(genome)

    with steps("extract"), probes(table) as extraction:
        sub1 = S.extract_subgraph(dbg)
    seed = fields(sub1)
    sub2 = dict(sub1)
    say(f"seed subgraph: {len(sub1)} nodes")
    blue = sum(1 for *_, color in seed if color == 1)

    warm = dict(sub1)
    with steps("traversal_cold"), probes(table) as rounds:
        S.traversal(dbg, warm)
    say(f"batched traversal (cold): {steps.s['traversal_cold']:6.2f}s")
    with steps("traversal_warm"), log.job() as trav:
        S.traversal(dbg, sub1)
    t_new = steps.s["traversal_warm"]
    say(f"batched traversal (warm): {t_new:6.2f}s -> {len(sub1)} nodes")

    with steps("scalar_traversal"):
        old_traversal(dbg, sub2)
    t_old = steps.s["scalar_traversal"]
    say(f"scalar traversal:   {t_old:6.2f}s -> {len(sub2)} nodes")
    got = fields(sub1)
    if list(sub1) != list(sub2):
        raise AssertionError("order mismatch")
    if got != fields(sub2):
        raise AssertionError("traversal: node fields differ")
    say(f"speedup: {t_old / t_new:.1f}x — outputs identical "
        f"(incl. insertion order)")

    ui.trav_algorithm = "best-first"
    ui.kmer_depth = -1
    with steps("extract_best_first"):
        sub3 = S.extract_subgraph(dbg)
    sub4 = dict(sub3)
    bf_seed = fields(sub3)
    with steps("best_first"), log.job() as bf:
        out_new = S.best_first(dbg, sub3)
    t_bf = steps.s["best_first"]
    say(f"prefiltered best-first: {t_bf:6.2f}s -> {len(out_new)} nodes")
    with steps("exhaustive_best_first"):
        out_old = exhaustive_best_first(dbg, sub4)
    t_ex = steps.s["exhaustive_best_first"]
    say(f"exhaustive best-first:  {t_ex:6.2f}s -> {len(out_old)} nodes")
    if list(out_new) != list(out_old):
        raise AssertionError("order mismatch")
    say(f"best-first speedup: {t_ex / t_bf:.1f}x — identical")
    if fields({key: sub1[key] for key, *_ in seed}) != seed \
            or fields(sub3) != bf_seed:
        raise AssertionError("a seed node changed in place")
    launches = dict(kernels.LAUNCHES)

    b5 = {"traversal_round": hold_b5(table, rounds["largest"]),
          "extraction": hold_b5(table, extraction["largest"])}
    for name, rec in b5.items():
        say(b5_line(name.replace("_", " "), rec))
    for c in steps.host_copy:
        say(f"table host copy: {c['s']:.2f}s (in {c['step']})")
    warm_rounds = trav["counters"].get("subgraph.rounds", 0)
    # the warm traversal probes the cold one's batches: the same rounds
    if len(rounds["sizes"]) != warm_rounds:
        raise AssertionError(f"{len(rounds['sizes'])} cold rounds, "
                             f"{warm_rounds} warm")
    record = {
        "bench": "subgraph", "device": card(device), "n": n, "k": K,
        "table_rows": len(table), "assembly_bases": len(asm),
        "seed_nodes": len(seed), "traversal_nodes": len(sub1),
        "best_first_nodes": len(out_new), "steps_s": steps.s,
        "table_host_copy": steps.host_copy,
        "subgraph_stats": {
            "seed": len(seed), "blue": blue,
            "rounds": [{"q": q} for q in rounds["sizes"]],
            "round_nodes": trav["counters"].get("subgraph.round_nodes", 0),
            "sources": bf["counters"]["subgraph.sources"],
            "search_s": bf["spans"]["kq.subgraph.search"]["total_s"]},
        "traversal_warm_s_per_mbp": t_new / (len(asm) / 1e6),
        "speedup": {"traversal": t_old / t_new, "best_first": t_ex / t_bf},
        "identical": {"traversal": True, "best_first": True}, "b5": b5,
        "launches": launches}
    return record, {"traversal": got, "best_first": list(out_new)}


def main() -> None:
    from .device import resolve_device

    record, _ = run(N, resolve_device())
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
