"""PyTorch port, subgraph mode against the JAX package on the CPU, exact:
the neighbour scan (`neighbors8`, `survivors`), extraction with and
without --no-reference and with -p spans, traversal at several depths,
the best-first prefilter and search, edge pruning, the unitig collapse,
the uncollapsed graph and the graph statistics.  Every node dict must
equal the JAX one, insertion order included (GFA ids follow it).  The
JAX package runs its host scans and, with KREEQ_TPU_FRONTIER_MIN=0, its
device scans.  Inputs: a 2,000-base genome, 400 reads of 100 bases at
1% substitutions, the first 1,800 bases with one SNV plus bases
1,500-1,990 as the assembly."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _write_inputs(path):
    rng = np.random.default_rng(4)
    genome = "".join(rng.choice(list("ACGT"), 2000))
    reads = []
    for s in rng.integers(0, 1900, 400):
        r = list(genome[s:s + 100])
        for j in np.nonzero(rng.random(100) < 0.01)[0]:
            r[j] = "ACGT"[("ACGT".index(r[j]) + 1) % 4]
        reads.append("".join(r))
    rp = path / "reads.fq"
    rp.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    asm = list(genome[:1800])
    asm[700] = "ACGT"[("ACGT".index(asm[700]) + 2) % 4]  # SNV
    ap = path / "asm.fa"
    ap.write_text(">chr1\n" + "".join(asm) + "\n>chr2\n"
                  + genome[1500:1990] + "\n")
    bp = path / "spans.bed"
    bp.write_text("chr1\t100\t900\nchr2\t50\t300\nchr1\t1200\t1700\n")
    return str(rp), str(ap), str(bp)


@pytest.fixture(scope="module", params=[21, 31, 32])
def db(request, tmp_path_factory):
    """(k, JAX table, port table, assembly, spans): the table built once
    per k by the JAX package, the port's from the same arrays."""
    from kreeq_tpu.core.table import KmerTable as JaxTable
    from kreeq_tpu_torch.core.table import KmerTable

    k = request.param
    rp, ap, bp = _write_inputs(tmp_path_factory.mktemp(f"sub{k}"))
    jt = JaxTable.from_reads([rp], k)
    pt = KmerTable.from_numpy(k, jt.keys, jt.cov, jt.fw, jt.bw, "cpu")
    return k, jt, pt, ap, bp


def _dbgs(db, **opts):
    """(JAX DBG, port DBG) on the module's table and assembly, with the
    UserInput fields `opts`."""
    from kreeq_tpu.config import UserInput as JaxUI
    from kreeq_tpu.core.dbg import DBG as JaxDBG
    from kreeq_tpu.io.fastx import load_genome as jax_load
    from kreeq_tpu.io.sequence import Genome as JaxGenome
    from kreeq_tpu_torch.config import UserInput
    from kreeq_tpu_torch.core.dbg import DBG
    from kreeq_tpu_torch.io.fastx import load_genome
    from kreeq_tpu_torch.io.sequence import Genome

    k, jt, pt, ap, bp = db
    if opts.pop("spans", False):
        opts["in_bed_include"] = bp
    out = []
    for ui_cls, dbg_cls, genome_cls, load, table in (
            (JaxUI, JaxDBG, JaxGenome, jax_load, jt),
            (UserInput, DBG, Genome, load_genome, pt)):
        ui = ui_cls(mode=2, kmer_len=k, in_sequence=ap)
        for name, val in opts.items():
            setattr(ui, name, val)
        dbg = dbg_cls(ui, table)
        genome = genome_cls()
        load(ap, genome)
        dbg.load_genome(genome)
        out.append(dbg)
    return out


def _snapshot(sub):
    return [(k, tuple(n.fw), tuple(n.bw), n.cov, n.color)
            for k, n in sub.items()]


def _jax_env(monkeypatch, frontier_min):
    if frontier_min is None:
        monkeypatch.delenv("KREEQ_TPU_FRONTIER_MIN", raising=False)
    else:
        monkeypatch.setenv("KREEQ_TPU_FRONTIER_MIN", frontier_min)


# -- the neighbour scan ------------------------------------------------------


@pytest.mark.parametrize("k", [5, 11, 21, 31, 32])
def test_neighbors8_matches_jax(k):
    from kreeq_tpu.core.keys import canonical_np, neighbors8_np
    from kreeq_tpu_torch.constants import keys_from_u64, keys_to_u64
    from kreeq_tpu_torch.ops.frontier import neighbors8

    rng = np.random.default_rng(k)
    raw = rng.integers(0, 1 << min(2 * k, 63), 3000).astype(np.uint64)
    if k == 32:
        raw[::2] |= np.uint64(1 << 63)
    keys, _ = canonical_np(raw, k)
    want = neighbors8_np(keys, k)
    got = neighbors8(torch.from_numpy(keys_from_u64(keys)), k)
    assert got.shape == (keys.size, 8)
    assert np.array_equal(keys_to_u64(got.numpy()), want)


def _survivor_inputs(n, m, k, seed, top=4):
    """The inputs of tests/test_frontier.py's cases: n unique canonical
    keys, random counters below `top`, and about m members drawn half
    from the keys' neighbours, half at random."""
    from kreeq_tpu.core.keys import canonical_np, neighbors8_np

    rng = np.random.default_rng(seed)
    keys, _ = canonical_np(
        rng.integers(0, 1 << min(2 * k, 63), n).astype(np.uint64), k)
    keys = np.unique(keys)
    rng.shuffle(keys)
    n = keys.size
    fw = rng.integers(0, top, (n, 4)).astype(np.uint32)
    bw = rng.integers(0, top, (n, 4)).astype(np.uint32)
    cand = neighbors8_np(keys, k)
    pool = np.concatenate([
        cand.ravel()[rng.integers(0, n * 8, max(m // 2, 1))],
        canonical_np(rng.integers(0, 1 << min(2 * k, 63),
                                  max(m // 2, 1)).astype(np.uint64),
                     k)[0]])
    return keys, fw, bw, np.sort(np.unique(pool)[:m])


@pytest.mark.parametrize("n,m,k,cutoff,seed,dedup", [
    (1000, 700, 21, 0, 0, False),
    (5000, 5000, 31, 1, 1, False),
    (3, 1, 5, 0, 2, False),
    (100, 0, 32, 2, 3, False),     # k = 32, empty member set
    (257, 31, 11, 0, 4, False),
    (3000, 900, 7, 0, 5, True),    # k = 7: many repeated neighbours
    (3000, 0, 9, 1, 6, True),     # dedup, empty member set
    (40000, 0, 25, 0, 9, False),   # more than 2^14 survivors
])
def test_survivors_matches_jax(n, m, k, cutoff, seed, dedup):
    """Against kreeq_tpu.ops.frontier.survivors_np (its device scan);
    with dedup, against the first occurrence of each value in scan
    order, as the JAX traversal's host rounds keep it."""
    from kreeq_tpu.ops.frontier import survivors_np
    from kreeq_tpu_torch.constants import keys_from_u64, keys_to_u64
    from kreeq_tpu_torch.ops.frontier import survivors

    keys, fw, bw, members = _survivor_inputs(n, m, k, seed)
    want_vals, want_idx = survivors_np(keys, fw, bw, members, k, cutoff)
    if dedup:
        _u, first = np.unique(want_vals, return_index=True)
        first = np.sort(first)
        assert first.size < want_vals.size
        want_vals, want_idx = want_vals[first], want_idx[first]
    if n == 40000:
        assert want_idx.size > (1 << 14)

    def t(a):
        return torch.from_numpy(a.astype(np.int64))

    vals, idx = survivors(torch.from_numpy(keys_from_u64(keys)), t(fw),
                          t(bw), torch.from_numpy(keys_from_u64(members)),
                          k, cutoff, dedup)
    assert want_idx.size > 0
    assert np.array_equal(idx.numpy(), want_idx)
    assert np.array_equal(keys_to_u64(vals.numpy()), want_vals)


# -- subgraph passes ----------------------------------------------------------


@pytest.mark.parametrize("opts", [{}, {"no_reference": True},
                                  {"spans": True}])
def test_extract_matches_jax(db, opts):
    from kreeq_tpu.core.subgraph import extract_subgraph as jax_extract
    from kreeq_tpu_torch.core.subgraph import extract_subgraph

    jdbg, pdbg = _dbgs(db, **opts)
    want = _snapshot(jax_extract(jdbg))
    colors = {c for *_rest, c in want}
    assert colors == ({1} if opts.get("no_reference") else {1, 2})
    assert _snapshot(extract_subgraph(pdbg)) == want


@pytest.mark.parametrize("depth", [1, 4, 11, 16])
def test_traversal_matches_jax(db, monkeypatch, depth):
    """The port's member set grows every round; the JAX rounds test the
    seed set only.  Both give the same dict, in the same order."""
    from kreeq_tpu.core import subgraph as J
    from kreeq_tpu_torch.core import subgraph as P

    jdbg, pdbg = _dbgs(db, trav_algorithm="traversal", kmer_depth=depth)
    psub = P.extract_subgraph(pdbg)
    seed = len(psub)
    P.traversal(pdbg, psub)
    got = _snapshot(psub)
    assert len(got) > seed
    for frontier_min in (None, "0"):
        _jax_env(monkeypatch, frontier_min)
        jsub = J.extract_subgraph(jdbg)
        J.traversal(jdbg, jsub)
        assert got == _snapshot(jsub)


@pytest.mark.parametrize("alg", ["traversal", "best-first"])
def test_python_nodes_match_extension(db, monkeypatch, alg):
    """_bulk_nodes without native/subnode_ext (no compiler or headers)
    gives the same dicts, insertion order included, as with it."""
    from kreeq_tpu_torch.core import subgraph as P

    assert P.get_module() is not None
    _jdbg, pdbg = _dbgs(db, trav_algorithm=alg, kmer_depth=4)

    def searched():
        sub = P.extract_subgraph(pdbg)
        if alg == "traversal":
            P.traversal(pdbg, sub)
        else:
            sub = P.best_first(pdbg, sub)
        return sub

    want = _snapshot(searched())
    monkeypatch.setattr(P, "get_module", lambda: None)
    sub = searched()
    assert all(type(n) is P.SubNode for n in sub.values())
    assert _snapshot(sub) == want


@pytest.mark.parametrize("frontier_min", [None, "0"])
def test_best_first_matches_jax(db, monkeypatch, frontier_min):
    """The prefilter's mask, the search's dict, and the pruned dict."""
    from kreeq_tpu.core import subgraph as J
    from kreeq_tpu_torch.core import subgraph as P

    _jax_env(monkeypatch, frontier_min)
    jdbg, pdbg = _dbgs(db, trav_algorithm="best-first")
    jsub, psub = J.extract_subgraph(jdbg), P.extract_subgraph(pdbg)
    need = J._boundary_sources(jdbg, jsub)
    assert 0 < need.sum() < need.size
    assert np.array_equal(P._boundary_sources(pdbg, psub), need)
    jsub, psub = J.best_first(jdbg, jsub), P.best_first(pdbg, psub)
    assert _snapshot(psub) == _snapshot(jsub)
    J.remove_missing_edges(jdbg, jsub)
    before = _snapshot(psub)
    P.remove_missing_edges(pdbg, psub)
    assert _snapshot(psub) == _snapshot(jsub) != before


@pytest.mark.parametrize("frontier_min", [None, "0"])
@pytest.mark.parametrize("cutoff", [0, 2])
def test_remove_missing_edges_after_traversal_matches_jax(
        db, monkeypatch, frontier_min, cutoff):
    """Pruning counts only counters above the cutoff."""
    from kreeq_tpu.core import subgraph as J
    from kreeq_tpu_torch.core import subgraph as P

    _jax_env(monkeypatch, frontier_min)
    jdbg, pdbg = _dbgs(db, trav_algorithm="traversal", kmer_depth=3,
                       cov_cutoff=cutoff)
    subs = []
    for mod, dbg in ((J, jdbg), (P, pdbg)):
        sub = mod.extract_subgraph(dbg)
        mod.traversal(dbg, sub)
        mod.remove_missing_edges(dbg, sub)
        subs.append(_snapshot(sub))
    assert subs[1] == subs[0]


def _gfa_snapshot(gfa):
    return ([(s.uid, s.header, s.seq, tuple(s.tags)) for s in gfa.segments],
            [(e.uid, e.eid, e.sid1, e.sid2, e.or1, e.or2, e.cigar, e.header,
              tuple(e.tags)) for e in gfa.edges])


@pytest.mark.parametrize("alg,no_collapse", [("best-first", False),
                                             ("traversal", False),
                                             ("best-first", True)])
def test_gfa_and_stats_match_jax(db, alg, no_collapse):
    """collapse_nodes (or the uncollapsed graph), then
    report_stats_lines, from the same pruned subgraph."""
    from kreeq_tpu.core import gfastats as JG
    from kreeq_tpu.core import subgraph as J
    from kreeq_tpu_torch.core import gfastats as PG
    from kreeq_tpu_torch.core import subgraph as P

    jdbg, pdbg = _dbgs(db, trav_algorithm=alg, no_collapse=no_collapse)
    out = []
    for mod, stats, dbg in ((J, JG, jdbg), (P, PG, pdbg)):
        sub = mod.search_graph(dbg, mod.extract_subgraph(dbg))
        mod.remove_missing_edges(dbg, sub)
        lines = mod.subgraph_summary_lines(sub, dbg.k)
        gfa = mod.graph_to_gfa(dbg, sub)
        out.append((lines, _gfa_snapshot(gfa),
                    stats.report_stats_lines(gfa)))
    assert out[1] == out[0]
    assert len(out[0][1][0]) > 100 and out[0][1][1]
