"""PyTorch port, candidate-error path against the JAX package on the CPU:
the generic probe (plain probe_sorted against probe_merge, probe_sorted
and the Pallas probe in interpret mode), k-mer extraction with
per-position sentinels and the depth-0 candidate scan (element for
element at k = 21, 31, 32), the host lookup, the Fibonacci heap's
extraction order, dbg_to_variants under forced window caps, and
detect_anomalies.  All exact: keys, counters and variants are integers
and strings."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _reads_table(rng, genome, k, nreads=80, err=0.004):
    """A JAX-built table (u64 keys with a SENTINEL tail, u32 counters) of
    100-base reads of `genome` with substitutions."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import count_sorted, kmer_positions

    reads = np.full(nreads * 101, 4, np.uint8)
    for i, s in enumerate(rng.integers(0, genome.shape[0] - 100, nreads)):
        r = genome[s:s + 100].copy()
        flip = rng.random(100) < err
        r[flip] = (r[flip] + 1) % 4
        reads[i * 101:i * 101 + 100] = r
    keys, _isfw, edges, valid = kmer_positions(jnp.asarray(reads), k)
    return tuple(np.asarray(a) for a in count_sorted(keys, edges, valid)[:4])


def _assembly(rng, genome):
    """The genome with substitutions, BAD bases and IUPAC letters."""
    from kreeq_tpu_torch.constants import codes_to_seq, seq_to_codes

    seq = list(codes_to_seq(genome))
    for x in rng.integers(0, len(seq), 12):
        seq[x] = "ACGT"[("ACGT".index(seq[x]) + 1) % 4] \
            if seq[x] in "ACGT" else "A"
    for x, c in zip(rng.integers(0, len(seq), 6), "RYKMSN"):
        seq[x] = c
    return seq_to_codes("".join(seq))


def _port_table(table):
    from kreeq_tpu_torch.constants import keys_from_u64

    return (torch.from_numpy(keys_from_u64(table[0])),
            *(torch.from_numpy(a.astype(np.int64)) for a in table[1:]))


def _same(got, want):
    """Port tensors (biased int64 keys) against JAX arrays (u64 keys)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        if w.dtype == np.uint64:
            from kreeq_tpu_torch.constants import keys_to_u64

            g = keys_to_u64(g)
        assert g.shape == w.shape
        assert np.array_equal(g.astype(w.dtype), w)
        if w.dtype != bool:
            assert np.array_equal(g, w.astype(g.dtype))


@pytest.mark.parametrize("k", [21, 31, 32])
def test_probe_sorted_matches_jax(k):
    """Hits, misses, SENTINEL queries and the per-position sentinels of
    invalid windows against a SENTINEL-tailed table."""
    import jax.numpy as jnp

    from kreeq_tpu.core.variants import _extract_sentinel as jax_extract
    from kreeq_tpu.ops.kmers import SENTINEL, probe_merge
    from kreeq_tpu.ops.kmers import probe_sorted as jax_probe_sorted
    from kreeq_tpu_torch.constants import keys_from_u64
    from kreeq_tpu_torch.ops.kmers import probe_sorted

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    table = _reads_table(rng, genome, k)
    assert table[0][-1] == np.uint64(SENTINEL)  # SENTINEL tail
    qkeys = np.concatenate([
        np.asarray(jax_extract(jnp.asarray(_assembly(rng, genome)), k)[0]),
        np.full(3, SENTINEL, np.uint64),
        rng.integers(0, 1 << 63, 50, dtype=np.uint64) << np.uint64(1)])
    want = probe_merge(*(jnp.asarray(a) for a in table), jnp.asarray(qkeys))
    _same(want, jax_probe_sorted(*(jnp.asarray(a) for a in table),
                                 jnp.asarray(qkeys)))
    got = probe_sorted(*_port_table(table),
                       torch.from_numpy(keys_from_u64(qkeys)))
    found = np.asarray(want[0])
    assert 0 < found.sum() < found.shape[0]
    assert not found[-53:-50].any()  # SENTINEL queries
    _same(got, want)
    # q = 0
    _same(probe_sorted(*_port_table(table), torch.zeros(0, dtype=torch.int64)),
          probe_merge(*(jnp.asarray(a) for a in table),
                      jnp.zeros(0, jnp.uint64)))


def test_probe_sorted_k32_sentinels_never_found():
    """At k = 32 the sentinels of invalid windows are not SENTINEL: they
    are searched, and no canonical key equals one."""
    from kreeq_tpu_torch.constants import SENTINEL
    from kreeq_tpu_torch.core.variants import _extract_sentinel
    from kreeq_tpu_torch.ops.kmers import probe_sorted

    k = 32
    codes = torch.full((k + 40,), 4, dtype=torch.uint8)
    keys, _isfw, valid = _extract_sentinel(codes, k)
    assert not valid.any() and not (keys == SENTINEL).any()
    # a table holding every key next to the sentinels in the port's order
    near = torch.unique(torch.cat([keys - 1, keys + 1]))
    tab = (near, torch.ones_like(near), torch.ones((near.shape[0], 4),
                                                    dtype=torch.int64),
           torch.ones((near.shape[0], 4), dtype=torch.int64))
    found, cov, fw, bw = probe_sorted(*tab, keys)
    assert not found.any() and not cov.any() and not fw.any() \
        and not bw.any()


def test_probe_sorted_empty_table_matches_jax():
    """An empty table finds nothing (JAX: probe_merge_pallas's early
    return, the path KmerTable._probe_one takes)."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.pallas_kernels import probe_merge_pallas
    from kreeq_tpu_torch.ops.kmers import probe_sorted

    qkeys = np.arange(1, 40, 3, dtype=np.uint64)
    want = probe_merge_pallas(jnp.zeros(0, jnp.uint64),
                              jnp.zeros(0, jnp.uint32),
                              jnp.zeros((0, 4), jnp.uint32),
                              jnp.zeros((0, 4), jnp.uint32),
                              jnp.asarray(qkeys))
    empty = (torch.zeros(0, dtype=torch.int64),
             torch.zeros(0, dtype=torch.int64),
             torch.zeros((0, 4), dtype=torch.int64),
             torch.zeros((0, 4), dtype=torch.int64))
    got = probe_sorted(*empty, torch.from_numpy(qkeys.astype(np.int64)))
    _same(got[1:], want[1:])
    assert not got[0].any() and not np.asarray(want[0]).any()


def test_probe_sorted_matches_pallas_interpret(monkeypatch):
    """One small case against the Pallas generic probe in interpret
    mode."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.pallas_kernels import probe_merge_pallas
    from kreeq_tpu_torch.constants import keys_from_u64
    from kreeq_tpu_torch.ops.kmers import probe_sorted

    monkeypatch.setenv("KREEQ_TPU_PALLAS_INTERPRET", "1")
    k = 21
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 900).astype(np.uint8)
    table = _reads_table(rng, genome, k, nreads=20)
    from kreeq_tpu.ops.kmers import kmer_positions

    asm = _assembly(rng, genome)[:500]
    qkeys = np.asarray(kmer_positions(jnp.asarray(asm), k)[0])
    want = probe_merge_pallas(*(jnp.asarray(a) for a in table),
                              jnp.asarray(qkeys))
    assert 0 < np.asarray(want[0]).sum() < qkeys.shape[0]
    _same(probe_sorted(*_port_table(table),
                       torch.from_numpy(keys_from_u64(qkeys))), want)


@pytest.mark.parametrize("k", [21, 31, 32])
def test_extract_and_candidate_scan_match_jax(k):
    """_extract_sentinel and _candidate_scan element for element, on an
    assembly with BAD and IUPAC bases, against a table of reads with
    errors (so branch points exist), cutoff 1 (bw side)."""
    import jax.numpy as jnp

    from kreeq_tpu.core import variants as JV
    from kreeq_tpu.ops.kmers import probe_sorted as jax_probe_sorted
    from kreeq_tpu_torch.core import variants as PV

    rng = np.random.default_rng(100 + k)
    genome = rng.integers(0, 4, 2500).astype(np.uint8)
    table = _reads_table(rng, genome, k, nreads=150, err=0.01)
    codes = _assembly(rng, genome)
    jkeys, jisfw, jvalid = JV._extract_sentinel(jnp.asarray(codes), k)
    pkeys, pisfw, pvalid = PV._extract_sentinel(torch.from_numpy(codes), k)
    _same((pkeys, pisfw, pvalid), (jkeys, jisfw, jvalid))
    assert not np.asarray(jvalid).all()

    # the same probe result into both scans
    jfound, jcov, jfw, jbw = jax_probe_sorted(
        *(jnp.asarray(a) for a in table), jkeys)
    jfound = jfound & jvalid
    want = JV._candidate_scan(jkeys, jisfw, jfound, jcov, jfw, jbw,
                              jnp.uint32(1), k)
    pfound = torch.from_numpy(np.array(jfound))
    pcov, pfw, pbw = (torch.from_numpy(np.asarray(a).astype(np.int64))
                      for a in (jcov, jfw, jbw))
    got = PV._candidate_scan(pkeys, pisfw, pfound, pcov, pfw, pbw, 1, k)
    search = np.asarray(want[2])
    assert 0 < search.sum() < np.asarray(jfound).sum()
    _same(got, want)


@pytest.mark.parametrize("k", [21, 32])
def test_table_lookup_matches_jax(k):
    """The host lookup of u64 keys, hits and misses, keys above 2^63
    included at k = 32."""
    from kreeq_tpu.core.table import KmerTable as JaxTable
    from kreeq_tpu_torch.core.table import KmerTable

    rng = np.random.default_rng(k + 7)
    genome = rng.integers(0, 4, 2000).astype(np.uint8)
    tkeys, cov, fw, bw = _reads_table(rng, genome, k)
    n = int(np.searchsorted(tkeys, np.uint64(0xFFFFFFFFFFFFFFFF)))
    arrays = (tkeys[:n], cov[:n], fw[:n], bw[:n])
    jax_table = JaxTable(k, *arrays)
    port = KmerTable.from_numpy(k, *arrays, device="cpu")
    queries = [int(x) for x in tkeys[:n:7]] + [int(x) + 1 for x in
                                                tkeys[:n:11]] + [0]
    if k == 32:
        assert max(queries) >= 1 << 63
    hits = 0
    for key in queries:
        want = jax_table.lookup(key)
        got = port.lookup(key)
        assert (got is None) == (want is None)
        if want is not None:
            hits += 1
            assert got[2] == want[2]
            for g, w in zip(got[:2], want[:2]):
                assert g.dtype == w.dtype and np.array_equal(g, w)
    assert 0 < hits < len(queries)


def test_fibheap_order_matches_jax():
    """A seeded sequence of insert / decrease_key / extract_min, with
    evictions at the node cap: the same extraction order and sizes."""
    from kreeq_tpu.core.fibheap import FibonacciHeap as JaxHeap
    from kreeq_tpu_torch.core.fibheap import FibonacciHeap

    rng = np.random.default_rng(3)
    heaps = (JaxHeap(max_nodes=40), FibonacciHeap(max_nodes=40))
    logs = ([], [])
    live = set()
    nxt = 0
    for _ in range(3000):
        op = rng.random()
        if op < 0.5:
            obj, key = nxt, int(rng.choice([0, int(rng.integers(0, 9))]))
            nxt += 1
            live.add(obj)
            args = ("insert", obj, key)
        elif op < 0.75 and live:
            obj = int(rng.choice(sorted(live)))
            args = ("decrease_key", obj, int(rng.integers(0, 6)))
        else:
            args = ("extract_min",)
        for heap, log in zip(heaps, logs):
            out = getattr(heap, args[0])(*args[1:])
            log.append((out, heap.size()))
        if args[0] == "extract_min" and logs[0][-1][0] is not None:
            live.discard(logs[0][-1][0])
    assert logs[0] == logs[1]
    assert sum(1 for out, _n in logs[0] if out is not None) > 500


def _planted_6kbp(tmp_path):
    """The planted 6 kbp input of tests/test_variants_windows.py."""
    rng = np.random.default_rng(11)
    genome_seq = "".join(rng.choice(list("ACGT"), size=6000))
    rp = str(tmp_path / "r.fasta")
    with open(rp, "w") as fh:
        for i in range(0, 5850, 30):
            fh.write(f">r{i}\n{genome_seq[i:i + 150]}\n")
    asm = list(genome_seq)
    for pos in (255, 256, 511, 700, 1023, 1024, 2300, 3071, 4095, 5000):
        asm[pos] = "ACGT"[("ACGT".index(asm[pos]) + 1) % 4]
    asm.insert(1500, "T")
    del asm[2800]
    ap = str(tmp_path / "a.fasta")
    with open(ap, "w") as fh:
        fh.write(">a\n" + "".join(asm) + "\n")
    return ap, rp


def _variants(pkg, ap, rp, k=21, **opts):
    import importlib

    UserInput = importlib.import_module(f"{pkg}.config").UserInput
    DBG = importlib.import_module(f"{pkg}.core.dbg").DBG
    KmerTable = importlib.import_module(f"{pkg}.core.table").KmerTable
    variants = importlib.import_module(f"{pkg}.core.variants")
    fastx = importlib.import_module(f"{pkg}.io.fastx")
    Genome = importlib.import_module(f"{pkg}.io.sequence").Genome

    ui = UserInput(mode=0, in_sequence=ap, in_reads=[rp], kmer_len=k,
                   **(opts or dict(kmer_depth=50, max_span=32)))
    if pkg == "kreeq_tpu":
        table = KmerTable.from_reads([rp], k)
    else:
        table = KmerTable.from_reads([rp], k, "cpu")
    dbg = DBG(ui, table)
    g = Genome()
    fastx.load_genome(ap, g)
    dbg.load_genome(g)
    out = []
    for seg in dbg.genome.segments:
        variants.dbg_to_variants(dbg, seg)
        out.append([(p.type, p.pos, p.sequence, p.ref_len)
                    for grp in seg.variants for p in grp])
    return out


@pytest.mark.parametrize("window", [None, 256, 100])
def test_dbg_to_variants_matches_jax(tmp_path, monkeypatch, window):
    """The same variants per segment as the JAX package, with window
    seams on and near the planted errors (cap 256: ~23 windows)."""
    from kreeq_tpu_torch.utils import log

    if window:
        monkeypatch.setenv("KREEQ_TPU_VARIANTS_WINDOW", str(window))
    else:
        monkeypatch.delenv("KREEQ_TPU_VARIANTS_WINDOW", raising=False)
    ap, rp = _planted_6kbp(tmp_path)
    want = _variants("kreeq_tpu", ap, rp)
    with log.job() as rec:
        got = _variants("kreeq_tpu_torch", ap, rp)
    assert got == want
    assert sum(len(v) for v in want) >= 10  # the planted errors surfaced
    assert rec["counters"]["variants.branch_points"] > 0
    assert rec["spans"]["kq.variants.search"]["calls"] \
        == rec["spans"]["kq.variants.scan"]["calls"] > 0


@pytest.mark.parametrize("k", [21, 32])
def test_segment_end_window_matches_unwindowed_jax(tmp_path, monkeypatch, k):
    """Every segment's last position is a branch point here (the reads
    go on past the assembly's N run and segment ends), so small windows
    end up holding branch points only in a segment's last k + 1
    positions, whose target windows are empty.  The windowed port gives
    the variants of the unwindowed scan (where the JAX package's
    windowed scan raises an IndexError)."""
    from .test_torch_cli import _write_inputs

    rp, ap = _write_inputs(tmp_path, 9)
    monkeypatch.delenv("KREEQ_TPU_VARIANTS_WINDOW", raising=False)
    want = _variants("kreeq_tpu", ap, rp, k, max_span=5)
    assert sum(len(v) for v in want) >= 5
    for window in (100, 300):
        monkeypatch.setenv("KREEQ_TPU_VARIANTS_WINDOW", str(window))
        assert _variants("kreeq_tpu_torch", ap, rp, k, max_span=5) == want


def test_detect_anomalies_matches_jax(tmp_path):
    """Anomaly ranges per segment (IUPAC bases, an N run, planted
    differences, a segment shorter than k)."""
    from kreeq_tpu.config import UserInput as JaxInput
    from kreeq_tpu.core.dbg import DBG as JaxDBG
    from kreeq_tpu.core.table import KmerTable as JaxTable
    from kreeq_tpu.core.variants import detect_anomalies as jax_detect
    from kreeq_tpu.io.fastx import load_genome as jax_load
    from kreeq_tpu.io.sequence import Genome as JaxGenome
    from kreeq_tpu_torch.config import UserInput
    from kreeq_tpu_torch.core.dbg import DBG
    from kreeq_tpu_torch.core.table import KmerTable
    from kreeq_tpu_torch.core.variants import detect_anomalies
    from kreeq_tpu_torch.io.fastx import load_genome
    from kreeq_tpu_torch.io.sequence import Genome

    from .test_torch_cli import _write_inputs

    rp, ap = _write_inputs(tmp_path, 8)
    jt = JaxTable.from_reads([rp], 21)
    jdbg = JaxDBG(JaxInput(in_sequence=ap), jt)
    jg = JaxGenome()
    jax_load(ap, jg)
    jdbg.load_genome(jg)
    dbg = DBG(UserInput(in_sequence=ap),
              KmerTable.from_numpy(21, jt.keys, jt.cov, jt.fw, jt.bw, "cpu"))
    g = Genome()
    load_genome(ap, g)
    dbg.load_genome(g)
    want = [jax_detect(jdbg, seg) for seg in jdbg.genome.segments]
    got = [detect_anomalies(dbg, seg) for seg in dbg.genome.segments]
    assert got == want
    assert sum(len(r) for r in want) >= 4 and [] in want


@pytest.mark.parametrize("k", [11, 17, 21, 32])
def test_segment_end_default_window_matches_jax_without_record(
        tmp_path, monkeypatch, k):
    """At the default scan window: an assembly record of 50 bases, 7 N
    and 70 bases, whose two short segments hold branch points only in
    their last k + 1 positions.  The JAX CLI's `-o vcf` raises an
    IndexError on it (kreeq_tpu/core/variants.py:546-548); the port's
    VCF of the whole assembly equals the JAX CLI's of the assembly
    without that record."""
    from kreeq_tpu.cli.main import run as jax_run
    from kreeq_tpu_torch.cli.main import run

    from .test_torch_cli import _stdout, _write_inputs

    monkeypatch.delenv("KREEQ_TPU_VARIANTS_WINDOW", raising=False)
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    rp, ap = _write_inputs(tmp_path, 9)
    # the genome _write_inputs draws first from its seed
    genome = "".join(np.random.default_rng(9).choice(list("ACGT"), 2000))
    whole = tmp_path / "whole.fa"
    with open(ap) as fh:
        whole.write_text(fh.read() + ">gap\n" + genome[600:650] + "N" * 7
                         + genome[657:727] + "\n")
    argv = ["kreeq", "validate", "-r", rp, "-k", str(k), "-o", "vcf", "-f"]
    with pytest.raises(IndexError):
        _stdout(jax_run, argv + [str(whole)])
    want = _stdout(jax_run, argv + [ap])
    assert len(want.splitlines()) > 10
    assert _stdout(run, argv + [str(whole)]) == want
