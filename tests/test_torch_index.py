"""PyTorch port, the bucket directory of a sorted table (ops/index.py):
its starts equal the JAX package's build_bucket_index at the same bits,
capped at the real row count as the JAX table's _build_bucket caps them;
every key's row lies inside its bucket, the invariant the probe_qv,
probe_select and probe_sorted kernels rely on, also for every kind of
query the generic probe is sent; a table builds it once, and only for
the card: on the CPU, validation and the table's batched probes build
none.  Inputs come from numpy with a seed; every comparison is exact."""

import io

import numpy as np
import pytest
import torch

from kreeq_tpu_torch.constants import SENTINEL, keys_from_u64, keys_to_u64

torch.set_num_threads(1)

U64_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _u64_keys(rng, n, k):
    """Sorted unique random k-mer keys in the JAX package's u64 form."""
    top = 1 << (2 * k)
    if k == 32:
        keys = rng.integers(0, np.iinfo(np.uint64).max, n, dtype=np.uint64)
    else:
        keys = rng.integers(0, top, n, dtype=np.uint64)
    return np.unique(keys)


def _port_keys(u64):
    return torch.from_numpy(keys_from_u64(u64))


def _jax_starts(u64, nrows, k, bits):
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import build_bucket_index

    starts = build_bucket_index(jnp.asarray(u64), k, bits)
    return np.minimum(np.asarray(starts), nrows).astype(np.int64)


@pytest.mark.parametrize("k,n,tail", [(21, 5000, 0), (21, 3000, 37),
                                      (31, 4000, 5), (32, 6000, 0),
                                      (32, 2000, 64), (3, 40, 3),
                                      (4, 200, 0)])
def test_starts_match_jax(k, n, tail):
    """At the size rule's bits (2k at k = 3 and 4) and at two others,
    on a table with and without a SENTINEL tail."""
    from kreeq_tpu_torch.ops.index import bucket_bits, bucket_index

    rng = np.random.default_rng(k * 1000 + n)
    keys = _u64_keys(rng, n, k)
    nrows = keys.shape[0]
    u64 = np.concatenate([keys, np.full(tail, U64_SENTINEL)])
    rule = bucket_bits(u64.shape[0], k)
    if k <= 4:
        assert rule == 2 * k
    for bits in sorted({rule, min(rule + 2, 2 * k), max(rule - 3, 1)}):
        starts, shift = bucket_index(_port_keys(u64), k, bits)
        assert shift == 2 * k - bits
        assert starts.dtype == torch.int64
        assert np.array_equal(starts.numpy(),
                              _jax_starts(u64, nrows, k, bits))


def test_bucket_bits_rule():
    """The JAX package's min(max(8, ceil(log2 t) + 1), ., 2k), capped at
    MAX_BITS so that the int64 directory stays inside L2."""
    from kreeq_tpu_torch.ops.index import MAX_BITS, bucket_bits

    assert bucket_bits(0, 21) == 8
    assert bucket_bits(1000, 21) == 11
    assert bucket_bits(1 << 16, 21) == 17
    assert bucket_bits(24_756_385, 21) == MAX_BITS
    assert bucket_bits(24_756_385, 5) == 10
    assert 8 * ((1 << MAX_BITS) + 1) < 50e6  # the H100's L2


def _check_invariant(tkeys, qkeys, k, bits=None):
    """starts[b(q)] <= searchsorted(tkeys, q) <= starts[b(q) + 1] for
    every non-SENTINEL query q; a key that the table holds lies in
    [starts[b], starts[b + 1]).  Returns the directory."""
    from kreeq_tpu_torch.ops.index import bucket_index, bucket_of

    starts, shift = bucket_index(tkeys, k, bits)
    nb = starts.shape[0] - 1
    assert bool((starts[1:] >= starts[:-1]).all())
    qkeys = qkeys[qkeys != SENTINEL]
    b = bucket_of(qkeys, shift)
    assert bool(((b >= 0) & (b < nb)).all())
    # the kernels' form: (uint64)(key ^ INT64_MIN) >> shift
    u = keys_to_u64(qkeys.numpy())
    assert np.array_equal(b.numpy(), (u >> np.uint64(shift)).astype(
        np.int64))
    row = torch.searchsorted(tkeys, qkeys)
    lo, hi = starts[b], starts[b + 1]
    assert bool(((lo <= row) & (row <= hi)).all())
    if tkeys.shape[0]:
        at = row.clamp(max=tkeys.shape[0] - 1)
        held = tkeys[at] == qkeys
        assert bool((row[held] < hi[held]).all())
    return starts, shift


@pytest.mark.parametrize("k", [21, 32])
def test_invariant_random_keys(k):
    """Random tables, queries half held and half not, a SENTINEL tail
    and SENTINEL queries; at k = 32 keys of both signs."""
    rng = np.random.default_rng(k)
    keys = _u64_keys(rng, 20_000, k)
    u64 = np.concatenate([keys, np.full(11, U64_SENTINEL)])
    tkeys = _port_keys(u64)
    queries = np.concatenate([keys[::2], _u64_keys(rng, 10_000, k),
                              np.full(3, U64_SENTINEL)])
    qkeys = _port_keys(queries)
    if k == 32:
        assert bool((tkeys < 0).any()) and bool(
            (tkeys[tkeys != SENTINEL] >= 0).any())
    for bits in (8, 15, 21):
        starts, _shift = _check_invariant(tkeys, qkeys, k, bits)
        assert int(starts[-1]) == keys.shape[0]


def test_invariant_poly_a_pile():
    """One bucket holds most rows (a poly-A pile: the keys just above
    AA..A), as in a low-complexity region."""
    from kreeq_tpu_torch.ops.index import bucket_index

    k = 21
    rng = np.random.default_rng(5)
    pile = np.arange(1, 100_001, dtype=np.uint64)
    keys = np.unique(np.concatenate([pile, _u64_keys(rng, 3000, k)]))
    tkeys = _port_keys(keys)
    queries = _port_keys(np.concatenate([pile[::7], pile[::13] + 200_000,
                                         keys[::5]]))
    starts, _shift = _check_invariant(tkeys, queries, k)
    sizes = starts[1:] - starts[:-1]
    assert int(sizes.max()) >= 100_000
    assert np.array_equal(starts.numpy(),
                          bucket_index(tkeys, k)[0].numpy())


@pytest.mark.parametrize("k", [21, 32])
def test_invariant_bucket_boundaries(k):
    """Queries on every bucket's first key and the key before it, with
    table keys there too, at the first and the last buckets."""
    rng = np.random.default_rng(k + 7)
    bits = 10
    shift = 2 * k - bits
    firsts = np.arange(1 << bits, dtype=np.uint64) << np.uint64(shift)
    last = (np.uint64(1) << np.uint64(shift)) - np.uint64(1)
    before = firsts[1:] - np.uint64(1)
    edge = np.concatenate([firsts, before, firsts[-1:] + last])
    if k == 32:
        edge = edge[edge != U64_SENTINEL]
    keys = np.unique(np.concatenate([firsts[::2], before[1::2],
                                     _u64_keys(rng, 5000, k)]))
    tkeys = _port_keys(np.concatenate([keys, np.full(2, U64_SENTINEL)]))
    _check_invariant(tkeys, _port_keys(edge), k, bits)


def test_invariant_empty_and_all_sentinel_tables():
    from kreeq_tpu_torch.ops.index import bucket_index

    rng = np.random.default_rng(9)
    for k in (21, 32):
        queries = _port_keys(_u64_keys(rng, 500, k))
        for t in (0, 17):
            tkeys = torch.full((t,), SENTINEL, dtype=torch.int64)
            starts, _shift = _check_invariant(tkeys, queries, k)
            assert not bool(starts.any())
            assert starts.shape[0] == (1 << 8) + 1
        assert bucket_index(torch.zeros(0, dtype=torch.int64), k, 3)[1] \
            == 2 * k - 3


def _small_table(rng, k, t, held=None):
    """A random CPU table of about t keys, the u64 keys `held` among
    them."""
    from kreeq_tpu_torch.core.table import KmerTable

    keys = _u64_keys(rng, t, k)
    if held is not None:
        keys = np.unique(np.concatenate([keys, held]))
    t = keys.shape[0]
    return KmerTable.from_numpy(
        k, keys, rng.integers(0, 4, t).astype(np.uint32),
        rng.integers(0, 3, (t, 4)).astype(np.uint32),
        rng.integers(0, 3, (t, 4)).astype(np.uint32), "cpu")


def test_table_caches_its_bucket_index():
    """KmerTable builds the bucket directory once and keeps it."""
    from kreeq_tpu_torch.ops.index import bucket_index

    k = 21
    table = _small_table(np.random.default_rng(2), k, 1000)
    first = table.bucket_index()
    assert table.bucket_index() is first
    starts, shift = bucket_index(table.keys, k)
    assert first[1] == shift and torch.equal(first[0], starts)


@pytest.mark.parametrize("need_tracks", [False, True])
def test_cpu_validate_builds_no_directory(monkeypatch, need_tracks):
    """On the CPU the plain probes need no directory, so validation
    builds none; its sums equal the plain probe's over the segment."""
    from kreeq_tpu_torch.config import UserInput
    from kreeq_tpu_torch.core.dbg import DBG
    from kreeq_tpu_torch.core.table import KmerTable
    from kreeq_tpu_torch.io.sequence import Genome, Segment
    from kreeq_tpu_torch.ops.kmers import kmer_positions
    from kreeq_tpu_torch.ops.validate import validate_qv_sums

    k, n = 21, 500
    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list("ACGT"), n))
    seg = Segment(1, "s", seq)
    pkeys, _isfw, _edges, _valid = kmer_positions(
        torch.from_numpy(seg.codes), k)
    table = _small_table(rng, k, 2000, keys_to_u64(pkeys[::3].numpy()))

    def refuse(self):
        raise AssertionError("the CPU path built a bucket directory")

    monkeypatch.setattr(KmerTable, "bucket_index", refuse)
    genome = Genome()
    genome.segments.append(seg)
    ui = UserInput(kmer_len=k)
    ui.in_sequence = "asm.fa"
    dbg = DBG(ui, table)
    dbg.load_genome(genome)
    dbg.validate_sequences(out=io.StringIO(), need_tracks=need_tracks)
    kcount = n - k + 1
    buf = torch.from_numpy(dbg._window_buf(seg.codes, 0, kcount, kcount))
    want = validate_qv_sums(table.keys, table.cov, table.fw, table.bw, buf,
                            k, 0, 1, 1 + kcount)
    assert dbg.tot_kcount == kcount
    assert (dbg.tot_missing, dbg.tot_edge_missing) == tuple(want.tolist())
    assert 0 < dbg.tot_missing < kcount


def _jax_probe(table_u64, qkeys):
    """The JAX package's probe_sorted of port queries against a table in
    its dtypes: (found, cov, fw, bw) as numpy."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import probe_sorted

    got = probe_sorted(*(jnp.asarray(a) for a in table_u64),
                       jnp.asarray(keys_to_u64(qkeys.numpy())))
    return tuple(np.asarray(a) for a in got)


def _generic_queries(rng, k, n=3000):
    """What the generic probe is sent: the variants scan's keys of an
    assembly with N and IUPAC runs (valid keys and per-position
    sentinels), the subgraph rounds' canonical neighbours of its keys,
    SENTINEL and random int64.  Returns (queries, per-position sentinel
    mask, the assembly's valid keys)."""
    from kreeq_tpu_torch.core.variants import _extract_sentinel
    from kreeq_tpu_torch.ops.frontier import neighbors8

    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.integers(0, n, 30)] = 4
    codes[n // 2:n // 2 + 50] = 4
    keys, _isfw, valid = _extract_sentinel(torch.from_numpy(codes), k)
    nbrs = neighbors8(keys[valid][::5], k).reshape(-1)
    extra = torch.cat([nbrs, torch.full((4,), SENTINEL),
                       torch.from_numpy(rng.integers(
                           -(1 << 63), SENTINEL, 500, dtype=np.int64))])
    sentinel = torch.cat([~valid, torch.zeros(extra.shape[0], dtype=bool)])
    return torch.cat([keys, extra]), sentinel, keys[valid]


@pytest.mark.parametrize("k", [21, 31, 32])
def test_generic_probe_queries_lie_in_their_bucket(k):
    """The invariant the generic probe's bucket search relies on, for
    every kind of query its callers send: a query lies past the
    directory (bucket_of >= nb, so it is not searched) or, where the
    table holds it (the JAX package's probe_sorted finds it), its row
    lies in [starts[b], starts[b + 1]).  So the search of one bucket
    finds exactly what the JAX probe finds.  At k < 32 the per-position
    sentinels lie past the directory; at k = 32 they lie inside it and
    are never found."""
    from kreeq_tpu_torch.ops.index import bucket_bits, bucket_index, bucket_of

    rng = np.random.default_rng(40 + k)
    qkeys, sentinel, valid_keys = _generic_queries(rng, k)
    held = keys_to_u64(valid_keys[::2].numpy())
    table = _small_table(rng, k, 4000, held)
    t = len(table)
    tkeys = torch.cat([table.keys, torch.full((7,), SENTINEL)])
    want = _jax_probe((keys_to_u64(tkeys.numpy()),
                       *(np.concatenate([a, np.zeros((7,) + a.shape[1:],
                                                     a.dtype)])
                         for a in table.to_numpy()[1:])), qkeys)[0]
    assert 0 < want.sum() < want.shape[0]
    for bits in sorted({bucket_bits(tkeys.shape[0], k), 8, 16}):
        starts, shift = bucket_index(tkeys, k, bits)
        nb = starts.shape[0] - 1
        b = bucket_of(qkeys, shift)
        past = (b >= nb).numpy()
        searched = ~past & (qkeys != SENTINEL).numpy()
        row = torch.searchsorted(tkeys, qkeys)
        bb = b.clamp(0, nb - 1)
        lo, hi = starts[bb], starts[bb + 1]
        inside = ((lo <= row) & (row < hi)).numpy()
        at = tkeys[row.clamp(max=t - 1)] == qkeys
        assert np.array_equal(searched & inside & at.numpy(), want)
        if k < 32:
            assert past[sentinel.numpy()].all()
        else:
            assert not past[sentinel.numpy()].any()
            assert not want[sentinel.numpy()].any()


def _probe_queries(rng, table, k):
    """Port queries of a table: held keys, their neighbours in the key
    order, per-position sentinels, SENTINEL, random int64."""
    qkeys, _sentinel, _valid = _generic_queries(rng, k, 600)
    return torch.cat([table.keys[::3], table.keys[1::7] + 1, qkeys])


@pytest.mark.parametrize("k", [21, 32])
def test_cpu_table_probe_builds_no_directory(monkeypatch, k):
    """On the CPU, KmerTable.probe_device and probe run the plain probe
    and build no directory; both equal the JAX package's probe_sorted
    exactly."""
    from kreeq_tpu_torch.core.table import KmerTable

    rng = np.random.default_rng(50 + k)
    table = _small_table(rng, k, 3000)
    qkeys = _probe_queries(rng, table, k)
    want = _jax_probe(table.to_numpy(), qkeys)
    assert 0 < want[0].sum() < want[0].shape[0]

    def refuse(self):
        raise AssertionError("the CPU path built a bucket directory")

    monkeypatch.setattr(KmerTable, "bucket_index", refuse)
    got = table.probe_device(qkeys)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w.astype(g.numpy().dtype))
    for g, w in zip(table.probe(qkeys), want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert table._bucket is None


@pytest.mark.parametrize("k", [21, 32])
def test_probe_sorted_wrapper_on_cpu_takes_the_plain_version(k):
    """probe_sorted_cuda on CPU tensors, given the table's directory, is
    the plain version, equal to the JAX package's probe_sorted."""
    from kreeq_tpu_torch.ops import kmers as K
    from kreeq_tpu_torch.ops.index import bucket_index
    from kreeq_tpu_torch.ops.kernels import LAUNCHES, probe_sorted_cuda

    rng = np.random.default_rng(60 + k)
    table = _small_table(rng, k, 3000)
    qkeys = _probe_queries(rng, table, k)
    tab = (table.keys, table.cov, table.fw, table.bw)
    before = LAUNCHES["probe_sorted"]
    got = probe_sorted_cuda(*tab, qkeys, bucket_index(table.keys, k))
    assert LAUNCHES["probe_sorted"] == before
    want = _jax_probe(table.to_numpy(), qkeys)
    for g, p, w in zip(got, K.probe_sorted(*tab, qkeys), want):
        assert torch.equal(g, p)
        assert np.array_equal(g.numpy(), w.astype(g.numpy().dtype))
