"""PyTorch port, CUDA kernels against their plain versions on the card,
on edge cases: empty input, all-SENTINEL input, one key repeated 10^6
times, runs of every length up to three count tiles at every offset
across a tile seam, equal merge pairs on every merge tile seam, A == B,
1 row against 10^6, saturation, k = 32, SENTINEL queries and the
per-position sentinels of the variants scan; for the three probes
every bits of the bucket directory's size rule, k = 4, a bucket of
10^5 rows, queries on every bucket's first key and the key before it,
counters of 2^31 and above, and a call without the directory (and for
the generic probe misaligned rows); and
the subgraph searches' neighbour scan (plain torch ops) on the card
against the CPU; B4 and B5 on the uploaded windows of a
host-resident table, each with its own directory; the sharded path's
owners and routing on the card against the CPU, a 1-rank NCCL
build against the plain build, the flagship step
(entry.entry) on the card against its run on the CPU, and the bench's
four stages (kreeq_tpu_torch/bench.py) at bench.py's shapes; the
extraction (kmer_extract) in each of its four forms on the CPU
tests' cases (tests/test_torch_extract.py), at every k from 1 to 32, with
P on and around its tile seams, codes that start off a 16-byte
boundary, and P = 8,388,578; the sort (sort_records) at P = 0, 1, a
tile and one either side, and 8,388,608, at every k from 1 to 32, on
all-SENTINEL records, one key 8,388,608 times (its payload must stay in
input order), keys that differ only in their top digit and keys of
both signs at k = 32; and the count step of one chunk
(count_chunk_cuda) against the CPU path.  Needs a
CUDA device (the `gpu` marker); run on the card with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m gpu

(--noconftest: tests/conftest.py configures JAX, which the port does not
need.)
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


def _count_both(skeys, sedges):
    from kreeq_tpu_torch.ops import kmers as K
    from kreeq_tpu_torch.ops.kernels import count_runs_cuda

    _same(count_runs_cuda(skeys, sedges), K.count_runs(skeys, sedges))


def test_count_empty_and_all_sentinel(cuda):
    from kreeq_tpu_torch.constants import SENTINEL

    for p in (0, 1, 1000):
        _count_both(torch.full((p,), SENTINEL, dtype=torch.int64,
                               device=cuda),
                    torch.zeros(p, dtype=torch.uint8, device=cuda))


def test_count_one_key_repeated(cuda):
    """10^6 records of one key span thousands of blocks."""
    rng = np.random.default_rng(0)
    p = 1_000_000
    keys = torch.full((p + 5,), 42, dtype=torch.int64, device=cuda)
    keys[:3] = torch.tensor([-7, 0, 1], device=cuda)
    keys, _ = torch.sort(keys)
    edges = torch.from_numpy(rng.integers(0, 256, p + 5).astype(
        np.uint8)).to(cuda)
    _count_both(keys, edges)


def _runs(lengths, rng, device, tail=0):
    """Sorted records: one run of each length in `lengths` (a new key
    each), then `tail` SENTINEL records; random edge bytes."""
    from kreeq_tpu_torch.constants import SENTINEL

    lengths = np.asarray(lengths, np.int64)
    keys = np.repeat(np.arange(lengths.shape[0], dtype=np.int64) * 3 - 5,
                     lengths)
    keys = np.concatenate([keys, np.full(tail, SENTINEL, np.int64)])
    edges = rng.integers(0, 256, keys.shape[0]).astype(np.uint8)
    return torch.from_numpy(keys).to(device), torch.from_numpy(edges).to(
        device)


def _count_tile():
    from kreeq_tpu_torch.ops._build import library

    return library().kq_count_tile()


def test_count_every_run_length(cuda):
    """One run of every length from 1 to 3 tiles, back to back."""
    rng = np.random.default_rng(3)
    tile = _count_tile()
    _count_both(*_runs(np.arange(1, 3 * tile + 1), rng, cuda, tail=77))


@pytest.mark.parametrize("length", [1, 2, 3, 31, 32, 33, 255, 256, 257,
                                    1023, 1024, 1025, 2047, 2048, 2049,
                                    3071, 3072])
def test_count_run_at_every_seam_offset(cuda, length):
    """A run of `length` records, then single records to a period of
    1 mod the tile, `tile` times over: the run starts at every offset
    from a tile seam once, so it crosses a seam at every place."""
    rng = np.random.default_rng(length)
    tile = _count_tile()
    period = length + 1
    period += (1 - period) % tile
    one = [length] + [1] * (period - length)
    _count_both(*_runs(one * tile, rng, cuda))


def test_count_run_ends_on_tile_boundary(cuda):
    rng = np.random.default_rng(4)
    tile = _count_tile()
    # runs that end exactly at the first, second and third seams, the
    # last followed by the SENTINEL tail or by the input's end
    for tail in (0, 5):
        _count_both(*_runs([tile - 3, 3, 2 * tile - 1, 1], rng, cuda,
                           tail=tail))
        _count_both(*_runs([tile, tile, tile], rng, cuda, tail=tail))


@pytest.mark.parametrize("p", [1, 17, 1023, 1025, 5 * 1024 + 17])
def test_count_ragged_input(cuda, p):
    """P not a multiple of the tile; random runs, some SENTINELs."""
    rng = np.random.default_rng(p)
    lengths = rng.integers(1, 40, p)
    lengths = lengths[np.cumsum(lengths) <= p - p // 10]
    _count_both(*_runs(lengths, rng, cuda, tail=p - int(lengths.sum())))


@pytest.mark.parametrize("k,nbases", [(21, 4), (32, 4), (32, 2)])
def test_count_sorted_random_chunks(cuda, k, nbases):
    """A chunk's count step on the card (count_chunk_cuda: the three
    kernels) against count_sorted's plain version on the card."""
    from kreeq_tpu_torch.ops import kmers as K
    from kreeq_tpu_torch.ops.kernels import count_chunk_cuda

    rng = np.random.default_rng(k)
    codes = rng.integers(0, nbases, 300_000).astype(np.uint8)
    codes[rng.random(codes.shape[0]) < 0.01] = 4
    codes = torch.from_numpy(codes).to(cuda)
    keys, _isfw, edges, valid = K.kmer_positions(codes, k)
    _same(count_chunk_cuda(codes, k), K.count_sorted(keys, edges, valid))


def _table(rng, n, device, shared=(), top=None):
    """A sorted unique table of about n random keys plus `shared`, with
    a SENTINEL tail; counters random, or `top` in cov and fw."""
    from kreeq_tpu_torch.constants import SENTINEL

    keys = np.unique(np.concatenate([
        rng.integers(-(1 << 63), SENTINEL, n, dtype=np.int64),
        np.asarray(shared, np.int64)]))
    t = keys.shape[0]
    cov = rng.integers(0, 1 << 32, t, dtype=np.int64)
    fw = rng.integers(0, 1 << 32, (t, 4), dtype=np.int64)
    bw = rng.integers(0, 1 << 32, (t, 4), dtype=np.int64)
    if top is not None:
        cov[:] = top
        fw[:] = top
    pad = 100
    keys = np.concatenate([keys, np.full(pad, SENTINEL, np.int64)])
    cov = np.concatenate([cov, np.zeros(pad, np.int64)])
    fw = np.concatenate([fw, np.zeros((pad, 4), np.int64)])
    bw = np.concatenate([bw, np.zeros((pad, 4), np.int64)])
    return tuple(torch.from_numpy(a).to(device) for a in (keys, cov, fw, bw))


def _merge_both(a, b):
    from kreeq_tpu_torch.ops import kmers as K
    from kreeq_tpu_torch.ops.kernels import merge_sorted_cuda

    _same(merge_sorted_cuda(*a, *b), K.merge_sorted(*a, *b))


def test_merge_random_saturating_and_tailed(cuda):
    rng = np.random.default_rng(1)
    a = _table(rng, 200_000, cuda, top=0xFFFFFFF0)
    # b shares every second key of a; the shared rows saturate
    b = _table(rng, 150_000, cuda, shared=a[0][:-100:2].cpu().numpy(),
               top=0xFFFFFFF0)
    _merge_both(a, b)
    _merge_both(b, a)


def test_merge_empty_and_all_sentinel(cuda):
    from kreeq_tpu_torch.constants import SENTINEL

    rng = np.random.default_rng(2)
    a = _table(rng, 1000, cuda)

    def sentinel_table(n):
        return (torch.full((n,), SENTINEL, dtype=torch.int64, device=cuda),
                torch.zeros(n, dtype=torch.int64, device=cuda),
                torch.zeros((n, 4), dtype=torch.int64, device=cuda),
                torch.zeros((n, 4), dtype=torch.int64, device=cuda))

    for other in (sentinel_table(0), sentinel_table(777)):
        _merge_both(a, other)
        _merge_both(other, a)
    _merge_both(sentinel_table(0), sentinel_table(0))
    _merge_both(sentinel_table(5), sentinel_table(3))


def _merge_tile():
    from kreeq_tpu_torch.ops._build import library

    return library().kq_merge_tile()


def _with_counters(rng, keys_a, keys_b, device, top=None, pad=0):
    """Tables of the given sorted unique keys, random counters (or `top`
    in every counter), `pad` SENTINEL rows after each."""
    from kreeq_tpu_torch.constants import SENTINEL

    out = []
    for keys in (keys_a, keys_b):
        keys = np.asarray(keys, np.int64)
        t = keys.shape[0]
        if top is None:
            cov = rng.integers(0, 1 << 32, t, dtype=np.int64)
            fw = rng.integers(0, 1 << 32, (t, 4), dtype=np.int64)
            bw = rng.integers(0, 1 << 32, (t, 4), dtype=np.int64)
        else:
            cov = np.full(t, top, np.int64)
            fw = np.full((t, 4), top, np.int64)
            bw = np.full((t, 4), top, np.int64)
        keys = np.concatenate([keys, np.full(pad, SENTINEL, np.int64)])
        cov = np.concatenate([cov, np.zeros(pad, np.int64)])
        fw = np.concatenate([fw, np.zeros((pad, 4), np.int64)])
        bw = np.concatenate([bw, np.zeros((pad, 4), np.int64)])
        out.append(tuple(torch.from_numpy(x).to(device)
                         for x in (keys, cov, fw, bw)))
    return out


@pytest.mark.parametrize("top", [None, 0xFFFFFFF0])
def test_merge_a_equals_b(cuda, top):
    """Every row is an equal pair, saturating or not."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(-(1 << 63), 1 << 62, 300_001,
                                  dtype=np.int64))
    a, b = _with_counters(rng, keys, keys, cuda, top=top, pad=11)
    _merge_both(a, b)
    _merge_both(a, a)


def test_merge_equal_pair_on_every_tile_seam(cuda):
    """Keys placed so that the merged row before every seam of the
    kernel's tiles is an A row whose equal B row comes right after the
    seam, between random single and paired rows."""
    rng = np.random.default_rng(6)
    tile = _merge_tile()
    ka, kb = [], []
    pos, key, seams = 0, -(1 << 62), 0
    while pos < 40 * tile + 7:
        key += int(rng.integers(1, 1000))
        at = pos % tile
        pair = at == tile - 1 or (at != tile - 2 and rng.random() < 0.3)
        seams += at == tile - 1
        if pair:
            ka.append(key)
            kb.append(key)
            pos += 2
        elif rng.random() < 0.5:
            ka.append(key)
            pos += 1
        else:
            kb.append(key)
            pos += 1
    assert seams == 40
    for top, pad in ((None, 0), (0xFFFFFFF0, 3)):
        a, b = _with_counters(rng, ka, kb, cuda, top=top, pad=pad)
        _merge_both(a, b)


@pytest.mark.parametrize("inside", [True, False])
def test_merge_one_row_against_a_million(cuda, inside):
    """na = 1 against nb = 10^6 and the reverse; the single key equal to
    one of the others, or not."""
    rng = np.random.default_rng(7)
    many = np.unique(rng.integers(-(1 << 63), 1 << 62, 1_000_000,
                                  dtype=np.int64))
    one = many[len(many) // 2] + (0 if inside else 1)
    assert (one in many) == inside
    a, b = _with_counters(rng, [one], many, cuda)
    _merge_both(a, b)
    _merge_both(b, a)


@pytest.mark.parametrize("na,nb", [(5 * 2048 + 17, 3 * 2048 + 1),
                                   (2047, 1), (2048, 2048), (1, 0),
                                   (0, 12345)])
def test_merge_ragged_sizes_both_tailed(cuda, na, nb):
    """na + nb not a multiple of the tile, both inputs SENTINEL-tailed
    (and untailed); half of B's keys shared with A."""
    rng = np.random.default_rng(na + 3 * nb)
    ka = np.unique(rng.integers(-(1 << 63), 1 << 62, na, dtype=np.int64))
    kb = np.unique(np.concatenate([
        ka[::2][:nb // 2],
        rng.integers(-(1 << 63), 1 << 62, nb - nb // 2, dtype=np.int64)]))
    for pad in (0, 9):
        a, b = _with_counters(rng, ka, kb, cuda, pad=pad)
        _merge_both(a, b)
        _merge_both(b, a)


def _rule_bits(k):
    """Every bits that the directory's size rule gives, over table sizes
    from 1 row to 2^23."""
    from kreeq_tpu_torch.ops.index import bucket_bits

    return sorted({bucket_bits(1 << j, k) for j in range(24)})


def _skewed_table(rng, k, device, pile=100_000):
    """A table of k-mer keys whose first bucket holds a poly-A pile of
    `pile` rows (the keys just above AA..A), every first key of the
    2^12 buckets at 12 bits and the key before every other one, random
    keys (of both signs at k = 32), a SENTINEL tail; counters small, so
    that zero edges and cov under the cutoff occur, and in some rows at
    2^31 and above.  Returns the table and the u64 keys."""
    from kreeq_tpu_torch.constants import keys_from_u64

    hi = np.iinfo(np.uint64).max if k == 32 else 1 << (2 * k)
    shift = np.uint64(2 * k - 12)
    firsts = np.arange(1 << 12, dtype=np.uint64) << shift
    u64 = np.unique(np.concatenate([
        np.arange(1, pile + 1, dtype=np.uint64), firsts[::2],
        firsts[1::2] - np.uint64(1),
        rng.integers(0, hi, 50_000, dtype=np.uint64)]))
    t = u64.shape[0]
    pad = 9
    keys = np.concatenate([keys_from_u64(u64), np.full(pad, np.iinfo(
        np.int64).max)])
    cov = np.concatenate([rng.integers(0, 4, t), np.zeros(pad, np.int64)])
    fw = np.concatenate([rng.integers(0, 3, (t, 4)),
                         np.zeros((pad, 4), np.int64)])
    bw = np.concatenate([rng.integers(0, 3, (t, 4)),
                         np.zeros((pad, 4), np.int64)])
    cov[:t:5] = rng.integers(1 << 31, 1 << 32, cov[:t:5].shape[0])
    fw[1:t:7] = (1 << 32) - 1
    bw[2:t:9] = 1 << 31
    return tuple(torch.from_numpy(a).to(device)
                 for a in (keys, cov, fw, bw)), u64


def _skewed_queries(rng, k, u64, shift, device):
    """Queries of the pile (held, and just past it), every bucket's first
    key and the key before it at the directory's `shift`, table keys,
    random keys and SENTINELs; random ctx selectors 0-8 on each side."""
    from kreeq_tpu_torch.constants import SENTINEL, keys_from_u64

    hi = np.iinfo(np.uint64).max if k == 32 else 1 << (2 * k)
    nb = (hi >> shift) + 1 if k == 32 else hi >> shift
    firsts = np.arange(nb, dtype=np.uint64) << np.uint64(shift)
    q = np.concatenate([u64[:100_000:3], u64[:50] + np.uint64(100_000),
                        firsts, firsts[1:] - np.uint64(1), u64[::7],
                        rng.integers(0, hi, 20_000, dtype=np.uint64)])
    qkeys = np.concatenate([keys_from_u64(q), np.full(5, SENTINEL)])
    qkeys = qkeys[rng.permutation(qkeys.shape[0])]
    ctx = (rng.integers(0, 9, qkeys.shape[0])
           | (rng.integers(0, 9, qkeys.shape[0]) << 4)).astype(np.uint8)
    return (torch.from_numpy(qkeys).to(device),
            torch.from_numpy(ctx).to(device))


def _qv_both(tab, qkeys, qctx, cutoff, index):
    from kreeq_tpu_torch.ops import validate as V
    from kreeq_tpu_torch.ops.kernels import probe_qv_cuda

    q = qkeys.shape[0]
    for lead, hi in ((0, q), (1, q - 1), (5, q + 10), (q, q + 3)):
        got = probe_qv_cuda(*tab, qkeys, qctx, lead, hi, cutoff, index)
        want = V.qv_sums(*tab, qkeys, qctx, lead, hi, cutoff)
        _same((got,), (want,))


@pytest.mark.parametrize("k,cutoff", [(21, 0), (32, 3), (4, 1)])
def test_probe_qv_matches_plain(cuda, k, cutoff):
    """On a genome's table (SENTINEL-tailed) at every bits of the size
    rule; on a table with a poly-A bucket of 10^5 rows, queried on each
    bucket's first key and the key before it; an empty table; and a
    CUDA call without the directory, which raises."""
    from kreeq_tpu_torch.constants import SENTINEL
    from kreeq_tpu_torch.ops import kmers as K
    from kreeq_tpu_torch.ops import validate as V
    from kreeq_tpu_torch.ops.index import bucket_index
    from kreeq_tpu_torch.ops.kernels import probe_qv_cuda

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 200_000).astype(np.uint8)
    reads = np.concatenate([genome] * 3 + [genome[:50_000]])
    keys, _isfw, edges, valid = K.kmer_positions(
        torch.from_numpy(reads).to(cuda), k)
    tab = K.count_sorted(keys, edges, valid)[:4]  # SENTINEL-tailed
    asm = genome.copy()
    asm[rng.integers(0, asm.shape[0], 400)] ^= 1
    asm[rng.integers(0, asm.shape[0], 50)] = 4
    qkeys, qctx = V._extract_ctx_qv(torch.from_numpy(asm).to(cuda), k)
    assert bool((qkeys == SENTINEL).any())  # SENTINEL queries present
    for bits in [None] + _rule_bits(k):
        _qv_both(tab, qkeys, qctx, cutoff, bucket_index(tab[0], k, bits))
    q = qkeys.shape[0]
    with pytest.raises(ValueError, match="bucket directory"):
        probe_qv_cuda(*tab, qkeys, qctx, 0, q, cutoff)
    empty = tuple(t[:0] for t in tab)
    _same((probe_qv_cuda(*empty, qkeys, qctx, 0, q, cutoff,
                         bucket_index(empty[0], k)),),
          (V.qv_sums(*empty, qkeys, qctx, 0, q, cutoff),))
    if k < 21:
        return
    stab, u64 = _skewed_table(rng, k, cuda)
    for bits in (None, 8, 21):
        index = bucket_index(stab[0], k, bits)
        sizes = index[0][1:] - index[0][:-1]
        assert int(sizes.max()) >= 100_000
        sq, sctx = _skewed_queries(rng, k, u64, index[1], cuda)
        _qv_both(stab, sq, sctx, cutoff, index)


def _select_both(tab, qkeys, qctx, index):
    from kreeq_tpu_torch.ops import validate as V
    from kreeq_tpu_torch.ops.kernels import probe_select_cuda

    got = probe_select_cuda(*tab, qkeys, qctx, index)
    want = V.probe_select(*tab, qkeys, qctx)
    assert bool(want[0].any()) and bool(want[2].any())
    _same(got, want)


@pytest.mark.parametrize("k", [21, 32, 4])
def test_probe_select_matches_plain(cuda, k):
    """The cases of test_probe_qv_matches_plain, for the track probe;
    also no query."""
    from kreeq_tpu_torch.constants import SENTINEL
    from kreeq_tpu_torch.ops import kmers as K
    from kreeq_tpu_torch.ops import validate as V
    from kreeq_tpu_torch.ops.index import bucket_index
    from kreeq_tpu_torch.ops.kernels import probe_select_cuda

    rng = np.random.default_rng(k + 1)
    genome = rng.integers(0, 4, 200_000).astype(np.uint8)
    reads = np.concatenate([genome] * 3 + [genome[:50_000]])
    keys, _isfw, edges, valid = K.kmer_positions(
        torch.from_numpy(reads).to(cuda), k)
    tab = K.count_sorted(keys, edges, valid)[:4]  # SENTINEL-tailed
    asm = genome.copy()
    asm[rng.integers(0, asm.shape[0], 400)] ^= 1
    asm[rng.integers(0, asm.shape[0], 50)] = 4
    qkeys, _isfw, _valid, qctx = V._extract_ctx(
        torch.from_numpy(asm).to(cuda), k)
    assert bool((qkeys == SENTINEL).any())  # SENTINEL queries present
    # some 0 selectors too (no neighbour on that side)
    qctx[:100] &= 0xF0
    qctx[100:200] &= 0x0F
    for bits in [None] + _rule_bits(k):
        _select_both(tab, qkeys, qctx, bucket_index(tab[0], k, bits))
    with pytest.raises(ValueError, match="bucket directory"):
        probe_select_cuda(*tab, qkeys, qctx)
    index = bucket_index(tab[0], k)
    empty = tuple(t[:0] for t in tab)
    _same(probe_select_cuda(*empty, qkeys, qctx, bucket_index(empty[0], k)),
          V.probe_select(*empty, qkeys, qctx))
    _same(probe_select_cuda(*tab, qkeys[:0], qctx[:0], index),
          V.probe_select(*tab, qkeys[:0], qctx[:0]))
    if k < 21:
        return
    stab, u64 = _skewed_table(rng, k, cuda)
    for bits in (None, 8, 21):
        index = bucket_index(stab[0], k, bits)
        sq, sctx = _skewed_queries(rng, k, u64, index[1], cuda)
        _select_both(stab, sq, sctx, index)


def _sorted_both(tab, qkeys, index):
    """probe_sorted_cuda against the plain version; returns the plain
    result."""
    from kreeq_tpu_torch.ops import kmers as K
    from kreeq_tpu_torch.ops.kernels import probe_sorted_cuda

    want = K.probe_sorted(*tab, qkeys)
    _same(probe_sorted_cuda(*tab, qkeys, index), want)
    return want


@pytest.mark.parametrize("k", [21, 32, 4])
def test_probe_sorted_matches_plain(cuda, k):
    """The generic probe on the variants scan's queries (their per-position sentinels lie past the directory at k <
    32; at k = 32 they are searched and never found), SENTINEL queries
    and random keys, at every bits of the directory's size rule; a
    table of random keys and counters up to 2^32 - 1; on a table with a
    poly-A bucket of 10^5 rows, queried on each bucket's first key and
    the key before it; an empty table with its own directory; no query;
    and a CUDA call without the directory, which raises."""
    from kreeq_tpu_torch.constants import SENTINEL
    from kreeq_tpu_torch.core.variants import _extract_sentinel
    from kreeq_tpu_torch.ops import kmers as K
    from kreeq_tpu_torch.ops.index import bucket_index
    from kreeq_tpu_torch.ops.kernels import probe_sorted_cuda

    rng = np.random.default_rng(k + 2)
    genome = rng.integers(0, 4, 200_000).astype(np.uint8)
    reads = np.concatenate([genome] * 3 + [genome[:50_000]])
    keys, _isfw, edges, valid = K.kmer_positions(
        torch.from_numpy(reads).to(cuda), k)
    tab = K.count_sorted(keys, edges, valid)[:4]  # SENTINEL-tailed
    asm = genome.copy()
    asm[rng.integers(0, asm.shape[0], 400)] ^= 1
    asm[rng.integers(0, asm.shape[0], 50)] = 4
    skeys, _sisfw, svalid = _extract_sentinel(torch.from_numpy(asm).to(cuda),
                                              k)
    assert not bool(svalid.all())
    qkeys = torch.cat([skeys, torch.full((7,), SENTINEL, device=cuda),
                       torch.from_numpy(rng.integers(
                           -(1 << 63), SENTINEL, 1000,
                           dtype=np.int64)).to(cuda)])
    for bits in [None] + _rule_bits(k):
        want = _sorted_both(tab, qkeys, bucket_index(tab[0], k, bits))
        assert bool(want[0].any()) and bool(want[2].any())
        assert not bool(want[0][:skeys.shape[0]][~svalid].any())
    index = bucket_index(tab[0], k)
    for q in (qkeys, qkeys[:0]):
        with pytest.raises(ValueError, match="bucket directory"):
            probe_sorted_cuda(*tab, q)
    empty = tuple(t[:0] for t in tab)
    _sorted_both(empty, qkeys, bucket_index(empty[0], k))
    _same(probe_sorted_cuda(*tab, qkeys[:0], index),
          K.probe_sorted(*tab, qkeys[:0]))
    if k < 21:
        return
    rtab = _table(rng, 300_000, cuda)
    rq = torch.cat([rtab[0][::3], rtab[0][1::7] + 1])
    _sorted_both(rtab, rq, bucket_index(rtab[0], 32))
    stab, u64 = _skewed_table(rng, k, cuda)
    for bits in (None, 8, 21):
        index = bucket_index(stab[0], k, bits)
        assert int((index[0][1:] - index[0][:-1]).max()) >= 100_000
        sq, _sctx = _skewed_queries(rng, k, u64, index[1], cuda)
        want = _sorted_both(stab, sq, index)
        assert bool(want[0].any()) and bool(want[3].any())


def test_probe_sorted_refuses_misaligned_rows(cuda):
    """A table's fw and bw rows are read as 16-byte halves: a view that
    starts 8 bytes into its storage raises."""
    from kreeq_tpu_torch.ops.index import bucket_index
    from kreeq_tpu_torch.ops.kernels import probe_sorted_cuda

    tab = (torch.arange(3, dtype=torch.int64, device=cuda),
           torch.ones(3, dtype=torch.int64, device=cuda),
           torch.ones((3, 4), dtype=torch.int64, device=cuda),
           torch.ones((3, 4), dtype=torch.int64, device=cuda))
    qkeys = torch.arange(5, dtype=torch.int64, device=cuda)
    index = bucket_index(tab[0], 21)
    odd = torch.zeros(13, dtype=torch.int64, device=cuda)[1:].view(3, 4)
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="tfw must be 16-byte aligned"):
        probe_sorted_cuda(tab[0], tab[1], odd, tab[3], qkeys, index)
    with pytest.raises(ValueError, match="tbw must be 16-byte aligned"):
        probe_sorted_cuda(tab[0], tab[1], tab[2], odd, qkeys, index)


def test_empty_probes_count_no_launch(cuda):
    """A probe with no position to search launches no kernel, so its
    launch count stays where it was."""
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops.index import bucket_index

    tab = (torch.zeros(3, dtype=torch.int64, device=cuda),
           torch.ones(3, dtype=torch.int64, device=cuda),
           torch.zeros((3, 4), dtype=torch.int64, device=cuda),
           torch.zeros((3, 4), dtype=torch.int64, device=cuda))
    qkeys = torch.zeros(0, dtype=torch.int64, device=cuda)
    qctx = torch.zeros(0, dtype=torch.uint8, device=cuda)
    index = bucket_index(tab[0], 21)
    kernels.reset_launches()
    found, cov, right, left = kernels.probe_select_cuda(*tab, qkeys, qctx,
                                                        index)
    assert [t.shape[0] for t in (found, cov, right, left)] == [0] * 4
    sums = kernels.probe_qv_cuda(*tab, qkeys, qctx, 0, 5, 0, index)
    assert sums.tolist() == [0, 0]
    found, cov, fw, bw = kernels.probe_sorted_cuda(*tab, qkeys, index)
    assert [tuple(t.shape) for t in (found, cov, fw, bw)] == [
        (0,), (0,), (0, 4), (0, 4)]
    assert kernels.LAUNCHES["probe_select"] == 0
    assert kernels.LAUNCHES["probe_qv"] == 0
    assert kernels.LAUNCHES["probe_sorted"] == 0


@pytest.mark.parametrize("k", [21, 32])
def test_window_probes_match_plain(cuda, monkeypatch, k):
    """B4 and B5 on each uploaded window of a host-resident table, with
    that window's own directory, exact against the plain versions on
    the window's rows: on queries of every window, on queries that all
    lie below or above the window's key range, and with counters of
    2^31 and above; then the windowed probe_device on the card against
    the plain probe of the whole table, and windows that tile it."""
    from kreeq_tpu_torch.constants import keys_from_u64
    from kreeq_tpu_torch.core.table import KmerTable
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops import kmers as K
    from kreeq_tpu_torch.ops import validate as V

    rng = np.random.default_rng(k + 40)
    n = 300_000
    u64 = np.unique(rng.integers(0, 1 << (2 * k - 1), n, dtype=np.uint64)
                    * np.uint64(2))
    n = u64.shape[0]
    keys = keys_from_u64(u64)
    cov = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    fw, bw = (rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64)
              .astype(np.uint32) for _ in range(2))
    monkeypatch.setenv("KREEQ_TPU_MAX_TABLE_ROWS", str(n // 3 + 1))
    table = KmerTable.host_form(k, keys, cov, fw, bw, cuda)
    ranges = table.window_ranges()
    assert len(ranges) == 3 and ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    full = tuple(torch.from_numpy(x.astype(np.int64)) for x in
                 (keys, cov, fw, bw))
    per_window = [torch.from_numpy(np.concatenate([
        keys[lo:hi][rng.integers(0, hi - lo, 20_000)],
        keys[lo:hi][rng.integers(0, hi - lo, 5_000)] + 1])).to(cuda)
        for lo, hi in ranges]
    qall = torch.cat(per_window)
    ctx = torch.from_numpy(rng.integers(0, 9, (qall.shape[0], 2))
                           .astype(np.uint8)).to(cuda)
    qctx = ctx[:, 0] | (ctx[:, 1] << 4)
    for w, (lo, hi) in enumerate(ranges):
        tab = table.device_arrays(w)
        index = table.bucket_index(w)
        plain = tuple(x[lo:hi].to(cuda) for x in full)
        _same(tab, plain)
        others = [q for v, q in enumerate(per_window) if v != w]
        for q, c in ((qall, qctx), (others[0], qctx[:others[0].shape[0]]),
                     (others[1], qctx[:others[1].shape[0]])):
            want = K.probe_sorted(*plain, q)
            _same(kernels.probe_sorted_cuda(*tab, q, index), want)
            _same(kernels.probe_select_cuda(*tab, q, c, index),
                  V.probe_select(*plain, q, c))
            if q is not qall:  # a window above or below every query
                assert not bool(want[0].any())
    kernels.reset_launches()
    got = table.probe_device(qall)
    assert kernels.LAUNCHES["probe_sorted"] == len(ranges)
    want = K.probe_sorted(*full, qall.cpu())
    _same(got, want)
    assert int(want[0].sum()) == 60_000


@pytest.mark.parametrize("k", [21, 31, 32])
def test_frontier_scan_cuda_equals_cpu(cuda, k):
    """neighbors8 and survivors (plain torch ops, run on the card by
    the subgraph searches) give the CPU's values and scan order."""
    from kreeq_tpu_torch.ops.frontier import neighbors8, survivors
    from kreeq_tpu_torch.ops.kmers import kmer_positions

    rng = np.random.default_rng(k)
    codes = torch.from_numpy(rng.integers(0, 4, 200_000).astype(np.uint8))
    keys = torch.unique(kmer_positions(codes, k)[0])
    keys = keys[torch.from_numpy(rng.permutation(keys.shape[0]))]
    fw = torch.from_numpy(rng.integers(0, 3, (keys.shape[0], 4)))
    bw = torch.from_numpy(rng.integers(0, 3, (keys.shape[0], 4)))
    members = torch.sort(keys[::2]).values
    _same((neighbors8(keys.to(cuda), k),), (neighbors8(keys, k),))
    for cutoff, dedup in ((0, True), (1, False)):
        got = survivors(keys.to(cuda), fw.to(cuda), bw.to(cuda),
                        members.to(cuda), k, cutoff, dedup)
        want = survivors(keys, fw, bw, members, k, cutoff, dedup)
        assert want[0].shape[0] > 1000
        _same(got, want)
    empty = members[:0]
    _same(survivors(keys.to(cuda), fw.to(cuda), bw.to(cuda), empty.to(cuda),
                    k, 0, True), survivors(keys, fw, bw, empty, k, 0, True))


def test_trace_dir_records_card_kernels(cuda, tmp_path):
    """--trace-dir on the card: the chrome trace holds the card's
    kernels (the probe_qv kernel among them) beside the host's ops."""
    import contextlib
    import io
    import json

    from kreeq_tpu_torch.cli.main import run

    rng = np.random.default_rng(1)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    reads = tmp_path / "reads.fq"
    reads.write_text("".join(f"@r{i}\n{genome[s:s + 100]}\n+\n{'I' * 100}\n"
                             for i, s in enumerate(range(0, 2900, 10))))
    asm = tmp_path / "asm.fa"
    asm.write_text(f">a\n{genome}\n")
    trace = tmp_path / "trace"
    with contextlib.redirect_stdout(io.StringIO()):
        assert run(["kreeq", "validate", "-r", str(reads), "-f", str(asm),
                    "--trace-dir", str(trace)]) == 0
    with open(trace / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("probe_qv" in name for name in kernels), sorted(kernels)
    assert any(e.get("name", "").startswith("aten::") for e in events)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture
def one_rank(cuda, request):
    """A 1-rank process group of the backend `request.param` on the
    card, destroyed after the test."""
    import torch.distributed as dist

    backend = request.param
    kwargs = ({"device_id": torch.device("cuda", torch.cuda.current_device())}
              if backend == "nccl" else {})
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            **kwargs)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("one_rank", ["gloo"], indirect=True)
@pytest.mark.parametrize("k", [21, 32])
def test_owner_and_route_cuda_equal_cpu(cuda, one_rank, k):
    """owner_of and the owner split on the card give the CPU's owners,
    order and sizes for 2, 3 and 8 owners (k = 32: keys with the top
    bit set); route through a 1-rank group on the card gives the CPU's
    records, and its Route.back puts answers back in record order."""
    from kreeq_tpu_torch.ops.kmers import kmer_positions
    from kreeq_tpu_torch.parallel.sharded import owner_of, route, split

    rng = np.random.default_rng(k + 7)
    codes = torch.from_numpy(rng.integers(0, 4, 300_000).astype(np.uint8))
    keys, _isfw, edges, _valid = kmer_positions(codes, k)
    if k == 32:
        assert bool((keys >= 0).any())  # biased: the u64 top bit set
    for n in (2, 3, 8):
        want = owner_of(keys, n)
        assert int(want.min()) == 0 and int(want.max()) == n - 1
        assert torch.equal(owner_of(keys.to(cuda), n).cpu(), want)
        for g, w in zip(split(keys.to(cuda), n), split(keys, n)):
            assert torch.equal(g.cpu(), w)
    got = route(keys.to(cuda), (edges.to(cuda),), one_rank)
    want = route(keys, (edges,), one_rank)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1][0].cpu(), want[1][0])
    assert torch.equal(got[2].back(got[0]).cpu(), keys)


@pytest.mark.parametrize("one_rank", ["nccl"], indirect=True)
def test_nccl_one_rank_build_equals_from_reads(cuda, one_rank, tmp_path):
    """build_table_distributed in a 1-rank NCCL group (every collective
    NCCL's, on the card) equals from_reads on one card."""
    from kreeq_tpu_torch.core.table import KmerTable
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.parallel.multihost import build_table_distributed

    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), 20_000))
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(f">r{i}\n{genome[s:s + 150]}\n" for i, s in
                             enumerate(rng.integers(0, 19_850, 2_000))))
    kernels.reset_launches()
    got = build_table_distributed([str(reads)], 21, cuda, chunk=1 << 14,
                                  group=one_rank)
    assert kernels.LAUNCHES["count"] > 10 and kernels.LAUNCHES["merge"] > 0
    want = KmerTable.from_reads([str(reads)], 21, cuda, chunk=1 << 14)
    assert len(want) > 10_000
    for g, w in zip(got.to_numpy(), want.to_numpy()):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("one_rank", ["nccl", "gloo"], indirect=True)
def test_one_rank_build_above_cap_gathers_on_host(cuda, one_rank, tmp_path,
                                                  monkeypatch):
    """With a row cap of 4000, build_table_distributed gathers the table
    into host memory (NCCL: through card buffers of 1000 rows, many
    steps), keeps it in the host form, and equals from_reads on one
    card without the cap."""
    from kreeq_tpu_torch.core.table import KmerTable
    from kreeq_tpu_torch.parallel import sharded
    from kreeq_tpu_torch.parallel.multihost import build_table_distributed

    rng = np.random.default_rng(6)
    genome = "".join(rng.choice(list("ACGT"), 20_000))
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(f">r{i}\n{genome[s:s + 150]}\n" for i, s in
                             enumerate(rng.integers(0, 19_850, 2_000))))
    want = KmerTable.from_reads([str(reads)], 21, cuda, chunk=1 << 14)
    monkeypatch.setenv("KREEQ_TPU_MAX_TABLE_ROWS", "4000")
    monkeypatch.setattr(sharded, "_HOST_GATHER_STEP", 1000)
    sharded.stats_report(cuda)
    got = build_table_distributed([str(reads)], 21, cuda, chunk=1 << 14,
                                  group=one_rank)
    gather = sharded.stats_report(cuda)["gather"]
    assert (gather["calls"], gather["host_calls"]) == (1, 1)
    assert got.on_host and len(want) > 10_000
    for g, w in zip(got.to_numpy(), want.to_numpy()):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_entry_step_cuda_equals_cpu(cuda, monkeypatch):
    """entry()'s step on the card (B1, then B4 through the table's
    directory) gives the four numbers of the same step on the CPU's
    plain versions, and launches each kernel once."""
    from kreeq_tpu_torch.entry import entry
    from kreeq_tpu_torch.ops import kernels

    monkeypatch.delenv("KREEQ_TPU_PLATFORM", raising=False)
    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    kernels.reset_launches()
    got = [int(x) for x in fn(*args)]
    assert kernels.LAUNCHES["count"] == 1
    assert kernels.LAUNCHES["probe_select"] == 1
    assert got == [int(x) for x in fn(*(a.cpu() for a in args))]
    assert got[0] > 0 and got[1] == args[1].shape[0] - 21 + 1


def test_bench_stages_exact_at_bench_shapes(cuda):
    """The bench's four stages at bench.py's shapes (an 8M-base chunk,
    k = 31, its 4M-base prefix as the window, the counted table's two
    halves): each stage holds its kernel exactly against the plain
    version (it raises otherwise), the window's #missing is 0, and B1-B4
    each launched."""
    from kreeq_tpu_torch import bench
    from kreeq_tpu_torch.ops import kernels

    kernels.reset_launches()
    b = bench.Bench(cuda, 0, reps=2)
    for stage in (b.count, b.qv, b.track, b.merge):
        stage()
    stages = b.extra["stages"]
    assert all(stages[s]["exact"] for s in ("count", "probe_qv",
                                            "probe_track", "merge"))
    assert stages["count"]["records"] == bench.CHUNK - bench.K + 1
    assert stages["probe_qv"]["queries"] == bench.PCHUNK - bench.K + 1
    assert stages["probe_qv"]["missing"] == 0
    assert stages["index"]["bits"] == 22
    for key in ("count", "merge", "probe_qv", "probe_select"):
        assert kernels.LAUNCHES[key] > 0


# ---------------------------------------------------------------------------
# the extraction (kmer_extract)


def _extract_both(codes, k):
    """Each form of the kernel exactly against its plain version, both
    on the card; one launch a form."""
    from kreeq_tpu_torch.ops import kernels

    for form in kernels.EXTRACT_FORMS:
        before = kernels.LAUNCHES["extract"]
        got = kernels.extract_cuda(codes, k, form)
        assert kernels.LAUNCHES["extract"] == before + 1
        _same(got, kernels.plain_extract(form)(codes, k))


@pytest.mark.parametrize("k", [1, 3, 11, 21, 31, 32])
def test_extract_cpu_cases(cuda, k):
    """The CPU tests' cases: BAD runs, BAD at both ends, N = k and
    k + 1, all BAD, the last window valid at the buffer's end."""
    from tests.test_torch_extract import CASES, _codes

    for case in CASES:
        _extract_both(torch.from_numpy(_codes(case, k)).to(cuda), k)


@pytest.mark.parametrize("k", range(1, 33))
def test_extract_every_k(cuda, k):
    rng = np.random.default_rng(1000 + k)
    codes = rng.integers(0, 4, 5003).astype(np.uint8)
    codes[rng.random(codes.shape[0]) < 0.01] = 4
    _extract_both(torch.from_numpy(codes).to(cuda), k)


def _extract_tile():
    from kreeq_tpu_torch.ops._build import library

    return library().kq_extract_tile()


@pytest.mark.parametrize("k", [1, 21, 32])
def test_extract_tile_seams_and_alignment(cuda, k):
    """P on and around one, two and three tile seams, the codes starting
    at every offset from a 16-byte boundary (a slice of a larger
    buffer), BAD codes on each side of each seam."""
    tile = _extract_tile()
    rng = np.random.default_rng(k)
    big = rng.integers(0, 4, 3 * tile + 64 + 40).astype(np.uint8)
    for seam in (tile, 2 * tile, 3 * tile):
        big[seam - 1:seam + 1] = 4
    big = torch.from_numpy(big).to(cuda)
    for p in (1, 2, tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile,
              2 * tile + 1, 3 * tile):
        for off in (0, 1, 7, 15):
            codes = big[off:off + p + k - 1]
            assert codes.shape[0] - k + 1 == p
            _extract_both(codes, k)


def test_extract_at_the_chunk_size(cuda):
    """P = 8,388,578: one 8M-base read chunk at k = 31, as the bench
    counts it, with BAD runs."""
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 1 << 23).astype(np.uint8)
    for start in rng.integers(0, 1 << 23, 300):
        codes[start:start + rng.integers(1, 200)] = 4
    codes = torch.from_numpy(codes).to(cuda)
    assert codes.shape[0] - 31 + 1 == 8_388_578
    _extract_both(codes, 31)


def test_extract_no_window_launches_nothing(cuda):
    from kreeq_tpu_torch.ops import kernels

    before = kernels.LAUNCHES["extract"]
    for form in kernels.EXTRACT_FORMS:
        out = kernels.extract_cuda(torch.zeros(20, dtype=torch.uint8,
                                               device=cuda), 21, form)
        assert all(x.shape == (0,) and x.is_cuda for x in out)
    assert kernels.LAUNCHES["extract"] == before


# ---------------------------------------------------------------------------
# the sort (sort_records) and the count step of a chunk (count_chunk_cuda)


def _sort_both(keys, edges, k):
    """The sort kernel exactly against its plain version (a stable
    torch.sort and the edge gather), both on the card; one launch, none
    without a record."""
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops import kmers as K

    before = kernels.LAUNCHES["sort"]
    got = kernels.sort_records_cuda(keys, edges, k)
    assert kernels.LAUNCHES["sort"] == before + (keys.shape[0] > 0)
    _same(got, K.sort_keys_edges(keys, edges))
    return got


def _canonical(rng, p, k, cuda, sentinels=0.05):
    """p random canonical k-mer keys (the lesser of a random packed k-mer
    and its reverse complement), biased, a share of them SENTINEL, and p
    random edge bytes, on the card."""
    from kreeq_tpu_torch.constants import SENTINEL, keys_from_u64

    u = rng.integers(0, np.iinfo(np.uint64).max, p, dtype=np.uint64,
                     endpoint=True)
    if k < 32:
        u &= np.uint64((1 << (2 * k)) - 1)
    rc = np.zeros_like(u)
    for i in range(k):
        base = (u >> np.uint64(2 * i)) & np.uint64(3)
        rc |= (np.uint64(3) - base) << np.uint64(2 * (k - 1 - i))
    keys = torch.from_numpy(keys_from_u64(np.minimum(u, rc)))
    keys[torch.from_numpy(rng.random(p) < sentinels)] = SENTINEL
    edges = torch.from_numpy(rng.integers(0, 256, p).astype(np.uint8))
    return keys.to(cuda), edges.to(cuda)


def _sort_tile():
    from kreeq_tpu_torch.ops._build import library

    return library().kq_sort_tile()


def test_sort_sizes(cuda):
    """P = 0, 1, a tile and one either side, three tiles and one, and
    8,388,608, at k = 21 and 31, SENTINELs mixed in."""
    tile = _sort_tile()
    rng = np.random.default_rng(160)
    for k in (21, 31):
        for p in (0, 1, 2, tile - 1, tile, tile + 1, 3 * tile + 1,
                  1 << 23):
            _sort_both(*_canonical(rng, p, k, cuda), k)


@pytest.mark.parametrize("k", range(1, 33))
def test_sort_every_k(cuda, k):
    """Every pass count: a chunk's records as the count form gives them
    (BAD runs give SENTINELs; small k gives long runs of equal keys),
    then random canonical keys."""
    from kreeq_tpu_torch.ops import kernels

    rng = np.random.default_rng(2000 + k)
    codes = rng.integers(0, 4, 200_003).astype(np.uint8)
    for start in rng.integers(0, codes.shape[0], 40):
        codes[start:start + rng.integers(1, 60)] = 4
    recs = kernels.extract_cuda(torch.from_numpy(codes).to(cuda), k, "count")
    _sort_both(*recs, k)
    _sort_both(*_canonical(rng, 100_000, k, cuda), k)


def test_sort_all_sentinel(cuda):
    from kreeq_tpu_torch.constants import SENTINEL

    for p in (1, 5000, 300_000):
        keys = torch.full((p,), SENTINEL, dtype=torch.int64, device=cuda)
        edges = torch.arange(p, device=cuda).to(torch.uint8)
        for k in (1, 21, 32):
            got = _sort_both(keys, edges, k)
            assert torch.equal(got[1], edges)


def test_sort_one_key_repeated(cuda):
    """8,388,608 records of one key: every tile's and every pass's digit
    is the same, and stability keeps the payload in input order."""
    from kreeq_tpu_torch.constants import KEY_BIAS

    p = 1 << 23
    keys = torch.full((p,), KEY_BIAS + 0x2B5A3C1D, dtype=torch.int64,
                      device=cuda)
    edges = (torch.arange(p, device=cuda) * 7 % 251).to(torch.uint8)
    for k in (21, 31):
        got = _sort_both(keys, edges, k)
        assert torch.equal(got[1], edges)


@pytest.mark.parametrize("k", [4, 21, 31, 32])
def test_sort_top_digit_only(cuda, k):
    """Keys equal in every digit but the top one (below 4^k and never
    all ones, as a canonical key), in random order, with SENTINELs: only
    the last pass orders them."""
    from kreeq_tpu_torch.constants import SENTINEL, keys_from_u64

    rng = np.random.default_rng(k)
    passes = -(-2 * k // 8)
    shift = 8 * (passes - 1)
    values = 1 << (2 * k - shift)  # the top digit's values below 4^k
    p = 3 * _sort_tile() + 77
    low = np.uint64(0x5A5A5A5A5A5A5A5A & ((1 << shift) - 1))
    u = (rng.integers(0, values - 1, p).astype(np.uint64)
         << np.uint64(shift)) | low
    keys = torch.from_numpy(keys_from_u64(u))
    keys[torch.from_numpy(rng.random(p) < 0.1)] = SENTINEL
    edges = torch.from_numpy(rng.integers(0, 256, p).astype(np.uint8))
    _sort_both(keys.to(cuda), edges.to(cuda), k)


def test_sort_sign_flip_at_k32(cuda):
    """k = 32: unbiased keys over all 64 bits, so biased keys of both
    signs (the top digit holds the bias bit), and SENTINELs."""
    rng = np.random.default_rng(32)
    keys, edges = _canonical(rng, 1 << 20, 32, cuda)
    assert bool((keys < 0).any()) and bool((keys > 0).any())
    _sort_both(keys, edges, 32)


def test_sort_refuses_bad_inputs(cuda):
    from kreeq_tpu_torch.ops import kernels

    keys = torch.zeros(10, dtype=torch.int64, device=cuda)
    edges = torch.zeros(10, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        kernels.sort_records_cuda(keys.to(torch.int32), edges, 21)
    with pytest.raises(ValueError):
        kernels.sort_records_cuda(keys, edges[:9], 21)
    with pytest.raises(ValueError):
        kernels.sort_records_cuda(keys, edges, 33)


@pytest.mark.parametrize("k", [21, 31])
def test_count_chunk_equals_cpu(cuda, k):
    """count_chunk_cuda on the card (extraction, sort and B1, one launch
    each) equals the CPU path on one chunk of 2^22 codes with BAD
    runs."""
    from kreeq_tpu_torch.ops import kernels

    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 1 << 22).astype(np.uint8)
    for start in rng.integers(0, codes.shape[0], 200):
        codes[start:start + rng.integers(1, 200)] = 4
    before = dict(kernels.LAUNCHES)
    got = kernels.count_chunk_cuda(torch.from_numpy(codes).to(cuda), k)
    for key in ("extract", "sort", "count"):
        assert kernels.LAUNCHES[key] == before[key] + 1
    _same(got, kernels.count_chunk_cuda(torch.from_numpy(codes), k))
    empty = kernels.count_chunk_cuda(torch.zeros(k - 1, dtype=torch.uint8,
                                                 device=cuda), k)
    assert all(x.is_cuda for x in empty) and int(empty[4]) == 0
    assert kernels.LAUNCHES["count"] == before["count"] + 1
