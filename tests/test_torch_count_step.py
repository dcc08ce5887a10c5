"""PyTorch port, the count step of one chunk (ops/kernels.count_chunk_cuda:
the extraction's count form, the sort, count_runs) and its parts' plain
versions against the JAX package on the same numpy inputs:
  count form - ops/kmers.count_records vs the JAX kmer_positions with
               the masking of the JAX count_sorted (SENTINEL keys and 0
               edges where invalid);
  sort       - ops/kmers.sort_keys_edges (stable) vs the JAX
               _sort_keys_edges: the same keys, and the same edge bytes
               under each key (JAX orders ties by their edge bits);
  count step - count_chunk_cuda on CPU tensors vs the JAX
               count_sorted(*kmer_positions(codes, k)).
Inputs come from numpy.random.default_rng(seed) with BAD codes mixed in;
every value is an integer, so every comparison is exact.  On CPU tensors
the wrappers run the plain versions and count no launch; the kernels are
held against them on the card (tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

KS = [1, 2, 11, 21, 31, 32]
U64_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _codes(k: int, n: int = 3000, nbases: int = 4) -> np.ndarray:
    """n codes from a numpy seed: bases 0..nbases-1, runs of BAD codes
    and scattered non-ACGT bytes (5, 9, 255)."""
    rng = np.random.default_rng(1600 + k * 7 + nbases)
    codes = rng.integers(0, nbases, n).astype(np.uint8)
    for start in rng.integers(0, n, 10):
        codes[start:start + rng.integers(1, 30)] = 4
    one = rng.random(n) < 0.01
    codes[one] = rng.choice(np.array([5, 9, 255], np.uint8), one.sum())
    return codes


def _jax_records(codes: np.ndarray, k: int):
    """The JAX count_sorted's records before its sort: kmer_positions'
    keys and edge bits with SENTINEL and 0 where the window is invalid,
    as numpy (u64 keys)."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import kmer_positions

    keys, _isfw, edges, valid = (np.asarray(x) for x in kmer_positions(
        jnp.asarray(codes), k))
    return np.where(valid, keys, U64_SENTINEL), np.where(valid, edges, 0)


def _u64(keys: torch.Tensor) -> np.ndarray:
    from kreeq_tpu_torch.constants import keys_to_u64

    return keys_to_u64(keys.numpy())


@pytest.mark.parametrize("k", KS)
def test_count_records_match_jax(k):
    """The count form's plain version, and the wrapper's count form on a
    CPU tensor, equal the JAX masking at every position, with no
    launch."""
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops.kmers import count_records

    codes = _codes(k)
    want_keys, want_edges = _jax_records(codes, k)
    assert (want_keys == U64_SENTINEL).any() and \
        (want_keys != U64_SENTINEL).any()
    before = dict(kernels.LAUNCHES)
    t = torch.from_numpy(codes)
    for keys, edges in (count_records(t, k),
                        kernels.extract_cuda(t, k, "count")):
        assert keys.dtype == torch.int64 and edges.dtype == torch.uint8
        assert np.array_equal(_u64(keys), want_keys)
        assert np.array_equal(edges.numpy(), want_edges.astype(np.uint8))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("k", KS)
def test_stable_sort_matches_jax_sort(k):
    """The stable plain sort (and the wrapper on CPU tensors) against the
    JAX _sort_keys_edges on the same records: equal keys, and under each
    key the same edge bytes (JAX breaks ties by the edge bits, the port
    keeps input order); the port's ties are in input order."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import _sort_keys_edges
    from kreeq_tpu_torch.constants import keys_from_u64
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops.kmers import sort_keys_edges

    keys, edges = _jax_records(_codes(k, nbases=2), k)
    jk, je = (np.asarray(x) for x in _sort_keys_edges(
        jnp.asarray(keys), jnp.asarray(edges.astype(np.uint64))))
    tk = torch.from_numpy(keys_from_u64(keys))
    te = torch.from_numpy(edges.astype(np.uint8))
    for gk, ge in (sort_keys_edges(tk, te),
                   kernels.sort_records_cuda(tk, te, k)):
        assert np.array_equal(_u64(gk), jk)
        ge = ge.numpy().astype(np.uint64)
        jorder = np.lexsort((je, jk))
        gorder = np.lexsort((ge, jk))
        assert np.array_equal(ge[gorder], je[jorder])
        # stable: each key's edges in the order the records came
        order = np.argsort(keys, kind="stable")
        assert np.array_equal(ge, edges[order].astype(np.uint64))


@pytest.mark.parametrize("k,nbases", [(1, 4), (2, 4), (11, 4), (21, 4),
                                      (31, 4), (32, 4), (32, 2)])
def test_count_chunk_matches_jax(k, nbases):
    """count_chunk_cuda on CPU tensors against the JAX count_sorted of the
    JAX kmer_positions: keys, cov, fw, bw and n; no launch."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import count_sorted, kmer_positions
    from kreeq_tpu_torch.ops import kernels

    codes = _codes(k, nbases=nbases)
    keys, _isfw, edges, valid = kmer_positions(jnp.asarray(codes), k)
    want = [np.asarray(x) for x in count_sorted(keys, edges, valid)]
    before = dict(kernels.LAUNCHES)
    got = kernels.count_chunk_cuda(torch.from_numpy(codes), k)
    assert kernels.LAUNCHES == before
    assert int(got[4]) == int(want[4]) > 0
    assert np.array_equal(_u64(got[0]), want[0])
    for g, w in zip(got[1:4], want[1:4]):
        assert g.dtype == torch.int64 and g.shape == w.shape
        assert np.array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("n", [0, 5, 20, 21, 22])
def test_short_chunks(n):
    """N < k gives empty rows and n = 0 with no launch; N = k and k + 1
    give one and two records, as count_sorted does."""
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops import kmers as K

    codes = torch.full((n,), 2, dtype=torch.uint8)
    before = dict(kernels.LAUNCHES)
    keys, cov, fw, bw, cnt = kernels.count_chunk_cuda(codes, 21)
    assert kernels.LAUNCHES == before
    p = max(n - 20, 0)
    assert keys.shape == cov.shape == (p,)
    assert fw.shape == bw.shape == (p, 4)
    assert cnt.dtype == torch.int64 and cnt.shape == ()
    if p == 0:
        assert int(cnt) == 0
    else:
        want = K.count_sorted(*(K.kmer_positions(codes, 21)[i]
                                for i in (0, 2, 3)))
        for g, w in zip((keys, cov, fw, bw, cnt), want):
            assert torch.equal(g, w)
    skeys, sedges = kernels.sort_records_cuda(
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.uint8),
        21)
    assert skeys.shape == sedges.shape == (0,)


def test_wrappers_refuse_other_devices_and_k():
    from kreeq_tpu_torch.ops import kernels

    codes = torch.zeros(40, dtype=torch.uint8)
    keys = torch.zeros(40, dtype=torch.int64)
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.count_chunk_cuda(codes.to("meta"), 21)
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.sort_records_cuda(keys.to("meta"), codes.to("meta"), 21)
    with pytest.raises(ValueError, match="several devices"):
        kernels.sort_records_cuda(keys, codes.to("meta"), 21)
    for k in (0, 33):
        with pytest.raises(ValueError, match="outside 1..32"):
            kernels.sort_records_cuda(keys, codes, k)


@pytest.mark.parametrize("ckpt", [False, True])
def test_builds_count_through_count_chunk(monkeypatch, tmp_path, ckpt):
    """KmerTable.from_reads, and the checkpointed build it hands over to
    under KREEQ_TPU_BUILD_CKPT, count every chunk through
    count_chunk_cuda (the kernels on the card), and the table equals the
    JAX count of the same reads."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import count_sorted, kmer_positions
    from kreeq_tpu_torch.core.table import KmerTable
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops import kmers as K

    calls = []
    wrapped = kernels.count_chunk_cuda

    def counting(codes, k):
        calls.append((codes.shape[0], k))
        return wrapped(codes, k)

    monkeypatch.setattr(kernels, "count_chunk_cuda", counting)
    if ckpt:
        monkeypatch.setenv("KREEQ_TPU_BUILD_CKPT", str(tmp_path / "ckpt"))
    rng = np.random.default_rng(16)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 2000))
    seqs = [genome[s:s + 120] for s in rng.integers(0, 1880, 150)]
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    chunk = 1 << 12
    table = KmerTable.from_reads([str(reads)], 21, "cpu", chunk=chunk)
    bufs = list(K.pack_reads(seqs, 21, chunk))
    assert len(bufs) > 1
    assert calls == [(b.shape[0], 21) for b in bufs]
    # the JAX count of all the reads in one buffer
    codes = np.concatenate(bufs)
    keys, _isfw, edges, valid = kmer_positions(jnp.asarray(codes), 21)
    want = [np.asarray(x) for x in count_sorted(keys, edges, valid)]
    n = int(want[4])
    assert len(table) == n
    assert np.array_equal(_u64(table.keys[:n].cpu()), want[0][:n])
    assert np.array_equal(table.cov[:n].cpu().numpy(),
                          want[1][:n].astype(np.int64))
