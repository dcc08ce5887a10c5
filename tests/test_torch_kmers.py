"""PyTorch port, k-mer extraction and counting: exact agreement with the
JAX package on the same numpy inputs (all values are integers, so every
comparison is exact)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _codes(seed, n, badp, nbases=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, nbases, n).astype(np.uint8)
    codes[rng.random(n) < badp] = 4
    return codes


def _port_u64(keys):
    from kreeq_tpu_torch.constants import keys_to_u64

    return keys_to_u64(keys.numpy())


@pytest.mark.parametrize("k", [21, 31, 32])
def test_kmer_positions_match_jax(k):
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import kmer_positions as jax_positions
    from kreeq_tpu_torch.ops.kmers import kmer_positions

    codes = _codes(k, 3000, 0.02)
    ref = jax_positions(jnp.asarray(codes), k)
    got = kmer_positions(torch.from_numpy(codes), k)
    assert np.array_equal(np.asarray(ref[0]), _port_u64(got[0]))
    for name, x, y in zip(("isfw", "edges", "valid"), ref[1:], got[1:]):
        assert np.array_equal(np.asarray(x), y.numpy()), name


@pytest.mark.parametrize("k,nbases", [(21, 4), (31, 4), (32, 4), (32, 2)])
def test_count_sorted_matches_jax(k, nbases):
    """count_sorted with BAD bases; nbases=2 gives low-entropy input with
    long runs of equal keys."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import count_sorted as jax_count
    from kreeq_tpu.ops.kmers import kmer_positions as jax_positions
    from kreeq_tpu_torch.ops.kernels import count_sorted_cuda
    from kreeq_tpu_torch.ops.kmers import kmer_positions

    codes = _codes(100 + k, 3000, 0.02, nbases)
    ref = jax_count(*(jax_positions(jnp.asarray(codes), k)[i]
                      for i in (0, 2, 3)))
    keys, _isfw, edges, valid = kmer_positions(torch.from_numpy(codes), k)
    got = count_sorted_cuda(keys, edges, valid)
    assert int(ref[4]) == int(got[4])
    assert np.array_equal(np.asarray(ref[0]), _port_u64(got[0]))
    for name, x, y in zip(("cov", "fw", "bw"), ref[1:4], got[1:4]):
        assert np.array_equal(np.asarray(x).astype(np.int64), y.numpy()), name


@pytest.mark.parametrize("run", [2500, 3 * 1024])
def test_count_sorted_long_run_matches_jax(run):
    """A run longer than two of the count kernel's 1024-record tiles,
    between shorter ones, with invalid records; same records to both."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import count_sorted as jax_count
    from kreeq_tpu_torch.constants import keys_from_u64
    from kreeq_tpu_torch.ops.kernels import count_sorted_cuda

    rng = np.random.default_rng(run)
    keys = np.concatenate([rng.integers(0, 1 << 42, 700, dtype=np.uint64),
                           np.full(run, 1 << 41, np.uint64),
                           rng.integers(0, 40, 900).astype(np.uint64)])
    keys = keys[rng.permutation(keys.shape[0])]
    edges = rng.integers(0, 256, keys.shape[0]).astype(np.uint8)
    valid = rng.random(keys.shape[0]) > 0.05
    ref = jax_count(jnp.asarray(keys), jnp.asarray(edges), jnp.asarray(valid))
    got = count_sorted_cuda(torch.from_numpy(keys_from_u64(keys)),
                            torch.from_numpy(edges), torch.from_numpy(valid))
    assert int(ref[4]) == int(got[4])
    assert int(got[1].max()) > 2 * 1024
    assert np.array_equal(np.asarray(ref[0]), _port_u64(got[0]))
    for name, x, y in zip(("cov", "fw", "bw"), ref[1:4], got[1:4]):
        assert np.array_equal(np.asarray(x).astype(np.int64), y.numpy()), name


def test_count_sorted_matches_pallas_interpret(monkeypatch):
    """One tiny case against the Pallas count kernel in interpret mode."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import kmer_positions as jax_positions
    from kreeq_tpu.ops.pallas_kernels import count_sorted_pallas
    from kreeq_tpu_torch.ops.kmers import count_sorted, kmer_positions

    monkeypatch.setenv("KREEQ_TPU_PALLAS_INTERPRET", "1")
    k = 21
    codes = _codes(5, 1200, 0.05, 3)
    ref = count_sorted_pallas(*(jax_positions(jnp.asarray(codes), k)[i]
                                for i in (0, 2, 3)))
    keys, _isfw, edges, valid = kmer_positions(torch.from_numpy(codes), k)
    got = count_sorted(keys, edges, valid)
    n = int(ref[4])
    assert n == int(got[4])
    assert np.array_equal(np.asarray(ref[0])[:n], _port_u64(got[0])[:n])
    for x, y in zip(ref[1:4], got[1:4]):
        assert np.array_equal(np.asarray(x)[:n].astype(np.int64),
                              y[:n].numpy())


def test_count_sorted_all_invalid():
    """A chunk of BAD codes only: n = 0 and an all-SENTINEL table."""
    from kreeq_tpu_torch.constants import SENTINEL
    from kreeq_tpu_torch.ops.kmers import count_sorted, kmer_positions

    codes = torch.full((64,), 4, dtype=torch.uint8)
    keys, _isfw, edges, valid = kmer_positions(codes, 21)
    ukeys, cov, fw, bw, n = count_sorted(keys, edges, valid)
    assert int(n) == 0
    assert bool((ukeys == SENTINEL).all())
    assert int(cov.sum() + fw.sum() + bw.sum()) == 0


def test_pack_reads_matches_jax():
    from kreeq_tpu.ops.kmers import pack_reads as jax_pack
    from kreeq_tpu_torch.ops.kmers import pack_reads

    rng = np.random.default_rng(2)
    reads = ["".join(rng.choice(list("ACGTN"), int(m)))
             for m in rng.integers(1, 90, 40)] + ["A" * 300]
    ref = list(jax_pack(reads, 21, 256))
    got = list(pack_reads(reads, 21, 256))
    assert len(ref) == len(got)
    for x, y in zip(ref, got):
        assert np.array_equal(x, y)
