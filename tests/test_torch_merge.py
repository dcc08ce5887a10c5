"""PyTorch port, sorted merge: exact agreement with the JAX
merge_sorted, including saturation at 0xFFFFFFFF and SENTINEL-tailed
parts."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SENT_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _table(rng, n, kbits=40):
    # keys below 2^kbits, never the SENTINEL
    keys = np.unique(rng.integers(0, (1 << kbits) - 1, n, dtype=np.uint64))
    t = len(keys)
    c = rng.integers(0, 1 << 32, t, dtype=np.uint64).astype(np.uint32)
    fw = rng.integers(0, 1 << 32, (t, 4), dtype=np.uint64).astype(np.uint32)
    bw = rng.integers(0, 1 << 32, (t, 4), dtype=np.uint64).astype(np.uint32)
    return keys, c, fw, bw


def _pad(table, size):
    k, c, f, b = table
    pad = size - len(k)
    return (np.concatenate([k, np.full(pad, SENT_U64, np.uint64)]),
            np.concatenate([c, np.zeros(pad, np.uint32)]),
            np.concatenate([f, np.zeros((pad, 4), np.uint32)]),
            np.concatenate([b, np.zeros((pad, 4), np.uint32)]))


def _to_port(table):
    from kreeq_tpu_torch.constants import keys_from_u64

    k, c, f, b = table
    return (torch.from_numpy(keys_from_u64(k)),
            *(torch.from_numpy(x.astype(np.int64)) for x in (c, f, b)))


def _assert_same(ref, got):
    from kreeq_tpu_torch.constants import keys_to_u64

    assert int(ref[4]) == int(got[4])
    assert np.array_equal(np.asarray(ref[0]), keys_to_u64(got[0].numpy()))
    for name, x, y in zip(("cov", "fw", "bw"), ref[1:4], got[1:4]):
        assert np.array_equal(np.asarray(x).astype(np.int64),
                              y.numpy()), name


def _cases():
    rng = np.random.default_rng(11)
    a = _table(rng, 700)
    # B shares every third key of A, with counters near the top so the
    # shared rows saturate (tests/test_kernels.py::test_merge_saturation)
    kb = np.unique(np.concatenate(
        [a[0][::3], rng.integers(0, 1 << 40, 300).astype(np.uint64)]))
    t = len(kb)
    b = (kb, np.full(t, 0xFFFFFFF0, np.uint32),
         np.full((t, 4), 0xFFFFFFFE, np.uint32),
         rng.integers(0, 1 << 31, (t, 4), dtype=np.uint64).astype(np.uint32))

    def _row(table, i):
        """Row i of table, or a key none of its rows has."""
        if i is None:
            key = np.setdiff1d(np.arange(1, 1 << 20, dtype=np.uint64),
                               table[0])[:1]
            return (key, np.array([7], np.uint32),
                    np.full((1, 4), 3, np.uint32),
                    np.full((1, 4), 5, np.uint32))
        return tuple(x[i:i + 1] for x in table)

    cases = {
        "overlap_saturating": (_pad(a, 1024), _pad(b, 1024)),
        "dense_duplicates": (_pad(_table(rng, 400, kbits=10), 1024),
                             _pad(_table(rng, 400, kbits=10), 1024)),
        "a_all_sentinel": (_pad((a[0][:0], a[1][:0], a[2][:0], a[3][:0]),
                                1024), _pad(a, 1024)),
        "b_empty_untailed": (_pad(b, 1024),
                             (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                              np.zeros((0, 4), np.uint32),
                              np.zeros((0, 4), np.uint32))),
        "top_bit_keys": (_pad(_table(rng, 500, kbits=64), 1024),
                         _pad(_table(rng, 500, kbits=64), 1024)),
    }
    big = _table(rng, 5000)
    cases.update({
        # every row an equal pair: summed, and saturating
        "a_equals_b": (_pad(a, 1024), _pad(a, 1024)),
        "a_equals_b_saturating": (_pad(b, 1024), _pad(b, 1024)),
        # one row against many, its key among them or not
        "one_against_many": (_pad(_row(big, 1234), 2),
                             _pad(big, len(big[0]) + 3)),
        "many_against_one": (_pad(big, len(big[0]) + 3),
                             _pad(_row(big, None), 1)),
    })
    return cases


@pytest.mark.parametrize("case", ["overlap_saturating", "dense_duplicates",
                                  "a_all_sentinel", "b_empty_untailed",
                                  "top_bit_keys", "a_equals_b",
                                  "a_equals_b_saturating", "one_against_many",
                                  "many_against_one"])
def test_merge_sorted_matches_jax(case):
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import merge_sorted as jax_merge
    from kreeq_tpu_torch.ops.kernels import merge_sorted_cuda

    a, b = _cases()[case]
    ref = jax_merge(*(jnp.asarray(x) for x in (*a, *b)))
    got = merge_sorted_cuda(*_to_port(a), *_to_port(b))
    _assert_same(ref, got)


def test_merge_saturation():
    """The single-key case of tests/test_kernels.py::test_merge_saturation."""
    from kreeq_tpu_torch.ops.kmers import merge_sorted

    big = 0xFFFFFFFF - 1

    def one(v):
        return (np.array([5], np.uint64), np.array([v], np.uint32),
                np.array([[v, 0, 0, 0]], np.uint32),
                np.zeros((1, 4), np.uint32))

    keys, cov, fw, bw, n = merge_sorted(*_to_port(one(big)),
                                        *_to_port(one(7)))
    assert int(n) == 1 and int(cov[0]) == 0xFFFFFFFF
    assert int(fw[0, 0]) == 0xFFFFFFFF


def test_merge_sorted_matches_pallas_interpret(monkeypatch):
    """One tiny case against the Pallas merge kernel in interpret mode."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.pallas_kernels import merge_sorted_pallas
    from kreeq_tpu_torch.constants import keys_to_u64
    from kreeq_tpu_torch.ops.kmers import merge_sorted

    monkeypatch.setenv("KREEQ_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(4)
    a = _pad(_table(rng, 200, kbits=12), 256)
    b = _pad(_table(rng, 150, kbits=12), 256)
    ref = merge_sorted_pallas(*(jnp.asarray(x) for x in (*a, *b)))
    got = merge_sorted(*_to_port(a), *_to_port(b))
    n = int(ref[4])
    assert n == int(got[4])
    assert np.array_equal(np.asarray(ref[0])[:n],
                          keys_to_u64(got[0].numpy())[:n])
    for x, y in zip(ref[1:4], got[1:4]):
        assert np.array_equal(np.asarray(x)[:n].astype(np.int64),
                              y[:n].numpy())
