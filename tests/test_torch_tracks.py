"""PyTorch port, per-base tracks: validate_positions against the JAX
validate_positions (and, in one small case, validate_positions_pallas
with the select-probe kernel in interpret mode) on all seven outputs,
exactly, on one JAX-built table carried over with KmerTable.from_numpy."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NAMES = ("valid", "missing", "edge_missing", "cov", "isfw", "right",
         "left")


def _inputs(seed, k):
    """A JAX-built table of reads drawn from a genome at uneven coverage
    (1 to 12), and an assembly window: the genome with substitutions and
    BAD bases.  Substitution pairs k + 1 apart leave the k-mer between
    them found but with neither neighbour seen in the reads."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import count_sorted, kmer_positions

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2000).astype(np.uint8)
    starts = np.concatenate([rng.integers(0, 1900, 40),
                             rng.integers(600, 700, 20)])
    reads = np.full(starts.shape[0] * 101, 4, np.uint8)
    for i, s in enumerate(starts):
        reads[i * 101:i * 101 + 100] = genome[s:s + 100]
    keys, _isfw, edges, valid = kmer_positions(jnp.asarray(reads), k)
    tkeys, cov, fw, bw, n = count_sorted(keys, edges, valid)
    table = tuple(np.asarray(a)[:int(n)] for a in (tkeys, cov, fw, bw))
    asm = genome[:1500].copy()
    for x in rng.integers(0, 1500 - k - 1, 6):
        asm[[x, x + k + 1]] ^= 1
    asm[700:703] = 4
    asm[rng.integers(0, 1500, 5)] = 4
    return table, asm


def _jax_positions(table, asm, k, cutoff):
    import jax.numpy as jnp

    from kreeq_tpu.ops.validate import validate_positions

    return [np.asarray(a) for a in validate_positions(
        *(jnp.asarray(a) for a in table), jnp.zeros((1 << 8) + 1, jnp.int32),
        jnp.asarray(asm), k, cutoff, 8, 1, True)]


def _port_positions(table, asm, k, cutoff):
    from kreeq_tpu_torch.ops.validate import validate_positions

    return [a.numpy() for a in validate_positions(
        table.keys, table.cov, table.fw, table.bw, torch.from_numpy(asm), k,
        cutoff)]


def _assert_same(got, want):
    assert len(got) == len(want) == 7
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and np.array_equal(g, w), name


@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("cutoff", [0, 2])
def test_positions_match_jax(k, cutoff):
    from kreeq_tpu_torch.core.table import KmerTable

    table, asm = _inputs(k + cutoff, k)
    want = _jax_positions(table, asm, k, cutoff)
    valid, missing, edge, cov = want[:4]
    # every branch exercised: invalid windows, missing, edge-missing,
    # counters above the cutoff
    assert (~valid).any() and missing.any() and edge.any()
    assert (cov > 2).any() and want[5].any() and want[6].any()
    port = KmerTable.from_numpy(k, *table, device="cpu")
    _assert_same(_port_positions(port, asm, k, cutoff), want)


def test_positions_empty_table():
    """Empty table: nothing is found (the JAX DBG probes a one-row
    SENTINEL table then)."""
    from kreeq_tpu.ops.kmers import SENTINEL
    from kreeq_tpu_torch.core.table import KmerTable

    k = 21
    _table, asm = _inputs(0, k)
    sent = (np.full(1, np.uint64(SENTINEL)), np.zeros(1, np.uint32),
            np.zeros((1, 4), np.uint32), np.zeros((1, 4), np.uint32))
    want = _jax_positions(sent, asm, k, 0)
    _assert_same(_port_positions(KmerTable.empty(k, "cpu"), asm, k, 0), want)


def test_positions_match_pallas_interpret(monkeypatch):
    """One small case against the Pallas select-probe kernel in
    interpret mode."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.validate import validate_positions_pallas
    from kreeq_tpu_torch.core.table import KmerTable

    monkeypatch.setenv("KREEQ_TPU_PALLAS_INTERPRET", "1")
    k = 21
    table, asm = _inputs(5, k)
    want = [np.asarray(a) for a in validate_positions_pallas(
        *(jnp.asarray(a) for a in table), jnp.asarray(asm), k, 2)]
    assert want[2].any() and want[5].any()
    port = KmerTable.from_numpy(k, *table, device="cpu")
    _assert_same(_port_positions(port, asm, k, 2), want)


def test_track_readback_keeps_u32_counters():
    """Track values cross to the host as 32-bit patterns: saturated
    counters (0xFFFFFFFF) and values past 2^31 come back unchanged."""
    from kreeq_tpu_torch.core.dbg import SegmentTrack, _start_readback

    vals = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    track = SegmentTrack.zeros(8)
    _start_readback(track, 2, 7, vals, vals > 1, vals.flip(0),
                    vals // 2)()
    v = vals.numpy()
    assert track.cov.tolist() == [0, 0, *v.tolist(), 0]
    assert track.right[2:7].tolist() == v[::-1].tolist()
    assert track.left[2:7].tolist() == (v // 2).tolist()
    assert track.isfw.tolist() == [False] * 4 + [True] * 3 + [False]
