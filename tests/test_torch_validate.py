"""PyTorch port, QV probe: validate_qv_sums against the JAX
validate_positions + qv_window_sums on one JAX-built table carried over
with KmerTable.from_numpy (exact: the sums are integers)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

WINDOWS = ((0, 10_000), (1, 1200), (7, 500))  # (lead, hi); hi may pass p


def _inputs(seed, k):
    """A JAX-built table of reads drawn from a genome at uneven coverage,
    and an assembly window: the genome with substitutions and BADs.
    Substitution pairs k + 1 apart leave the k-mer between them found
    but with neither neighbour seen in the reads (edge-missing)."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import count_sorted, kmer_positions

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2000).astype(np.uint8)
    reads = np.full(60 * 101, 4, np.uint8)
    for i, s in enumerate(rng.integers(0, 1900, 60)):
        reads[i * 101:i * 101 + 100] = genome[s:s + 100]
    keys, _isfw, edges, valid = kmer_positions(jnp.asarray(reads), k)
    tkeys, cov, fw, bw, n = count_sorted(keys, edges, valid)
    table = tuple(np.asarray(a)[:int(n)] for a in (tkeys, cov, fw, bw))
    asm = genome[:1500].copy()
    for x in rng.integers(0, 1500 - k - 1, 6):
        asm[[x, x + k + 1]] ^= 1
    asm[700:703] = 4
    return table, asm


def _jax_sums(table, asm, k, cutoff):
    import jax.numpy as jnp

    from kreeq_tpu.ops.validate import qv_window_sums, validate_positions

    r = validate_positions(*(jnp.asarray(a) for a in table),
                           jnp.zeros((1 << 8) + 1, jnp.int32),
                           jnp.asarray(asm), k, cutoff, 8, 1, True)
    return [tuple(int(x) for x in np.asarray(
        qv_window_sums(r[1], r[2], jnp.uint32(lead), jnp.uint32(hi)))[:2])
        for lead, hi in WINDOWS]


def _port_sums(table, asm, k, cutoff):
    from kreeq_tpu_torch.ops.validate import validate_qv_sums

    tab = (table.keys, table.cov, table.fw, table.bw)
    return [tuple(int(x) for x in validate_qv_sums(
        *tab, torch.from_numpy(asm), k, cutoff, lead, hi).tolist())
        for lead, hi in WINDOWS]


@pytest.mark.parametrize("k,cutoff", [(21, 0), (21, 1), (21, 3), (31, 0),
                                      (32, 2)])
def test_qv_sums_match_jax(k, cutoff):
    from kreeq_tpu_torch.core.table import KmerTable

    table, asm = _inputs(k, k)
    port = KmerTable.from_numpy(k, *table, device="cpu")
    want = _jax_sums(table, asm, k, cutoff)
    assert want[0][0] > 0 and want[0][1] > 0  # both counts exercised
    assert _port_sums(port, asm, k, cutoff) == want


def test_qv_sums_empty_table():
    """Empty table: every in-window position is missing (the JAX DBG
    probes a one-row SENTINEL table then)."""
    from kreeq_tpu.ops.kmers import SENTINEL
    from kreeq_tpu_torch.core.table import KmerTable

    k = 21
    _table, asm = _inputs(0, k)
    sent = (np.full(1, np.uint64(SENTINEL)), np.zeros(1, np.uint32),
            np.zeros((1, 4), np.uint32), np.zeros((1, 4), np.uint32))
    want = _jax_sums(sent, asm, k, 0)
    assert _port_sums(KmerTable.empty(k, "cpu"), asm, k, 0) == want


def test_qv_sums_match_pallas_interpret(monkeypatch):
    """One tiny case against the Pallas QV-indicator kernel in interpret
    mode."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.validate import validate_qv_sums_pallas
    from kreeq_tpu_torch.core.table import KmerTable
    from kreeq_tpu_torch.ops.validate import validate_qv_sums

    monkeypatch.setenv("KREEQ_TPU_PALLAS_INTERPRET", "1")
    k = 21
    table, asm = _inputs(3, k)
    asm = asm[:400]
    lead, hi = 2, 300
    ref = validate_qv_sums_pallas(*(jnp.asarray(a) for a in table),
                                  jnp.asarray(asm), k, 2, jnp.uint32(lead),
                                  jnp.uint32(hi), sync=True)
    want = tuple(int(x) for x in np.asarray(ref)[:2])
    port = KmerTable.from_numpy(k, *table, device="cpu")
    got = validate_qv_sums(port.keys, port.cov, port.fw, port.bw,
                           torch.from_numpy(asm), k, 2, lead, hi)
    assert tuple(got.tolist()) == want


def test_table_numpy_round_trip():
    from kreeq_tpu_torch.core.table import KmerTable

    table, _asm = _inputs(1, 32)
    back = KmerTable.from_numpy(32, *table, device="cpu").to_numpy()
    for x, y in zip(table, back):
        assert x.dtype == y.dtype and np.array_equal(x, y)
