"""PyTorch port, `.kreeq` I/O: a DB written by the JAX package reads
back in the port as the JAX reader reads it, and a DB written by the
port is byte-identical, file for file, to the one the JAX package
writes for the same table.  Tables include rows with counters >= 255
(tombstones in the u8 maps, full records in the high-copy map) and
saturated counters (0xFFFFFFFF)."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _jax_table(kind):
    """A JAX KmerTable of sorted unique canonical-range keys (k = 21)."""
    from kreeq_tpu.core.table import KmerTable

    k = 21
    if kind == "empty":
        return KmerTable.empty(k)
    rng = np.random.default_rng(len(kind))
    n = 3000
    keys = np.unique(rng.integers(0, 4 ** k, n, dtype=np.uint64))
    n = keys.shape[0]
    top = 300 if kind == "overflow" else 200
    cov = rng.integers(1, top, n).astype(np.uint32)
    fw = rng.integers(0, top, (n, 4)).astype(np.uint32)
    bw = rng.integers(0, top, (n, 4)).astype(np.uint32)
    if kind == "overflow":
        cov[:7] = 0xFFFFFFFF
        bw[7:9, 2] = 0xFFFFFFFF
        fw[9, 0] = 255  # one counter at the u8 limit, cov below it
        cov[9] = 3
    return KmerTable(k, keys, cov, fw, bw)


def _numpy(table):
    return (table.keys, table.cov, table.fw, table.bw)


def _same_tables(got, want):
    assert got.k == want.k
    for g, w in zip(got.to_numpy(), _numpy(want)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kind", ["plain", "overflow", "empty"])
def test_port_reads_jax_db(tmp_path, monkeypatch, kind):
    from kreeq_tpu.io.kreeqdb import read_kreeq as jax_read
    from kreeq_tpu.io.kreeqdb import write_kreeq as jax_write
    from kreeq_tpu_torch.io.kreeqdb import read_kreeq

    db = str(tmp_path / "x.kreeq")
    jax_write(db, _jax_table(kind))
    want = jax_read(db)
    if kind == "overflow":
        assert os.path.getsize(os.path.join(db, ".map.hc.bin")) > 8 * 257
    _same_tables(read_kreeq(db, "cpu"), want)
    # the pure-Python archive parser reads the same table
    monkeypatch.setenv("KREEQ_TPU_NO_NATIVE", "1")
    _same_tables(read_kreeq(db, "cpu"), want)


@pytest.mark.parametrize("kind", ["plain", "overflow", "empty"])
def test_port_writes_jax_bytes(tmp_path, kind):
    from kreeq_tpu.io.kreeqdb import write_kreeq as jax_write
    from kreeq_tpu_torch.core.table import KmerTable
    from kreeq_tpu_torch.io.kreeqdb import write_kreeq

    jt = _jax_table(kind)
    jax_db, port_db = tmp_path / "jax.kreeq", tmp_path / "port.kreeq"
    jax_write(str(jax_db), jt)
    write_kreeq(str(port_db),
                KmerTable.from_numpy(jt.k, *_numpy(jt), device="cpu"))
    names = sorted(os.listdir(jax_db))
    assert len(names) == 130 and sorted(os.listdir(port_db)) == names
    for name in names:
        assert (port_db / name).read_bytes() == (jax_db / name).read_bytes(), \
            name


def test_python_placement_matches_native():
    """The Python fallback of the SwissTable placement gives the native
    helper's slots, also when groups wrap and probing chains."""
    from kreeq_tpu_torch.io.kreeqdb import _place_python, phmap_mix
    from kreeq_tpu_torch.native import phmap_place

    rng = np.random.default_rng(0)
    hs = phmap_mix(rng.integers(0, 1 << 62, 200, dtype=np.uint64))
    native = phmap_place(hs, 255)
    if native is None:
        pytest.skip("no C++ compiler for the native helpers")
    assert np.array_equal(_place_python(hs, 255), native)


def test_union_matches_jax_merge():
    """KmerTable.merge (the plain merge on the CPU) against the JAX
    union, with shared keys whose counters saturate."""
    from kreeq_tpu.core.table import KmerTable as JaxTable
    from kreeq_tpu_torch.core.table import KmerTable

    a = _jax_table("overflow")
    rng = np.random.default_rng(7)
    keys = np.unique(np.concatenate([
        a.keys[::2], rng.integers(0, 4 ** a.k, 1000, dtype=np.uint64)]))
    n = keys.shape[0]
    b = JaxTable(a.k, keys, *(rng.integers(0, 1 << 32, shape).astype(
        np.uint32) for shape in (n, (n, 4), (n, 4))))
    want = a.merge(b)
    got = KmerTable.from_numpy(a.k, *_numpy(a), device="cpu").merge(
        KmerTable.from_numpy(b.k, *_numpy(b), device="cpu"))
    assert (want.cov == 0xFFFFFFFF).any()
    _same_tables(got, want)
    empty = KmerTable.empty(a.k, "cpu")
    assert empty.merge(got) is got and got.merge(empty) is got
