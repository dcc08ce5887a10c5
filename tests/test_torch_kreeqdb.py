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
    # "heavy": nearly every row overflows, so nearly every u8 row is a
    # tombstone
    top = {"overflow": 300, "heavy": 600}.get(kind, 200)
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


def _native(monkeypatch, native):
    """Select the native DB loader or the pure-Python archive parser."""
    if not native:
        monkeypatch.setenv("KREEQ_TPU_NO_NATIVE", "1")
    else:
        from kreeq_tpu_torch.native import get_lib

        if get_lib() is None:
            pytest.skip("no C++ compiler for the native helpers")


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


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kind,drop", [
    ("plain", ()), ("overflow", ()), ("empty", ()), ("heavy", ()),
    ("overflow", (0, 5, 127)), ("heavy", tuple(range(0, 128, 3)))])
def test_loader_matches_jax_reader(tmp_path, monkeypatch, native, kind,
                                   drop):
    """The DB loader against the JAX reader, also where some u8 map
    files are missing and where most u8 rows are tombstones; the
    counters db.maps, db.bytes, db.rows and db.tombstones."""
    from kreeq_tpu.io.kreeqdb import read_kreeq as jax_read
    from kreeq_tpu.io.kreeqdb import write_kreeq as jax_write
    from kreeq_tpu_torch.io.kreeqdb import read_kreeq
    from kreeq_tpu_torch.utils import log

    _native(monkeypatch, native)
    db = tmp_path / "x.kreeq"
    jt = _jax_table(kind)
    jax_write(str(db), jt)
    for m in drop:
        os.remove(db / f".map.{m}.bin")
    want = jax_read(str(db))
    with log.job() as rec:
        got = read_kreeq(str(db), "cpu")
    _same_tables(got, want)
    c = rec["counters"]
    maps = [f for f in os.listdir(db) if f.startswith(".map.")]
    assert c["db.maps"] == len(maps) == 129 - len(drop)
    assert c["db.bytes"] == sum(os.path.getsize(db / f) for f in maps)
    assert c["db.rows"] == len(want)
    # every overflow row of the kept maps is a tombstone there
    kept = ~np.isin(jt.keys % np.uint64(128), np.array(drop, np.uint64))
    overflow = ((jt.cov >= 255) | (jt.fw >= 255).any(axis=1)
                | (jt.bw >= 255).any(axis=1))
    assert c["db.tombstones"] == np.count_nonzero(overflow & kept)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kind", ["plain", "overflow", "heavy"])
def test_loader_host_form(tmp_path, monkeypatch, native, kind):
    """Above the row cap the loaded table stays on the host, equal to
    the JAX reader's."""
    from kreeq_tpu.io.kreeqdb import read_kreeq as jax_read
    from kreeq_tpu.io.kreeqdb import write_kreeq as jax_write
    from kreeq_tpu_torch.io.kreeqdb import read_kreeq

    _native(monkeypatch, native)
    db = str(tmp_path / "x.kreeq")
    jax_write(db, _jax_table(kind))
    monkeypatch.setenv("KREEQ_TPU_MAX_TABLE_ROWS", "500")
    got = read_kreeq(db, "cpu")
    assert got.on_host
    _same_tables(got, jax_read(db))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_loader_tombstone_without_hc_record(tmp_path, monkeypatch, native):
    """A u8 tombstone whose key the hc map lacks raises the JAX reader's
    error."""
    from kreeq_tpu.io.kreeqdb import read_kreeq as jax_read
    from kreeq_tpu.io.kreeqdb import write_kreeq as jax_write
    from kreeq_tpu_torch.io.kreeqdb import SLOT_U32, _write_phmap, read_kreeq

    _native(monkeypatch, native)
    db = str(tmp_path / "x.kreeq")
    jt = _jax_table("overflow")
    jax_write(db, jt)
    hc = np.nonzero((jt.cov >= 255) | (jt.fw >= 255).any(axis=1)
                    | (jt.bw >= 255).any(axis=1))[0][1:-1]  # two dropped
    recs = np.concatenate([jt.fw[hc], jt.bw[hc], jt.cov[hc, None]], axis=1)
    _write_phmap(os.path.join(db, ".map.hc.bin"), jt.keys[hc],
                 recs.astype(np.uint32), SLOT_U32)
    with pytest.raises(ValueError) as want:
        jax_read(db)
    with pytest.raises(ValueError) as got:
        read_kreeq(db, "cpu")
    assert "missing 255 value" in str(want.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("fault", ["truncated", "truncated_hc",
                                   "trailing", "version", "empty_file"])
def test_loader_rejects_a_corrupt_archive(tmp_path, monkeypatch, native,
                                          fault):
    """A cut, lengthened or mis-marked map file raises ValueError; the
    native loader's text is `corrupt phmap archive`."""
    from kreeq_tpu.io.kreeqdb import write_kreeq as jax_write
    from kreeq_tpu_torch.io.kreeqdb import read_kreeq

    _native(monkeypatch, native)
    db = tmp_path / "x.kreeq"
    jax_write(str(db), _jax_table("overflow"))
    path = db / (".map.hc.bin" if fault == "truncated_hc" else ".map.5.bin")
    data = path.read_bytes()
    data = {"truncated": data[:len(data) - 9],
            "truncated_hc": data[:len(data) // 2],
            "trailing": data + b"\0",
            "version": data[:8] + b"\0" + data[9:],
            "empty_file": b""}[fault]
    path.write_bytes(data)
    with pytest.raises(ValueError, match="corrupt phmap archive"
                       if native else None):
        read_kreeq(str(db), "cpu")


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
