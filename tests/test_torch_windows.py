"""PyTorch port, out-of-core tables against the JAX package on the CPU,
under the same forced caps: KREEQ_TPU_MAX_TABLE_ROWS puts a table above
it on the host, probed in key-range windows, and
KREEQ_TPU_HOST_MERGE_ROWS sends larger merges to the host.  The
windowed probe, the host merge (saturation included), the build and
`union` with host merges, and every CLI output read from a windowed
table (QV sums, each track writer, VCF, anomaly BED, subgraph GFA) must
equal the JAX package's exactly, and the port's own in-core result, at
k = 21, 31 and 32."""

import numpy as np
import pytest
import torch

from .test_torch_cli import (CHUNK, _read_text, _same_output, _stdout,
                             _write_inputs)
from .test_torch_cli import both  # noqa: F401  (the CLI pair fixture)

torch.set_num_threads(1)

KS = [21, 31, 32]
CAP = 500  # rows a window: several windows for these inputs


def _caps(monkeypatch, rows=CAP, merge_rows=2 * CAP):
    monkeypatch.setenv("KREEQ_TPU_MAX_TABLE_ROWS", str(rows))
    monkeypatch.setenv("KREEQ_TPU_HOST_MERGE_ROWS", str(merge_rows))


def _port_table(tmp_path, k):
    from kreeq_tpu_torch.core.table import KmerTable

    rp, _ap = _write_inputs(tmp_path, k)
    return KmerTable.from_reads([rp], k, torch.device("cpu"), chunk=CHUNK)


@pytest.mark.parametrize("cap", [7, 500])
@pytest.mark.parametrize("k", KS)
def test_windowed_probe_matches_jax(tmp_path, monkeypatch, k, cap):
    """The host form's windows and its probe_device against the JAX
    KmerTable's under the same cap: hits, misses, keys past every
    window and the per-position sentinels of the variants scan."""
    from kreeq_tpu.core.table import KmerTable as JaxTable
    from kreeq_tpu_torch.constants import keys_from_u64, keys_to_u64
    from kreeq_tpu_torch.core.table import KmerTable

    arrays = _port_table(tmp_path, k).to_numpy()
    monkeypatch.setenv("KREEQ_TPU_MAX_TABLE_ROWS", str(cap))
    table = KmerTable.from_numpy(k, *arrays, torch.device("cpu"))
    want_table = JaxTable(k, *arrays)
    assert table.on_host
    assert table.window_ranges() == want_table.window_ranges()
    assert len(table.window_ranges()) >= 3
    rng = np.random.default_rng(k)
    u64 = arrays[0]
    q = np.concatenate([
        u64[rng.integers(0, len(u64), 300)], u64[:1], u64[-1:],
        u64[rng.integers(0, len(u64), 100)] + np.uint64(1),
        rng.integers(0, 1 << (2 * k - 1), 200, dtype=np.uint64),
        np.array([0, (1 << 63) | 5, 0xFFFFFFFFFFFFFFFF], np.uint64)])
    want = want_table.probe(q)
    got = table.probe(torch.from_numpy(keys_from_u64(q)))
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
    assert want[0][:302].all()
    # the host form holds the same rows
    for g, w in zip(table.to_numpy(), arrays):
        assert np.array_equal(g, w)
    assert np.array_equal(keys_to_u64(table.keys.numpy()), u64)


def test_host_merge_matches_jax_with_saturation(monkeypatch):
    from kreeq_tpu.core.table import host_merge_sorted as jax_merge
    from kreeq_tpu_torch.constants import keys_from_u64, keys_to_u64
    from kreeq_tpu_torch.core import table as table_mod
    from kreeq_tpu_torch.core.table import (host_merge_sorted,
                                            parallel_host_merge)

    rng = np.random.default_rng(0)

    def table(n, top):
        keys = np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))
        keys[::7] = np.arange(0, len(keys), 7, dtype=np.uint64) * 3
        keys = np.unique(keys)
        m = len(keys)
        return (keys, rng.integers(top - 9, top, m, dtype=np.uint32),
                rng.integers(top - 9, top, (m, 4), dtype=np.uint32),
                rng.integers(0, 9, (m, 4), dtype=np.uint32))

    for top in (1 << 12, 0xFFFFFFFF):
        a, b = table(3000, top), table(2000, top)
        want = jax_merge(*a, *b)
        a2 = (keys_from_u64(a[0]), *a[1:])
        b2 = (keys_from_u64(b[0]), *b[1:])
        # in one piece, and cut into slices of at least 64 rows
        monkeypatch.setattr(table_mod, "_HOST_MERGE_SLICE", 64)
        for got in (host_merge_sorted(*a2, *b2),
                    parallel_host_merge(a2, b2)):
            assert np.array_equal(keys_to_u64(got[0]), want[0])
            for g, w in zip(got[1:], want[1:]):
                assert g.dtype == np.uint32 and np.array_equal(g, w)
        shared = len(a[0]) + len(b[0]) - len(want[0])
        assert shared > 100
        if top == 0xFFFFFFFF:
            assert (want[1] == 0xFFFFFFFF).sum() >= shared // 2
    for empty in (0, 1):
        e = tuple(x[:0] for x in a)
        args = (e, a) if empty == 0 else (a, e)
        got = host_merge_sorted(keys_from_u64(args[0][0]), *args[0][1:],
                                keys_from_u64(args[1][0]), *args[1][1:])
        assert np.array_equal(keys_to_u64(got[0]), a[0])


@pytest.mark.parametrize("k", KS)
def test_build_and_union_with_host_merges_match_jax(tmp_path, both,
                                                     monkeypatch, k):
    """`validate -r -o x.kreeq` and `union` of two DBs with the merges
    above HOST_MERGE_ROWS on the host and the results above the cap:
    the same DB directories as the JAX package's."""
    from kreeq_tpu_torch.utils import log

    jax_run, run = both
    _caps(monkeypatch)
    dbs = []
    for name, fn in (("jax", jax_run), ("port", run)):
        out = tmp_path / name
        out.mkdir()
        for seed in (0, 5):
            rp, _ap = _write_inputs(tmp_path, seed)
            _stdout(fn, ["kreeq", "validate", "-r", rp, "-k", str(k),
                         "-o", str(out / f"r{seed}.kreeq")])
            if name == "port":  # the build merged on the host
                rec = log.jobs[-1]
                merges = rec["spans"]["kq.build.host_merge"]["calls"]
                assert merges == rec["counters"]["build.host_merges"] >= 1
                assert rec["counters"]["build.host_merge_rows_in"] \
                    >= rec["counters"]["build.host_merge_rows_out"] > 0
        stdout = _stdout(fn, ["kreeq", "union", "-d", str(out / "r0.kreeq"),
                              str(out / "r5.kreeq"), "-o",
                              str(out / "u.kreeq")])
        if name == "port":  # so did the union
            rec = log.jobs[-1]
            assert rec["spans"]["kq.build.host_merge"]["calls"] == 1
            assert rec["counters"]["build.host_merge_rows_in"] \
                >= rec["counters"]["build.host_merge_rows_out"] > 0
        dbs.append((out, stdout))
    (want_dir, want_stdout), (got_dir, got_stdout) = dbs
    assert got_stdout == want_stdout and "Distinct kmers" in want_stdout
    for db in ("r0.kreeq", "r5.kreeq", "u.kreeq"):
        _same_output(str(got_dir / db), str(want_dir / db))


@pytest.mark.parametrize("k", KS)
def test_windowed_validate_matches_jax(tmp_path, both, monkeypatch, k):
    """`-d db -f asm` against a windowed table: the QV table (sums
    path) and every track writer as the JAX package writes them under
    the same cap, and as the port writes them in core."""
    from kreeq_tpu_torch.utils import log

    jax_run, run = both
    rp, ap = _write_inputs(tmp_path, 20 + k)
    db = str(tmp_path / "reads.kreeq")
    _stdout(run, ["kreeq", "validate", "-r", rp, "-k", str(k), "-o", db])
    exts = ["bed", "csvtable", "kwig", "bkwig"]
    outs = {}
    for caps in (False, True):
        if caps:
            _caps(monkeypatch)
        for name, fn in (("jax", jax_run), ("port", run)):
            if name == "jax" and not caps:
                continue
            stdouts = []
            files = [str(tmp_path / f"{name}{int(caps)}.{ext}")
                     for ext in exts]
            for argv in ([], *(["-o", out] for out in files)):
                stdouts.append(_stdout(fn, ["kreeq", "validate", "-d", db,
                                            "-f", ap, *argv]))
                if name == "port" and caps:  # probed in its windows
                    rec = log.jobs[-1]
                    assert rec["spans"]["kq.ooc.upload"]["calls"] >= 3
                    assert rec["counters"]["ooc.probe_select"] >= 3
            outs[name, caps] = stdouts, files
    want_stdouts, want_files = outs["jax", True]
    assert "Kreeq" in want_stdouts[0]
    for key in (("port", True), ("port", False)):
        stdouts, files = outs[key]
        assert stdouts == want_stdouts
        for got, want in zip(files, want_files):
            _same_output(got, want)


@pytest.mark.parametrize("k", KS)
def test_windowed_variants_and_subgraph_match_jax(tmp_path, both,
                                                  monkeypatch, k):
    """-o x.vcf, --detect-anomalies and `subgraph` (best-first and
    traversal) against a table of several windows: the JAX package's
    bytes under the same cap."""
    jax_run, run = both
    rp, ap = _write_inputs(tmp_path, 9)
    db = str(tmp_path / "reads.kreeq")
    _stdout(run, ["kreeq", "validate", "-r", rp, "-k", str(k), "-o", db])
    _caps(monkeypatch)
    outs = []
    for name, fn in (("jax", jax_run), ("port", run)):
        vcf, bed, gfa, gfa2 = (str(tmp_path / f"{name}.{ext}") for ext in
                               ("vcf", "anom.bed", "gfa", "trav.gfa2"))
        sub = ["kreeq", "subgraph", "-d", db, "-f", ap]
        stdouts = [
            _stdout(fn, ["kreeq", "validate", "-d", db, "-f", ap, "-o", vcf,
                         "--detect-anomalies", bed]),
            _stdout(fn, sub + ["-o", gfa]),
            _stdout(fn, sub + ["--traversal-algorithm", "traversal", "-o",
                               gfa2])]
        outs.append((stdouts, [_read_text(f) for f in (vcf, bed, gfa, gfa2)]))
    want, got = outs
    assert want[1][1].count("\n") > 3 and want[1][2].count("\nS\t") > 10
    assert "#CHROM" in want[1][0]
    assert got == want
