"""PyTorch port, the sharded build, probe and union
(kreeq_tpu_torch/parallel/sharded.py, ShardedCounter, merge_sharded)
against the JAX package's SPMD versions on the CPU, exact: 2 and 3
gloo ranks, spawned as processes (tests/torch_sharded_worker.py),
against JAX meshes of as many of its 8 virtual devices, at k = 21, 31
and 32."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_sharded_worker.py")
KS = (21, 31, 32)
CHUNK = 2048  # bases of one rank's read or assembly chunk
POLY_A = 4096  # bases of each rank's poly-A chunk (one key, one owner)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _chunks(rng, genome, n, mutate):
    """[n, CHUNK] uint8 codes: per rank, reads of 100-150 bases from
    `genome` (ranks overlap, so a key is counted on several ranks),
    BAD-separated; with `mutate`, two substitutions and an N in each."""
    from kreeq_tpu.constants import seq_to_codes

    out = np.full((n, CHUNK), 4, np.uint8)
    for r in range(n):
        pos = 0
        while True:
            ln = int(rng.integers(100, 151))
            if pos + ln + 1 > CHUNK:
                break
            s = int(rng.integers(0, len(genome) - ln))
            read = list(genome[s:s + ln])
            if mutate:
                # an SNV pair k + 1 apart (k = 21, 31, 32): the k-mer
                # between them is found but neither neighbour is
                x = int(rng.integers(0, ln - 40))
                for j in (x, x + int(rng.choice([22, 32, 33]))):
                    read[j] = "ACGT"[("ACGT".index(read[j]) + 1) % 4]
                read[int(rng.integers(0, ln))] = "N"
            out[r, pos:pos + ln] = seq_to_codes("".join(read))
            pos += ln + 1
    return out


def _tables(k):
    """Two sorted tables whose keys overlap, one shared row saturating
    (as in tests/test_sharded.py)."""
    def table(nkeys, seed):
        r = np.random.default_rng(seed)
        keys = np.unique(r.integers(0, 1 << (2 * k - 1), nkeys,
                                    dtype=np.uint64) << np.uint64(1))
        shape = (len(keys),)
        return [keys, r.integers(1, 1 << 31, shape, dtype=np.uint32),
                r.integers(0, 1 << 31, shape + (4,), dtype=np.uint32),
                r.integers(0, 1 << 31, shape + (4,), dtype=np.uint32)]

    a, b = table(5000, 1), table(3000, 2)
    b[0][:500] = a[0][1000:1500]
    order = np.argsort(b[0], kind="stable")
    b = [x[order] for x in b]
    i = np.searchsorted(b[0], a[0][1000])
    b[1][i] = np.uint32(0xFFFFFFF0)  # saturates with a's cov
    return a, b


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Inputs of every job, the read files of from_reads."""
    tmp = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(17)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    inputs = {}
    for n in (2, 3):
        inputs[f"reads{n}"] = _chunks(rng, genome, n, False)
        inputs[f"asm{n}"] = _chunks(rng, genome, n, True)
        inputs[f"polya{n}"] = np.zeros((n, POLY_A), np.uint8)
    a, b = _tables(21)
    for name, t in (("a", a), ("b", b)):
        for field, x in zip(("keys", "cov", "fw", "bw"), t):
            inputs[f"{name}.{field}"] = x
    files = []
    for i, nreads in enumerate((30, 12, 5)):
        p = tmp / f"reads{i}.fa"
        with open(p, "w") as fh:
            for j in range(nreads):
                s = int(rng.integers(0, 2800))
                fh.write(f">r{i}.{j}\n{genome[s:s + 150]}\n")
        files.append(str(p))
    return tmp, inputs, files


_RUNS = {}


@pytest.fixture(params=[2, 3], ids=["2ranks", "3ranks"])
def ranks(request, work):
    """(n, per-rank outputs) of one spawn of n gloo ranks that ran every
    job; spawned once per n."""
    n = request.param
    if n in _RUNS:
        return n, _RUNS[n]
    tmp, inputs, files = work
    d = tmp / f"n{n}"
    d.mkdir()
    np.savez(d / "inputs.npz", **{key: v for key, v in inputs.items()
                                  if not key[-1].isdigit() or
                                  key.endswith(str(n))})
    jobs = [{"name": f"count{k}", "kind": "count", "codes": f"reads{n}",
             "k": k} for k in KS]
    jobs += [{"name": "polya", "kind": "count", "codes": f"polya{n}",
              "k": 15}]
    jobs += [{"name": f"probe{k}", "kind": "pipeline", "reads": f"reads{n}",
              "asm": f"asm{n}", "k": k} for k in KS]
    # *_host: a row cap so small that the whole table is gathered into
    # host memory (table.device_gather_rows: a quarter of the cap)
    small = {"KREEQ_TPU_MAX_TABLE_ROWS": "400"}
    force = {"KREEQ_TPU_FORCE_SHARDED": "1"}
    jobs += [{"name": "merge", "kind": "merge", "k": 21},
             {"name": "merge_host", "kind": "merge", "k": 21, "env": small},
             {"name": "from_reads", "kind": "from_reads", "files": files,
              "k": 21, "chunk": 1024, "env": force},
             {"name": "from_reads_host", "kind": "from_reads",
              "files": files, "k": 21, "chunk": 1024,
              "env": {**force, **small}}]
    (d / "jobs.json").write_text(json.dumps(jobs))
    port = _free_port()
    env = dict(os.environ)
    env.pop("KREEQ_TPU_FORCE_SHARDED", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(n), str(port), str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()
    _RUNS[n] = [dict(np.load(d / f"out_{r}.npz")) for r in range(n)]
    return n, _RUNS[n]


def _mesh(n):
    import jax

    from kreeq_tpu.parallel.sharded import make_mesh

    return make_mesh(jax.devices()[:n])


def _assert_rows(out, name, keys, cov, fw, bw):
    for field, want in zip(("keys", "cov", "fw", "bw"), (keys, cov, fw, bw)):
        got = out[f"{name}.{field}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), field


@pytest.mark.parametrize("k", KS)
def test_owner_of_matches_jax(k):
    """The port's owner of each key (biased int64, as a tensor and in
    numpy) is the JAX owner_of's of the u64 key, keys with the top bit
    set included at k = 32."""
    from kreeq_tpu.parallel.sharded import owner_of as jax_owner_of
    from kreeq_tpu_torch.constants import keys_from_u64
    from kreeq_tpu_torch.parallel.sharded import owner_of

    rng = np.random.default_rng(k)
    top = np.uint64((1 << (2 * k)) - 1)
    keys = rng.integers(0, 1 << 63, 20000, dtype=np.uint64) * np.uint64(2)
    keys = (keys | rng.integers(0, 2, 20000, dtype=np.uint64)) & top
    keys[:3] = [0, top, top - np.uint64(1)]
    if k == 32:
        assert (keys >= np.uint64(1 << 63)).sum() > 5000
    biased = keys_from_u64(keys)
    for n in (2, 3, 8):
        want = jax_owner_of(keys, n).astype(np.int64)
        assert np.array_equal(owner_of(biased, n), want)
        assert np.array_equal(owner_of(torch.from_numpy(biased), n).numpy(),
                              want)


@pytest.mark.parametrize("k", KS)
def test_sharded_count_matches_jax(ranks, work, k):
    """Each rank's sub-table equals the rows that JAX's sharded_count_fn
    keeps on the device of the same index."""
    import jax.numpy as jnp

    from kreeq_tpu.parallel.sharded import sharded_count_fn

    n, outs = ranks
    codes = work[1][f"reads{n}"]
    tk, tc, tf, tb, nv, drop = sharded_count_fn(_mesh(n), k, full_bins=True)(
        jnp.asarray(codes))
    assert int(np.asarray(drop)[0]) == 0
    tk, tc, tf, tb, nv = (np.asarray(x) for x in (tk, tc, tf, tb, nv))
    for r in range(n):
        m = int(nv[r])
        assert m > 0
        _assert_rows(outs[r], f"count{k}", tk[r, :m], tc[r, :m], tf[r, :m],
                     tb[r, :m])


def test_poly_a_one_owner_exact(ranks):
    """A poly-A chunk on every rank: one key, so one rank receives every
    record.  The routed count is exact in one pass and equals JAX's
    full-size-bin result (whose capacity bins drop and retry)."""
    import jax.numpy as jnp

    from kreeq_tpu.parallel.sharded import sharded_count_fn

    n, outs = ranks
    codes = np.zeros((n, POLY_A), np.uint8)
    tk, tc, tf, tb, nv, _drop = sharded_count_fn(_mesh(n), 15,
                                                 full_bins=True)(
        jnp.asarray(codes))
    tk, tc, tf, tb, nv = (np.asarray(x) for x in (tk, tc, tf, tb, nv))
    assert sorted(int(x) for x in nv) == [0] * (n - 1) + [1]
    for r in range(n):
        m = int(nv[r])
        _assert_rows(outs[r], "polya", tk[r, :m], tc[r, :m], tf[r, :m],
                     tb[r, :m])
        if m:
            assert int(outs[r]["polya.cov"][0]) == n * (POLY_A - 15 + 1)


@pytest.mark.parametrize("k", KS)
def test_sharded_probe_matches_jax(ranks, work, k):
    """full_pipeline (sharded_count, then sharded_probe through the
    sub-table) gives each position's found flag and cov and the three
    summed totals of JAX's full_pipeline_fn."""
    import jax.numpy as jnp

    from kreeq_tpu.parallel.sharded import full_pipeline_fn

    n, outs = ranks
    _, inputs, _ = work
    qf, qc, tot, miss, emiss, drop = full_pipeline_fn(_mesh(n), k)(
        jnp.asarray(inputs[f"reads{n}"]), jnp.asarray(inputs[f"asm{n}"]))
    assert int(np.asarray(drop)[0]) == 0
    sums = [int(np.asarray(x)[0]) for x in (tot, miss, emiss)]
    assert 0 < sums[1] < sums[0] and sums[2] > 0
    qf, qc = np.asarray(qf), np.asarray(qc)
    for r in range(n):
        assert np.array_equal(outs[r][f"probe{k}.qfound"], qf[r])
        assert np.array_equal(outs[r][f"probe{k}.qcov"], qc[r])
        assert outs[r][f"probe{k}.sums"].tolist() == sums


def test_merge_sharded_matches_jax(ranks, work):
    """KmerTable.merge_sharded equals JAX's, a saturating row included;
    every rank holds the whole result."""
    from kreeq_tpu.core.table import KmerTable as JaxTable

    n, outs = ranks
    inputs = work[1]
    a, b = (JaxTable(21, *(inputs[f"{t}.{f}"] for f in
                           ("keys", "cov", "fw", "bw"))) for t in "ab")
    want = a.merge_sharded(b, _mesh(n))
    assert (want.cov == np.uint32(0xFFFFFFFF)).any()
    for r in range(n):
        _assert_rows(outs[r], "merge", want.keys, want.cov, want.fw, want.bw)
        # one gather, on the device: the result is far below the cap
        assert outs[r]["merge.gathers"].tolist() == [1, 0]


def test_merge_sharded_above_cap_gathers_on_host(ranks, work):
    """With a row cap of 400, a quarter of it below the 7,500-row
    result, merge_sharded gathers the slices' results into host memory,
    never onto the device, and still equals JAX's merge_sharded."""
    from kreeq_tpu.core.table import KmerTable as JaxTable

    n, outs = ranks
    inputs = work[1]
    a, b = (JaxTable(21, *(inputs[f"{t}.{f}"] for f in
                           ("keys", "cov", "fw", "bw"))) for t in "ab")
    want = a.merge_sharded(b, _mesh(n))
    assert len(want) > 400
    for r in range(n):
        _assert_rows(outs[r], "merge_host", want.keys, want.cov, want.fw,
                     want.bw)
        assert outs[r]["merge_host.gathers"].tolist() == [1, 1]


def test_from_reads_force_sharded_matches_jax(ranks, work, monkeypatch):
    """KmerTable.from_reads(group=...) under KREEQ_TPU_FORCE_SHARDED=1
    equals JAX's from_reads under the same switch (its 8 devices); every
    rank holds the whole table."""
    from kreeq_tpu.core.table import KmerTable as JaxTable

    n, outs = ranks
    monkeypatch.setenv("KREEQ_TPU_FORCE_SHARDED", "1")
    want = JaxTable.from_reads(work[2], 21, chunk=1024)
    assert len(want) > 0
    for r in range(n):
        _assert_rows(outs[r], "from_reads", want.keys, want.cov, want.fw,
                     want.bw)
        assert outs[r]["from_reads.gathers"].tolist() == [1, 0]


def test_from_reads_above_cap_gathers_on_host(ranks, work, monkeypatch):
    """With a row cap of 400, the sharded build's drain gathers and sorts
    the shards in host memory (as the JAX drain does), never on the
    device, and every rank's table equals JAX's."""
    from kreeq_tpu.core.table import KmerTable as JaxTable

    n, outs = ranks
    monkeypatch.setenv("KREEQ_TPU_FORCE_SHARDED", "1")
    want = JaxTable.from_reads(work[2], 21, chunk=1024)
    assert len(want) > 400
    for r in range(n):
        _assert_rows(outs[r], "from_reads_host", want.keys, want.cov,
                     want.fw, want.bw)
        assert outs[r]["from_reads_host.gathers"].tolist() == [1, 1]
