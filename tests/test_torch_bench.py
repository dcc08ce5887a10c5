"""PyTorch port, the bench (kreeq_tpu_torch/bench.py) on the CPU: its
count, QV, track and merge steps against the JAX package on bench.py's
recipe at a small size (exact), its result lines' schema, its watchdog,
its refusal to run without a card, and the bounds it shares with
chip_smoke.py (ops/bounds.py)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

K = 31
CHUNK = 1 << 14
PCHUNK = 1 << 13
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def counted():
    """The chunk of bench.py's recipe at 2^14 bases, counted by the JAX
    package and by the bench's count step on the CPU."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import count_sorted, kmer_positions
    from kreeq_tpu_torch import bench

    codes = np.random.default_rng(0).integers(0, 4, CHUNK).astype(np.uint8)
    assert np.array_equal(bench.genome(0, CHUNK), codes)
    keys, _isfw, edges, valid = kmer_positions(jnp.asarray(codes), K)
    want = tuple(np.asarray(a) for a in count_sorted(keys, edges, valid))
    got = bench.count_step(torch.from_numpy(codes), K)
    return codes, want, got


def _same_table(got, want):
    """A port table (int64 biased keys, int64 counters) against a JAX one
    (u64 keys, u32 counters), element for element."""
    from kreeq_tpu_torch.constants import keys_to_u64

    assert np.array_equal(keys_to_u64(got[0].numpy()), want[0])
    for g, w in zip(got[1:4], want[1:4]):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), w.astype(np.int64))
    assert int(got[4]) == int(want[4])


def test_count_step_matches_jax(counted):
    _codes, want, got = counted
    assert int(got[4]) > CHUNK - K - 100  # nearly every 31-mer distinct
    _same_table(got, want)


def _jax_classify(want, codes):
    import jax.numpy as jnp

    from kreeq_tpu.ops.validate import validate_positions

    return validate_positions(*(jnp.asarray(a) for a in want[:4]),
                              jnp.zeros((1 << 8) + 1, jnp.int32),
                              jnp.asarray(codes[:PCHUNK]), K, 0, 8, 1, True)


def test_qv_and_track_steps_match_jax(counted):
    """The window drawn from the counted chunk: the QV sums and every
    track of the port equal the JAX classification and its window sums
    (#missing 0, as the bench asserts on the card)."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.validate import qv_window_sums
    from kreeq_tpu_torch import bench

    codes, want, got = counted
    asm = torch.from_numpy(codes[:PCHUNK])
    p = PCHUNK - K + 1
    ref = _jax_classify(want, codes)
    sums = bench.qv_step(got, None, asm, K)
    want_sums = np.asarray(qv_window_sums(ref[1], ref[2], jnp.uint32(0),
                                          jnp.uint32(p)))[:2]
    assert sums.tolist() == want_sums.tolist() == [0, 0]
    track = bench.track_step(got, None, asm, K)
    assert len(track) == len(ref) == 7
    for g, w in zip(track, ref):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), w.astype(g.numpy().dtype))
    assert int(track[3].min()) >= 1  # every position found


def test_merge_step_matches_jax(counted):
    """bench.py's split of the counted table ([:h], [h:2h]) merged."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import merge_sorted
    from kreeq_tpu_torch import bench
    from kreeq_tpu_torch.ops.bounds import real_rows

    _codes, want, got = counted
    a, b = bench.halves(got)
    h = got[0].shape[0] // 2
    assert a[0].shape[0] == b[0].shape[0] == h
    wa = tuple(jnp.asarray(x[:h]) for x in want[:4])
    wb = tuple(jnp.asarray(x[h:2 * h]) for x in want[:4])
    ref = tuple(np.asarray(x) for x in merge_sorted(*wa, *wb))
    merged = bench.merge_step(a, b)
    # the halves share no key: the union holds every real row of both
    assert int(merged[4]) == real_rows(a[0]) + real_rows(b[0])
    _same_table(merged, ref)


def _fake_times(fn, reps):
    """Calls fn once a rep and returns fixed milliseconds: the schema
    test's stand-in for CUDA events (no device number)."""
    for _ in range(reps):
        fn()
    return [1.0 + 0.25 * i for i in range(reps)]


def _superset(new, old):
    """Every key of `old` is in `new`, dicts recursively."""
    for key, value in old.items():
        assert key in new
        if isinstance(value, dict):
            _superset(new[key], value)


def test_result_lines_schema():
    """One line per stage, each a superset of the one before, with the
    metric, the unit, the card, every stage's times, bounds and exactness
    and the launches; built from the stages run on the CPU."""
    from kreeq_tpu_torch import bench

    b = bench.Bench(torch.device("cpu"), 0, chunk=CHUNK, pchunk=PCHUNK,
                    reps=10, timer=_fake_times)
    oracle = {"threads": 4, "count_kmers_per_s_4t": 2.0e7,
              "probe_kmers_per_s_4t": 5.0e7}
    b.extra.update(device={"name": "test", "count": 0}, host_cores=4,
                   cpu_oracle=oracle)
    lines = []
    b.run(lambda line: lines.append(json.loads(json.dumps(line))))
    assert len(lines) == 4
    for old, new in zip(lines, lines[1:]):
        _superset(new, old)
    last = lines[-1]
    assert last["metric"] == "read kmers counted/s/chip"
    assert last["unit"] == "kmers/s"
    assert last["value"] == pytest.approx((CHUNK - K + 1) / 2.125e-3)
    assert last["vs_baseline"] == pytest.approx(last["value"] / 2.0e7)
    extra = last["extra"]
    assert extra["device"]["name"] == "test"
    assert (extra["k"], extra["chunk_bases"], extra["seed"]) == (K, CHUNK, 0)
    for key in ("count_step_ms", "index_ms", "probe_qv_step_ms",
                "probe_track_step_ms", "merge_step_ms", "probe_kmers_per_s",
                "merge_kmers_per_s", "probe_vs_cpu_oracle"):
        assert extra[key] > 0
    stages = extra["stages"]
    assert set(stages) == {"count", "index", "probe_qv", "probe_track",
                           "merge"}
    for name in ("count", "probe_qv", "probe_track", "merge"):
        st = stages[name]
        assert st["exact"] is True
        assert st["step"]["n"] == st["plain"]["n"] == 10
        assert st["step"]["q1_ms"] <= st["step"]["median_ms"] \
            <= st["step"]["q3_ms"]
        assert st["bound_ms"] > 0
        assert st["share_of_bound"] == pytest.approx(st["bound_ms"]
                                                     / st["kernel_ms"])
    for name in ("probe_qv", "probe_track"):
        assert stages[name]["sector_floor_ms"] > 0
    assert set(stages["count"]["parts"]) == {"extract", "extract_plain",
                                             "sort", "sort_plain",
                                             "torch_sort"}
    assert 0 < stages["count"]["sort_bound_ms"] \
        < stages["count"]["sort_passes_ms"]
    for name in ("probe_qv", "probe_track"):
        assert set(stages[name]["parts"]) == {"extract", "extract_plain"}
    for name in ("count", "probe_qv", "probe_track"):
        assert stages[name]["extract_bound_ms"] > 0
    assert stages["probe_qv"]["missing"] == 0
    assert stages["merge"]["na"] == stages["merge"]["nb"] \
        == stages["count"]["records"] // 2
    assert set(extra["launches"]) == {"count", "merge", "probe_qv",
                                      "probe_select", "probe_sorted",
                                      "extract", "sort", "variant_search"}
    assert "incomplete" not in extra


def _watch(argv, deadline, capfd):
    from kreeq_tpu_torch import bench

    rc = bench.watchdog(argv, deadline)
    out = capfd.readouterr()
    return rc, out.out.strip().splitlines(), out.err


def test_watchdog_deadline(capfd):
    """A child that sleeps past the deadline: its group is killed, its
    JSON lines stand, the incomplete line carries the stage, exit 0."""
    child = ("import json, time\n"
             "print('stage: first', flush=True)\n"
             "print(json.dumps({'metric': 'm', 'value': 1}), flush=True)\n"
             "print('stage: sleeping', flush=True)\n"
             "time.sleep(60)\n")
    rc, lines, err = _watch([sys.executable, "-c", child], 1.0, capfd)
    assert rc == 0
    assert json.loads(lines[0]) == {"metric": "m", "value": 1}
    last = json.loads(lines[-1])
    assert last["value"] == 0 and last["vs_baseline"] == 0
    assert last["extra"] == {"incomplete": True, "stage": "sleeping"}
    assert "stage: sleeping" in err and "deadline" in err


def test_watchdog_child_error(capfd):
    """A child that raises: the incomplete line carries the stage and the
    error, and the watchdog exits with the child's code."""
    child = ("import sys\n"
             "sys.argv = ['bench', '--child']\n"
             "from kreeq_tpu_torch import bench\n"
             "bench._measure = lambda seed: (bench.say('stage: count'),"
             " 1 / 0)\n"
             "bench.main()\n")
    rc, lines, err = _watch([sys.executable, "-c", child], 120.0, capfd)
    assert rc == 1
    last = json.loads(lines[-1])
    assert last["value"] == 0
    assert last["extra"] == {"incomplete": True, "stage": "count",
                             "error": "ZeroDivisionError: division by zero"}
    assert "Traceback" in err


def test_module_without_card_fails():
    """`python -m kreeq_tpu_torch.bench` with no card visible and no
    KREEQ_TPU_PLATFORM: non-zero, the error in the last line, no number
    under the metric's name."""
    env = {k: v for k, v in os.environ.items() if k != "KREEQ_TPU_PLATFORM"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["KREEQ_TPU_BENCH_DEADLINE"] = "120"
    res = subprocess.run([sys.executable, "-m", "kreeq_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    last = json.loads(lines[-1])
    assert last["value"] == 0 and last["extra"]["incomplete"] is True
    assert last["extra"]["stage"] == "device"
    assert "no CUDA device" in last["extra"]["error"]


def test_cpu_platform_refused(monkeypatch):
    """KREEQ_TPU_PLATFORM=cpu: the bench has no CPU mode."""
    from kreeq_tpu_torch import bench

    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")
    with pytest.raises(RuntimeError, match="no CPU mode"):
        bench._measure(0)


def test_bounds_from_row_counts():
    """PERF.md's bounds at 3.35 TB/s: the 12 Mbp build's largest merge
    (na = 9,775,932, nb = 30,822,978, 15,927,093 SENTINEL rows) 1.597
    ms; count_runs on an 8,388,588-record chunk 0.223 ms; and the tensor
    forms equal the row-count forms."""
    from kreeq_tpu_torch.constants import SENTINEL
    from kreeq_tpu_torch.ops import bounds

    rows = 9_775_932 + 30_822_978
    assert round(bounds.merge_rows_bound_ms(rows, rows - 15_927_093),
                 3) == 1.597
    assert round(bounds.count_rows_bound_ms(8_388_588, 8_388_588), 3) \
        == 0.223
    assert bounds.bound_ms(3.35e9) == pytest.approx(1.0)
    ka = torch.tensor([1, 5, 9, SENTINEL, SENTINEL])
    kb = torch.tensor([2, SENTINEL])
    assert bounds.real_rows(ka) == 3
    assert bounds.merge_bound_ms(ka, kb) == bounds.merge_rows_bound_ms(7, 4)
    assert bounds.count_bound_ms(ka) == bounds.count_rows_bound_ms(5, 3)


def test_count_step_bounds():
    """PERF.md's bounds of the count step's front half at 3.35 TB/s on
    bench.py's chunk (N = 2^23, k = 31, P = 8,388,578): the extraction's
    count form 0.025 ms and records form 0.030 ms; the sort's bound, 18 B
    a record, 0.045 ms, below the least traffic of its passes with 8-bit
    digits, 0.381 ms at k = 31 (8 passes) and 0.290 ms at k = 21 (6)."""
    from kreeq_tpu_torch.ops import bounds

    n, p = 1 << 23, 8_388_578
    assert round(bounds.extract_bound_ms(n, 31, "count"), 3) == 0.025
    assert round(bounds.extract_bound_ms(n, 31, "records"), 3) == 0.030
    assert bounds.sort_bound_ms(p) == bounds.bound_ms(18 * p)
    assert round(bounds.sort_bound_ms(p), 3) == 0.045
    assert round(bounds.sort_passes_ms(p, 31), 3) == 0.381
    assert round(bounds.sort_passes_ms(p, 21), 3) == 0.290
    assert [bounds.sort_passes(k) for k in (1, 4, 5, 21, 31, 32)] \
        == [1, 1, 2, 6, 8, 8]


def test_oracle_build_is_cached():
    """The CPU oracle is built once per source hash into _build/ (the
    bench runs it on the card's host)."""
    from kreeq_tpu_torch import bench

    if bench.shutil.which("g++") is None:
        pytest.skip("needs g++")
    exe = bench.build_oracle()
    assert os.path.basename(exe).startswith("cpu_oracle-")
    mtime = os.path.getmtime(exe)
    assert bench.build_oracle() == exe
    assert os.path.getmtime(exe) == mtime
    assert not [f for f in os.listdir(os.path.dirname(exe))
                if f.startswith("cpu_oracle-") and f.endswith(".tmp")]
