"""The port's path benches (kreeq_tpu_torch/bench_variants.py,
bench_subgraph.py) against the JAX scripts they port
(scripts/bench_variants.py, scripts/bench_subgraph.py) on the CPU, exact:
the data recipe at the scripts' size, each scalar loop against the
script's own loop, and each run() against the JAX package's batched
paths on the same inputs, at a small genome (N_SMALL bases, k = 21).
Also the JSON last line, the imports, the refusal without a card, and a
batched result with one node or variant dropped, which run() must
catch."""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kreeq_tpu_torch import bench_subgraph, bench_variants

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SMALL = 40_000
CPU = torch.device("cpu")
MODULES = {"variants": bench_variants, "subgraph": bench_subgraph}


def _script(name):
    """scripts/bench_<name>.py as a module (scripts/ is not a package)."""
    path = os.path.join(ROOT, "scripts", f"bench_{name}.py")
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(*texts):
    h = hashlib.sha256()
    for t in texts:
        h.update(t.encode())
        h.update(b"\0")
    return h.hexdigest()


def test_data_recipes_match_scripts_at_full_size():
    """make_data(1,000,000) gives the bytes of the scripts' inline
    recipes (bench_variants.py:92-113, bench_subgraph.py:60-80)."""
    from kreeq_tpu.constants import ITOC

    n = 1_000_000
    rng = np.random.default_rng(42)
    genome = "".join(rng.choice(list("ACGT"), size=n))
    reads = "".join(f">r{i}\n{genome[off:] + genome[:off]}\n"
                    for i, off in enumerate((0, 101, 211)))
    asm = list(genome)
    pos = rng.choice(np.arange(1000, n - 1000), size=100, replace=False)
    for p in pos:
        asm[p] = "ACGT"[(ord(asm[p]) + 1) % 4]
    want = _sha(reads, "".join(asm))
    assert _sha(*bench_variants.make_data(n)) == want

    rng = np.random.default_rng(7)
    genome_codes = rng.integers(0, 4, n).astype(np.uint8)
    genome_str = "".join(ITOC[b] for b in genome_codes)
    want = _sha(f">r0\n{genome_str}\n", genome_str[25_000:-25_000])
    assert _sha(*bench_subgraph.make_data(n)) == want


def _tables(tmp_path, reads):
    """(JAX table, the port's table from the same arrays) of `reads`."""
    from kreeq_tpu.core.table import KmerTable as JaxTable
    from kreeq_tpu_torch.core.table import KmerTable

    path = tmp_path / "reads.fasta"
    path.write_text(reads)
    jt = JaxTable.from_reads([str(path)], 21)
    return jt, KmerTable.from_numpy(21, jt.keys, jt.cov, jt.fw, jt.bw, CPU)


def _variants_dbgs(tmp_path, n):
    """(JAX DBG, port DBG) of the variants bench's data at `n` bases."""
    from kreeq_tpu.config import UserInput as JaxUI
    from kreeq_tpu.core.dbg import DBG as JaxDBG
    from kreeq_tpu.io.sequence import Genome as JaxGenome
    from kreeq_tpu_torch.config import UserInput
    from kreeq_tpu_torch.core.dbg import DBG
    from kreeq_tpu_torch.io.sequence import Genome

    reads, asm = bench_variants.make_data(n)
    jt, pt = _tables(tmp_path, reads)
    out = []
    for ui, dbg_cls, genome, table in ((JaxUI, JaxDBG, JaxGenome(), jt),
                                       (UserInput, DBG, Genome(), pt)):
        genome.append_sequence("chr1", "", asm, 0)
        dbg = dbg_cls(ui(out_file="out.vcf"), table)
        dbg.load_genome(genome)
        out.append(dbg)
    return out


def _subgraph_dbgs(tmp_path, n, alg):
    """(JAX DBG, port DBG) of the subgraph bench's data at `n` bases."""
    from kreeq_tpu.config import UserInput as JaxUI
    from kreeq_tpu.core.dbg import DBG as JaxDBG
    from kreeq_tpu.io.sequence import Genome as JaxGenome
    from kreeq_tpu_torch.config import UserInput
    from kreeq_tpu_torch.core.dbg import DBG
    from kreeq_tpu_torch.io.sequence import Genome

    reads, asm = bench_subgraph.make_data(n)
    jt, pt = _tables(tmp_path, reads)
    out = []
    for ui, dbg_cls, genome, table in ((JaxUI, JaxDBG, JaxGenome(), jt),
                                       (UserInput, DBG, Genome(), pt)):
        genome.append_sequence("asm", "", asm, 0)
        dbg = dbg_cls(ui(kmer_len=21, trav_algorithm=alg), table)
        dbg.load_genome(genome)
        out.append(dbg)
    return out


def _paths(seg):
    return [(p.type, p.pos, p.sequence, p.ref_len)
            for grp in seg.variants for p in grp]


def test_per_position_loop_matches_script(tmp_path):
    """The port's old_dbg_to_variants on the port equals the script's on
    the JAX package: the same variants in the same order."""
    jdbg, pdbg = _variants_dbgs(tmp_path, N_SMALL)
    jseg, pseg = jdbg.genome.segments[0], pdbg.genome.segments[0]
    _script("variants").old_dbg_to_variants(jdbg, jseg)
    bench_variants.old_dbg_to_variants(pdbg, pseg)
    assert len(jseg.variants) > 50
    assert _paths(pseg) == _paths(jseg)


def test_scalar_traversal_matches_script(tmp_path):
    """The port's old_traversal on the port equals the script's on the
    JAX package, insertion order and fields included."""
    from kreeq_tpu.core import subgraph as J
    from kreeq_tpu_torch.core import subgraph as P

    jdbg, pdbg = _subgraph_dbgs(tmp_path, N_SMALL, "traversal")
    jsub, psub = J.extract_subgraph(jdbg), P.extract_subgraph(pdbg)
    seed = len(psub)
    _script("subgraph").old_traversal(jdbg, jsub)
    bench_subgraph.old_traversal(pdbg, psub)
    assert len(psub) > seed
    assert bench_subgraph.fields(psub) == bench_subgraph.fields(jsub)


RECORD_KEYS = {
    "variants": {"bench", "device", "n", "k", "snvs", "table_rows",
                 "steps_s", "table_host_copy", "search_stats",
                 "variant_groups", "paths", "batched_s_per_mbp", "speedup",
                 "identical", "b5", "launches"},
    "subgraph": {"bench", "device", "n", "k", "table_rows",
                 "assembly_bases", "seed_nodes", "traversal_nodes",
                 "best_first_nodes", "steps_s", "table_host_copy",
                 "subgraph_stats", "traversal_warm_s_per_mbp", "speedup",
                 "identical", "b5", "launches"},
}
STEPS = {
    "variants": {"db_build", "batched_warmup", "batched", "per_position"},
    "subgraph": {"db_build", "extract", "traversal_cold", "traversal_warm",
                 "scalar_traversal", "extract_best_first", "best_first",
                 "exhaustive_best_first"},
}
B5 = {"variants": {"scan_window"},
      "subgraph": {"traversal_round", "extraction"}}


def _check_record(name, rec, n):
    """The JSON record's keys, device field and invariants on the CPU."""
    assert set(rec) == RECORD_KEYS[name]
    assert rec["bench"] == name and rec["n"] == n and rec["k"] == 21
    assert rec["device"] == {"type": "cpu"}
    assert set(rec["steps_s"]) == STEPS[name]
    assert all(s >= 0 for s in rec["steps_s"].values())
    assert set(rec["b5"]) == B5[name]
    for b5 in rec["b5"].values():
        assert b5["max_abs_err"] == 0.0 and b5["q"] > 0
        assert b5["bound_ms"] > 0 and b5["sector_floor_ms"] > 0
        assert b5["ms"] is None and b5["plain_ms"] is None
    # the wrappers run their plain versions on the CPU: no launch
    assert set(rec["launches"].values()) == {0}
    # the first host lookup copies the table, in the step that made it
    assert [c["step"] for c in rec["table_host_copy"]] == (
        ["batched_warmup"] if name == "variants" else ["scalar_traversal"])
    assert json.loads(json.dumps(rec)) == rec


def test_variants_run_matches_jax(tmp_path):
    """run() holds, and its batched variants equal the JAX package's
    dbg_to_variants on the same inputs."""
    from kreeq_tpu.core.variants import dbg_to_variants

    rec, out = bench_variants.run(N_SMALL, CPU)
    _check_record("variants", rec, N_SMALL)
    assert rec["identical"] == {"variants": True}
    assert rec["search_stats"]["branch_points"] > 0
    jdbg, _pdbg = _variants_dbgs(tmp_path, N_SMALL)
    jseg = jdbg.genome.segments[0]
    dbg_to_variants(jdbg, jseg)
    assert out["variants"] == _paths(jseg)
    assert rec["paths"] == len(out["variants"]) > 50


def test_subgraph_run_matches_jax(tmp_path):
    """run() holds, and its batched traversal and best-first equal the
    JAX package's on the same inputs."""
    from kreeq_tpu.core import subgraph as J

    rec, out = bench_subgraph.run(N_SMALL, CPU)
    _check_record("subgraph", rec, N_SMALL)
    assert rec["identical"] == {"traversal": True, "best_first": True}
    assert rec["traversal_nodes"] > rec["seed_nodes"]
    # the largest round of this genome probes the two flank ends
    assert rec["b5"]["traversal_round"]["q"] == 2
    # ceil(21 / 2) rounds, each probing and finding the two ends
    st = rec["subgraph_stats"]
    assert [r["q"] for r in st["rounds"]] == [2] * 11
    assert st["round_nodes"] == 22
    jdbg, _pdbg = _subgraph_dbgs(tmp_path, N_SMALL, "traversal")
    jsub = J.extract_subgraph(jdbg)
    J.traversal(jdbg, jsub)
    assert out["traversal"] == bench_subgraph.fields(jsub)
    jdbg.ui.trav_algorithm = "best-first"
    assert out["best_first"] == list(J.best_first(jdbg,
                                                  J.extract_subgraph(jdbg)))


def _drop_last(fn):
    """fn, whose batched result then loses its last node or variant
    group."""
    def dropped(dbg, arg):
        fn(dbg, arg)
        if isinstance(arg, dict):
            arg.popitem()
        else:
            arg.variants = list(arg.variants)[:-1]
    return dropped


@pytest.mark.parametrize("name,module,attr,match", [
    ("subgraph", "kreeq_tpu_torch.core.subgraph", "traversal",
     "order mismatch"),
    ("variants", "kreeq_tpu_torch.core.variants", "dbg_to_variants",
     "batched result differs"),
])
def test_dropped_result_raises(monkeypatch, name, module, attr, match):
    """A batched path that drops one node (or one variant group) makes
    run() raise."""
    mod = sys.modules[module]
    monkeypatch.setattr(mod, attr, _drop_last(getattr(mod, attr)))
    with pytest.raises(AssertionError, match=match):
        MODULES[name].run(N_SMALL, CPU)


_FRESH = """
import json, sys
from kreeq_tpu_torch import bench_{name} as mod
mod.N = {n}
mod.main()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kreeq_tpu"))
print("bad", bad)
"""


@pytest.mark.parametrize("name", ["variants", "subgraph"])
def test_main_imports_no_jax(name):
    """main() in a fresh interpreter (KREEQ_TPU_PLATFORM=cpu, a small
    genome) prints the script's lines and a JSON record, and imports
    neither jax nor the JAX package."""
    env = dict(os.environ, KREEQ_TPU_PLATFORM="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _FRESH.format(name=name, n=N_SMALL)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[-1] == "bad []"
    _check_record(name, json.loads(lines[-2]), N_SMALL)
    first = {"variants": ["DB build: ", "batched: ", "per-position: ",
                          "speedup: ", "outputs identical"],
             "subgraph": ["DB build: ", "seed subgraph: ",
                          "batched traversal (cold): ",
                          "batched traversal (warm): ",
                          "scalar traversal: ", "speedup: ",
                          "prefiltered best-first: ",
                          "exhaustive best-first: ",
                          "best-first speedup: "]}[name]
    assert [line.split(":")[0] + ": " if ":" in line else line
            for line in lines[:len(first)]] == first


@pytest.mark.parametrize("name", ["variants", "subgraph"])
def test_module_without_card_fails(name):
    """`python -m` with no card visible and no KREEQ_TPU_PLATFORM: a
    non-zero exit whose error names the missing card, and no record."""
    env = {k: v for k, v in os.environ.items() if k != "KREEQ_TPU_PLATFORM"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m",
                          f"kreeq_tpu_torch.bench_{name}"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""
