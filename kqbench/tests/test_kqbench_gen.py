"""The generator: the same seed gives the same inputs, and the inputs
have the stated lengths, composition and copy numbers."""

import os

import numpy as np
import pytest

from kqbench import gen, spec
from kqbench.gen import genome_reads

from kq_tiny import LONG_READS, SHORT_READS, config


@pytest.mark.parametrize("reads", [SHORT_READS, LONG_READS],
                         ids=["short", "long"])
def test_same_seed_same_inputs(tmp_path, reads):
    a, b, c = (tmp_path / n for n in "abc")
    for d in (a, b, c):
        d.mkdir()
    x = gen.make(config(reads), 2 ** 33 + 5, str(a))
    y = gen.make(config(reads), 2 ** 33 + 5, str(b))
    z = gen.make(config(reads), 2 ** 33 + 6, str(c))
    for role in ("reads", "asm"):
        assert (a / f"{os.path.basename(x.files[role])}").read_bytes() == \
            (b / f"{os.path.basename(y.files[role])}").read_bytes()
    assert np.array_equal(x.reads, y.reads)
    assert x.records == y.records
    assert not np.array_equal(x.reads[:1000], z.reads[:1000])
    # every seed gets the same amount of work
    assert x.sizes == z.sizes


@pytest.mark.parametrize("reads", [SHORT_READS, LONG_READS],
                         ids=["short", "long"])
def test_reads_and_assembly(tmp_path, reads):
    cfg = config(reads)
    inp = gen.make(cfg, 11, str(tmp_path))
    lens = {s["name"]: s["length"] for s in cfg["genome"]["sequences"]}
    for name, seq in inp.records:
        # planted errors: as many insertions as deletions, give or take one
        assert abs(len(seq) - lens[name]) <= 1
    # 30x of every copy, the tandem array at its genome copy number
    t = cfg["genome"]["tandem"][0]
    source = sum(lens.values()) - lens["m"] + 20 * lens["m"] \
        + (t["genome_copies"] - t["assembly_copies"]) * t["unit"]
    assert inp.sizes["read_bases"] == pytest.approx(30 * source, rel=0.01)
    # the FASTQ holds exactly these reads
    lines = (tmp_path / "reads.fq").read_bytes().split(b"\n")
    seqs = lines[1::4]
    assert len(seqs) == len(inp.offsets) - 1
    o = inp.offsets
    for i in (0, len(seqs) // 2, len(seqs) - 1):
        got = np.frombuffer(seqs[i], np.uint8)
        assert np.array_equal(genome_reads.ASCII[inp.reads[o[i]:o[i + 1]]],
                              got)


def test_composition_and_copies():
    cfg = config(SHORT_READS)
    cfg["genome"]["sequences"][0]["length"] = 400_000
    asm, source, copies = genome_reads.genome(cfg, np.random.default_rng(3))
    c1 = asm["c1"]
    gc = np.isin(c1, (1, 2)).mean()
    assert gc == pytest.approx(0.4, abs=0.01)
    assert np.isin(asm["m"], (1, 2)).mean() == pytest.approx(0.2, abs=0.03)
    assert copies == {"c1": 1, "c2": 1, "m": 20}
    t = cfg["genome"]["tandem"][0]
    unit = c1[t["start"]:t["start"] + t["unit"]]
    assert np.array_equal(c1[t["start"] + t["unit"]:t["start"]
                             + 2 * t["unit"]], unit)
    assert len(source["c1"]) == len(c1) + 13 * t["unit"]


def test_dispersed_copies():
    cfg = config(SHORT_READS)
    cfg["genome"]["tandem"] = []
    asm, _source, _copies = genome_reads.genome(cfg, np.random.default_rng(4))
    # a 40-mer seen twice lies in two copies of the repeat
    seen = {}
    for name in ("c1", "c2"):
        win = np.lib.stride_tricks.sliding_window_view(asm[name], 40)
        for w in win[::7]:
            seen[bytes(w)] = seen.get(bytes(w), 0) + 1
    probe = np.frombuffer(next(k for k, v in seen.items() if v >= 2),
                          np.uint8)
    hits = 0
    for name in ("c1", "c2"):
        win = np.lib.stride_tricks.sliding_window_view(asm[name], 40)
        hits += int((win == probe).all(1).sum()
                    + (win == 3 - probe[::-1]).all(1).sum())
    assert hits == cfg["genome"]["dispersed"][0]["copies"]


@pytest.mark.parametrize("name", ["yeast_r64_il30x_k21",
                                  "ecoli_k12_hifi30x_k21"])
def test_published_layout(name):
    bench = spec.load()
    _path, cfg = spec.config(bench, name)
    total = sum(s["length"] for s in cfg["genome"]["sequences"])
    assert total == {"yeast_r64_il30x_k21": 12_157_105,
                     "ecoli_k12_hifi30x_k21": 4_641_652}[name]
    assert cfg["k"] == 21 and cfg["reduced"] == []
    assert cfg["name"] == name and cfg["source"] == next(
        c["source"] for c in bench["configs"] if c["name"] == name)
