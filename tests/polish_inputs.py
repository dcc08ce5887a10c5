"""Small polishing inputs for the CPU tests: the benchmark's polishing
configuration (kqbench/configs/ecoli_k12_hifi30x_k21_polish1m.json)
on a 40-kbp genome with 3-kb HiFi reads at 30x, the port's `-d -f -o
x.vcf` on them, and a reference table at any k <= 32."""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "kqbench", "configs",
                      "ecoli_k12_hifi30x_k21_polish1m.json")
GENOME = 40_000
DRAFT = (0, 32_000)


def config(k: int = 21) -> dict:
    with open(CONFIG) as fh:
        cfg = json.load(fh)
    cfg["k"] = k
    cfg["genome"]["sequences"][0]["length"] = GENOME
    cfg["genome"]["dispersed"] = [{"name": "IS5", "length": 1195,
                                   "copies": 3}]
    cfg["reads"].update(length_mean=3000, length_sd=600, length_min=1000,
                        length_max=5000)
    cfg["draft"]["start"], cfg["draft"]["end"] = DRAFT
    return cfg


def make(work: str, seed: int, k: int = 21):
    from kqbench import gen

    return gen.make(config(k), seed, str(work))


def table(inputs, k: int):
    """The reference Table of the inputs' reads at any k <= 32, counted
    with reference/kmers' windows and edge bits in one pass."""
    from kqbench.reference.kmers import Table, edge_bits, separated, windows

    w = windows(separated(inputs.reads, inputs.offsets), k)
    keys = w.key[w.valid]
    bits = edge_bits(w)[w.valid]
    uniq, inv = np.unique(keys, return_inverse=True)
    cov = np.bincount(inv, minlength=len(uniq)).astype(np.uint64)
    edges = np.stack([np.bincount(inv, weights=(bits >> b) & 1,
                                  minlength=len(uniq))
                      for b in range(8)], 1).astype(np.uint64)
    return Table(k, uniq, cov, edges[:, :4], edges[:, 4:])


def cli(*argv) -> str:
    from kreeq_tpu_torch.cli.main import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run(["kreeq", *argv]) == 0
    return buf.getvalue()


def port_vcf(work, inputs, k: int) -> bytes:
    """The port's `-d reads.kreeq -f asm -o asm.vcf`, the DB built from
    the inputs' reads first."""
    db = os.path.join(str(work), "reads.kreeq")
    if not os.path.exists(db):
        cli("validate", "-r", inputs.files["reads"], "-k", str(k), "-o", db)
    out = os.path.join(str(work), "asm.vcf")
    cli("validate", "-d", db, "-f", inputs.files["asm"], "-o", out)
    with open(out, "rb") as fh:
        return fh.read()


def insert(inputs, at: int, n: int):
    """The draft with a run of n bases no read holds inserted at `at`
    (tests/test_torch_polish_vcf.py's plant)."""
    from kqbench.gen.genome_reads import _write_fasta

    name, seq = inputs.records[0]
    base = next(b for b in b"ACGT" if b not in seq[at - 1:at + 1])
    inputs.records = [(name, seq[:at] + bytes([base]) * n + seq[at:])]
    _write_fasta(inputs.files["asm"], inputs.records, 80)
    return inputs


# The variant search cases held against the JAX package: the digests of
# its dbg_to_variants paths, kept in JAX_PATHS (the card has no JAX);
# tests/test_torch_variant_search.py checks them against the JAX
# package, tests/test_torch_variant_search_cuda.py the kernel against
# them.  Options are UserInput fields.
JAX_PATHS = os.path.join(ROOT, "tests", "variant_search_jax.json")
JAX_CASES = {
    "k21": dict(seed=4200002201, k=21),
    "k31": dict(seed=4200002202, k=31),
    "k32": dict(seed=4200002203, k=32),
    "com": dict(seed=4200002206, k=21, insert=(16_000, 5)),
    "depth100": dict(seed=4200002207, k=21, kmer_depth=100),
}


def case_inputs(work, name: str):
    case = JAX_CASES[name]
    inputs = make(work, case["seed"], case["k"])
    if "insert" in case:
        insert(inputs, *case["insert"])
    return inputs


def variant_paths(pkg: str, inputs, name: str, device=None) -> list:
    """`pkg`'s dbg_to_variants (kreeq_tpu, or kreeq_tpu_torch with its
    table on `device`) on a case's draft against its reads: per segment,
    (type, pos, sequence, ref_len) of every path."""
    import importlib

    case = JAX_CASES[name]
    k = case["k"]
    opts = {key: v for key, v in case.items()
            if key not in ("seed", "k", "insert")}
    mod = {m: importlib.import_module(f"{pkg}.{m}")
           for m in ("config", "core.dbg", "core.table", "core.variants",
                     "io.fastx", "io.sequence")}
    ui = mod["config"].UserInput(in_sequence=inputs.files["asm"], kmer_len=k,
                                 **opts)
    reads = [inputs.files["reads"]]
    table = (mod["core.table"].KmerTable.from_reads(reads, k)
             if device is None
             else mod["core.table"].KmerTable.from_reads(reads, k, device))
    dbg = mod["core.dbg"].DBG(ui, table)
    genome = mod["io.sequence"].Genome()
    mod["io.fastx"].load_genome(inputs.files["asm"], genome)
    dbg.load_genome(genome)
    out = []
    for seg in dbg.genome.segments:
        mod["core.variants"].dbg_to_variants(dbg, seg)
        out.append([[p.type, p.pos, p.sequence, p.ref_len]
                    for grp in seg.variants for p in grp])
    return out


def paths_digest(paths: list) -> dict:
    import hashlib

    return {"paths": sum(len(s) for s in paths),
            "sha256": hashlib.sha256(json.dumps(paths).encode()).hexdigest()}


def jax_digests() -> dict:
    with open(JAX_PATHS) as fh:
        return json.load(fh)


def write_jax_digests(work) -> None:
    """Rewrite JAX_PATHS from the JAX package (needs jax)."""
    out = {}
    for name in JAX_CASES:
        sub = os.path.join(str(work), name)
        os.makedirs(sub, exist_ok=True)
        out[name] = paths_digest(variant_paths(
            "kreeq_tpu", case_inputs(sub, name), name))
    with open(JAX_PATHS, "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
