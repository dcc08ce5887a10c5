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
