"""PyTorch port, the variant search kernel (ops/csrc/variant_search.cu)
on the card against the host search (core/variants._search_from_scan)
through the CLI's `validate -d db -f draft -o x.vcf` on drafts made by
the polishing configuration's generator (tests/polish_inputs.py): the
VCFs byte for byte (and a bubble graph, `-o x.gfa`), and the counters
variants.branch_points, .lookups, .cache_hits and .paths equal, at k =
21, 31 and 32 on three seeds, across scan windows of 4,096 positions,
at cutoffs 0 and 3, spans 4 and 5 on a draft with a planted 5-base
insertion (COM), search depths 3, 62 (the deepest held in shared
memory), 63 and 250 (held in a global buffer, also in launches of a
few searches each) and 1,300 at k = 7 (the heap's 1,000-node
eviction), on a draft with N runs, with pools too small for
the first launch; a run with no branch point launches nothing; the
kernel's paths against the JAX package's dbg_to_variants on five cases
(k = 21, 31, 32, the COM, depth 100; their digests in
tests/variant_search_jax.json, which the CPU tests hold to the JAX
package), and one seed against the benchmark's plain reference
(kqbench/reference/variants.py).  Needs a CUDA device (the `gpu`
marker); run on the card with

    python -m pytest --noconftest tests/test_torch_variant_search_cuda.py -m gpu

(--noconftest: tests/conftest.py configures JAX, which the port does not
need.)
"""

import ctypes
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kqbench import kinds
from kqbench.gen.genome_reads import _write_fasta

from tests.polish_inputs import (JAX_CASES, case_inputs, cli, insert,
                                 jax_digests, make, paths_digest, table,
                                 variant_paths)

pytestmark = pytest.mark.gpu

VCF = kinds.find("vcf")
COUNTERS = ("variants.branch_points", "variants.lookups",
            "variants.cache_hits", "variants.paths")


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.delenv("KREEQ_TPU_PLATFORM", raising=False)
    monkeypatch.delenv("KREEQ_TPU_VARIANTS_WINDOW", raising=False)
    return torch.device("cuda")


def _job(work, inputs, k: int, name: str, opts):
    """One `-d -f -o name` job on the card (the DB built from the
    inputs' reads first): (the output's bytes, the job's counters, the
    kernel's launches)."""
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.utils import log

    db = os.path.join(str(work), "reads.kreeq")
    if not os.path.exists(db):
        cli("validate", "-r", inputs.files["reads"], "-k", str(k), "-o", db)
    out = os.path.join(str(work), name)
    before = kernels.LAUNCHES["variant_search"]
    cli("validate", "-d", db, "-f", inputs.files["asm"], "-o", out, *opts)
    with open(out, "rb") as fh:
        data = fh.read()
    return (data, log.jobs[-1]["counters"],
            kernels.LAUNCHES["variant_search"] - before)


def _host(work, inputs, k: int, opts, ext: str = "vcf"):
    """The same job with the host search."""
    from kreeq_tpu_torch.core import variants

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(variants, "_device_search", lambda dbg: False)
        return _job(work, inputs, k, "host." + ext, opts)


def _both(work, inputs, k: int = 21, *opts, ext: str = "vcf"):
    """The kernel's job and the host's: equal outputs and counters;
    every branch point searched on the card, none by the host.  Returns
    the kernel's (output, counters, launches)."""
    card = _job(work, inputs, k, "card." + ext, opts)
    host = _host(work, inputs, k, opts, ext)
    assert card[0] == host[0]
    for name in COUNTERS:
        assert card[1][name] == host[1][name], name
    assert card[1]["variants.device_searches"] == \
        card[1]["variants.branch_points"] > 0
    assert card[2] >= 1
    assert host[1]["variants.device_searches"] == 0 and host[2] == 0
    return card


@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("seed", [4200002201, 4200002202, 4200002203])
def test_kernel_equals_host(tmp_path, cuda, seed, k):
    vcf, c, launches = _both(tmp_path, make(tmp_path, seed, k), k)
    assert vcf.count(b"\n") > 100 and c["variants.paths"] > 100
    assert launches == 1  # one scan window


def test_kernel_equals_host_across_scan_windows(tmp_path, cuda,
                                                monkeypatch):
    monkeypatch.setenv("KREEQ_TPU_VARIANTS_WINDOW", "4096")
    _vcf, _c, launches = _both(tmp_path, make(tmp_path, 4200002204))
    assert launches == 8  # 31,980 positions in windows of 4,096


@pytest.mark.parametrize("cutoff", ["0", "3"])
def test_kernel_equals_host_at_cutoff(tmp_path, cuda, cutoff):
    _both(tmp_path, make(tmp_path, 4200002205), 21, "-c", cutoff)


@pytest.mark.parametrize("span", ["4", "5"])
def test_kernel_equals_host_at_span_with_insertion(tmp_path, cuda, span):
    inputs = insert(make(tmp_path, 4200002206), 16_000, 5)
    vcf, _c, _l = _both(tmp_path, inputs, 21, "--max-span", span)
    # the insertion's COM record needs the fifth target
    assert (b"\t16001\t.\t" in vcf) == (span == "5")


@pytest.mark.parametrize("depth", ["3", "62", "63", "250"])
def test_kernel_equals_host_at_depth(tmp_path, cuda, depth):
    _both(tmp_path, make(tmp_path, 4200002207), 21, "--search-depth", depth)


def test_deep_searches_in_several_launches(tmp_path, cuda, monkeypatch):
    """A global buffer that holds 40 searches of depth 63: many
    launches of two blocks of 20, with the same VCF."""
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops._build import library

    per = ctypes.c_int64()
    assert library().kq_variant_search_bytes(
        63, 10 ** 6, ctypes.addressof(per)) == 0 and per.value > 0
    monkeypatch.setattr(kernels, "VARIANT_SEARCH_STATE_BYTES",
                        40 * per.value)
    _both(tmp_path, make(tmp_path, 4200002210), 21, "--search-depth", "63")


def test_kernel_equals_host_with_evictions(tmp_path, cuda, monkeypatch):
    """k = 7 on a 60-kbp random genome (nearly every 7-mer, four edges
    each) at depth 1,300: the host's heap reaches its 1,000 nodes and
    evicts; the kernel's VCF and counters are still the host's."""
    from kreeq_tpu_torch.core import fibheap

    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), 60_000))
    reads = os.path.join(str(tmp_path), "r.fa")
    with open(reads, "w") as fh:
        for i in range(0, 60_000 - 150, 30):
            fh.write(f">r{i}\n{genome[i:i + 150]}\n")
    draft = list(genome[:16])
    draft[8] = "ACGT"[("ACGT".index(draft[8]) + 1) % 4]
    asm = os.path.join(str(tmp_path), "a.fa")
    with open(asm, "w") as fh:
        fh.write(">a\n" + "".join(draft) + "\n")
    peak = []
    insert_ = fibheap.FibonacciHeap.insert

    def counted(heap, obj, key):
        peak.append(heap.n)
        return insert_(heap, obj, key)

    monkeypatch.setattr(fibheap.FibonacciHeap, "insert", counted)
    inputs = SimpleNamespace(files={"reads": reads, "asm": asm})
    _both(tmp_path, inputs, 7, "--search-depth", "1300")
    assert max(peak) == 1000


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_kernel_equals_jax(tmp_path, cuda, name):
    """The kernel's paths are the JAX package's (by their digest)."""
    from kreeq_tpu_torch.ops import kernels

    before = kernels.LAUNCHES["variant_search"]
    got = variant_paths("kreeq_tpu_torch", case_inputs(tmp_path, name),
                        name, "cuda")
    assert kernels.LAUNCHES["variant_search"] == before + 1
    assert paths_digest(got) == jax_digests()[name]


def test_kernel_equals_host_on_n_runs(tmp_path, cuda):
    inputs = make(tmp_path, 4200002208)
    name, seq = inputs.records[0]
    for at, n in ((5_000, 1), (12_000, 30), (20_000, 200), (31_990, 10)):
        seq = seq[:at] + b"N" * n + seq[at + n:]
    inputs.records = [(name, seq)]
    _write_fasta(inputs.files["asm"], inputs.records, 80)
    _both(tmp_path, inputs)


def test_bubble_graph_equals_host(tmp_path, cuda):
    """`-o x.gfa` splits the draft at the same variants."""
    gfa, _c, _l = _both(tmp_path, make(tmp_path, 4200002213), ext="gfa")
    assert gfa.count(b"\nS\t") > 100


def test_small_pools_launch_again(tmp_path, cuda, monkeypatch):
    from kreeq_tpu_torch.ops import kernels

    inputs = make(tmp_path, 4200002209)
    monkeypatch.setattr(kernels, "_pool_sizes", lambda n: (1, 1))
    _vcf, _c, launches = _both(tmp_path, inputs)
    assert launches == 2


def test_no_branch_point_launches_nothing(tmp_path, cuda):
    """Reads that are the draft itself: no k-mer branches."""
    inputs = make(tmp_path, 4200002211)
    rng = np.random.default_rng(4200002211)
    seq = bytes(rng.choice(list(b"ACGT"), 3000).astype(np.uint8))
    inputs.records = [("draft", seq)]
    _write_fasta(inputs.files["asm"], inputs.records, 80)
    with open(inputs.files["reads"], "w") as fh:
        fh.write(f"@r\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    vcf, c, launches = _job(tmp_path, inputs, 21, "none.vcf", [])
    assert c["variants.branch_points"] == 0 and launches == 0
    assert not [line for line in vcf.splitlines()
                if not line.startswith(b"#")]


def test_kernel_equals_reference(tmp_path, cuda):
    inputs = make(tmp_path, 4200002212)
    vcf, _c, launches = _job(tmp_path, inputs, 21, "card.vcf", [])
    assert launches == 1
    want = VCF.expected(table(inputs, 21), inputs.records, None)
    assert VCF.values_off(vcf, want) == 0
    assert vcf == want
