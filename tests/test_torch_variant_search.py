"""The variant search's dispatch and the decoder of its kernel's path
records (CPU): the host search runs on the CPU and against a
host-resident table, with an unchanged VCF; the card's kernel
(ops/csrc/variant_search.cu) is chosen for a device-form table on CUDA,
at any search depth; its packed records decode to the host search's
path lists; the JAX package's paths on the cases the card tests hold
the kernel to (tests/variant_search_jax.json) are still the JAX
package's, and the port's host search gives them.  The kernel itself
runs in tests/test_torch_variant_search_cuda.py, on the card."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kqbench import kinds

from tests.polish_inputs import (JAX_CASES, case_inputs, jax_digests, make,
                                 paths_digest, port_vcf, table,
                                 variant_paths)

VCF = kinds.find("vcf")


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")


@pytest.mark.parametrize("rows_cap", [None, "20000"])
def test_host_search_on_cpu(tmp_path, cpu, monkeypatch, rows_cap):
    """In core and with the table held on the host (out of core): the
    host search, no kernel, and the reference's VCF."""
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.utils import log

    if rows_cap:
        monkeypatch.setenv("KREEQ_TPU_MAX_TABLE_ROWS", rows_cap)
    inputs = make(tmp_path, 4200002201)
    before = kernels.LAUNCHES["variant_search"]
    got = port_vcf(tmp_path, inputs, 21)
    c = log.jobs[-1]["counters"]
    assert ("kq.ooc.upload" in log.jobs[-1]["spans"]) == bool(rows_cap)
    assert c["variants.branch_points"] > 0
    assert c["variants.device_searches"] == 0
    assert kernels.LAUNCHES["variant_search"] == before
    assert got == VCF.expected(table(inputs, 21), inputs.records, None)


def _dbg(device, on_host=False, depth=-1, k=21):
    """A stand-in DBG: a table on `device` (in the host form when
    on_host) and a search depth (-1: k, best-first)."""
    from kreeq_tpu_torch.config import UserInput

    tab = SimpleNamespace(device=torch.device(device),
                          window_ranges=lambda: [(0, 1)] if on_host else None)
    return SimpleNamespace(table=tab, ui=UserInput(kmer_len=k,
                                                   kmer_depth=depth))


@pytest.mark.parametrize("device, on_host, depth, k, want", [
    ("cuda", False, -1, 21, True),   # the polishing cell
    ("cuda", False, -1, 32, True),
    ("cuda", False, 62, 21, True),   # the deepest in shared memory
    ("cuda", False, 0, 21, True),
    ("cuda", False, 63, 21, True),   # the state in a global buffer
    ("cuda", True, -1, 21, False),   # out of core
    ("cpu", False, -1, 21, False),
])
def test_device_search_dispatch(device, on_host, depth, k, want):
    from kreeq_tpu_torch.core.variants import _device_search

    assert _device_search(_dbg(device, on_host, depth, k)) is want


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_paths_digest(tmp_path, cpu, name):
    """The digests the card tests hold the kernel to are the JAX
    package's dbg_to_variants paths on the same inputs, and the port's
    host search (whose paths PathGroups packs) gives them too."""
    inputs = case_inputs(tmp_path, name)
    want = jax_digests()[name]
    assert paths_digest(variant_paths("kreeq_tpu", inputs, name)) == want
    assert paths_digest(variant_paths("kreeq_tpu_torch", inputs, name,
                                      "cpu")) == want
    assert want["paths"] > 700


def test_kernel_wrapper_refuses_cpu_tensors():
    from kreeq_tpu_torch.ops.kernels import variant_search_cuda

    z = torch.zeros(4, dtype=torch.int64)
    e = torch.zeros((4, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        variant_search_cuda(z, e, e, z, z.bool(), e, e, z[:0], 0, 4, 21, 5,
                            0, 21)


def _recs(*rows):
    return np.array(rows, np.int64).reshape(-1, 5)


@pytest.mark.parametrize("case", ["types", "several", "repeat", "none"])
def test_path_groups_decode(case):
    """Hand-made kernel records: (pos, type, ref_len, bases, offset),
    types 0 SNV, 1 INS, 2 DEL, 3 COM, bases as codes 0-3; a branch
    point's records together in destination order, the branch points
    in any order of the pool."""
    from kreeq_tpu_torch.core.variants import DBGpath, PathGroups

    bases = np.array([0, 1, 2, 3, 3, 2, 1], np.uint8)  # ACGTTGC
    if case == "types":
        # pool order 60, 22, 41, 90: read in position order
        recs = _recs((60, 2, 1, 2, 2), (22, 0, 1, 1, 0), (41, 1, 1, 0, 7),
                     (90, 3, 4, 3, 4))
        want = [[DBGpath("SNV", 22, "A", 1)], [DBGpath("INS", 41, "", 1)],
                [DBGpath("DEL", 60, "GT", 1)], [DBGpath("COM", 90, "TGC", 4)]]
    elif case == "several":
        # two branch points, the later one first in the pool: each
        # keeps its destination order
        recs = _recs((75, 3, 2, 2, 5), (75, 0, 1, 1, 1), (75, 2, 1, 1, 0),
                     (30, 0, 1, 1, 3), (30, 0, 1, 1, 2))
        want = [[DBGpath("SNV", 30, "T", 1), DBGpath("SNV", 30, "G", 1)],
                [DBGpath("COM", 75, "GC", 2), DBGpath("SNV", 75, "C", 1),
                 DBGpath("DEL", 75, "A", 1)]]
    elif case == "repeat":
        # the same destination twice: two equal records, both kept
        recs = _recs((33, 0, 1, 1, 4), (33, 0, 1, 1, 4))
        want = [[DBGpath("SNV", 33, "T", 1), DBGpath("SNV", 33, "T", 1)]]
    else:
        recs, bases = _recs(), bases[:0]
        want = []
    groups = PathGroups()
    groups.add(recs, bases)
    assert list(groups) == want and len(groups) == len(want)
    assert bool(groups) == bool(want)
    assert list(groups) == want  # read again


def test_path_groups_across_windows():
    """Windows added in position order read as one list; a window
    without records adds nothing."""
    from kreeq_tpu_torch.core.variants import DBGpath, PathGroups

    groups = PathGroups()
    groups.add(_recs((50, 0, 1, 1, 1), (10, 1, 1, 0, 0)),
               np.array([3, 2], np.uint8))
    groups.add(_recs(), np.zeros(0, np.uint8))
    groups.add(_recs((4100, 2, 1, 2, 0), (4100, 0, 1, 1, 2)),
               np.array([0, 0, 1], np.uint8))
    want = [[DBGpath("INS", 10, "", 1)], [DBGpath("SNV", 50, "G", 1)],
            [DBGpath("DEL", 4100, "AA", 1), DBGpath("SNV", 4100, "C", 1)]]
    assert list(groups) == want and len(groups) == 3
