"""The port's `validate -d db -f draft -o x.vcf` against the benchmark's
plain reference of kreeq's error search (kqbench/reference/variants.py,
the `vcf` kind), byte for byte, on small drafts made by the polishing
configuration's generator; and the faults the comparison must catch
(CPU; plain versions of the kernels)."""

import heapq

import pytest

from kqbench import kinds
from kqbench.gen.genome_reads import _write_fasta
from kqbench.reference import variants as ref

from tests.polish_inputs import make, port_vcf, table

VCF = kinds.find("vcf")


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")


@pytest.mark.parametrize("k", [21, 31])
@pytest.mark.parametrize("seed", [4200002101, 4200002102, 4200002103])
def test_port_vcf_equals_reference(tmp_path, cpu, seed, k):
    inputs = make(tmp_path, seed, k)
    got = port_vcf(tmp_path, inputs, k)
    want = VCF.expected(table(inputs, k), inputs.records, None)
    assert want.count(b"\n") > 100  # read errors' side paths
    assert got == want
    assert VCF.values_off(got, want) == 0


def test_port_vcf_equals_reference_across_scan_windows(tmp_path, cpu,
                                                       monkeypatch):
    # the port's scan windows of 4,096 positions: their halos are crossed
    monkeypatch.setenv("KREEQ_TPU_VARIANTS_WINDOW", "4096")
    inputs = make(tmp_path, 4200002104)
    got = port_vcf(tmp_path, inputs, 21)
    assert got == VCF.expected(table(inputs, 21), inputs.records, None)


def _insert(inputs, at: int, n: int):
    """The inputs with a run of n bases inserted into the draft at `at`,
    of a base that is neither the one before nor the one after, so that
    no read holds a k-mer that covers a base of the run."""
    name, seq = inputs.records[0]
    base = next(b for b in b"ACGT" if b not in seq[at - 1:at + 1])
    inputs.records = [(name, seq[:at] + bytes([base]) * n + seq[at:])]
    _write_fasta(inputs.files["asm"], inputs.records, 80)
    return inputs


def test_max_span_4_is_caught(tmp_path, cpu):
    # five draft bases no read holds: the reads reconnect at the fifth
    # target, which a span of 4 leaves out of the window
    inputs = _insert(make(tmp_path, 4200002105), 16_000, 5)
    got = port_vcf(tmp_path, inputs, 21)
    t = table(inputs, 21)
    want = VCF.expected(t, inputs.records, None)
    assert got == want
    # the COM record of the insertion: the five bases, then the base
    # after them
    assert b"\t16001\t.\t" in want
    assert VCF.values_off(got, ref.vcf(t, inputs.records, max_span=4)) > 0


class KeyOrderHeap:
    """A heap that pops the least (priority, k-mer key)."""

    def __init__(self):
        self.h = []

    def size(self):
        return len(self.h)

    def insert(self, obj, key):
        heapq.heappush(self.h, (key, obj))

    def extract_min(self):
        return heapq.heappop(self.h)[1]

    def decrease_key(self, obj, key):
        pass


def test_heap_order_and_a_dropped_record_are_caught(tmp_path, cpu):
    inputs = make(tmp_path, 4200002101)
    got = port_vcf(tmp_path, inputs, 21)
    t = table(inputs, 21)
    assert VCF.values_off(got, ref.vcf(t, inputs.records,
                                       heap=KeyOrderHeap)) > 0
    lines = got.splitlines(keepends=True)
    dropped = b"".join(lines[:10] + lines[11:])
    assert VCF.values_off(dropped, got) > 0


def test_reference_heap_extracts_in_fibonacci_order():
    # all-equal priorities: the order is the splice and consolidate
    # mechanics', not insertion or key order
    h = ref.FibonacciHeap()
    h.insert("s", 1)
    out = [h.extract_min()]
    for x in "abcdef":
        h.insert(x, 0)
    out.append(h.extract_min())
    for x in "gh":
        h.insert(x, 0)
    while h.size():
        out.append(h.extract_min())
    assert sorted(out) == sorted("sabcdefgh")
    assert out != ["s", *"abcdefgh"] and out != ["s", *"hgfedcba"]
    # bounded: at max_nodes an insert evicts one node first
    small = ref.FibonacciHeap(max_nodes=4)
    for x in range(6):
        small.insert(x, 0)
    assert small.size() == 4
