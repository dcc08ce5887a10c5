"""Wrappers of the CUDA kernels of the main path.

Each wrapper dispatches on the device of its tensors: CPU tensors go to
the plain PyTorch version (ops/kmers.py, ops/validate.py), CUDA tensors
to the hand-written kernel (ops/csrc/), and any other device raises.
On CUDA the wrapper checks its inputs, allocates every output and
scratch buffer, launches on the current stream and raises if the launch
failed; nothing falls back to the plain version.  LAUNCHES counts the
kernel launches of each wrapper, so a run can show that it went through
the kernels.

  count_runs_cuda  <- csrc/count_runs.cu    (TPU: pallas_kernels._kernel)
  merge_sorted_cuda <- csrc/merge_sorted.cu (TPU: _merge_kernel2)
  probe_qv_cuda    <- csrc/probe_qv.cu      (TPU: _probe_kernel_ind)
  probe_select_cuda <- csrc/probe_select.cu (TPU: _probe_kernel_sel2)
  probe_sorted_cuda <- csrc/probe_sorted.cu (TPU: _probe_kernel)
  extract_cuda     <- csrc/kmer_extract.cu  (TPU: the jitted kmer_positions
                      and validate._extract_ctx / _extract_ctx_qv, XLA
                      fusions rather than a pl.pallas_call)
  sort_records_cuda <- csrc/sort_records.cu (TPU: jax.lax.sort in
                      kmers._sort_keys_edges, an XLA sort)

count_chunk_cuda is the count step of one chunk: the extraction's count
form, the sort, then count_runs.

The three probes search through the table's bucket directory
(ops/index.py, `KmerTable.bucket_index`), which their callers pass on
CUDA; without it they raise.
"""

from __future__ import annotations

import torch

from . import kmers as K
from . import validate as V

LAUNCHES = {"count": 0, "merge": 0, "probe_qv": 0, "probe_select": 0,
            "probe_sorted": 0, "extract": 0, "sort": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or
    on any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor "
                         f"of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} (contiguous: "
                         f"{t.is_contiguous()})")


def _check_table(name, keys, cov, fw, bw) -> int:
    n = keys.shape[0]
    _check(name + " keys", keys, torch.int64, (n,))
    _check(name + " cov", cov, torch.int64, (n,))
    _check(name + " fw", fw, torch.int64, (n, 4))
    _check(name + " bw", bw, torch.int64, (n, 4))
    return n


def _ptrs(*tensors: torch.Tensor):
    return [t.data_ptr() for t in tensors]


def _launch(name: str, fn, *args) -> None:
    from ._build import library

    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        msg = library().kq_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def count_runs_cuda(skeys, sedges):
    """Run-aggregation of key-sorted records (see kmers.count_runs for
    the contract).  CUDA tensors: the count_runs kernel."""
    if not _on_cuda("count_runs", skeys, sedges):
        return K.count_runs(skeys, sedges)
    from ._build import library

    lib = library()
    p = skeys.shape[0]
    _check("count_runs skeys", skeys, torch.int64, (p,))
    _check("count_runs sedges", sedges, torch.uint8, (p,))
    dev = skeys.device
    okeys = torch.empty(p, dtype=torch.int64, device=dev)
    ocov = torch.empty(p, dtype=torch.int64, device=dev)
    ofw = torch.empty((p, 4), dtype=torch.int64, device=dev)
    obw = torch.empty((p, 4), dtype=torch.int64, device=dev)
    n = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty(max(-(-p // lib.kq_count_tile()), 1),
                          dtype=torch.int64, device=dev)
    _launch("count_runs", lib.kq_count_runs, skeys.data_ptr(),
            sedges.data_ptr(), p, *_ptrs(okeys, ocov, ofw, obw, n, scratch))
    LAUNCHES["count"] += 1
    return okeys, ocov, ofw, obw, n


def sort_records_cuda(skeys, sedges, k: int):
    """The records (biased int64 keys, each a canonical k-mer key or
    SENTINEL, and uint8 edge bytes, P each) in key order, each edge
    byte beside its key, equal keys in input order (see
    kmers.sort_keys_edges for the contract).  CUDA tensors: the
    sort_records kernel, a radix sort of the low 2k key bits.  With no
    record the outputs are empty and nothing launches."""
    if not 1 <= k <= 32:
        raise ValueError(f"sort_records: k = {k} outside 1..32")
    if not _on_cuda("sort_records", skeys, sedges):
        return K.sort_keys_edges(skeys, sedges)
    from ._build import library

    lib = library()
    p = skeys.shape[0]
    _check("sort_records skeys", skeys, torch.int64, (p,))
    _check("sort_records sedges", sedges, torch.uint8, (p,))
    dev = skeys.device
    okeys = torch.empty(p, dtype=torch.int64, device=dev)
    oedges = torch.empty(p, dtype=torch.uint8, device=dev)
    if p == 0:  # nothing to sort: no launch, so no count
        return okeys, oedges
    tkeys = torch.empty_like(okeys)
    tedges = torch.empty_like(oedges)
    # the look-back status of every tile's digits, the histograms, the
    # tile counters
    scratch = torch.empty(-(-p // lib.kq_sort_tile()) * 256 + 8 * 256 + 8,
                          dtype=torch.int64, device=dev)
    _launch("sort_records", lib.kq_sort_records, skeys.data_ptr(),
            sedges.data_ptr(), p, k,
            *_ptrs(okeys, oedges, tkeys, tedges, scratch))
    LAUNCHES["sort"] += 1
    return okeys, oedges


def count_chunk_cuda(codes, k: int):
    """One chunk of codes counted into a sorted unique table, as
    kmers.count_sorted(*kmer_positions(codes, k)) gives it: the
    extraction's count form, the sort and count_runs, each a kernel on
    CUDA tensors and its plain version on CPU tensors.  Returns (keys,
    cov, fw, bw, n) of P = N - k + 1 rows, a SENTINEL tail after n; with
    no window, empty rows and n = 0, and nothing launches."""
    skeys, sedges = extract_cuda(codes, k, "count")
    if skeys.shape[0] == 0:
        keys, cov, fw, bw = K._empty_rows(0, codes.device)
        return keys, cov, fw, bw, torch.zeros((), dtype=torch.int64,
                                              device=codes.device)
    return count_runs_cuda(*sort_records_cuda(skeys, sedges, k))


def merge_sorted_cuda(keys_a, cov_a, fw_a, bw_a, keys_b, cov_b, fw_b, bw_b):
    """Union of two sorted unique tables (see kmers.merge_sorted for the
    contract).  CUDA tensors: the merge_sorted kernel."""
    a = (keys_a, cov_a, fw_a, bw_a)
    b = (keys_b, cov_b, fw_b, bw_b)
    if not _on_cuda("merge_sorted", *a, *b):
        return K.merge_sorted(*a, *b)
    from ._build import library

    lib = library()
    na = _check_table("merge_sorted a", *a)
    nb = _check_table("merge_sorted b", *b)
    m = na + nb
    dev = keys_a.device
    # the tiles' starts in A, then their head counts
    scratch = torch.empty(2 * -(-m // lib.kq_merge_tile()) + 1,
                          dtype=torch.int64, device=dev)
    okeys = torch.empty(m, dtype=torch.int64, device=dev)
    ocov = torch.empty(m, dtype=torch.int64, device=dev)
    ofw = torch.empty((m, 4), dtype=torch.int64, device=dev)
    obw = torch.empty((m, 4), dtype=torch.int64, device=dev)
    n = torch.empty((), dtype=torch.int64, device=dev)
    _launch("merge_sorted", lib.kq_merge_sorted, *_ptrs(*a), na, *_ptrs(*b),
            nb, *_ptrs(scratch, okeys, ocov, ofw, obw, n))
    LAUNCHES["merge"] += 1
    return okeys, ocov, ofw, obw, n


def _check_index(name: str, index, tkeys) -> tuple:
    """(starts, nb, shift) of a table's bucket directory (ops/index.py)
    for a CUDA probe; raises without one, since a rebuild per call would
    hide a directory build in every window."""
    if index is None:
        raise ValueError(f"{name}: a CUDA probe needs the table's bucket "
                         "directory (KmerTable.bucket_index, or "
                         "ops.index.bucket_index of its keys)")
    starts, shift = index
    nb = starts.shape[0] - 1
    _check(name + " starts", starts, torch.int64, (nb + 1,))
    if starts.device != tkeys.device:
        raise ValueError(f"{name}: directory on {starts.device}, table on "
                         f"{tkeys.device}")
    bits = nb.bit_length() - 1
    if nb < 1 or nb & (nb - 1) or not 0 <= shift <= 64 - bits:
        raise ValueError(f"{name}: not a bucket directory: {nb} buckets, "
                         f"shift {shift}")
    _check_aligned(name, tkeys=tkeys)
    return starts, nb, int(shift)


def _check_aligned(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless each tensor starts on 16 bytes: the kernels read
    (and write) it in 16-byte loads."""
    for what, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def probe_qv_cuda(tkeys, tcov, tfw, tbw, qkeys, qctx, lead: int, hi: int,
                  cutoff: int, index=None):
    """(#missing, #edge-missing) over query positions lead <= i < hi as
    int64[2] (see validate.qv_sums for the contract).  CUDA tensors:
    the probe_qv kernel, which searches through `index`, the table's
    bucket directory (starts, shift) of ops/index.py; CPU tensors
    ignore it."""
    tab = (tkeys, tcov, tfw, tbw)
    if not _on_cuda("probe_qv", *tab, qkeys, qctx):
        return V.qv_sums(*tab, qkeys, qctx, lead, hi, cutoff)
    from ._build import library

    lib = library()
    _check_table("probe_qv table", *tab)
    starts, nb, shift = _check_index("probe_qv", index, tkeys)
    q = qkeys.shape[0]
    _check("probe_qv qkeys", qkeys, torch.int64, (q,))
    _check("probe_qv qctx", qctx, torch.uint8, (q,))
    lead = max(int(lead), 0)
    count = max(min(int(hi), q) - lead, 0)
    if count == 0:  # nothing to probe: no launch, so no count
        return torch.zeros(2, dtype=torch.int64, device=qkeys.device)
    out = torch.empty(2, dtype=torch.int64, device=qkeys.device)
    _launch("probe_qv", lib.kq_probe_qv, *_ptrs(*tab, starts), nb, shift,
            *_ptrs(qkeys, qctx), lead, count, max(int(cutoff), 1),
            out.data_ptr())
    LAUNCHES["probe_qv"] += 1
    return out


def probe_select_cuda(tkeys, tcov, tfw, tbw, qkeys, qctx, index=None):
    """(found, cov, right, left) per query, in query order (see
    validate.probe_select for the contract).  CUDA tensors: the
    probe_select kernel, which searches through `index`, the table's
    bucket directory (starts, shift) of ops/index.py; CPU tensors
    ignore it."""
    tab = (tkeys, tcov, tfw, tbw)
    if not _on_cuda("probe_select", *tab, qkeys, qctx):
        return V.probe_select(*tab, qkeys, qctx)
    from ._build import library

    lib = library()
    _check_table("probe_select table", *tab)
    starts, nb, shift = _check_index("probe_select", index, tkeys)
    q = qkeys.shape[0]
    _check("probe_select qkeys", qkeys, torch.int64, (q,))
    _check("probe_select qctx", qctx, torch.uint8, (q,))
    dev = qkeys.device
    found = torch.empty(q, dtype=torch.bool, device=dev)
    cov = torch.empty(q, dtype=torch.int64, device=dev)
    right = torch.empty(q, dtype=torch.int64, device=dev)
    left = torch.empty(q, dtype=torch.int64, device=dev)
    if q == 0:  # nothing to probe: no launch, so no count
        return found, cov, right, left
    _launch("probe_select", lib.kq_probe_select, *_ptrs(*tab, starts), nb,
            shift, *_ptrs(qkeys, qctx), q, *_ptrs(found, cov, right, left))
    LAUNCHES["probe_select"] += 1
    return found, cov, right, left


def probe_sorted_cuda(tkeys, tcov, tfw, tbw, qkeys, index=None):
    """(found, cov, fw, bw) per query, in query order (see
    kmers.probe_sorted for the contract).  CUDA tensors: the
    probe_sorted kernel, which searches through `index`, the table's
    bucket directory (starts, shift) of ops/index.py; CPU tensors
    ignore it."""
    tab = (tkeys, tcov, tfw, tbw)
    if not _on_cuda("probe_sorted", *tab, qkeys):
        return K.probe_sorted(*tab, qkeys)
    from ._build import library

    lib = library()
    _check_table("probe_sorted table", *tab)
    starts, nb, shift = _check_index("probe_sorted", index, tkeys)
    q = qkeys.shape[0]
    _check("probe_sorted qkeys", qkeys, torch.int64, (q,))
    dev = qkeys.device
    found = torch.empty(q, dtype=torch.bool, device=dev)
    cov = torch.empty(q, dtype=torch.int64, device=dev)
    fw = torch.empty((q, 4), dtype=torch.int64, device=dev)
    bw = torch.empty((q, 4), dtype=torch.int64, device=dev)
    # a row's fw and bw, and each query's, move as 16-byte halves
    _check_aligned("probe_sorted", tfw=tfw, tbw=tbw, fw=fw, bw=bw)
    if q == 0:  # nothing to probe: no launch, so no count
        return found, cov, fw, bw
    _launch("probe_sorted", lib.kq_probe_sorted, *_ptrs(*tab, starts), nb,
            shift, qkeys.data_ptr(), q, *_ptrs(found, cov, fw, bw))
    LAUNCHES["probe_sorted"] += 1
    return found, cov, fw, bw


# the forms of extract_cuda, in the kernel's numbering, with their plain
# versions
EXTRACT_FORMS = ("records", "qv", "track", "count")


def plain_extract(form: str):
    """The plain version of an extraction form."""
    return {"records": K.kmer_positions, "qv": V._extract_ctx_qv,
            "track": V._extract_ctx, "count": K.count_records}[form]


def _by_form(form: str, keys, isfw, valid, byte):
    """The outputs of `form` in its plain version's order (byte: the
    edge bits of records and count, the ctx of qv and track)."""
    return {"records": (keys, isfw, byte, valid), "qv": (keys, byte),
            "track": (keys, isfw, valid, byte), "count": (keys, byte)}[form]


def extract_cuda(codes, k: int, form: str = "records"):
    """Canonical k-mer extraction of a chunk of codes (uint8 [N], 0-3
    bases, BAD elsewhere) in one of four forms, each the output of its
    plain version over P = N - k + 1 windows:
      records - (keys, isfw, edges, valid), kmers.kmer_positions;
      qv      - (keys, ctx), validate._extract_ctx_qv;
      track   - (keys, isfw, valid, ctx), validate._extract_ctx;
      count   - (keys, edges) with SENTINEL and 0 where invalid, the
                records the count step sorts, kmers.count_records.
    CUDA tensors: the kmer_extract kernel.  With no window (P <= 0) the
    outputs are empty, on either device, and nothing launches."""
    if form not in EXTRACT_FORMS:
        raise ValueError(f"extract: no form {form!r} (one of "
                         f"{EXTRACT_FORMS})")
    on_cuda = _on_cuda("extract", codes)
    n = codes.shape[0]
    p = n - k + 1
    dev = codes.device
    if p <= 0:
        flag = torch.zeros(0, dtype=torch.bool, device=dev)
        return _by_form(form, torch.zeros(0, dtype=torch.int64, device=dev),
                        flag, flag.clone(), flag.to(torch.uint8))
    if not on_cuda:
        return plain_extract(form)(codes, k)
    from ._build import library

    if not 1 <= k <= 32:
        raise ValueError(f"extract: k = {k} outside 1..32")
    _check("extract codes", codes, torch.uint8, (n,))
    keys = torch.empty(p, dtype=torch.int64, device=dev)
    byte = torch.empty(p, dtype=torch.uint8, device=dev)
    isfw = valid = None
    if form in ("records", "track"):
        isfw = torch.empty(p, dtype=torch.bool, device=dev)
        valid = torch.empty(p, dtype=torch.bool, device=dev)
    _launch("extract", library().kq_extract, codes.data_ptr(), n, k,
            EXTRACT_FORMS.index(form), keys.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (isfw, valid)),
            byte.data_ptr())
    LAUNCHES["extract"] += 1
    return _by_form(form, keys, isfw, valid, byte)
