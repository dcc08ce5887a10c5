"""Assembly validation: probe + QV classification.

Counterpart of kreeq_tpu/ops/validate.py.  For every k-mer position of
an assembly window, look its canonical key up in the table and classify
it (reference: src/kreeq.cpp:110-229 evaluateSegment):
  missing      - not found, or cov < max(cutoff, 1);
  edge-missing - not missing, and on each side that has a neighbour
                 base the edge counter toward that base is zero.
Two paths, as in the JAX package:
  sums   - plain `validate` consumes only the two totals, so nothing per
           position leaves the device (`validate_qv_sums`; `qv_sums` is
           the plain version of the probe_qv kernel, csrc/probe_qv.cu);
  tracks - the bed/csv/kwig/bkwig writers need cov and the two edge
           counters of every position (`validate_positions`;
           `probe_select` is the plain version of the probe_select
           kernel, csrc/probe_select.cu).
ops/kernels.py dispatches between each kernel and its plain version.
"""

from __future__ import annotations

import torch

from ..constants import BAD, SENTINEL
from .kmers import kmer_positions


def _neighbours(codes, k: int, p: int):
    """The base after and the base before each of the p windows (BAD at
    the buffer ends)."""
    nxt = torch.cat([codes[k:], codes.new_full((1,), BAD)])
    prv = torch.cat([codes.new_full((1,), BAD), codes[:p - 1]])
    return nxt, prv


def _extract_ctx_qv(codes, k: int):
    """Query keys plus the QV selection context of each position.

    ctx bits 0-3 select the right edge counter and bits 4-7 the left
    one: 1-4 = fw0-3, 5-8 = bw0-3, 0 = that side has no neighbour base.
    The choice is the JAX _classify's (right = isfw ? fw[nc] :
    bw[3-nc], left = isfw ? bw[pc] : fw[3-pc]).  Invalid windows
    (a non-ACGT base) get the SENTINEL key, which never matches.
    Returns (keys int64[P], ctx uint8[P])."""
    keys, isfw, _edges, valid = kmer_positions(codes, k)
    keys = torch.where(valid, keys, SENTINEL)
    nxt, prv = _neighbours(codes, k, keys.shape[0])
    nc = (nxt & 3).to(torch.int64)
    pc = (prv & 3).to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=codes.device)
    row_r = torch.where(nxt <= 3, torch.where(isfw, 1 + nc, 8 - nc), zero)
    row_l = torch.where(prv <= 3, torch.where(isfw, 5 + pc, 4 - pc), zero)
    return keys, (row_r | (row_l << 4)).to(torch.uint8)


def _select(tfw, tbw, row, sel):
    """Counter chosen by a ctx selector (1-4 fw, 5-8 bw); 0 for 0."""
    col = (sel - 1) & 3
    return torch.where(sel == 0, 0,
                       torch.where(sel <= 4, tfw[row, col], tbw[row, col]))


def qv_sums(tkeys, tcov, tfw, tbw, qkeys, qctx, lead: int, hi: int,
            cutoff: int):
    """(#missing, #edge-missing) over query positions lead <= i < hi,
    as int64[2] (plain version of the probe_qv kernel).

    tkeys is sorted and unique (a SENTINEL tail is allowed); an empty
    table finds nothing, so every in-window position is missing."""
    qk = qkeys[lead:hi]
    t = tkeys.shape[0]
    if t == 0:
        return torch.tensor([qk.shape[0], 0], dtype=torch.int64,
                            device=qk.device)
    row = torch.searchsorted(tkeys, qk).clamp_(max=t - 1)
    found = (tkeys[row] == qk) & (qk != SENTINEL)
    ok = found & (tcov[row] >= max(int(cutoff), 1))
    ctx = qctx[lead:hi].to(torch.int64)
    sel_r, sel_l = ctx & 15, ctx >> 4
    no_right = (sel_r != 0) & (_select(tfw, tbw, row, sel_r) == 0)
    no_left = (sel_l != 0) & (_select(tfw, tbw, row, sel_l) == 0)
    edge = ok & no_right & no_left
    return torch.stack([(~ok).sum(), edge.sum()])


def validate_qv_sums(tkeys, tcov, tfw, tbw, codes, k: int, cutoff: int,
                     lead: int, hi: int, index=None):
    """QV sums of one assembly window (counterpart of the JAX
    validate_qv_sums_pallas): the extraction's qv form through
    ops.kernels.extract_cuda, then the probe through
    ops.kernels.probe_qv_cuda; each launches its CUDA kernel for CUDA
    tensors and runs its plain version (_extract_ctx_qv, qv_sums) for
    CPU tensors.

    codes: uint8[N] window buffer on the table's device; index: the
    table's bucket directory (ops/index.py), which the CUDA kernel
    needs and the CPU ignores.  Returns int64[2] = (#missing,
    #edge-missing) over positions lead <= i < hi."""
    from .kernels import extract_cuda, probe_qv_cuda

    if codes.shape[0] - k + 1 <= 0:
        return torch.zeros(2, dtype=torch.int64, device=codes.device)
    keys, ctx = extract_cuda(codes, k, "qv")
    return probe_qv_cuda(tkeys, tcov, tfw, tbw, keys, ctx, lead, hi, cutoff,
                         index)


# ---------------------------------------------------------------------------
# per-base tracks


def _extract_ctx(codes, k: int):
    """Query keys, orientation, validity and the track selection context
    of each position (the JAX _extract_ctx).

    ctx bits 0-3 select the right edge counter and bits 4-7 the left one
    (1-4 = fw0-3, 5-8 = bw0-3), chosen as the JAX _classify does (right =
    isfw ? fw[nc] : bw[3-nc], left = isfw ? bw[pc] : fw[3-pc]).  Unlike
    the QV context there is no 0 selector: _classify_sel masks by
    has_next / has_prev itself.  Invalid windows get the SENTINEL key,
    which the probe never finds; _classify_sel masks them by `valid`
    anyway, so this only spares the kernel their searches.
    Returns (keys int64[P], isfw bool[P], valid bool[P], ctx uint8[P])."""
    keys, isfw, _edges, valid = kmer_positions(codes, k)
    keys = torch.where(valid, keys, SENTINEL)
    nxt, prv = _neighbours(codes, k, keys.shape[0])
    nc = (nxt & 3).to(torch.int64)
    pc = (prv & 3).to(torch.int64)
    row_r = torch.where(isfw, 1 + nc, 8 - nc)
    row_l = torch.where(isfw, 5 + pc, 4 - pc)
    return keys, isfw, valid, (row_r | (row_l << 4)).to(torch.uint8)


def probe_select(tkeys, tcov, tfw, tbw, qkeys, qctx):
    """Context-selected probe in query order (plain version of the
    probe_select kernel; contract of the JAX probe_select_pallas).

    Returns (found bool[q], cov int64[q], right int64[q], left
    int64[q]): found = the key is among the table's keys (tkeys sorted
    and unique, a SENTINEL tail allowed; a SENTINEL query is never
    found); cov and the counters chosen by the ctx selectors (see
    _extract_ctx; a selector of 0 gives 0) are those of the found row,
    and 0 where nothing was found."""
    q = qkeys.shape[0]
    t = tkeys.shape[0]
    if t == 0:
        zero = torch.zeros(q, dtype=torch.int64, device=qkeys.device)
        return zero.bool(), zero, zero.clone(), zero.clone()
    row = torch.searchsorted(tkeys, qkeys).clamp_(max=t - 1)
    found = (tkeys[row] == qkeys) & (qkeys != SENTINEL)
    ctx = qctx.to(torch.int64)

    def hit(x):
        return torch.where(found, x, 0)

    return (found, hit(tcov[row]), hit(_select(tfw, tbw, row, ctx & 15)),
            hit(_select(tfw, tbw, row, ctx >> 4)))


def _classify_sel(codes, sel, k: int, cutoff: int, isfw, valid):
    """The JAX _classify semantics over a context-selected probe result
    (found, cov, right, left already column-selected).  Returns valid,
    missing, edge_missing, cov, isfw, right, left."""
    found, cov, right, left = sel
    found = found & valid
    nxt, prv = _neighbours(codes, k, found.shape[0])
    has_next = nxt <= 3
    has_prev = prv <= 3
    right = torch.where(found & has_next, right, 0)
    left = torch.where(found & has_prev, left, 0)
    cov = torch.where(found, cov, 0)
    missing = (cov == 0) | (cov < cutoff)
    no_right = has_next & (right == 0)
    no_left = has_prev & (left == 0)
    edge_missing = valid & ~missing & no_left & no_right
    # the reference fills edge tracks only on the non-missing branch
    # (src/kreeq.cpp:176-210)
    right = torch.where(missing, 0, right)
    left = torch.where(missing, 0, left)
    return valid, missing, edge_missing, cov, isfw, right, left


def validate_positions(tkeys, tcov, tfw, tbw, codes, k: int, cutoff: int,
                       index=None):
    """Per-position classification of one assembly window (counterpart
    of the JAX validate_positions and validate_positions_pallas): the
    extraction's track form through ops.kernels.extract_cuda and the
    probe through ops.kernels.probe_select_cuda, each of which launches
    its CUDA kernel for CUDA tensors and runs its plain version
    (_extract_ctx, probe_select) for CPU tensors; the classification
    in PyTorch.

    codes: uint8[N] window buffer on the table's device; index: the
    table's bucket directory (ops/index.py), which the CUDA kernel
    needs and the CPU ignores.  Returns seven arrays of length P =
    N - k + 1: valid, missing, edge_missing (bool), cov int64, isfw
    bool, right int64, left int64."""
    from .kernels import extract_cuda, probe_select_cuda

    keys, isfw, valid, ctx = extract_cuda(codes, k, "track")
    sel = probe_select_cuda(tkeys, tcov, tfw, tbw, keys, ctx, index)
    return _classify_sel(codes, sel, k, cutoff, isfw, valid)
