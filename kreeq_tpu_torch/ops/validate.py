"""Sums-only assembly validation: probe + QV classification.

Counterpart of the sums path of kreeq_tpu/ops/validate.py.  For every
k-mer position of an assembly window, look its canonical key up in the
table and classify it (reference: src/kreeq.cpp:110-229 evaluateSegment):
  missing      - not found, or cov < max(cutoff, 1);
  edge-missing - not missing, and on each side that has a neighbour
                 base the edge counter toward that base is zero.
Plain `validate` consumes only the two totals, so nothing per position
leaves the device.  `qv_sums` is the plain version of the probe_qv
kernel (csrc/probe_qv.cu); ops/kernels.py dispatches between them.
"""

from __future__ import annotations

import torch

from ..constants import BAD, SENTINEL
from .kmers import kmer_positions


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
    p = keys.shape[0]
    nxt = torch.cat([codes[k:], codes.new_full((1,), BAD)])
    prv = torch.cat([codes.new_full((1,), BAD), codes[:p - 1]])
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
                     lead: int, hi: int):
    """QV sums of one assembly window (counterpart of the JAX
    validate_qv_sums_pallas): extraction in PyTorch, then the probe
    through ops.kernels.probe_qv_cuda, which launches the CUDA kernel
    for CUDA tensors and runs qv_sums for CPU tensors.

    codes: uint8[N] window buffer on the table's device.  Returns
    int64[2] = (#missing, #edge-missing) over positions
    lead <= i < hi."""
    from .kernels import probe_qv_cuda

    if codes.shape[0] - k + 1 <= 0:
        return torch.zeros(2, dtype=torch.int64, device=codes.device)
    keys, ctx = _extract_ctx_qv(codes, k)
    return probe_qv_cuda(tkeys, tcov, tfw, tbw, keys, ctx, lead, hi, cutoff)
