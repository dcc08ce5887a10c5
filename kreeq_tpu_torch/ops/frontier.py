"""Neighbour expansion for the subgraph searches and the variants scan.

Counterpart of kreeq_tpu/ops/frontier.py.  The three subgraph passes
(`traversal` rounds, the best-first boundary prefilter,
`remove_missing_edges`) start the same way: compute every node's eight
canonical neighbour keys, keep the slots whose edge counter passes the
cutoff and whose neighbour is not yet a member, then act on the (few)
survivors.  Here that scan is plain torch on the table's device, CPU or
CUDA: membership by `torch.searchsorted` on the sorted members,
compaction by `nonzero` (which keeps scan order) and first-wins dedup
by `torch.unique` plus a `scatter_reduce("amin")` of flat positions.
The TPU's two-sort join, its capped output with overflow retry, pow2
padding, 2^20-node slabs and fused rounds are not needed on the card.

Layout contract (shared with kreeq_tpu.core.keys.neighbors8_np): slot j
of node i is neighbour fw0,bw0,fw1,bw1,...,fw3,bw3; flat index = i*8 +
j, ascending = the reference's scan order (reference:
src/subgraph.cpp:329-356, :460-505, :599-628).

Keys follow the dtype rule in constants.py (int64 holding u64 ^ 2^63).
The arithmetic runs on the unbiased u64 bit patterns held in int64,
with every right shift logical (`_lsr`) and the k = 32 mask 2^64 - 1
written as -1; the unsigned minimum of two keys is the signed minimum
of their biased patterns.
"""

from __future__ import annotations

import torch

from ..constants import KEY_BIAS


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns, 0 < s < 64: torch's
    >> on int64 is arithmetic, so the sign bit is masked off."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def neighbors8(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical neighbour keys int64 [n, 8] of biased int64 keys [n],
    in the order fw0, bw0, ..., fw3, bw3 (the JAX `_neighbors8`).  A
    neighbour's reverse complement is the key's reverse complement
    shifted one base the other way, so one [n] revcomp serves all
    eight neighbours."""
    m = (1 << (2 * k)) - 1 if k < 32 else -1
    u = keys ^ KEY_BIAS
    x = ((~u) & m) << (64 - 2 * k)
    for sh, mm in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                   (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = ((x & mm) << sh) | (_lsr(x, sh) & mm)
    rc = ((x << 32) | _lsr(x, 32)) & m

    bases = torch.arange(4, dtype=torch.int64, device=keys.device)[None, :]
    comp = 3 - bases
    top = 2 * (k - 1)
    raw_fw = _lsr(u[:, None], 2) | (bases << top)
    rc_fw = ((rc[:, None] << 2) & m) | comp
    raw_bw = ((u[:, None] << 2) & m) | bases
    rc_bw = _lsr(rc[:, None], 2) | (comp << top)

    def umin(a, b):
        return torch.minimum(a ^ KEY_BIAS, b ^ KEY_BIAS)

    return torch.stack([umin(raw_fw, rc_fw), umin(raw_bw, rc_bw)],
                       dim=2).reshape(keys.shape[0], 8)


def survivors(keys: torch.Tensor, fw: torch.Tensor, bw: torch.Tensor,
              member_sorted: torch.Tensor, k: int, cutoff: int,
              dedup: bool):
    """Surviving neighbour slots of nodes `keys` (biased int64 [n]) with
    edge counters fw, bw [n, 4]: a slot survives when its counter is
    above `cutoff` and its canonical neighbour is not in
    `member_sorted` (ascending biased int64).  With `dedup`, only the
    first occurrence of each neighbour in scan order survives.

    Returns (vals int64 [c], flat_idx int64 [c]) in flat scan order,
    flat = row * 8 + slot: the contract of the JAX `_survivors_core`
    and `survivors_np`."""
    cand = neighbors8(keys, k).reshape(-1)
    ok = torch.stack([fw > cutoff, bw > cutoff], dim=2).reshape(-1)
    m = member_sorted.shape[0]
    if m:
        at = torch.searchsorted(member_sorted, cand).clamp_(max=m - 1)
        ok &= member_sorted[at] != cand
    flat = torch.nonzero(ok).squeeze(1)
    vals = cand[flat]
    if dedup and vals.shape[0]:
        uniq, inv = torch.unique(vals, return_inverse=True)
        first = torch.full((uniq.shape[0],), vals.shape[0],
                           dtype=torch.int64, device=vals.device)
        first.scatter_reduce_(0, inv, torch.arange(
            vals.shape[0], device=vals.device), reduce="amin")
        keep = torch.zeros(vals.shape[0], dtype=torch.bool,
                           device=vals.device)
        keep[first] = True
        flat, vals = flat[keep], vals[keep]
    return vals, flat
