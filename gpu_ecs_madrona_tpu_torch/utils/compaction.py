"""Rank compaction of overlap grids into candidate slots (PyTorch).

Shared by the simple_jobs example (its 4-node path and the plain version
of its fused kernel, ops/simple_jobs_kernel.py) and the physics dense
broadphase.  The JAX package extracts each row's partners with a
[W, n, D, n] compare; here each partner is scattered to its within-row
rank instead ([W, n, n]), which gives the same slots.
"""

from __future__ import annotations

import torch


def first_partners(ok, D: int):
    """[W, n, D] int32: row a's first D partners in ascending b (0 past
    its degree), and the row degrees [W, n] int32.  Each partner is
    scattered to its within-row rank, which the inclusive cumsum gives."""
    W, n, _ = ok.shape
    # the scan runs over dim 1 of ok's transpose: for a transposed view (the
    # physics broadphase's owner-major grid) that is the contiguous tensor's
    # outer dim, which PyTorch's CUDA scan handles far faster than the
    # innermost one over short rows
    local_rank = torch.cumsum(ok.transpose(1, 2), dim=1, dtype=torch.int32).transpose(1, 2)
    dest = torch.where(ok & (local_rank <= D), local_rank - 1, D).long()
    out = torch.zeros((W, n, D + 1), dtype=torch.int32, device=ok.device)
    b_iota = torch.arange(n, dtype=torch.int32, device=ok.device).expand(W, n, n)
    out.scatter_(2, dest, b_iota)
    return out[:, :, :D], local_rank[:, :, -1]


def rank_slots(partners, deg, D: int, k: int):
    """The capped rank compaction's slots: (ab [W, k, 2] int32, zero past
    min(total, k); total [W] int32; dropped [W] int32).

    Slot s belongs to the last row a with base[a] <= s (rows of degree 0
    share their base with the next row), at rank s - base[a]."""
    W, n = deg.shape
    degc = deg.clamp(max=D)
    base = torch.cumsum(degc, dim=1, dtype=torch.int32) - degc
    total = degc.sum(dim=1, dtype=torch.int32)
    dropped = deg.sum(dim=1, dtype=torch.int32) - total
    slots = torch.arange(k, dtype=torch.int32, device=deg.device).expand(W, k).contiguous()
    owner = (torch.searchsorted(base, slots, right=True) - 1).clamp(0, n - 1)
    valid = slots < total[:, None]
    if D == 0:  # every pair is dropped: no slot is valid
        part = torch.zeros_like(slots)
    else:
        dd = slots - torch.gather(base, 1, owner)
        part = torch.gather(partners.reshape(W, n * D), 1,
                            owner * D + dd.clamp(0, D - 1).long())
    ab = torch.stack([torch.where(valid, owner.int(), 0),
                      torch.where(valid, part, 0)], dim=-1)
    return ab.int(), total, dropped
