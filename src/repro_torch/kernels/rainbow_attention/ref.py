"""Plain PyTorch version of the paged decode attention kernel.

The function of ``repro.kernels.rainbow_attention.ref.rainbow_attention_ref``
(the Pallas kernel's oracle) and, with a fresh lane and the block mass, of
``repro.serving.rainbow_decode._attend_with_mass``, computed the way the
reference computes it: gather the blocks through vidx from [capacity ++
hot], repeat the kv heads, float32 scores divided by sqrt(hd), positions
>= length masked to -2e38, softmax, probabilities cast to the value dtype
for the PV product, float32 sums.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def rainbow_attention_ref(
    q: torch.Tensor,  # [B, HP, hd]
    cap_k: torch.Tensor,  # [NB, block, KVS, hd]
    cap_v: torch.Tensor,
    hot_k: torch.Tensor,  # [HOT, block, KVS, hd]
    hot_v: torch.Tensor,
    vidx: torch.Tensor,  # int32[B, nblk]; < NB: capacity row, else hot row - NB
    length: int,  # readable positions of every row
    k_new: torch.Tensor | None = None,  # [B, KVS, hd] fresh lane, always readable
    v_new: torch.Tensor | None = None,
    with_mass: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(out [B, HP, hd] in q's dtype, block mass float32[B, nblk] or None)."""
    b, hp, hd = q.shape
    nblk = vidx.shape[1]
    block, kvs = cap_k.shape[1], cap_k.shape[2]
    full = nblk * block
    idx = vidx.long()
    k = torch.cat([cap_k, hot_k])[idx].reshape(b, full, kvs, hd)
    v = torch.cat([cap_v, hot_v])[idx].reshape(b, full, kvs, hd)
    if k_new is not None:
        k = torch.cat([k, k_new[:, None]], dim=1)
        v = torch.cat([v, v_new[:, None]], dim=1)
    m = hp // kvs
    ke = k.repeat_interleave(m, dim=2)  # consecutive repeat (GQA)
    ve = v.repeat_interleave(m, dim=2)
    sqrt_hd = torch.tensor(math.sqrt(hd), dtype=torch.float32, device=q.device)
    s = torch.einsum("bhk,bshk->bhs", q.float(), ke.float()) / sqrt_hd
    pos = torch.arange(s.shape[-1], device=q.device)
    valid = pos < length
    if k_new is not None:
        valid = valid | (pos == s.shape[-1] - 1)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshk->bhk", p.to(q.dtype).float(), ve.float()).to(q.dtype)
    mass = None
    if with_mass:
        mass = p.sum(dim=1)[:, :full].reshape(b, nblk, block).sum(-1)
    return out, mass
