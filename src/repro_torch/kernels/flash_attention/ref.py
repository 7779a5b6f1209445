"""Plain PyTorch versions of the flash attention kernel (its oracles).

`flash_attention_ref` is the function of
``repro.kernels.flash_attention.ref.flash_attention_ref``: float32 scores
divided by sqrt(hd), the causal mask at -2e38, softmax, probabilities cast
to q's dtype for the PV product, float32 sums, out in q's dtype.  K and V
come with their heads already expanded to q's.  `flash_attention_lse_ref`
is the per-row log-sum-exp the kernel also writes, and
`flash_attention_bwd_ref` the float32 backward that recomputes the
probabilities from it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """float32 [B, H, Sq, Sk] scores q.k / sqrt(hd), masked above the diagonal."""
    sqrt_hd = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / sqrt_hd
    if causal:
        sl = q.shape[1]
        mask = torch.ones((sl, sl), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    return s


def flash_attention_ref(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, H, hd] (kv heads pre-expanded to H)
    v: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    return torch.einsum(
        "bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float()).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            causal: bool = True) -> torch.Tensor:
    """float32 [B, H, S]: log sum_j exp(s_ij) over the unmasked keys."""
    return torch.logsumexp(_scores(q, k, causal), dim=-1)


def expand_kv(k: torch.Tensor, hp: int) -> torch.Tensor:
    """[B, S, KVS, hd] -> [B, S, hp, hd]: kv head j serves query heads
    j * (hp // KVS) .. (j + 1) * (hp // KVS) - 1 (the consecutive repeat)."""
    m = hp // k.shape[2]
    return k if m == 1 else k.repeat_interleave(m, dim=2)


def flash_attention_bwd_ref(
    q: torch.Tensor,  # [B, S, HP, hd]
    k: torch.Tensor,  # [B, S, KVS, hd]
    v: torch.Tensor,
    out: torch.Tensor,  # [B, S, HP, hd], the forward's output
    lse: torch.Tensor,  # float32 [B, HP, S], the forward's log-sum-exp
    dout: torch.Tensor,  # [B, S, HP, hd]
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtypes, computed in float32.

    P = exp(s - lse) is recomputed from q, k and lse; dS = P * (dP - D) with
    D = rowsum(dout * out); the gradients of the query heads that share a kv
    head are summed into it.
    """
    b, s_len, hp, hd = q.shape
    kvs = k.shape[2]
    ke, ve = expand_kv(k, hp).float(), expand_kv(v, hp).float()
    p = torch.exp(_scores(q, ke, causal) - lse[..., None])
    do = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, ve)
    d_row = (do * out.float()).sum(-1).permute(0, 2, 1)  # [B, HP, S]
    ds = p * (dp - d_row[..., None])
    del p, dp
    scale = 1.0 / math.sqrt(hd)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, ke) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    m = hp // kvs
    if m > 1:
        dk = dk.reshape(b, s_len, kvs, m, hd).sum(3)
        dv = dv.reshape(b, s_len, kvs, m, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
