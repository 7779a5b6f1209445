"""GQA attention: q/k/v projections with qk-norm and RoPE, the output
projection, the consecutive kv-head repeat, and the full-sequence attention
of the training path (dense and chunked).

Layout as in the reference (tp = 1): query heads HP = num_heads, kv heads
KVS = num_kv_heads, HP % KVS == 0, and query head h reads kv head
h // (HP // KVS).  Decode attention is the rainbow_attention kernel
(kernels/rainbow_attention); chunked full-sequence attention is the
flash_attention kernel (kernels/flash_attention).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import expand_kv as _expand_kv
from repro_torch.models.layers import (
    Params, apply_rope, dtype_of, init_device, matmul, normal_init, rms_head_norm, rope,
)

NEG_INF = -2.0e38  # fp32-safe mask value


def attn_init(cfg, gen, tp: int = 1, stacked: int | None = None) -> Params:
    dt = dtype_of(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    hp, kvs = cfg.padded_heads(tp), cfg.kv_store(tp)
    lead = () if stacked is None else (stacked,)
    scale_out = 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)
    p = {
        "wq": normal_init(gen, (*lead, d, hp, hd), 0.02, dt),
        "wk": normal_init(gen, (*lead, d, kvs, hd), 0.02, dt),
        "wv": normal_init(gen, (*lead, d, kvs, hd), 0.02, dt),
        "wo": normal_init(gen, (*lead, hp, hd, d), scale_out, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=torch.float32, device=init_device(gen))
        p["k_norm"] = torch.ones((*lead, hd), dtype=torch.float32, device=init_device(gen))
    return p


def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                        causal: bool) -> torch.Tensor:
    """bool[?, Q, K] mask; window 0 = unlimited."""
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    mask = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        mask &= rel >= 0
    if window > 0:
        mask &= rel < window
    return mask


def qkv_project(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                use_rope: bool, rope_cs: tuple | None = None):
    """x [B, S, d] -> (q [B, S, HP, hd], k/v [B, S, KVS, hd]) with qk-norm + RoPE.

    `rope_cs`: the (cos, sin) of ``layers.rope_tables(positions, ...)``, when
    the caller has them already (the same values `positions` gives).
    """
    q = matmul(x, p["wq"])
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    if use_rope and rope_cs is not None:
        q, k = apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)
    elif use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_output(p: Params, o: torch.Tensor) -> torch.Tensor:
    """o [B, S, HP, hd] @ wo [HP, hd, d] -> [B, S, d] in o's dtype."""
    b, s, hp, hd = o.shape
    return matmul(o.reshape(b, s, hp * hd), p["wo"].reshape(hp * hd, -1))


def attend_dense(
    q: torch.Tensor,  # [B, Sq, HP, hd]
    k: torch.Tensor,  # [B, Sk, KVS, hd]
    v: torch.Tensor,
    mask: torch.Tensor | None,  # bool broadcastable to [B, HP, Sq, Sk]
) -> torch.Tensor:
    """Reference O(Sq*Sk)-memory attention (baseline path), plain PyTorch."""
    hp = q.shape[2]
    k = _expand_kv(k, hp)
    v = _expand_kv(v, hp)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", w.float(), v.float()).to(q.dtype)


def _is_arange(pos: torch.Tensor, n: int) -> bool:
    return (pos.dim() == 1 and pos.shape[0] == n
            and torch.equal(pos, torch.arange(n, dtype=pos.dtype, device=pos.device)))


def attend_chunked(
    q: torch.Tensor,  # [B, Sq, HP, hd]
    k: torch.Tensor,  # [B, Sk, KVS, hd]
    v: torch.Tensor,
    q_pos: torch.Tensor,  # int[Sq]
    k_pos: torch.Tensor,  # int[Sk]
    window: int,
    causal: bool,
) -> torch.Tensor:
    """The reference's flash-style chunked attention, as the flash_attention
    kernel: causal self-attention with no window over positions 0..S-1 (the
    training path of every dense arch without a sliding window).  The
    kernel keeps P in float32 for the PV product where the reference rounds
    it to q's dtype, so in bf16 the two agree within bf16 rounding.  The
    kernel tiles on its own (the reference's `chunk` has no counterpart).
    Other masks raise (pass positions as host tensors: the check reads them).
    """
    s = q.shape[1]
    if (int(window) == 0 and causal and k.shape[1] == s
            and _is_arange(q_pos, s) and _is_arange(k_pos, s)):
        return flash_ops.attention(q, k, v, causal=True)
    raise NotImplementedError(
        "attend_chunked is ported for causal self-attention over positions "
        "0..S-1 with no window only (the flash_attention kernel); sliding "
        "windows, bidirectional and cross attention are not ported yet "
        "(ROADMAP.md Queue 1 item 13)")
