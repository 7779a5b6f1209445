"""GQA projections of the decode path: q/k/v with qk-norm and RoPE, the
output projection, and the consecutive kv-head repeat.

Layout as in the reference (tp = 1): query heads HP = num_heads, kv heads
KVS = num_kv_heads, HP % KVS == 0, and query head h reads kv head
h // (HP // KVS).  The attention itself is the rainbow_attention kernel
(kernels/rainbow_attention).
"""
from __future__ import annotations

import torch

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


def _expand_kv(k: torch.Tensor, hp: int) -> torch.Tensor:
    """Repeat kv slots to match query heads (consecutive repeat)."""
    b, s, kvs, hd = k.shape
    m = hp // kvs
    if m == 1:
        return k
    return k[:, :, :, None, :].expand(b, s, kvs, m, hd).reshape(b, s, kvs * m, hd)


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
