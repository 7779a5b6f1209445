"""Shared model building blocks of the dense family: norms, RoPE, the gated
MLP, embeddings, the LM head and the cross-entropy loss.

The reference's conventions hold: params are nested dicts of tensors,
layer-stacked leaves carry a leading L dim, every matrix product accumulates
in float32 (the reference's ``preferred_element_type=float32``) and is cast
back to the activation dtype where the reference casts, and norms and RoPE
run in float32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def matmul(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` over x's last dim and w's first, accumulated in float32.

    w may have several trailing dims ([d, H, hd]); the result is
    [*x.shape[:-1], *w.shape[1:]] in `out_dtype` (default: x's dtype).  On
    the card cuBLAS accumulates bf16 products in float32; on the CPU both
    operands are widened to float32 first, as the reference's products are.
    """
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, x.shape[-1])
    w2 = w.reshape(w.shape[0], -1)
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        y = x2 @ w2
    elif out_dtype == torch.float32:
        y = _MatmulF32.apply(x2, w2)
    elif x.is_cuda:
        y = x2 @ w2
    else:
        y = x2.float() @ w2.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], *w.shape[1:])


class _MatmulF32(torch.autograd.Function):
    """A float32 product of bf16 x, w (``torch.mm(x, w, out_dtype=float32)``
    on the card, which has no derivative in PyTorch; the widened product on
    the CPU) with the reference's gradient.  JAX's transpose of a
    ``dot_general`` with ``preferred_element_type=float32`` takes the float32
    output gradient into a float32 product with the other bf16 operand and
    rounds the result to the operand's dtype; so does this backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w, out_dtype=torch.float32)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = (g @ w.float().T).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = (x.float().T @ g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def init_device(gen) -> torch.device:
    """Where `gen` puts the tensors it initialises (numpy Generators: the CPU)."""
    return gen.device if isinstance(gen, torch.Generator) else torch.device("cpu")


def normal_init(gen, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """float32 normal draws times `scale`, cast to `dtype`.  `gen` is a
    torch.Generator, or a numpy Generator (float32 ``standard_normal`` draws
    on the CPU), which makes the same weights on any machine."""
    if isinstance(gen, torch.Generator):
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    else:
        x = torch.from_numpy(gen.standard_normal(shape, dtype=np.float32))
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(cfg, d: int, stacked: int | None = None, device=None) -> Params:
    shape = (d,) if stacked is None else (stacked, d)
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device)}


def apply_norm(cfg, p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, cast back to x's dtype (the only norm ported)."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return rms_head_norm(p["scale"], x, eps)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim (also qwen3's per-head qk_norm)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE (not interleaved). x: [B, S, H, hd]; positions: [B, S] or [S]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta, x.device))


def rope_tables(positions: torch.Tensor, hd: int, theta: float, device) -> tuple:
    """(cos, sin) float32 [B, S, 1, hd // 2] of `positions`; a decode step
    computes them once for all its layers."""
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B, S, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU)
# ---------------------------------------------------------------------------


def mlp_init(cfg, gen, d: int, f: int, stacked: int | None = None) -> Params:
    dt = dtype_of(cfg)
    lead = () if stacked is None else (stacked,)
    scale_out = 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)
    return {
        "wi": normal_init(gen, (*lead, d, f), 0.02, dt),
        "wo": normal_init(gen, (*lead, f, d), scale_out, dt),
        "wg": normal_init(gen, (*lead, d, f), 0.02, dt),
    }


def apply_mlp(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """silu(x @ wg) * (x @ wi) in float32, cast to x's dtype, then @ wo."""
    if not (cfg.gated_mlp and cfg.act == "silu"):
        raise NotImplementedError("only the gated SwiGLU MLP is ported yet")
    h = matmul(x, p["wi"], torch.float32)
    g = matmul(x, p["wg"], torch.float32)
    h = (F.silu(g) * h).to(x.dtype)
    return matmul(h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------


def embed_init(cfg, gen) -> Params:
    dt = dtype_of(cfg)
    vp = cfg.padded_vocab
    p = {"tok": normal_init(gen, (vp, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["head"] = normal_init(gen, (cfg.d_model, vp), 0.02, dt)
    return p


def embed_lookup(cfg, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["tok"])


def lm_logits(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """float32 logits [..., padded_vocab]; the vocab padding is masked to -1e9."""
    head = p["head"] if not cfg.tie_embeddings else p["tok"].T
    logits = matmul(x, head, torch.float32)
    vp = logits.shape[-1]
    if vp != cfg.vocab_size:
        mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, -1e9)
    return logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over mask==1 positions. logits fp32 [B,S,V]; labels int [B,S]."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
