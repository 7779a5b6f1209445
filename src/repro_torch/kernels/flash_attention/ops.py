"""Wrapper of the flash attention kernel (csrc/flash_attention.cu).

`attention` is the differentiable entry point.  CPU tensors take the plain
version (ref.py, differentiated by autograd); CUDA tensors launch the kernel
or raise -- there is no fallback.  On the card the gradient is a
``torch.autograd.Function`` whose backward recomputes the probabilities from
q, k and the kernel's log-sum-exp in float32 plain PyTorch
(`ref.flash_attention_bwd_ref`): the JAX package has no backward kernel
either (its gradient is XLA's autodiff of ``attend_chunked``).
`flash_attention.launches` counts the forward kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (
    expand_kv, flash_attention_bwd_ref, flash_attention_ref,
)

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_launch": ([_I] + [_P] * 5 + [_I] * 6 + [ctypes.c_float, _P], _I),
}


def _fail(msg: str) -> None:
    raise ValueError(f"flash_attention: {msg}")


def flash_attention(
    q: torch.Tensor,  # [B, S, HP, hd], CUDA
    k: torch.Tensor,  # [B, S, KVS, hd], HP % KVS == 0
    v: torch.Tensor,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: (out [B, S, HP, hd] in q's dtype, lse float32 [B, HP, S])."""
    if q.device.type != "cuda":
        _fail(f"the kernel runs on CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        _fail(f"dtype {q.dtype} is not supported (float32 or bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        _fail("expected q [B, S, HP, hd] and k, v [B, S, KVS, hd]")
    b, s, hp, hd = q.shape
    kvs = k.shape[2]
    for name, t, heads in (("q", q, hp), ("k", k, kvs), ("v", v, kvs)):
        if (t.dtype != q.dtype or tuple(t.shape) != (b, s, heads, hd)
                or not t.is_contiguous() or t.device != q.device):
            _fail(f"{name} must be a contiguous {q.dtype} tensor of shape "
                  f"{(b, s, heads, hd)} on {q.device}, got {t.dtype} "
                  f"{tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            _fail(f"{name} must start on a 16-byte boundary")
    if hp % kvs:
        _fail(f"{hp} query heads do not divide over {kvs} kv heads")
    if hd not in HEAD_DIMS:
        _fail(f"head_dim {hd} is not one of {HEAD_DIMS}")
    if min(b, s) < 1:
        _fail(f"empty input {tuple(q.shape)}")
    out = torch.empty_like(q)
    lse = torch.empty((b, hp, s), dtype=torch.float32, device=q.device)
    lib = build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, s, hp, kvs, hd, int(causal),
            1.0 / math.sqrt(hd), stream,
        )
    flash_attention.launches += 1
    build.check_launch(lib, err, "flash_attention")
    return out, lse


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, dout.contiguous(),
                                             ctx.causal)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Causal (or full) attention of q [B, S, HP, hd] over k, v [B, S, KVS, hd]
    -> [B, S, HP, hd] in q's dtype; query head h reads kv head h // (HP // KVS)."""
    if q.device.type == "cpu":
        hp = q.shape[2]
        return flash_attention_ref(q, expand_kv(k, hp), expand_kv(v, hp), causal)
    if q.device.type != "cuda":
        _fail(f"unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, bool(causal))
