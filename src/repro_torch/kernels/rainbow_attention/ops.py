"""Wrapper of the paged decode attention kernel (csrc/rainbow_attention.cu).

CPU tensors take the plain version (ref.py); CUDA tensors launch the kernel
or raise -- there is no fallback.  On the card a call is two launches: the
split kernel, one CTA per (kv head, row, split of the KV blocks, as
`kv_splits` plans them), and the kernel that combines the splits.
`rainbow_attention.launches` counts the calls that launch them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rainbow_attention.ref import rainbow_attention_ref

# the kernel's compile-time limits (csrc/rainbow_attention.cu)
MAX_GROUP = 8  # query heads per kv head (kMaxGroup)
MAX_HEAD_DIM = 256  # (kMaxHd)
MAX_BLOCK = 64  # tokens per KV block (kMaxBlock)
SPLIT_POSITIONS = 64  # positions per split at most, whole blocks (kSplitPos)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rainbow_attention_launch": ([_I] + [_P] * 12 + [_I] * 9 + [_P], _I),
}


def kv_splits(nblk: int, block: int) -> tuple[int, int]:
    """(nsplit, blocks_per_split): the split kernel's grid axis over the KV
    blocks.  Each split covers as many whole blocks as fit in SPLIT_POSITIONS
    positions (at least one), the last split what remains; the plan depends
    on nblk and block only, never on the call's length, so the grid and the
    scratch keep their shapes through a decode run."""
    per = max(1, SPLIT_POSITIONS // block)
    return -(-nblk // per), per


def _fail(msg: str) -> None:
    raise ValueError(f"rainbow_attention: {msg}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        _fail(f"{name} must be a contiguous {dtype} tensor of shape {shape}, "
              f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        _fail(f"{name} lies on {t.device}, q on {device}")


def rainbow_attention(
    q: torch.Tensor,  # [B, HP, hd]
    cap_k: torch.Tensor,  # [NB, block, KVS, hd]
    cap_v: torch.Tensor,
    hot_k: torch.Tensor,  # [HOT, block, KVS, hd]
    hot_v: torch.Tensor,
    vidx: torch.Tensor,  # int32[B, nblk]
    length: int,
    k_new: torch.Tensor | None = None,  # [B, KVS, hd]
    v_new: torch.Tensor | None = None,
    with_mass: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Paged single-token decode attention; (out [B, HP, hd], mass [B, nblk] | None).

    Positions < length of the blocks named by vidx are read (vidx < NB from
    the capacity pool, else hot row vidx - NB); (k_new, v_new), when given,
    is one more always-readable position.  with_mass also returns each
    block's softmax mass summed over heads.
    """
    length = int(length)
    if q.device.type == "cpu":
        return rainbow_attention_ref(q, cap_k, cap_v, hot_k, hot_v, vidx, length,
                                     k_new, v_new, with_mass)
    if q.device.type != "cuda":
        _fail(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        _fail(f"dtype {q.dtype} is not supported (float32 or bfloat16)")
    if q.dim() != 3 or cap_k.dim() != 4 or hot_k.dim() != 4 or vidx.dim() != 2:
        _fail("expected q [B, HP, hd], pools [N, block, KVS, hd], vidx [B, nblk]")
    b, hp, hd = q.shape
    nb, block, kvs, _ = cap_k.shape
    n_hot = hot_k.shape[0]
    nblk = vidx.shape[1]
    dev = q.device
    _check("q", q, q.dtype, (b, hp, hd), dev)
    for name, t, rows in (("cap_k", cap_k, nb), ("cap_v", cap_v, nb),
                          ("hot_k", hot_k, n_hot), ("hot_v", hot_v, n_hot)):
        _check(name, t, q.dtype, (rows, block, kvs, hd), dev)
    _check("vidx", vidx, torch.int32, (b, nblk), dev)
    if (k_new is None) != (v_new is None):
        _fail("k_new and v_new come together")
    if k_new is not None:
        _check("k_new", k_new, q.dtype, (b, kvs, hd), dev)
        _check("v_new", v_new, q.dtype, (b, kvs, hd), dev)
    elif length < 1:
        _fail(f"length {length} leaves no readable position")
    if hp % kvs or hp // kvs > MAX_GROUP:
        _fail(f"{hp} query heads over {kvs} kv heads: the group must divide "
              f"and be at most {MAX_GROUP}")
    if not (1 <= hd <= MAX_HEAD_DIM and 1 <= block <= MAX_BLOCK and nblk >= 1 and b >= 1):
        _fail(f"head_dim {hd} (max {MAX_HEAD_DIM}), block {block} (max "
              f"{MAX_BLOCK}), nblk {nblk} and batch {b} out of range")

    out = torch.empty_like(q)
    # scratch: each (row, head, split)'s partial record -- acc [hd], max, sum --
    # then, with the mass, each (row, head, block)'s sum within its split
    nsplit, _ = kv_splits(nblk, block)
    n_part = b * hp * nsplit * (hd + 2)
    scratch = torch.empty(n_part + (b * hp * nblk if with_mass else 0),
                          dtype=torch.float32, device=dev)
    part = scratch[:n_part]
    blk_sum = scratch[n_part:] if with_mass else None
    mass = torch.empty((b, nblk), dtype=torch.float32, device=dev) if with_mass else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    # 16-byte loads: every K/V row start is then 16-byte aligned
    bases = [t.data_ptr() for t in (cap_k, cap_v, hot_k, hot_v, k_new, v_new) if t is not None]
    vec16 = int((hd * q.element_size()) % 16 == 0 and all(p % 16 == 0 for p in bases))

    lib = build.library("rainbow_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rainbow_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), cap_k.data_ptr(), cap_v.data_ptr(),
            hot_k.data_ptr(), hot_v.data_ptr(), vidx.data_ptr(), ptr(k_new),
            ptr(v_new), out.data_ptr(), part.data_ptr(), ptr(blk_sum), ptr(mass),
            b, length, nblk, nb, block, kvs, hp, hd, vec16, stream,
        )
    rainbow_attention.launches += 1
    build.check_launch(lib, err, "rainbow_attention")
    return out, mass


rainbow_attention.launches = 0
