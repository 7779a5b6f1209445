"""Wrapper of the block-migration copy kernel (csrc/block_gather.cu).

CPU tensors take the plain version (ref.py); CUDA tensors launch the kernel
or raise -- there is no fallback.  `block_gather_.launches` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_gather.ref import block_gather_ref_

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "block_gather_launch": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_longlong, _I, _P], _I),
}


def _fail(msg: str) -> None:
    raise ValueError(f"block_gather: {msg}")


def block_gather_(pairs, src: torch.Tensor, dst: torch.Tensor) -> None:
    """In place, for each (cap [L, NB, ...], hot [L, HOT, ...]) pair (one or
    two: K and V) and every layer: ``hot[:, dst[k]] = cap[:, src[k]]`` for
    lanes with 0 <= src < NB and 0 <= dst < HOT.  One launch for all pairs."""
    pairs = tuple(pairs)
    if not 1 <= len(pairs) <= 2:
        _fail(f"expected one or two (cap, hot) pairs, got {len(pairs)}")
    cap0 = pairs[0][0]
    if cap0.device.type == "cpu":
        block_gather_ref_(pairs, src, dst)
        return
    if cap0.device.type != "cuda":
        _fail(f"unsupported device {cap0.device}")
    layers, nb = cap0.shape[:2]
    n_hot = pairs[0][1].shape[1]
    row_shape = tuple(cap0.shape[2:])
    for cap, hot in pairs:
        for name, t, rows in (("cap", cap, nb), ("hot", hot, n_hot)):
            if (t.dtype != cap0.dtype or t.device != cap0.device or not t.is_contiguous()
                    or tuple(t.shape) != (layers, rows, *row_shape)):
                _fail(f"{name} must be a contiguous {cap0.dtype} tensor of shape "
                      f"{(layers, rows, *row_shape)} on {cap0.device}, got "
                      f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lanes = src.shape[0]
    for name, t in (("src", src), ("dst", dst)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (lanes,) or not t.is_contiguous()
                or t.device != cap0.device):
            _fail(f"{name} must be a contiguous int32[{lanes}] tensor on {cap0.device}")
    row_bytes = cap0[0, 0].numel() * cap0.element_size() if nb else 0
    ptrs = [t.data_ptr() for pair in pairs for t in pair]
    unit = 16
    while unit > 1 and (row_bytes % unit or any(p % unit for p in ptrs)):
        unit //= 2
    cap1, hot1 = pairs[1] if len(pairs) == 2 else (None, None)
    lib = build.library("block_gather", _SIGNATURES)
    with torch.cuda.device(cap0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.block_gather_launch(
            cap0.data_ptr(), pairs[0][1].data_ptr(),
            None if cap1 is None else cap1.data_ptr(),
            None if hot1 is None else hot1.data_ptr(),
            src.data_ptr(), dst.data_ptr(), lanes, layers, len(pairs), nb, n_hot,
            row_bytes, unit, stream,
        )
    block_gather_.launches += 1
    build.check_launch(lib, err, "block_gather")


block_gather_.launches = 0

