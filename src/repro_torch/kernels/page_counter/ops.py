"""Wrappers of the two counter kernels (csrc/page_counter.cu).

CPU tensors take the plain versions (ref.py); CUDA tensors launch the kernel
or raise -- there is no fallback.  `fused_observe_count.launches` and
`two_stage_count.launches` count the kernel launches.  `count_accesses` is
the reference's entry point (``repro.kernels.page_counter.ops.count_accesses``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.page_counter.ref import fused_observe_count_ref, two_stage_count_ref

_MAX_BLOCKS = 132 * 8  # 8 blocks per SM of the H100's 132
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_observe_count_launch": (
        [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P], _I),
    "two_stage_count_launch": ([_P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _I, _P], _I),
}


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           what: str = "fused_observe_count") -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous {ndim}-d {dtype} "
            f"tensor, got {t.dtype} shape {tuple(t.shape)}"
        )


def fused_observe_count(
    sp: torch.Tensor,  # int32[A] superpage per access (-1 = skip)
    page: torch.Tensor,  # int32[A]
    is_write: torch.Tensor,  # bool[A]
    monitored: torch.Tensor,  # int32[N] monitored superpage ids (-1 = unused row)
    num_superpages: int,
    pages_per_sp: int,
    write_weight: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass batch histograms: (s1 int32[NSP], s2_reads, s2_writes int32[N, P])."""
    if sp.device.type == "cpu":
        return fused_observe_count_ref(
            sp, page, is_write, monitored, num_superpages, pages_per_sp, write_weight
        )
    if sp.device.type != "cuda":
        raise ValueError(f"fused_observe_count: unsupported device {sp.device}")
    _check("sp", sp, torch.int32, 1)
    _check("page", page, torch.int32, 1)
    _check("is_write", is_write, torch.bool, 1)
    _check("monitored", monitored, torch.int32, 1)
    a, n = sp.shape[0], monitored.shape[0]
    if page.shape[0] != a or is_write.shape[0] != a:
        raise ValueError("fused_observe_count: sp, page and is_write differ in length")
    if not (page.device == is_write.device == monitored.device == sp.device):
        raise ValueError("fused_observe_count: inputs lie on different devices")
    if 8 * num_superpages > _SMEM_LIMIT:
        raise ValueError(
            f"fused_observe_count: {num_superpages} superpages exceed one "
            "block's shared memory (8 bytes each)"
        )
    nsp, p = num_superpages, pages_per_sp
    out = torch.zeros((nsp + 2 * n * p,), dtype=torch.int32, device=sp.device)
    s1 = out[:nsp]
    s2r = out[nsp:nsp + n * p]
    s2w = out[nsp + n * p:]
    lib = build.library("page_counter", _SIGNATURES)
    with torch.cuda.device(sp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_observe_count_launch(
            sp.data_ptr(), page.data_ptr(), is_write.data_ptr(), a,
            monitored.data_ptr(), n, nsp, p, int(write_weight),
            s1.data_ptr(), s2r.data_ptr(), s2w.data_ptr(), _MAX_BLOCKS, stream,
        )
    fused_observe_count.launches += 1
    build.check_launch(lib, err, "fused_observe_count")
    return s1, s2r.view(n, p), s2w.view(n, p)


fused_observe_count.launches = 0


def two_stage_count(
    sp: torch.Tensor,  # int32[A] superpage per access (-1 = skip)
    page: torch.Tensor,  # int32[A]
    weight: torch.Tensor,  # int32[A]: uint32 weights, same bits
    monitored: torch.Tensor,  # int32[N] monitored superpage ids (-1 = unused row)
    num_superpages: int,
    pages_per_sp: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted histograms: (s1 int32[NSP], s2 int32[N, P]) (uint32 bits)."""
    what = "two_stage_count"
    if sp.device.type == "cpu":
        return two_stage_count_ref(sp, page, weight, num_superpages, monitored,
                                   pages_per_sp)
    if sp.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {sp.device}")
    for name, t in (("sp", sp), ("page", page), ("weight", weight), ("monitored", monitored)):
        _check(name, t, torch.int32, 1, what)
        if t.device != sp.device:
            raise ValueError(f"{what}: inputs lie on different devices")
    a, n = sp.shape[0], monitored.shape[0]
    if page.shape[0] != a or weight.shape[0] != a:
        raise ValueError(f"{what}: sp, page and weight differ in length")
    if 8 * num_superpages > _SMEM_LIMIT:
        raise ValueError(f"{what}: {num_superpages} superpages exceed one block's "
                         "shared memory (8 bytes each)")
    nsp, p = num_superpages, pages_per_sp
    out = torch.zeros((nsp + n * p,), dtype=torch.int32, device=sp.device)
    s1, s2 = out[:nsp], out[nsp:]
    lib = build.library("page_counter", _SIGNATURES)
    with torch.cuda.device(sp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.two_stage_count_launch(
            sp.data_ptr(), page.data_ptr(), weight.data_ptr(), a, monitored.data_ptr(),
            n, nsp, p, s1.data_ptr(), s2.data_ptr(), _MAX_BLOCKS, stream,
        )
    two_stage_count.launches += 1
    build.check_launch(lib, err, what)
    return s1, s2.view(n, p)


two_stage_count.launches = 0


def count_accesses(sp, page, weight, monitored, num_superpages, pages_per_sp):
    """The reference's ``count_accesses``: the two-stage counter.  The
    reference sends a zero-access chunk to its oracle because Pallas cannot
    slice a zero-length operand; the kernel here takes A = 0 (one block that
    writes the zero tables), so every chunk goes through it."""
    return two_stage_count(sp, page, weight, monitored, num_superpages, pages_per_sp)
