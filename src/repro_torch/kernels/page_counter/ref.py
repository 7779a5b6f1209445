"""Plain PyTorch versions of the two counter kernels (their oracles).

uint32 counts and weights are carried as int32 (same bits); integer adds
wrap modulo 2^32 either way."""
from __future__ import annotations

import torch

from repro_torch.core.counting import psn_to_row


def fused_observe_count_ref(
    sp: torch.Tensor,  # int32[A] superpage per access (-1 = skip)
    page: torch.Tensor,  # int32[A] page within superpage
    is_write: torch.Tensor,  # bool[A]
    monitored: torch.Tensor,  # int32[N] monitored superpage ids (-1 = unused row)
    num_superpages: int,
    pages_per_sp: int,
    write_weight: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(stage-1 int32[NSP] weighted by write_weight, stage-2 read and write
    int32[N, pages_per_sp] histograms of the monitored rows).

    An access counts in the first monitored row holding its superpage.
    """
    dev = sp.device
    valid = sp >= 0
    w1 = torch.where(valid, torch.where(is_write, write_weight, 1), 0).to(torch.int32)
    s1 = torch.zeros((num_superpages,), dtype=torch.int32, device=dev)
    s1.index_add_(0, torch.where(valid, sp, 0).long(), w1)

    row = psn_to_row(monitored, sp)
    hit = row >= 0
    n = monitored.shape[0]
    idx = torch.where(hit, row * pages_per_sp + page, 0).long()

    def hist(w: torch.Tensor) -> torch.Tensor:
        flat = torch.zeros((n * pages_per_sp,), dtype=torch.int32, device=dev)
        flat.index_add_(0, idx, (hit & w).to(torch.int32))
        return flat.reshape(n, pages_per_sp)

    return s1, hist(~is_write), hist(is_write)


def two_stage_count_ref(
    sp: torch.Tensor,  # int32[A] superpage per access (-1 = skip)
    page: torch.Tensor,  # int32[A] page within superpage
    weight: torch.Tensor,  # uint32[A] as int32
    num_superpages: int,
    monitored: torch.Tensor,  # int32[N] monitored superpage ids (-1 = unused row)
    pages_per_sp: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(stage-1 int32[NSP], stage-2 int32[N, pages_per_sp]), both weighted by
    `weight` -- ``repro.kernels.page_counter.ref.two_stage_count_ref`` with
    its argument order.  An access counts in the first monitored row holding
    its superpage."""
    dev = sp.device
    valid = sp >= 0
    w = torch.where(valid, weight, 0).to(torch.int32)
    s1 = torch.zeros((num_superpages,), dtype=torch.int32, device=dev)
    s1.index_add_(0, torch.where(valid, sp, 0).long(), w)
    row = psn_to_row(monitored, sp)
    hit = row >= 0
    n = monitored.shape[0]
    flat = torch.zeros((n * pages_per_sp,), dtype=torch.int32, device=dev)
    flat.index_add_(0, torch.where(hit, row * pages_per_sp + page, 0).long(),
                    torch.where(hit, w, 0))
    return s1, flat.reshape(n, pages_per_sp)
