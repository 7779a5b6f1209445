"""Split TLB model (Rainbow §II-A / §III-E): set-associative, LRU, two page sizes.

The per-access lookups run inside the interval walk (sim.tlbsim); this module
holds the state and the batch shootdown that runs between intervals.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TLBState(NamedTuple):
    tags: torch.Tensor  # int32[sets, ways]; -1 invalid
    lru: torch.Tensor  # int32[sets, ways] last-touch time


def tlb_init(entries: int, ways: int, device) -> TLBState:
    sets = max(1, entries // ways)
    return TLBState(
        tags=torch.full((sets, ways), -1, dtype=torch.int32, device=device),
        lru=torch.zeros((sets, ways), dtype=torch.int32, device=device),
    )


class SplitTLB(NamedTuple):
    """Two-level split TLB: L1 + L2 for one page size (Table IV geometry)."""

    l1: TLBState
    l2: TLBState


def split_tlb_init(
    l1_entries: int, l1_ways: int, l2_entries: int, l2_ways: int, device
) -> SplitTLB:
    return SplitTLB(
        l1=tlb_init(l1_entries, l1_ways, device), l2=tlb_init(l2_entries, l2_ways, device)
    )


def _invalidate_tags_many(tags: torch.Tensor, vpns: torch.Tensor) -> torch.Tensor:
    """tags with every entry whose tag appears in `vpns` set to -1.

    A shootdown clears vpn only inside its own set (vpn % sets, floor-mod as
    in the reference), so membership is masked to entries whose tag maps to
    the row it sits in; the result holds for arbitrary states.
    """
    sets = tags.shape[0]
    matched = (tags.unsqueeze(-1) == vpns.view(1, 1, -1)).any(-1)
    rows = torch.arange(sets, dtype=tags.dtype, device=tags.device).unsqueeze(1)
    home_row = torch.remainder(tags, sets) == rows
    return torch.where(matched & home_row, -1, tags)


def split_tlb_invalidate_many(st: SplitTLB, vpns: torch.Tensor) -> SplitTLB:
    """Batch shootdown of a vpn list (-1 lanes are no-ops).

    Invalidation only writes -1 where tag == vpn and never touches lru, so
    one broadcast membership test per level equals the sequential per-vpn
    shootdown, duplicates and padding included.
    """
    vpns = vpns.to(torch.int32)
    return SplitTLB(
        l1=st.l1._replace(tags=_invalidate_tags_many(st.l1.tags, vpns)),
        l2=st.l2._replace(tags=_invalidate_tags_many(st.l2.tags, vpns)),
    )
