"""NVM->DRAM address remapping (Rainbow §III-E) as a side table.

``remap[superpage, page] -> performance-tier slot`` (-1 = not migrated); the
residency bitmap answers "is it migrated?" and the remap table "where?".
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bitmap import bitmap_get, bitmap_init, bitmap_update


class RemapState(NamedTuple):
    """bitmap: int32[num_sp, words] (uint32 words); remap: int32[num_sp, pages_per_sp]."""

    bitmap: torch.Tensor
    remap: torch.Tensor


def remap_init(num_superpages: int, pages_per_sp: int, device) -> RemapState:
    return RemapState(
        bitmap=bitmap_init(num_superpages, pages_per_sp, device),
        remap=torch.full((num_superpages, pages_per_sp), -1, dtype=torch.int32,
                         device=device),
    )


def _set_rows(remap: torch.Tensor, sp: torch.Tensor, page: torch.Tensor, value) -> torch.Tensor:
    """``remap[sp, page] = value`` with sp < 0 lanes dropped (never row 0)."""
    num_sp = remap.shape[0]
    out = torch.cat([remap, remap[:1]])
    row = torch.where(sp >= 0, sp, num_sp).long()
    out[row, page.long()] = value
    return out[:num_sp]


def remap_install(
    st: RemapState, sp: torch.Tensor, page: torch.Tensor, slot: torch.Tensor
) -> RemapState:
    """Install migrated pages (vectorized; sp < 0 lanes dropped)."""
    return RemapState(
        bitmap=bitmap_update(st.bitmap, sp, page, True),
        remap=_set_rows(st.remap, sp, page, slot.to(torch.int32)),
    )


def remap_evict(st: RemapState, sp: torch.Tensor, page: torch.Tensor) -> RemapState:
    """Remove mappings for evicted pages (vectorized; sp < 0 lanes dropped)."""
    return RemapState(
        bitmap=bitmap_update(st.bitmap, sp, page, False),
        remap=_set_rows(st.remap, sp, page, -1),
    )


def translate(
    st: RemapState, sp: torch.Tensor, page: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized translation: (in_fast_tier bool, slot int32; -1 when not migrated)."""
    migrated = bitmap_get(st.bitmap, sp, page)
    slot = torch.where(migrated, st.remap[sp.long(), page.long()], -1)
    return migrated, slot
