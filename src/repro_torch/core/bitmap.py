"""Migration bitmap + set-associative bitmap cache (Rainbow §III-D).

The bitmap marks, per 4 KB small page, whether the page has been migrated to
the performance tier, packed 32 pages per word.  Words are carried as int32
holding the reference's uint32 bit pattern (torch's unsigned types support
few ops); `interop` reinterprets them at the numpy boundary.

The BitmapCache models the paper's 8-way SRAM cache in the memory controller;
the per-access walk (sim.tlbsim) probes it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def bitmap_init(num_superpages: int, pages_per_sp: int, device) -> torch.Tensor:
    words = (pages_per_sp + 31) // 32
    return torch.zeros((num_superpages, words), dtype=torch.int32, device=device)


def bitmap_get(bitmap: torch.Tensor, sp: torch.Tensor, page: torch.Tensor) -> torch.Tensor:
    """Vectorized test of migration flags. sp/page may be any matching shape."""
    word = bitmap[sp.long(), (page >> 5).long()]
    return ((word >> (page & 31)) & 1).bool()


def _unpack(bitmap: torch.Tensor) -> torch.Tensor:
    """int32[S, W] words -> bool[S, W*32] bits (bit j of word w is page 32w+j)."""
    shifts = torch.arange(32, dtype=torch.int32, device=bitmap.device)
    bits = (bitmap.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(bitmap.shape[0], -1).bool()


def _pack(bits: torch.Tensor, words: int) -> torch.Tensor:
    """bool[S, W*32] bits -> int32[S, W] words (uint32 pattern, wrapped)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = (bits.reshape(bits.shape[0], words, 32).long() << shifts).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def bitmap_update(
    bitmap: torch.Tensor, sp: torch.Tensor, page: torch.Tensor, value: bool
) -> torch.Tensor:
    """Set (value=True) or clear (value=False) the given (sp, page) positions.

    Duplicates are safe; entries with sp < 0 are dropped.
    """
    num_sp, words = bitmap.shape
    bits = _unpack(bitmap)
    bits = torch.cat([bits, torch.zeros_like(bits[:1])])  # pad row for sp < 0
    row = torch.where(sp >= 0, sp, num_sp).long()
    bits[row, page.long()] = value
    return _pack(bits[:num_sp], words)


class BitmapCache(NamedTuple):
    """8-way set-associative cache of per-superpage bitmaps.

    tags: int32[sets, ways] physical superpage number (-1 invalid)
    lru:  int32[sets, ways] last-touch timestamp
    """

    tags: torch.Tensor
    lru: torch.Tensor


def bitmap_cache_init(entries: int, ways: int, device) -> BitmapCache:
    sets = max(1, entries // ways)
    return BitmapCache(
        tags=torch.full((sets, ways), -1, dtype=torch.int32, device=device),
        lru=torch.zeros((sets, ways), dtype=torch.int32, device=device),
    )
