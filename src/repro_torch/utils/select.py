"""Fixed-shape selection shared by the engine's shootdown step."""
from __future__ import annotations

import torch


def first_k_valid(values: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """First k `values` whose lane is valid, in lane order; -1 padding.

    A cumulative sum ranks the valid lanes (each rank is unique, so the
    scatter is conflict-free); lanes past the first k land in a pad slot that
    is cut off.  int32[k].
    """
    rank = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    dst = torch.where(valid & (rank < k), rank, torch.full_like(rank, k))
    out = torch.full((k + 1,), -1, dtype=torch.int32, device=values.device)
    out[dst.long()] = values.to(torch.int32)
    return out[:k]
