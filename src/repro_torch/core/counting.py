"""Two-stage memory access counting (Rainbow §III-B).

Stage 1: per-superpage saturating counters -- the 15-bit value + 1-bit sticky
overflow layout of Fig. 4.  Stage 2: for the top-N hot superpages, per-4KB
page counters inside each monitored superpage (an [N, pages_per_sp] table
plus the PSN tag per row).

The reference stores counters as uint16; here they are int32 tensors holding
the same 16-bit pattern (torch's unsigned types support few ops).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.migration import order_desc

COUNTER_MAX = (1 << 15) - 1  # 15-bit value field
OVERFLOW_BIT = 1 << 15  # 1-bit overflow flag (=> "definitely hot")


class Stage1State(NamedTuple):
    """Per-superpage access counters for one interval."""

    counts: torch.Tensor  # int32[num_superpages]: 15-bit value + overflow bit


class Stage2State(NamedTuple):
    """Fine-grained counters for the top-N monitored superpages."""

    psn: torch.Tensor  # int32[N] superpage number per row (-1 = unused)
    counts: torch.Tensor  # int32[N, pages_per_sp]


def stage1_init(num_superpages: int, device) -> Stage1State:
    return Stage1State(counts=torch.zeros((num_superpages,), dtype=torch.int32,
                                          device=device))


def stage2_init(top_n: int, pages_per_sp: int, device) -> Stage2State:
    return Stage2State(
        psn=torch.full((top_n,), -1, dtype=torch.int32, device=device),
        counts=torch.zeros((top_n, pages_per_sp), dtype=torch.int32, device=device),
    )


def counter_value(counts: torch.Tensor) -> torch.Tensor:
    """Effective hotness: overflowed counters count as COUNTER_MAX + 1."""
    val = counts & COUNTER_MAX
    return torch.where((counts & OVERFLOW_BIT) != 0, COUNTER_MAX + 1, val)


def saturating_merge(counts: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """Fold a batch histogram into 15-bit + sticky-overflow counters.

    The batch is reduced first and saturated once, as in the reference (both
    of its counting paths reduce in uint32 before saturating).
    """
    new = (counts & COUNTER_MAX).long() + hist.long()
    ovf = (counts & OVERFLOW_BIT) | torch.where(new > COUNTER_MAX, OVERFLOW_BIT, 0)
    return torch.clamp(new, max=COUNTER_MAX).to(torch.int32) | ovf.to(torch.int32)


def _saturating_add(counts: torch.Tensor, idx: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """Scatter-add with 15-bit saturation + sticky overflow bit (Fig. 4)."""
    add = torch.zeros(counts.shape, dtype=torch.int32, device=counts.device)
    return saturating_merge(counts, add.index_add_(0, idx.long(), inc.to(torch.int32)))


def stage1_record(
    state: Stage1State, superpage_ids: torch.Tensor, is_write: torch.Tensor,
    write_weight: int = 2,
) -> Stage1State:
    """Count one batch of NVM accesses per superpage (<0 ids ignored).

    NVM writes carry `write_weight` (paper: "NVM write operations have a
    higher weighting of the counter value").
    """
    return stage1_record_weighted(state, superpage_ids,
                                  torch.where(is_write, write_weight, 1))


def stage1_record_weighted(
    state: Stage1State, superpage_ids: torch.Tensor, weight: torch.Tensor
) -> Stage1State:
    """Count one batch per superpage with explicit per-lane weights (<0 ids
    ignored); Layer B feeds quantized attention mass here.  Weights are the
    reference's uint32 values carried as int32."""
    valid = superpage_ids >= 0
    inc = torch.where(valid, weight.to(torch.int32), 0)
    idx = torch.where(valid, superpage_ids, 0)
    return Stage1State(counts=_saturating_add(state.counts, idx, inc))


def select_top_n(state: Stage1State, top_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """End of interval: the top-N hot superpages (paper step (2)).

    Returns (psn int32[N], counts int32[N]); rows with zero accesses get
    psn=-1.  Ties go to the lower superpage index, as ``lax.top_k`` orders
    them (all-zero counters are the common tie).
    """
    hotness = counter_value(state.counts)
    k = min(top_n, hotness.shape[0])
    order = order_desc(hotness)[:k]
    vals = hotness[order]
    psn = torch.where(vals > 0, order.to(torch.int32), -1)
    if k < top_n:  # fewer superpages than monitor rows: pad with empty rows
        pad = top_n - k
        psn = torch.cat([psn, psn.new_full((pad,), -1)])
        vals = torch.cat([vals, vals.new_zeros((pad,))])
    return psn, vals


def stage2_begin(psn: torch.Tensor, pages_per_sp: int) -> Stage2State:
    """Start fine-grained monitoring of the selected superpages."""
    return Stage2State(
        psn=psn.to(torch.int32),
        counts=torch.zeros((psn.shape[0], pages_per_sp), dtype=torch.int32,
                           device=psn.device),
    )


def psn_to_row(psn: torch.Tensor, superpage_ids: torch.Tensor) -> torch.Tensor:
    """Monitor row of each access's superpage (-1 if unmonitored; first row wins)."""
    eq = (superpage_ids.unsqueeze(1) == psn.unsqueeze(0)) & (psn >= 0).unsqueeze(0)
    row = torch.argmax(eq.to(torch.uint8), dim=1).to(torch.int32)
    return torch.where(eq.any(dim=1), row, -1)


def stage2_record_weighted(
    state: Stage2State,
    superpage_ids: torch.Tensor,  # int32[B] (<0 = ignore)
    page_offsets: torch.Tensor,  # int32[B] small-page index within superpage
    weight: torch.Tensor,  # int[B] per-lane increment (0 = inert lane)
) -> Stage2State:
    """Count accesses in monitored superpages at small-page grain."""
    row = psn_to_row(state.psn, superpage_ids)
    valid = row >= 0
    n, p = state.counts.shape
    flat_idx = torch.where(valid, row * p + page_offsets, 0)
    inc = torch.where(valid, weight.to(torch.int32), 0)
    flat = _saturating_add(state.counts.reshape(-1), flat_idx, inc)
    return Stage2State(psn=state.psn, counts=flat.reshape(n, p))
