"""The interval controller of Rainbow (§III) as three phases on tensors.

  observe_tiers    : translate a batch of accesses, count the NVM tier with the
                     two-stage counters (stage-1 superpage + stage-2 read/write
                     small-page), and record DRAM-tier slot stats for Eq. 2.
  plan_and_apply   : hot-page candidates from the stage-2 counters, utility
                     admission (Eq. 1/2) against the free/clean/dirty slot
                     manager, remap/bitmap evict + install, adaptive
                     threshold update (§III-C).
  rotate_monitors  : top-N hot-superpage selection for the next interval and
                     per-interval counter reset.

The counting step has two backends behind ``ControlConfig.counter_backend``:
"kernel" -- the fused one-pass counter (kernels/page_counter), merged into
the saturating counters -- and "scatter", the saturating scatter-adds of the
reference's "jax" backend.  Both reduce the batch before saturating once, so
they are bitwise equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.counting import (
    Stage1State,
    Stage2State,
    saturating_merge,
    select_top_n,
    stage1_init,
    stage1_record,
    stage2_record_weighted,
)
from repro_torch.core.migration import (
    DramState,
    MigrationPlan,
    TimingParams,
    adapt_threshold,
    dram_apply_plan,
    dram_new_interval,
    dram_record_access,
    migration_benefit,
    order_desc,
    plan_migrations,
)
from repro_torch.core.remap import RemapState, remap_evict, remap_install, translate
from repro_torch.kernels.page_counter.ops import fused_observe_count


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Static geometry of one controller instance.

    Layer A: units = superpages, pages = 4 KB pages.  `max_moves` bounds the
    per-interval plan size K.
    """

    num_units: int = 1024
    pages_per_unit: int = 512
    top_n: int = 100
    max_moves: int = 512
    write_weight: int = 2
    counter_backend: str = "kernel"


class PlanOutcome(NamedTuple):
    """Result of plan_and_apply (the interval's migration decision + new tables)."""

    remap: RemapState
    dram: DramState
    threshold: torch.Tensor
    plan: MigrationPlan
    cand_sp: torch.Tensor
    cand_page: torch.Tensor
    n_migrated: torch.Tensor  # int32
    n_evicted: torch.Tensor  # int32
    n_dirty: torch.Tensor  # int32


def observe_tiers(
    cfg: ControlConfig,
    s1: Stage1State,
    s2_reads: Stage2State,
    s2_writes: Stage2State,
    dram: DramState,
    remap: RemapState,
    sp: torch.Tensor,  # int32[B] unit id per access
    page: torch.Tensor,  # int32[B] page within unit
    is_write: torch.Tensor,  # bool[B]
    now: torch.Tensor,  # int32 logical time (LRU)
) -> tuple[Stage1State, Stage2State, Stage2State, DramState]:
    """Record one access batch: NVM-tier two-stage counting + DRAM-tier stats."""
    in_dram, slot = translate(remap, sp, page)
    nvm_sp = torch.where(in_dram, -1, sp)

    if cfg.counter_backend == "scatter":
        s1 = stage1_record(s1, nvm_sp, is_write, cfg.write_weight)
        s2_reads = stage2_record_weighted(s2_reads, nvm_sp, page, ~is_write)
        s2_writes = stage2_record_weighted(s2_writes, nvm_sp, page, is_write)
    elif cfg.counter_backend == "kernel":
        h1, h2r, h2w = fused_observe_count(
            nvm_sp, page, is_write, s2_reads.psn, cfg.num_units,
            cfg.pages_per_unit, write_weight=cfg.write_weight,
        )
        s1 = Stage1State(counts=saturating_merge(s1.counts, h1))
        s2_reads = s2_reads._replace(counts=saturating_merge(s2_reads.counts, h2r))
        s2_writes = s2_writes._replace(counts=saturating_merge(s2_writes.counts, h2w))
    else:
        raise ValueError(
            f"unknown counter_backend {cfg.counter_backend!r}; "
            "expected 'kernel' or 'scatter'"
        )

    dram = dram_record_access(dram, torch.where(in_dram, slot, -1), is_write, now)
    return s1, s2_reads, s2_writes, dram


def plan_and_apply(
    cfg: ControlConfig,
    reads: torch.Tensor,  # [N, P] effective read counts of monitored units
    writes: torch.Tensor,  # [N, P] effective write counts
    psn: torch.Tensor,  # int32[N] monitored unit per row (-1 unused)
    remap: RemapState,
    dram: DramState,
    threshold: torch.Tensor,
    timing: TimingParams,
    now: torch.Tensor,
) -> PlanOutcome:
    """Close the interval's decision: classify hot pages and admit migrations.

    Candidates are the K best (Eq. 1) monitored pages not already resident;
    admission runs Eq. 1/2 against the slot manager best-first into victims
    cheapest-first, then the remap/bitmap tables evict + install.
    """
    # one exact float32 conversion (saturating counters cap at 32768 << 2**24)
    reads = reads.float()
    writes = writes.float()
    n, p = reads.shape
    dev = reads.device

    valid_row = (psn >= 0).unsqueeze(1)
    score = migration_benefit(reads, writes, timing)
    score = torch.where(valid_row, score, -math.inf)
    already, _ = translate(
        remap, torch.clamp(psn, min=0).unsqueeze(1),
        torch.arange(p, dtype=torch.int32, device=dev).unsqueeze(0),
    )
    score = torch.where(already & valid_row, -math.inf, score).reshape(-1)

    k = min(cfg.max_moves, score.shape[0])
    top_idx = order_desc(score)[:k]
    top_score = score[top_idx]
    cand_sp = torch.where(top_score > -math.inf, psn[top_idx // p], -1)
    cand_page = (top_idx % p).to(torch.int32)
    cand_r = reads.reshape(-1)[top_idx]
    cand_w = writes.reshape(-1)[top_idx]

    plan = plan_migrations(cand_sp, cand_page, cand_r, cand_w, dram, timing, threshold)
    dram = dram_apply_plan(dram, plan, cand_sp, cand_page, now)

    rm = remap_evict(remap, plan.evict_sp, plan.evict_page)
    rm = remap_install(rm, torch.where(plan.migrate, cand_sp, -1), cand_page,
                       plan.dst_slot)

    n_migrated = plan.migrate.sum(dtype=torch.int32)
    n_evicted = (plan.evict_sp >= 0).sum(dtype=torch.int32)
    n_dirty = plan.evict_dirty.sum(dtype=torch.int32)
    threshold = adapt_threshold(threshold, n_evicted)

    return PlanOutcome(
        remap=rm, dram=dram, threshold=threshold, plan=plan,
        cand_sp=cand_sp, cand_page=cand_page,
        n_migrated=n_migrated, n_evicted=n_evicted, n_dirty=n_dirty,
    )


def rotate_monitors(
    cfg: ControlConfig, s1: Stage1State, dram: DramState
) -> tuple[Stage1State, torch.Tensor, DramState]:
    """Rotate to the next interval: (fresh stage-1, new monitor set, reset slots).

    The next interval's stage-2 monitors are this interval's stage-1 top-N;
    stage-1 restarts from zero (the paper's per-interval reset) and DRAM
    per-interval slot stats are zeroed.
    """
    new_psn, _ = select_top_n(s1, cfg.top_n)
    return stage1_init(cfg.num_units, s1.counts.device), new_psn, dram_new_interval(dram)
