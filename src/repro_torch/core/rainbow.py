"""RainbowController: the paper's memory-controller + OS modules on tensors.

  observe(accesses)  -> stage-1 superpage counting, stage-2 small-page counting
                        for the monitored hot superpages, DRAM-tier counters.
  end_interval()     -> top-N selection (next interval's monitors), hot-page
                        classification, utility admission (Eq. 1/2), remap and
                        bitmap install/evict, adaptive threshold update.
  interval_step()    -> observe + end_interval, one call per interval.

The phase bodies live in `repro_torch.engine.control`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import counting, migration
from repro_torch.core.counting import Stage1State, Stage2State
from repro_torch.core.migration import DramState, MigrationPlan, TimingParams
from repro_torch.core.remap import RemapState, remap_init
from repro_torch.engine import control
from repro_torch.engine.policy import ControlPolicy


class RainbowConfig(NamedTuple):
    """Layer-A controller config: ControlPolicy + superpage geometry."""

    num_superpages: int
    pages_per_sp: int
    policy: ControlPolicy

    def validate(self) -> "RainbowConfig":
        if self.num_superpages < 1 or self.pages_per_sp < 1:
            raise ValueError(
                "RainbowConfig: num_superpages and pages_per_sp must be >= 1 "
                f"(got {self.num_superpages}, {self.pages_per_sp})"
            )
        self.policy.validate("RainbowConfig")
        return self

    def control_config(self) -> control.ControlConfig:
        return self.policy.control_config(self.num_superpages, self.pages_per_sp)


class RainbowState(NamedTuple):
    s1: Stage1State
    s2_reads: Stage2State
    s2_writes: Stage2State
    dram: DramState
    remap: RemapState
    threshold: torch.Tensor  # float32 adaptive admission threshold
    interval: torch.Tensor  # int32 interval counter
    evictions_last: torch.Tensor  # int32 bidirectional-traffic monitor
    migrations_total: torch.Tensor  # int32 cumulative pages migrated in
    evictions_total: torch.Tensor  # int32 cumulative pages evicted


class IntervalReport(NamedTuple):
    plan: MigrationPlan
    cand_sp: torch.Tensor
    cand_page: torch.Tensor
    n_migrated: torch.Tensor
    n_evicted: torch.Tensor
    n_dirty_evicted: torch.Tensor
    threshold: torch.Tensor


def rainbow_init(cfg: RainbowConfig, device) -> RainbowState:
    """Fresh controller state; the threshold starts at the policy's threshold_init."""
    pol = cfg.policy

    def scalar(value, dtype):
        return torch.tensor(value, dtype=dtype, device=device)

    return RainbowState(
        s1=counting.stage1_init(cfg.num_superpages, device),
        s2_reads=counting.stage2_init(pol.top_n, cfg.pages_per_sp, device),
        s2_writes=counting.stage2_init(pol.top_n, cfg.pages_per_sp, device),
        dram=migration.dram_init(pol.hot_slots, device),
        remap=remap_init(cfg.num_superpages, cfg.pages_per_sp, device),
        threshold=scalar(pol.threshold_init, torch.float32),
        interval=scalar(0, torch.int32),
        evictions_last=scalar(0, torch.int32),
        migrations_total=scalar(0, torch.int32),
        evictions_total=scalar(0, torch.int32),
    )


def observe(cfg: RainbowConfig, st: RainbowState, sp, page, is_write, now) -> RainbowState:
    """Record one batch of accesses (DRAM-tier hits on slots, the rest on the
    NVM-tier two-stage counters)."""
    s1, s2r, s2w, dram = control.observe_tiers(
        cfg.control_config(), st.s1, st.s2_reads, st.s2_writes, st.dram, st.remap,
        sp, page, is_write, now,
    )
    return st._replace(s1=s1, s2_reads=s2r, s2_writes=s2w, dram=dram)


def end_interval(
    cfg: RainbowConfig, st: RainbowState, timing: TimingParams
) -> tuple[RainbowState, IntervalReport]:
    """Close the interval: classify hot pages, admit migrations, rotate monitors."""
    ctrl = cfg.control_config()
    out = control.plan_and_apply(
        ctrl,
        counting.counter_value(st.s2_reads.counts),
        counting.counter_value(st.s2_writes.counts),
        st.s2_reads.psn, st.remap, st.dram, st.threshold, timing, now=st.interval,
    )
    s1, new_psn, dram = control.rotate_monitors(ctrl, st.s1, out.dram)
    new_st = st._replace(
        s1=s1,
        s2_reads=counting.stage2_begin(new_psn, cfg.pages_per_sp),
        s2_writes=counting.stage2_begin(new_psn, cfg.pages_per_sp),
        dram=dram,
        remap=out.remap,
        threshold=out.threshold,
        interval=st.interval + 1,
        evictions_last=out.n_evicted,
        migrations_total=st.migrations_total + out.n_migrated,
        evictions_total=st.evictions_total + out.n_evicted,
    )
    report = IntervalReport(
        plan=out.plan,
        cand_sp=out.cand_sp,
        cand_page=out.cand_page,
        n_migrated=out.n_migrated,
        n_evicted=out.n_evicted,
        n_dirty_evicted=out.n_dirty,
        threshold=out.threshold,
    )
    return new_st, report


def interval_step(
    cfg: RainbowConfig, st: RainbowState, sp, page, is_write, timing: TimingParams
) -> tuple[RainbowState, IntervalReport]:
    """One full monitoring interval: observe the batch, then end_interval."""
    st = observe(cfg, st, sp, page, is_write, st.interval)
    return end_interval(cfg, st, timing)
