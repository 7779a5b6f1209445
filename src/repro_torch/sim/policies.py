"""Per-policy admission timing and interval cost model of the simulator.

This slice ports the rainbow entries; the other policies' costs come with
their step programs (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

from repro_torch.core.migration import TimingParams, make_timing
from repro_torch.engine.policy import require_ported
from repro_torch.sim.config import MachineConfig


def machine_timing(mc: MachineConfig) -> TimingParams:
    """Admission-test timing: T_mig amortized over expected residency."""
    a = max(mc.t_mig_amortize, 1.0)
    return make_timing(
        t_nr=mc.t_nr, t_nw=mc.t_nw, t_dr=mc.t_dr, t_dw=mc.t_dw,
        t_mig=mc.mig_page_cost / a, t_writeback=mc.writeback_page_cost / a,
    )


def interval_costs(
    policy: str, mc: MachineConfig, migrations: int, evictions: int,
    dirty: int, shootdowns: int,
) -> dict[str, float]:
    """Per-interval traffic/cycle costs derived from migration counts.

    Clean evictions write back only the 8-byte remap pointer (§III-E).
    """
    require_ported(policy)
    moved = migrations + evictions
    return {
        "mig_bytes": migrations * 4096.0 + dirty * 4096.0 + (evictions - dirty) * 8.0,
        "mig_cycles": migrations * mc.mig_page_cost + dirty * mc.writeback_page_cost,
        "shootdown_cycles": shootdowns * mc.shootdown_cost,
        "clflush_cycles": moved * (4096 / mc.line_bytes) * mc.clflush_per_line,
    }
