"""Energy model (paper Table IV): DRAM current-based dynamic + capacity-scaled
static (standby + refresh), PCM pJ/bit dynamic.

Scaling: the simulator runs 1/SCALE_DOWN of the real per-interval work, so
dynamic/migration energies are multiplied back by SCALE_DOWN, and static power
uses the *unscaled* DRAM capacity over the scaled-up wall time. This keeps the
static-vs-dynamic balance of the paper's full-size system (Fig. 12: DRAM-only
pays 8x standby+refresh; misused hybrids pay PCM write energy)."""
from __future__ import annotations

from repro_torch.sim.config import CPU_GHZ, SCALE_DOWN, MachineConfig


def energy_joules(
    mc: MachineConfig,
    dram_reads: float,
    dram_writes: float,
    nvm_reads: float,
    nvm_writes: float,
    mig_bytes: float,
    total_cycles: float,
    dram_capacity_factor: float = 1.0,
) -> dict[str, float]:
    """dram_capacity_factor: 1 for the 4GB hybrid tiers, 8 for DRAM-only (32GB)."""
    t_dr_s = mc.t_dr / (CPU_GHZ * 1e9)
    t_dw_s = mc.t_dw / (CPU_GHZ * 1e9)
    e_dr = mc.dram_volt * (mc.dram_read_ma * 1e-3) * t_dr_s
    e_dw = mc.dram_volt * (mc.dram_write_ma * 1e-3) * t_dw_s
    line_bits = mc.line_bytes * 8
    e_nr = mc.pcm_read_pj_bit * line_bits * 1e-12
    e_nw = mc.pcm_write_pj_bit * line_bits * 1e-12

    dyn = (
        dram_reads * e_dr
        + dram_writes * e_dw
        + nvm_reads * e_nr
        + nvm_writes * e_nw
    ) * SCALE_DOWN
    # migration traffic: PCM read + DRAM write per line moved
    lines_moved = mig_bytes / mc.line_bytes
    mig = lines_moved * (e_nr + e_dw) * SCALE_DOWN

    # static: Table IV currents are per 4GB module; wall time scaled back up
    wall_s = total_cycles * SCALE_DOWN / (CPU_GHZ * 1e9)
    static_ma = (mc.dram_standby_ma + mc.dram_refresh_ma) * dram_capacity_factor
    static = mc.dram_volt * static_ma * 1e-3 * wall_s

    return {
        "dynamic_j": dyn,
        "migration_j": mig,
        "static_j": static,
        "total_j": dyn + mig + static,
    }
