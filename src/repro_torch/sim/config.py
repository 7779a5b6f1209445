"""Layer-A simulator configuration: machine model (paper Table IV) + per-app
trace calibration (paper Tables I/II).

Scaling: memory capacities, footprints, and TLB entry counts are scaled by
1/SCALE_DOWN (default 16) so the simulator runs at laptop scale while preserving
the *ratios* that drive the paper's effects (working set vs TLB coverage, DRAM:NVM
= 1:8, hot-page fractions). Latency/energy parameters are per-access and unscaled.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.migration import SIM_CPU_GHZ, SIM_PAGE_BYTES, TIMING_PRESETS

CPU_GHZ = SIM_CPU_GHZ
NS = CPU_GHZ  # cycles per nanosecond

# Memory latencies + page-migration costs come from the shared preset table
# (core.migration.TIMING_PRESETS, built from the SAME clock/page constants) so
# the simulator and serving cost models are never two divergent copies.
_T4 = TIMING_PRESETS["paper-table4-sim"]

SCALE_DOWN = 16

PAGE_BYTES = SIM_PAGE_BYTES
SP_BYTES = 2 << 20
PAGES_PER_SP = SP_BYTES // PAGE_BYTES  # 512


@dataclasses.dataclass(frozen=True)
class MachineConfig:
    # --- split TLBs (Table IV), entries scaled by SCALE_DOWN ---
    l1_tlb_entries: int = 32 // SCALE_DOWN or 1
    l1_tlb_ways: int = 2
    l1_tlb_lat: float = 1.0
    l2_tlb_entries: int = 512 // SCALE_DOWN
    l2_tlb_ways: int = 8
    l2_tlb_lat: float = 8.0

    # --- memory latencies (cycles @ 3.2 GHz, from the shared preset table) ---
    t_dr: float = _T4["t_dr"]  # DRAM read  = 43.2
    t_dw: float = _T4["t_dw"]  # DRAM write = 91.2
    t_nr: float = _T4["t_nr"]  # PCM read   = 62.4
    t_nw: float = _T4["t_nw"]  # PCM write  = 547.2

    # --- translation structures ---
    bitmap_cache_lat: float = 9.0
    bitmap_cache_entries: int = 4000 // SCALE_DOWN
    bitmap_cache_ways: int = 8
    ptw_refs_4k: int = 4  # x86-64 4-level walk
    ptw_refs_2m: int = 3  # superpage walk: 3 levels
    remap_read_lat: float = 19.5 * NS  # read 8B pointer from NVM (t_nr)

    # --- consistency / migration costs (cycles) ---
    shootdown_cost: float = 4000.0  # per TLB shootdown event (IPI + inval)
    clflush_per_line: float = 40.0  # per 64B line flushed on migration
    mig_page_cost: float = _T4["t_mig"]  # rd PCM + wr DRAM, one 4 KB page
    writeback_page_cost: float = _T4["t_writeback"]

    # --- capacities (scaled) ---
    dram_bytes: int = (4 << 30) // SCALE_DOWN
    nvm_bytes: int = (32 << 30) // SCALE_DOWN

    # --- energy (per access / per bit, from Table IV) ---
    dram_volt: float = 1.5
    dram_read_ma: float = 237.0  # row-buffer miss (conservative)
    dram_write_ma: float = 242.0
    dram_standby_ma: float = 77.0
    dram_refresh_ma: float = 160.0
    pcm_read_pj_bit: float = 81.2  # row-buffer miss
    pcm_write_pj_bit: float = 1684.8
    pcm_hit_pj_bit: float = 1.616
    line_bytes: int = 64

    # --- Rainbow policy knobs (paper §IV-F) ---
    interval_cycles: float = 1e8
    top_n: int = 100
    write_weight: int = 2
    mig_threshold: float = 0.0
    # Eq. 1/2 admission amortizes T_mig over the expected DRAM residency of a
    # migrated page (pages persist across intervals; measured residency >> 1
    # interval). Full T_mig is still charged to cycles/traffic. Calibration
    # choice documented in EXPERIMENTS.md §Repro.
    t_mig_amortize: float = 8.0

    @property
    def dram_pages(self) -> int:
        return self.dram_bytes // PAGE_BYTES

    @property
    def dram_superpages(self) -> int:
        return self.dram_bytes // SP_BYTES

    @property
    def nvm_superpages(self) -> int:
        return self.nvm_bytes // SP_BYTES


@dataclasses.dataclass(frozen=True)
class AppProfile:
    """Synthetic-trace calibration from paper Tables I/II (unscaled MB)."""

    name: str
    footprint_mb: float  # Table I total memory footprint
    working_set_mb: float  # Table I working set per 1e8-cycle interval
    hot_page_pct: float  # Table I hot page percent of working set
    hot_min_access: int  # Table I min accesses of a hot page per interval
    # Table II: % of superpages covered by N hot 4KB pages, bucket upper bounds
    # (32, 64, 128, 256, 384, 512)
    sp_hot_dist: tuple[float, ...]
    write_ratio: float = 0.25
    zipf_alpha: float = 1.1  # skew of accesses over the hot set
    inst_per_access: float = 12.0  # instructions per memory-controller access
    accesses_per_interval: int = 120_000


APPS: dict[str, AppProfile] = {
    "cactusADM": AppProfile("cactusADM", 776, 74.6, 4.71, 64,
                            (28.01, 34.1, 29.32, 0.65, 7.45, 0.47), 0.35, 1.2, 18.0),
    "mcf": AppProfile("mcf", 1698, 1089, 2.36, 30,
                      (57.56, 16.48, 10.84, 9.95, 4.78, 0.39), 0.2, 1.05, 6.0, 260_000),
    "soplex": AppProfile("soplex", 1888, 70.9, 19.63, 51,
                         (45.69, 10.88, 22.76, 9.28, 6.77, 4.62), 0.25, 1.15, 8.0),
    "canneal": AppProfile("canneal", 972, 891.6, 8.52, 2,
                          (62.18, 15.86, 8.9, 11.57, 0.91, 0.58), 0.2, 0.8, 7.0, 240_000),
    "bodytrack": AppProfile("bodytrack", 620, 16.2, 1.0, 19,
                            (83.19, 6.01, 7.66, 2.18, 0.63, 0.33), 0.3, 1.3, 20.0),
    "streamcluster": AppProfile("streamcluster", 150, 105.5, 27.6, 10,
                                (23.77, 30.55, 14.38, 13.71, 17.5, 0.09), 0.15, 1.0, 9.0),
    "DICT": AppProfile("DICT", 384, 20.3, 37.2, 53,
                       (23.86, 14.53, 28.27, 22.14, 11.06, 0.14), 0.3, 1.2, 10.0),
    "BFS": AppProfile("BFS", 3718, 404.1, 20.51, 30,
                      (3.94, 18.19, 57.42, 6.35, 5.6, 8.5), 0.2, 1.0, 7.0, 200_000),
    "setCover": AppProfile("setCover", 2520, 49.8, 37.53, 34,
                           (16.26, 24.28, 27.58, 17.36, 7.5, 7.02), 0.25, 1.1, 9.0, 150_000),
    "MST": AppProfile("MST", 6660, 121.2, 32.42, 35,
                      (13.44, 21.28, 21.77, 25.8, 16.31, 1.4), 0.25, 1.05, 8.0, 160_000),
    "Graph500": AppProfile("Graph500", 27.4 * 1024, 7.2, 6.35, 64,
                           (61.48, 38.46, 0.06, 0.0, 0.0, 0.0), 0.2, 1.2, 5.0),
    "Linpack": AppProfile("Linpack", 23.9 * 1024, 40, 21.19, 63,
                          (22.21, 14.71, 29.18, 16.3, 9.64, 7.96), 0.35, 1.25, 15.0),
    "NPB-CG": AppProfile("NPB-CG", 22.9 * 1024, 40.9, 24.7, 64,
                         (0.05, 96.29, 2.66, 1.0, 0.0, 0.0), 0.25, 1.2, 10.0),
    "GUPS": AppProfile("GUPS", 8.06 * 1024, 7.6 * 1024, 5.8, 4,
                       (95.5, 4.5, 0.0, 0.0, 0.0, 0.0), 0.5, 0.6, 4.0, 320_000),
}

MIXES: dict[str, tuple[str, ...]] = {
    "mix1": ("cactusADM", "soplex", "setCover", "MST"),
    "mix2": ("setCover", "BFS", "DICT", "mcf"),
    "mix3": ("canneal", "DICT", "MST", "soplex"),
}

POLICIES = ("flat-static", "hscc-4kb-mig", "hscc-2mb-mig", "rainbow", "dram-only")
