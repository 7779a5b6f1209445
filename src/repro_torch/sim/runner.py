"""Layer-A experiment runner: a thin host shell over the engine.

`simulate` generates the interval traces host-side, runs the engine on one
device (the GPU unless the caller asks for the CPU), and aggregates the
paper's metrics (MPKI, TLB-service cycles, IPC, migration traffic, energy,
translation breakdown) on the host.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.engine import simloop
from repro_torch.sim import trace as trace_mod
from repro_torch.sim.config import MachineConfig
from repro_torch.sim.energy import energy_joules
from repro_torch.sim.policies import interval_costs

BASE_CPI = 0.6  # out-of-order core CPI on non-memory work

_ZERO_TOTALS = {
    "migrations": 0, "evictions": 0, "dirty": 0, "shootdowns": 0,
    "mig_bytes": 0.0, "mig_cycles": 0.0, "shootdown_cycles": 0.0,
    "clflush_cycles": 0.0, "accesses": 0,
    # queueing timing model; exact 0.0 under timing_model="flat"
    "stall_dram": 0.0, "stall_nvm": 0.0, "mig_stall": 0.0,
    "backlog_dram": 0.0, "backlog_nvm": 0.0, "intervals": 0,
    # transactional async migration; 0 for synchronous policies
    "aborts": 0,
}


@dataclasses.dataclass
class SimMetrics:
    app: str
    policy: str
    instructions: float
    total_cycles: float
    ipc: float
    mpki: float
    tlb_service_cycles: float
    tlb_service_frac: float
    breakdown: dict[str, float]
    migrations: int
    evictions: int
    shootdowns: int
    mig_bytes: float
    footprint_bytes: float
    traffic_ratio: float
    energy: dict[str, float]
    bank_stall_cycles: float = 0.0
    mig_stall_cycles: float = 0.0
    queue_occupancy_dram: float = 0.0
    queue_occupancy_nvm: float = 0.0
    mig_aborts: int = 0


def finalize_metrics(
    app: str,
    policy: str,
    mc: MachineConfig,
    totals: dict,
    counters,
    inst_per_access: float,
    footprint_pages: int,
) -> SimMetrics:
    """Metrics from accumulated per-interval totals + final walk counters."""
    c = counters
    f = lambda x: float(x)  # float32 0-d tensor -> the same value as a Python float
    cycles_trans = (
        f(c.cycles_tlb) + f(c.cycles_walk) + f(c.cycles_bitmap) + f(c.cycles_remap)
    )
    instructions = totals["accesses"] * inst_per_access
    bank_stall = totals["stall_dram"] + totals["stall_nvm"]
    total_cycles = (
        instructions * BASE_CPI
        + cycles_trans
        + f(c.cycles_mem)
        + totals["mig_cycles"]
        + totals["shootdown_cycles"]
        + totals["clflush_cycles"]
        + bank_stall
    )
    # rainbow: page walks happen only when the superpage TLB misses
    tlb_misses = f(c.miss2m_l2)

    energy = energy_joules(
        mc,
        f(c.dram_reads), f(c.dram_writes), f(c.nvm_reads), f(c.nvm_writes),
        totals["mig_bytes"], total_cycles, dram_capacity_factor=1.0,
    )

    fp_bytes = footprint_pages * 4096.0
    return SimMetrics(
        app=app,
        policy=policy,
        instructions=instructions,
        total_cycles=total_cycles,
        ipc=instructions / total_cycles,
        mpki=tlb_misses / (instructions / 1000.0),
        tlb_service_cycles=cycles_trans,
        tlb_service_frac=cycles_trans / total_cycles,
        breakdown={
            "cycles_tlb": f(c.cycles_tlb),
            "cycles_walk": f(c.cycles_walk),
            "cycles_bitmap": f(c.cycles_bitmap),
            "cycles_remap": f(c.cycles_remap),
            "cycles_mem": f(c.cycles_mem),
            "cycles_mig": totals["mig_cycles"],
            "cycles_shootdown": totals["shootdown_cycles"],
            "cycles_clflush": totals["clflush_cycles"],
            "cycles_bank_stall": bank_stall,
            "bmc_misses": f(c.bmc_miss),
        },
        migrations=totals["migrations"],
        evictions=totals["evictions"],
        shootdowns=totals["shootdowns"],
        mig_bytes=totals["mig_bytes"],
        footprint_bytes=fp_bytes,
        traffic_ratio=totals["mig_bytes"] / fp_bytes,
        energy=energy,
        bank_stall_cycles=bank_stall,
        mig_stall_cycles=totals["mig_stall"],
        queue_occupancy_dram=totals["backlog_dram"] / max(totals["intervals"], 1),
        queue_occupancy_nvm=totals["backlog_nvm"] / max(totals["intervals"], 1),
        mig_aborts=totals["aborts"],
    )


def totals_from_stats(
    policy: str, mc: MachineConfig, stats: simloop.IntervalStats,
    accesses_per_interval: int,
) -> dict:
    """Accumulate per-interval stats in the reference's order and types."""
    totals = dict(_ZERO_TOTALS)
    cols = zip(*(x.tolist() for x in stats))
    for m, e, d, s, sd, sn, ms, bd, bn, ab in cols:
        costs = interval_costs(policy, mc, m, e, d, s)
        totals["migrations"] += m
        totals["evictions"] += e
        totals["dirty"] += d
        totals["shootdowns"] += s
        totals["mig_bytes"] += costs["mig_bytes"]
        totals["mig_cycles"] += costs["mig_cycles"]
        totals["shootdown_cycles"] += costs["shootdown_cycles"]
        totals["clflush_cycles"] += costs["clflush_cycles"]
        totals["accesses"] += accesses_per_interval
        totals["stall_dram"] += sd
        totals["stall_nvm"] += sn
        totals["mig_stall"] += ms
        totals["backlog_dram"] += bd
        totals["backlog_nvm"] += bn
        totals["aborts"] += ab
        totals["intervals"] += 1
    return totals


def resolve_device(device) -> torch.device:
    """`device`, or the GPU when None; raises when the GPU is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


def simulate(
    app: str,
    policy: str,
    mc: MachineConfig | None = None,
    intervals: int = 5,
    accesses: int | None = None,
    seed: int = 7,
    counter_backend: str = "kernel",
    device=None,
    timing_model: str = "flat",
    fused: bool = False,
) -> SimMetrics:
    """Simulate (app x policy) over N intervals and aggregate SimMetrics.

    `app` is a numpy app profile or a mix.  `device=None` runs on the GPU and
    raises if there is none; `device="cpu"` runs every kernel's plain
    version.  `counter_backend` is "kernel" (the fused counting kernel) or
    "scatter" (saturating scatter-adds); the two are bitwise equal.
    """
    if fused:
        raise NotImplementedError(
            "fused in-loop trace generation is not ported yet "
            "(ROADMAP.md Queue 1 item 10)"
        )
    if timing_model != "flat":
        raise NotImplementedError(
            f"timing_model={timing_model!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 8); this slice runs 'flat'"
        )
    if intervals < 1:
        raise ValueError(f"intervals must be >= 1 (got {intervals})")
    dev = resolve_device(device)
    mc = mc or MachineConfig()
    probe = trace_mod.probe_meta(app, accesses)
    spec = simloop.EngineSpec(
        policy=policy,
        mc=mc,
        num_superpages=probe["num_superpages"],
        footprint_pages=probe["footprint_pages"],
        counter_backend=counter_backend,
    ).validate()
    chunks, meta = simloop.make_chunks_np(app, policy, mc, seed, intervals, accesses)
    state, stats = simloop.engine_run(
        spec, simloop.engine_init(spec, dev), simloop.chunks_to(chunks, dev)
    )
    totals = totals_from_stats(policy, mc, stats, meta["accesses_per_interval"])
    return finalize_metrics(
        app, policy, mc, totals, state.sim.counters,
        meta["inst_per_access"], meta["footprint_pages"],
    )

