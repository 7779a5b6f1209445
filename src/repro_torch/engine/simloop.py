"""Layer-A engine: the simulation as a loop over intervals on one device.

  EngineStep = residency -> per-access walk (walk kernel) -> observe (counting
               kernel) -> plan + apply + rotate (controller tensor ops) ->
               TLB shootdowns

`engine_run` steps the intervals from a Python loop; every step's work stays
on the device.  This slice runs the "rainbow" policy under flat timing; the
other policies, queueing timing, fused in-loop trace generation and batched
cells raise NotImplementedError naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import rainbow as rb
from repro_torch.core.remap import translate
from repro_torch.core.tlb import split_tlb_invalidate_many
from repro_torch.engine.policy import ControlPolicy, require_ported, sim_policy_for
from repro_torch.sim import tlbsim
from repro_torch.sim import trace as trace_mod
from repro_torch.sim.config import PAGES_PER_SP, MachineConfig
from repro_torch.sim.policies import machine_timing
from repro_torch.utils.select import first_k_valid

#: 4KB-TLB shootdowns applied per interval (the reference's max_invalidate).
MAX_INVALIDATE = 256


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Static configuration of one engine run."""

    policy: str
    mc: MachineConfig
    num_superpages: int
    footprint_pages: int
    counter_backend: str = "kernel"  # "kernel" | "scatter"

    def validate(self) -> "EngineSpec":
        self.control_policy()
        return self

    def control_policy(self) -> ControlPolicy:
        """The effective ControlPolicy of this run."""
        return sim_policy_for(self.policy, self.mc, self.counter_backend)


class TraceChunks(NamedTuple):
    """Pre-generated trace: [intervals, accesses] per field.

    `in_dram` is all False for rainbow, which derives residency on the
    device (the reference fills it for its state-free policies).
    """

    sp: np.ndarray | torch.Tensor  # int32[I, A]
    page: np.ndarray | torch.Tensor  # int32[I, A]
    vpn: np.ndarray | torch.Tensor  # int32[I, A]
    is_write: np.ndarray | torch.Tensor  # bool[I, A]
    in_dram: np.ndarray | torch.Tensor  # bool[I, A]


class EngineState(NamedTuple):
    sim: tlbsim.SimState
    pol: rb.RainbowState


class IntervalStats(NamedTuple):
    """Per-interval migration activity (host finalize derives bytes/cycles).

    The queueing-model fields are exact zeros under flat timing.
    """

    migrations: torch.Tensor  # int32
    evictions: torch.Tensor  # int32
    dirty_evictions: torch.Tensor  # int32
    shootdowns: torch.Tensor  # int32
    stall_dram: torch.Tensor  # f32
    stall_nvm: torch.Tensor  # f32
    mig_stall: torch.Tensor  # f32
    backlog_dram: torch.Tensor  # f32
    backlog_nvm: torch.Tensor  # f32
    aborts: torch.Tensor  # int32


# ---------------------------------------------------------------------------
# Host-side trace pre-generation
# ---------------------------------------------------------------------------


def make_chunks_np(
    app: str,
    policy: str,
    mc: MachineConfig,
    seed: int,
    intervals: int,
    accesses: int | None = None,
) -> tuple[TraceChunks, dict]:
    """Generate + stack all interval traces host-side (numpy TraceChunks)."""
    require_ported(policy)
    traces = [trace_mod.generate(app, seed, i, accesses) for i in range(intervals)]
    t0 = traces[0]
    vpn64 = np.stack([t.vpn for t in traces])
    wr = np.stack([t.is_write for t in traces])
    in_dram = np.zeros_like(wr)
    chunks = TraceChunks(
        sp=np.stack([t.sp for t in traces]),
        page=np.stack([t.page for t in traces]),
        vpn=vpn64.astype(np.int32),
        is_write=wr,
        in_dram=in_dram,
    )
    meta = {
        "num_superpages": int(t0.num_superpages),
        "footprint_pages": int(t0.footprint_pages),
        "inst_per_access": float(t0.inst_per_access),
        "accesses_per_interval": int(t0.sp.shape[0]),
    }
    return chunks, meta


def chunks_to(chunks: TraceChunks, device) -> TraceChunks:
    """numpy TraceChunks -> tensors on `device` (one copy per field)."""
    return TraceChunks(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                         for x in chunks))


# ---------------------------------------------------------------------------
# The rainbow step program
# ---------------------------------------------------------------------------


def _rainbow_cfg(spec: EngineSpec) -> rb.RainbowConfig:
    return rb.RainbowConfig(
        num_superpages=spec.num_superpages,
        pages_per_sp=PAGES_PER_SP,
        policy=spec.control_policy(),
    ).validate()


def engine_init(spec: EngineSpec, device) -> EngineState:
    spec.validate()
    return EngineState(
        sim=tlbsim.init_state(spec.mc, device),
        pol=rb.rainbow_init(_rainbow_cfg(spec), device),
    )


def _zero_stats(device) -> IntervalStats:
    zi = torch.zeros((), dtype=torch.int32, device=device)
    zf = torch.zeros((), dtype=torch.float32, device=device)
    return IntervalStats(zi, zi, zi, zi, zf, zf, zf, zf, zf, zi)


def _rainbow_finish(rep: rb.IntervalReport) -> tuple[IntervalStats, torch.Tensor]:
    """Shootdown list + interval stats from a rainbow IntervalReport.

    NVM->DRAM migration needs no shootdown (the superpage mapping is
    unchanged); only DRAM->NVM writeback shoots down the 4KB entries
    (paper §III-F), at most MAX_INVALIDATE of them.
    """
    ev_valid = rep.plan.evict_sp >= 0
    ev_vpn = rep.plan.evict_sp * PAGES_PER_SP + rep.plan.evict_page
    inval = first_k_valid(ev_vpn, ev_valid, MAX_INVALIDATE)
    stats = _zero_stats(ev_vpn.device)._replace(
        migrations=rep.n_migrated,
        evictions=rep.n_evicted,
        dirty_evictions=rep.n_dirty_evicted,
        shootdowns=rep.n_evicted,
    )
    return stats, inval


def engine_step(
    spec: EngineSpec, state: EngineState, chunk: TraceChunks
) -> tuple[EngineState, IntervalStats]:
    """One interval on the device: residency -> walk -> migrate -> shootdowns."""
    pol = state.pol
    in_dram, _ = translate(pol.remap, chunk.sp, chunk.page)
    sim = tlbsim.run_interval("rainbow", spec.mc, state.sim, chunk.vpn, chunk.sp,
                              in_dram, chunk.is_write)
    pol, rep = rb.interval_step(_rainbow_cfg(spec), pol, chunk.sp, chunk.page,
                                chunk.is_write, machine_timing(spec.mc))
    stats, inval = _rainbow_finish(rep)
    sim = sim._replace(tlb4=split_tlb_invalidate_many(sim.tlb4, inval))
    return EngineState(sim=sim, pol=pol), stats


def engine_run(
    spec: EngineSpec, state: EngineState, chunks: TraceChunks
) -> tuple[EngineState, IntervalStats]:
    """The whole simulation: one engine_step per interval chunk.

    Returns the final state and the per-interval stats stacked along [I].
    """
    rows = []
    for i in range(chunks.sp.shape[0]):
        state, stats = engine_step(spec, state, TraceChunks(*(x[i] for x in chunks)))
        rows.append(stats)
    return state, IntervalStats(*(torch.stack(col) for col in zip(*rows)))
