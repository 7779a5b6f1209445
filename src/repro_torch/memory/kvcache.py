"""RainbowKV: the paper's two-tier page management applied to a decode KV cache.

Per-sequence KV lives in a *capacity pool* (the NVM analogue) at superblock
granularity -- sequence b owns blocks [b * blocks_per_seq, (b + 1) *
blocks_per_seq) -- and hot blocks are copied into a small *hot pool* (the
DRAM analogue).  The residency bitmap + remap table (core.remap) redirect a
block's reads to its hot copy; blocks are never re-laid-out.  The "access"
the controller counts is the attention mass a block receives during decode,
counted by the two-stage counters and admitted by the utility test through
engine.control, as in the reference (repro/memory/kvcache.py).

Unlike the reference's immutable arrays, the pools are updated in place:
``append_token`` writes the new token into the pools it is given and
``end_interval_promote`` copies promoted blocks into the hot pool with the
block_gather kernel (kernels/block_gather), so a decode step never copies a
pool.  The small controller tables are replaced, not mutated.  `length` and
`step_in_interval` are host integers: the decode loop knows them without a
device round trip.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import counting, migration
from repro_torch.core.counting import Stage1State, Stage2State
from repro_torch.core.migration import DramState, TimingParams, preset_timing
from repro_torch.core.remap import RemapState, remap_init, translate
from repro_torch.engine import control
from repro_torch.engine.policy import ControlPolicy, get_policy
from repro_torch.kernels.block_gather.ops import block_gather_
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass(frozen=True, init=False)
class PagedConfig:
    """Layer-B cache config: ControlPolicy + block-pool geometry.

    The interval-controller knobs live on `policy`; the reference's flat
    kwargs (hot_slots, top_n, max_promotions, interval_steps) are accepted
    and read back as properties, as there.
    """

    block_size: int
    blocks_per_seq: int
    quantize: bool
    policy: ControlPolicy

    def __init__(
        self,
        block_size: int = 16,
        blocks_per_seq: int = 512,
        hot_slots: int | None = None,
        top_n: int | None = None,
        max_promotions: int | None = None,
        interval_steps: int | None = None,
        quantize: bool = False,
        policy: ControlPolicy | str | None = None,
    ):
        if quantize:
            raise NotImplementedError(
                "int8 paged pools (quantize=True) are not ported yet "
                "(ROADMAP.md Queue 1 item 12)")
        if policy is None:
            policy = get_policy("serving-default")
        elif isinstance(policy, str):
            policy = get_policy(policy)
        overrides = {k: v for k, v in {
            "hot_slots": hot_slots, "top_n": top_n,
            "max_promotions": max_promotions, "interval_steps": interval_steps,
        }.items() if v is not None}
        if overrides:
            policy = dataclasses.replace(policy, **overrides)
        object.__setattr__(self, "block_size", block_size)
        object.__setattr__(self, "blocks_per_seq", blocks_per_seq)
        object.__setattr__(self, "quantize", quantize)
        object.__setattr__(self, "policy", policy.validate("PagedConfig"))
        self.validate()

    def validate(self) -> "PagedConfig":
        """Reject impossible serving geometries loudly (the reference's checks)."""
        pol = self.policy
        if self.block_size < 1 or self.blocks_per_seq < 1:
            raise ValueError(
                "PagedConfig: block_size and blocks_per_seq must be >= 1 "
                f"(got {self.block_size}, {self.blocks_per_seq})")
        if pol.top_n > self.blocks_per_seq:
            raise ValueError(
                f"PagedConfig: top_n ({pol.top_n}) > blocks_per_seq "
                f"({self.blocks_per_seq}) -- each stage-2 monitor row holds "
                "blocks_per_seq counters; a monitor table wider than one "
                "superblock's block count is a mis-sized config (shrink top_n "
                "or pass a larger blocks_per_seq)")
        if pol.max_promotions > pol.hot_slots:
            raise ValueError(
                f"PagedConfig: max_promotions ({pol.max_promotions}) > hot_slots "
                f"({pol.hot_slots}) -- one interval can never admit more blocks "
                "than the hot pool holds")
        return self

    @property
    def hot_slots(self) -> int:
        return self.policy.hot_slots

    @property
    def top_n(self) -> int:
        return self.policy.top_n

    @property
    def max_promotions(self) -> int:
        return self.policy.max_promotions

    @property
    def interval_steps(self) -> int:
        return self.policy.interval_steps


def default_timing() -> TimingParams:
    """The "v5e-serving" preset of core.migration.TIMING_PRESETS: the
    reference's cost-model parameters (ns per block, HBM vs host link) that
    the utility test weighs; not a measured speed of any device."""
    return preset_timing("v5e-serving")


class RainbowKV(NamedTuple):
    """Per-layer-stacked paged KV state of a decode batch.

    cap_k/cap_v: [L, B * blocks_per_seq, block, KVS, hd]  capacity pool
    hot_k/hot_v: [L, hot_slots, block, KVS, hd]           hot pool
    remap:       RemapState over (superblock = sequence, page = block)
    s1/s2:       two-stage counters (stage 1 per sequence, stage 2 per block)
    dram:        hot-pool slot manager
    threshold:   float32 adaptive admission threshold
    length:      tokens already cached (uniform across the batch)
    step_in_interval: decode steps observed in the open interval
    """

    cap_k: torch.Tensor
    cap_v: torch.Tensor
    hot_k: torch.Tensor
    hot_v: torch.Tensor
    remap: RemapState
    s1: Stage1State
    s2: Stage2State
    dram: DramState
    threshold: torch.Tensor
    length: int
    step_in_interval: int


def paged_init(cfg, pcfg: PagedConfig, batch: int, tp: int, layers: int,
               device) -> RainbowKV:
    kvs = cfg.kv_store(tp)
    dt = dtype_of(cfg)
    nb = batch * pcfg.blocks_per_seq
    shape_cap = (layers, nb, pcfg.block_size, kvs, cfg.head_dim)
    shape_hot = (layers, pcfg.hot_slots, pcfg.block_size, kvs, cfg.head_dim)
    return RainbowKV(
        cap_k=torch.zeros(shape_cap, dtype=dt, device=device),
        cap_v=torch.zeros(shape_cap, dtype=dt, device=device),
        hot_k=torch.zeros(shape_hot, dtype=dt, device=device),
        hot_v=torch.zeros(shape_hot, dtype=dt, device=device),
        remap=remap_init(batch, pcfg.blocks_per_seq, device),
        s1=counting.stage1_init(batch, device),
        s2=counting.stage2_init(pcfg.top_n, pcfg.blocks_per_seq, device),
        dram=migration.dram_init(pcfg.hot_slots, device),
        threshold=torch.tensor(pcfg.policy.threshold_init, dtype=torch.float32,
                               device=device),
        length=0,
        step_in_interval=0,
    )


def append_token(kv: RainbowKV, pcfg: PagedConfig, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> RainbowKV:
    """Write one token's K/V, k_new/v_new [L, B, KVS, hd], at position
    kv.length of every sequence -- into its home capacity block and, when
    that block is resident, into its hot copy too (paper §III-E cases 1/2:
    the capacity copy stays fresh, so evictions are always clean).  In place.
    """
    b = k_new.shape[1]
    dev = k_new.device
    if kv.length >= pcfg.blocks_per_seq * pcfg.block_size:
        raise ValueError(
            f"append_token: the cache holds {pcfg.blocks_per_seq} blocks of "
            f"{pcfg.block_size} tokens per sequence; position {kv.length} is past it")
    blk, off = divmod(kv.length, pcfg.block_size)
    seq_ids = torch.arange(b, device=dev)
    flat_block = seq_ids * pcfg.blocks_per_seq + blk
    kv.cap_k[:, flat_block, off] = k_new.to(kv.cap_k.dtype)
    kv.cap_v[:, flat_block, off] = v_new.to(kv.cap_v.dtype)
    resident, slot = translate(kv.remap, seq_ids, torch.full((b,), blk, device=dev))
    # owner[s]: the sequence whose block sits in hot slot s (resident blocks
    # hold distinct slots); non-resident lanes land on the dropped sink entry
    n_hot = kv.hot_k.shape[1]
    owner = torch.full((n_hot + 1,), -1, dtype=torch.long, device=dev)
    owner.scatter_(0, torch.where(resident, slot, n_hot).long(), seq_ids)
    owned = (owner[:n_hot] >= 0)[None, :, None, None]
    lane = owner[:n_hot].clamp(min=0)
    for hot, new in ((kv.hot_k, k_new), (kv.hot_v, v_new)):
        hot[:, :, off] = torch.where(owned, new[:, lane].to(hot.dtype), hot[:, :, off])
    return kv


def quantize_mass(mass: torch.Tensor) -> torch.Tensor:
    """Attention mass -> access counts for the 15-bit counters (the
    reference's uint32 values, carried as int32)."""
    return torch.clamp(mass * 64.0, 0, 1024).to(torch.int32)


def observe_block_mass(kv: RainbowKV, pcfg: PagedConfig, mass: torch.Tensor) -> RainbowKV:
    """Record one decode step's per-block attention mass, float32[B, nblk]
    (summed over layers and heads): stage 1 per sequence, stage 2 per block
    of the monitored sequences, with a floor of 1 per block."""
    b, nblk = mass.shape
    dev = mass.device
    q = quantize_mass(mass)
    seq_ids = torch.arange(b, dtype=torch.int32, device=dev)
    s1 = counting.stage1_record_weighted(kv.s1, seq_ids, q.sum(dim=1))
    flat_sp = seq_ids[:, None].expand(b, nblk).reshape(-1)
    flat_pg = torch.arange(nblk, dtype=torch.int32, device=dev)[None].expand(b, nblk).reshape(-1)
    s2 = counting.stage2_record_weighted(kv.s2, flat_sp, flat_pg,
                                         torch.clamp(q.reshape(-1), min=1))
    return kv._replace(s1=s1, s2=s2, step_in_interval=kv.step_in_interval + 1)


def end_interval_promote(
    kv: RainbowKV, pcfg: PagedConfig, timing: TimingParams | None = None
) -> tuple[RainbowKV, dict]:
    """Close the interval: pick hot blocks (two-stage), admit them into the hot
    pool (utility test), copy their payloads, update the remap.

    The decision is engine.control's plan_and_apply + rotate_monitors, the
    same code the simulator runs; only the payload copy is serving-specific,
    and it is one block_gather launch over every layer, K and V.
    Returns (kv, {"promoted", "evicted", "plan", "cand_sp", "cand_pg"}).
    """
    timing = timing or default_timing()
    b = kv.s1.counts.shape[0]
    nblk = pcfg.blocks_per_seq
    dev = kv.threshold.device
    ctrl = pcfg.policy.control_config(num_units=b, pages_per_unit=nblk)
    reads = counting.counter_value(kv.s2.counts)
    # never promote blocks beyond the current sequence length
    out_of_range = (torch.arange(nblk, dtype=torch.int32, device=dev)[None, :]
                    > kv.length // pcfg.block_size)
    out = control.plan_and_apply(
        ctrl, reads, torch.zeros_like(reads), kv.s2.psn, kv.remap, kv.dram,
        kv.threshold, timing, now=torch.zeros((), dtype=torch.int32, device=dev),
        extra_exclude=out_of_range.expand(reads.shape),
    )
    plan, cand_sp, cand_pg = out.plan, out.cand_sp, out.cand_page
    src = torch.where(plan.migrate, cand_sp * nblk + cand_pg, -1).to(torch.int32)
    dst = torch.where(plan.migrate, plan.dst_slot, -1).to(torch.int32)
    block_gather_([(kv.cap_k, kv.hot_k), (kv.cap_v, kv.hot_v)], src, dst)

    s1, new_psn, dram = control.rotate_monitors(ctrl, kv.s1, out.dram)
    new = kv._replace(
        remap=out.remap, dram=dram, s1=s1,
        s2=counting.stage2_begin(new_psn, nblk),
        threshold=out.threshold, step_in_interval=0,
    )
    return new, {"promoted": out.n_migrated, "evicted": out.n_evicted,
                 "plan": plan, "cand_sp": cand_sp, "cand_pg": cand_pg}
