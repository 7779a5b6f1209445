"""The per-access translation walk of one interval (the serial core of Layer A).

One walk over the interval's accesses carries the TLB / bitmap-cache LRU
state and accumulates cycle and miss counters.  Residency (which pages are
DRAM-cached) is fixed within an interval, so it arrives as a per-access
vector.  This slice ports the "rainbow" kind: split 4 KB and 2 MB TLBs, the
bitmap cache and the remap-pointer read (the four cases of Fig. 6).

`run_interval` walks CUDA tensors with the hand-written kernel
(csrc/tlb_walk.cu) and CPU tensors with `walk_plain`, a Python loop that is
exact rather than fast; both are bitwise equal to the reference's
`run_interval_fast("rainbow", ...)`, tags, LRU, clock and counters.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bitmap import BitmapCache, bitmap_cache_init
from repro_torch.core.tlb import SplitTLB, TLBState, split_tlb_init
from repro_torch.kernels import build
from repro_torch.sim.config import MachineConfig

F32 = np.float32


class SimCounters(NamedTuple):
    """float32 0-d tensors; the nine count-like ones hold integers."""

    cycles_tlb: torch.Tensor
    cycles_walk: torch.Tensor
    cycles_bitmap: torch.Tensor
    cycles_remap: torch.Tensor
    cycles_mem: torch.Tensor
    miss4_l1: torch.Tensor
    miss4_l2: torch.Tensor
    miss2m_l1: torch.Tensor
    miss2m_l2: torch.Tensor
    bmc_miss: torch.Tensor
    dram_reads: torch.Tensor
    dram_writes: torch.Tensor
    nvm_reads: torch.Tensor
    nvm_writes: torch.Tensor


def zero_counters(device) -> SimCounters:
    return SimCounters(*torch.zeros(14, dtype=torch.float32, device=device).unbind())


class SimState(NamedTuple):
    tlb4: SplitTLB
    tlb2m: SplitTLB
    bmc: BitmapCache
    t: torch.Tensor  # int32 0-d access clock
    counters: SimCounters


def init_state(mc: MachineConfig, device) -> SimState:
    def mk():
        return split_tlb_init(
            mc.l1_tlb_entries, mc.l1_tlb_ways, mc.l2_tlb_entries, mc.l2_tlb_ways, device
        )

    return SimState(
        tlb4=mk(),
        tlb2m=mk(),
        bmc=bitmap_cache_init(mc.bitmap_cache_entries, mc.bitmap_cache_ways, device),
        t=torch.zeros((), dtype=torch.int32, device=device),
        counters=zero_counters(device),
    )


class WalkCosts(NamedTuple):
    """float32 values the reference adds per access, each rounded as it rounds them."""

    tlb_hit: np.float32  # l1_lat + 0.0
    tlb_miss: np.float32  # l1_lat + l2_lat (float32 add)
    walk2m: np.float32  # ptw_refs_2m * t_dr, formed in float64, rounded once
    bmp_hit: np.float32  # bitmap_cache_lat + 0.0
    bmp_miss: np.float32  # bitmap_cache_lat + t_nr (float32 add)
    remap: np.float32  # remap_read_lat, rounded from float64
    t_dr: np.float32
    t_dw: np.float32
    t_nr: np.float32
    t_nw: np.float32


def walk_costs(mc: MachineConfig) -> WalkCosts:
    return WalkCosts(
        tlb_hit=F32(F32(mc.l1_tlb_lat) + F32(0.0)),
        tlb_miss=F32(F32(mc.l1_tlb_lat) + F32(mc.l2_tlb_lat)),
        walk2m=F32(mc.ptw_refs_2m * mc.t_dr),
        bmp_hit=F32(F32(mc.bitmap_cache_lat) + F32(0.0)),
        bmp_miss=F32(F32(mc.bitmap_cache_lat) + F32(mc.t_nr)),
        remap=F32(mc.remap_read_lat),
        t_dr=F32(mc.t_dr), t_dw=F32(mc.t_dw), t_nr=F32(mc.t_nr), t_nw=F32(mc.t_nw),
    )


def _require_rainbow(kind: str) -> None:
    if kind != "rainbow":
        raise NotImplementedError(
            f"walk kind {kind!r} is not ported yet (ROADMAP.md Queue 1 item 6); "
            "this slice walks the 'rainbow' kind"
        )


# ---------------------------------------------------------------------------
# Plain version: a Python loop over the accesses (exact, not fast)
# ---------------------------------------------------------------------------


def _split_lookup(l1, l2, v: int, now: int, fill: bool) -> tuple[bool, bool]:
    """One split-TLB lookup on (tags, lru, sets) lists; the two L1 touches are
    one conditional write, as in the reference's fused lookup."""
    (t1, r1, s1), (t2, r2, s2) = l1, l2
    row1t, row1l = t1[v % s1], r1[v % s1]
    row2t, row2l = t2[v % s2], r2[v % s2]
    h1, h2 = v in row1t, v in row2t
    way2 = row2t.index(v) if h2 else row2l.index(min(row2l))
    way1 = row1t.index(v) if h1 else row1l.index(min(row1l))
    if h2 or fill:
        row2t[way2], row2l[way2] = v, now
    if h1 or h2 or fill:
        row1t[way1], row1l[way1] = v, now
    return h1, h2


def _bmc_lookup(bmc, p: int, now: int) -> bool:
    tags, lru, sets = bmc
    rowt, rowl = tags[p % sets], lru[p % sets]
    hit = p in rowt
    way = rowt.index(p) if hit else rowl.index(min(rowl))
    rowt[way], rowl[way] = p, now
    return hit


def _lists(tlb: TLBState):
    return tlb.tags.tolist(), tlb.lru.tolist(), tlb.tags.shape[0]


def walk_plain(
    kind: str, mc: MachineConfig, state: SimState,
    vpn: torch.Tensor, sp: torch.Tensor, in_dram: torch.Tensor, is_write: torch.Tensor,
) -> SimState:
    """Plain version of the walk kernel: a Python loop with float32 accumulators."""
    _require_rainbow(kind)
    c = walk_costs(mc)
    dev = state.t.device
    l41, l42 = _lists(state.tlb4.l1), _lists(state.tlb4.l2)
    l21, l22 = _lists(state.tlb2m.l1), _lists(state.tlb2m.l2)
    bmc = _lists(state.bmc)
    cnt = [F32(x) for x in torch.stack(list(state.counters)).tolist()]
    ctlb, cwalk, cbmp, crmp, cmem = cnt[:5]
    m41 = m42 = m21 = m22 = mb = dr = dw = nr = nw = 0
    t = int(state.t)
    zero = F32(0.0)
    for v, s, dram, wr in zip(vpn.tolist(), sp.tolist(), in_dram.tolist(),
                              is_write.tolist()):
        h41, h42 = _split_lookup(l41, l42, v, t, dram)
        hit4 = (h41 or h42) and dram
        h21, h22 = _split_lookup(l21, l22, s, t, True)
        sptw = not (h21 or h22)
        need = not hit4
        bhit = _bmc_lookup(bmc, s, t)  # probes and fills on every access
        bmiss = need and not bhit
        ctlb = ctlb + (c.tlb_miss if (not h41 and not h21) else c.tlb_hit)
        cwalk = cwalk + (c.walk2m if (need and sptw) else zero)
        cbmp = cbmp + ((c.bmp_miss if bmiss else c.bmp_hit) if need else zero)
        crmp = crmp + (c.remap if (need and dram) else zero)
        cmem = cmem + ((c.t_dw if dram else c.t_nw) if wr
                       else (c.t_dr if dram else c.t_nr))
        m41 += dram and not h41
        m42 += dram and not hit4
        m21 += not h21
        m22 += sptw
        mb += bmiss
        dr += dram and not wr
        dw += dram and wr
        nr += not dram and not wr
        nw += not dram and wr
        t += 1
    counts = [m41, m42, m21, m22, mb, dr, dw, nr, nw]
    cnt = [ctlb, cwalk, cbmp, crmp, cmem] + [
        cnt[5 + k] + F32(counts[k]) for k in range(9)]

    def tlb(lists) -> TLBState:
        tags, lru, _ = lists
        return TLBState(
            tags=torch.tensor(tags, dtype=torch.int32, device=dev),
            lru=torch.tensor(lru, dtype=torch.int32, device=dev),
        )

    return SimState(
        tlb4=SplitTLB(tlb(l41), tlb(l42)),
        tlb2m=SplitTLB(tlb(l21), tlb(l22)),
        bmc=BitmapCache(*tlb(bmc)),
        t=torch.tensor(t, dtype=torch.int32, device=dev),
        counters=SimCounters(*torch.tensor(np.array(cnt, np.float32), device=dev).unbind()),
    )


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "tlb_walk_rainbow_launch": ([_P, _P, _P, _P, _I, _P, _P] + [_I] * 6
                                + [_F] * 10 + [_P], _I),
    "tlb_walk_smem_bytes": ([_I], _I),
}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90


def _tables(state: SimState) -> list[torch.Tensor]:
    """The int32 tables in the kernel's packed order."""
    out = []
    for tlb in (state.tlb4, state.tlb2m):
        for lvl in (tlb.l1, tlb.l2):
            out += [lvl.tags, lvl.lru]
    return out + [state.bmc.tags, state.bmc.lru]


def _check_input(name: str, x: torch.Tensor, dtype: torch.dtype, a: int, dev) -> None:
    if x.dtype != dtype or x.shape != (a,) or not x.is_contiguous() or x.device != dev:
        raise ValueError(
            f"run_interval: {name} must be a contiguous {dtype}[{a}] on {dev}, got "
            f"{x.dtype}{tuple(x.shape)} on {x.device}"
        )


def _walk_kernel(mc: MachineConfig, state: SimState, vpn, sp, in_dram, is_write) -> SimState:
    dev = state.t.device
    a = vpn.shape[0]
    _check_input("vpn", vpn, torch.int32, a, dev)
    _check_input("sp", sp, torch.int32, a, dev)
    _check_input("in_dram", in_dram, torch.bool, a, dev)
    _check_input("is_write", is_write, torch.bool, a, dev)
    g4, g2 = state.tlb4, state.tlb2m
    if g4.l1.tags.shape != g2.l1.tags.shape or g4.l2.tags.shape != g2.l2.tags.shape:
        raise ValueError("run_interval: the 4 KB and 2 MB TLBs must share a geometry")
    if a and int(torch.minimum(vpn.min(), sp.min())) < 0:
        raise ValueError("run_interval: vpn and sp must be non-negative "
                         "(the kernel's set index is v % sets)")
    tables = _tables(state)
    ints = torch.cat([state.t.view(1).to(torch.int32)] + [x.reshape(-1) for x in tables])
    counters = torch.stack(list(state.counters)).to(torch.float32).contiguous()
    (s1, w1), (s2, w2) = g4.l1.tags.shape, g4.l2.tags.shape
    sb, wb = state.bmc.tags.shape
    lib = build.library("tlb_walk", _SIGNATURES)
    if lib.tlb_walk_smem_bytes(ints.numel()) > _SMEM_LIMIT:
        raise ValueError("run_interval: TLB and bitmap-cache tables exceed one "
                         "block's shared memory")
    c = walk_costs(mc)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tlb_walk_rainbow_launch(
            vpn.data_ptr(), sp.data_ptr(), in_dram.data_ptr(), is_write.data_ptr(), a,
            ints.data_ptr(), counters.data_ptr(), s1, w1, s2, w2, sb, wb,
            *(float(x) for x in c), stream,
        )
    run_interval.launches += 1
    build.check_launch(lib, err, "tlb_walk_rainbow")
    parts = iter(torch.split(ints[1:], [x.numel() for x in tables]))
    tabs = [next(parts).view(x.shape) for x in tables]
    return SimState(
        tlb4=SplitTLB(TLBState(tabs[0], tabs[1]), TLBState(tabs[2], tabs[3])),
        tlb2m=SplitTLB(TLBState(tabs[4], tabs[5]), TLBState(tabs[6], tabs[7])),
        bmc=BitmapCache(tabs[8], tabs[9]),
        t=ints[0],
        counters=SimCounters(*counters.unbind()),
    )


def run_interval(
    kind: str, mc: MachineConfig, state: SimState,
    vpn: torch.Tensor,  # int32[A] 4KB page id (global)
    sp: torch.Tensor,  # int32[A] superpage id
    in_dram: torch.Tensor,  # bool[A] residency at interval start
    is_write: torch.Tensor,  # bool[A]
) -> SimState:
    """Walk one interval's accesses; returns the state with accumulated counters.

    CPU state takes `walk_plain`; CUDA state launches the walk kernel (one
    launch, counted in `run_interval.launches`) or raises.
    """
    _require_rainbow(kind)
    dev = state.t.device
    if dev.type == "cpu":
        return walk_plain(kind, mc, state, vpn, sp, in_dram, is_write)
    if dev.type != "cuda":
        raise ValueError(f"run_interval: unsupported device {dev}")
    return _walk_kernel(mc, state, vpn, sp, in_dram, is_write)


run_interval.launches = 0
