"""Utility-based hot-page migration (Rainbow §III-C) + DRAM slot management.

Eq. 1 / Eq. 2 of the paper, the adaptive migration-benefit threshold, and the
free/clean/dirty DRAM slot manager (a per-slot state array with LRU order
inside each class).  Functions are pure: they return new tensors and leave
their inputs untouched.

Float arithmetic follows the reference's compiled program bit for bit.  Its
compiler contracts ``a*x + b*y`` into one fused multiply-add,
``fma(a, x, round(b*y))``; `fma_f32` reproduces that rounding on any device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

FREE, CLEAN, DIRTY = 0, 1, 2


def f32(x: float) -> float:
    """`x` rounded to the nearest float32, as a Python float."""
    return float(np.float32(x))


def fma_f32(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 ``round(a*x + y)`` with a single rounding (a fused multiply-add).

    The float32 product is exact in float64; the float64 sum is made
    round-to-odd with its exact error term, so the final rounding to float32
    is the correctly rounded fused result.
    """
    p = torch.as_tensor(a, dtype=torch.float64, device=x.device) * x.double()
    c = y.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    bump = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where(bump, torch.nextafter(s, toward), s)
    return s.float()


class TimingParams(NamedTuple):
    """Table III parameters (cycles), each rounded to float32."""

    t_nr: float  # NVM read latency
    t_nw: float  # NVM write latency
    t_dr: float  # DRAM read latency
    t_dw: float  # DRAM write latency
    t_mig: float  # cycles to migrate one page NVM -> DRAM
    t_writeback: float  # cycles to write a dirty DRAM page back to NVM


def _check_latency(name: str, value, *, positive: bool) -> None:
    """Reject malformed timing constants loudly at construction."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"timing parameter {name} must be a real number, got {value!r}"
        ) from None
    if v != v or v in (float("inf"), float("-inf")):
        raise ValueError(f"timing parameter {name} must be finite, got {v!r}")
    if positive and v <= 0:
        raise ValueError(f"timing parameter {name} must be positive, got {v!r}")
    if not positive and v < 0:
        raise ValueError(
            f"timing parameter {name} must be non-negative, got {v!r}"
        )


def make_timing(
    t_nr: float, t_nw: float, t_dr: float, t_dw: float, t_mig: float, t_writeback: float
) -> TimingParams:
    for name, value in (("t_nr", t_nr), ("t_nw", t_nw),
                        ("t_dr", t_dr), ("t_dw", t_dw)):
        _check_latency(name, value, positive=True)
    for name, value in (("t_mig", t_mig), ("t_writeback", t_writeback)):
        _check_latency(name, value, positive=False)
    return TimingParams(*(f32(v) for v in (t_nr, t_nw, t_dr, t_dw, t_mig, t_writeback)))


# -- named hardware presets (the single source of both timing tables) --------

#: Paper Table IV machine constants; sim.config re-exports them.
SIM_CPU_GHZ = 3.2  # cycles = ns * GHz
SIM_PAGE_BYTES = 4096
_SIM_PAGE_COST = (
    (SIM_PAGE_BYTES / 10.7e9) * 1e9 * SIM_CPU_GHZ * 2  # rd PCM + wr DRAM
)

#: "paper-table4-sim" is the simulator's machine model (cycles @ 3.2 GHz);
#: "v5e-serving" is the serving cost model in ns-per-block units.
TIMING_PRESETS: dict[str, dict[str, float]] = {
    "paper-table4-sim": {
        "t_nr": 19.5 * SIM_CPU_GHZ,  # PCM read   = 62.4
        "t_nw": 171.0 * SIM_CPU_GHZ,  # PCM write  = 547.2
        "t_dr": 13.5 * SIM_CPU_GHZ,  # DRAM read  = 43.2
        "t_dw": 28.5 * SIM_CPU_GHZ,  # DRAM write = 91.2
        "t_mig": _SIM_PAGE_COST,
        "t_writeback": _SIM_PAGE_COST,
    },
    "v5e-serving": {
        "t_nr": 100.0,
        "t_nw": 180.0,
        "t_dr": 8.0,
        "t_dw": 12.0,
        "t_mig": 400.0,
        "t_writeback": 400.0,
    },
}

_PRESET_KEYS = frozenset({"t_nr", "t_nw", "t_dr", "t_dw", "t_mig", "t_writeback"})


def _validate_preset(name: str, entry) -> None:
    """Malformed preset dicts fail here with the preset named."""
    if not isinstance(entry, dict):
        raise ValueError(
            f"timing preset {name!r} must be a dict, got {type(entry).__name__}"
        )
    got = set(entry)
    if got != _PRESET_KEYS:
        missing, extra = sorted(_PRESET_KEYS - got), sorted(got - _PRESET_KEYS)
        raise ValueError(
            f"timing preset {name!r} has malformed keys "
            f"(missing={missing}, unexpected={extra})"
        )
    for key in ("t_nr", "t_nw", "t_dr", "t_dw"):
        _check_latency(f"{name}.{key}", entry[key], positive=True)
    for key in ("t_mig", "t_writeback"):
        _check_latency(f"{name}.{key}", entry[key], positive=False)


def preset_timing(name: str) -> TimingParams:
    """TimingParams for a named hardware preset (see TIMING_PRESETS)."""
    try:
        entry = TIMING_PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown timing preset {name!r}; available: {sorted(TIMING_PRESETS)}"
        ) from None
    _validate_preset(name, entry)
    return make_timing(**entry)


for _name, _entry in TIMING_PRESETS.items():  # built-ins checked at import
    _validate_preset(_name, _entry)
del _name, _entry


def migration_benefit(c_r: torch.Tensor, c_w: torch.Tensor, t: TimingParams) -> torch.Tensor:
    """Eq. 1: cycles saved by serving (C_r, C_w) from DRAM instead of NVM."""
    k_r = f32(np.float32(t.t_nr) - np.float32(t.t_dr))
    k_w = f32(np.float32(t.t_nw) - np.float32(t.t_dw))
    return fma_f32(k_r, c_r, c_w * k_w) - t.t_mig


def swap_benefit(
    c_r_in: torch.Tensor,
    c_w_in: torch.Tensor,
    c_r_out: torch.Tensor,
    c_w_out: torch.Tensor,
    t: TimingParams,
    victim_dirty: torch.Tensor,
) -> torch.Tensor:
    """Eq. 2: benefit when migrating page p2 in requires evicting DRAM page p1.

    T_writeback applies only when the victim is dirty.
    """
    k_r = f32(np.float32(t.t_nr) - np.float32(t.t_dr))
    k_w = f32(np.float32(t.t_nw) - np.float32(t.t_dw))
    wb = torch.where(victim_dirty, t.t_writeback, 0.0).float()
    gain = fma_f32(k_r, c_r_in - c_r_out, (c_w_in - c_w_out) * k_w)
    return (gain - t.t_mig) - wb


class DramState(NamedTuple):
    """Performance-tier slot manager (free/clean/dirty lists as a state array).

    slot_state:  int32[S] in {FREE, CLEAN, DIRTY}
    slot_sp:     int32[S] superpage of the cached page (-1 if free)
    slot_page:   int32[S] small-page index within that superpage
    slot_reads:  float32[S] accesses observed this interval (for Eq. 2 victims)
    slot_writes: float32[S]
    last_touch:  int32[S] LRU timestamp within class
    """

    slot_state: torch.Tensor
    slot_sp: torch.Tensor
    slot_page: torch.Tensor
    slot_reads: torch.Tensor
    slot_writes: torch.Tensor
    last_touch: torch.Tensor


def dram_init(num_slots: int, device) -> DramState:
    def z(dtype, fill=0):
        return torch.full((num_slots,), fill, dtype=dtype, device=device)

    return DramState(
        slot_state=z(torch.int32),
        slot_sp=z(torch.int32, -1),
        slot_page=z(torch.int32, -1),
        slot_reads=z(torch.float32),
        slot_writes=z(torch.float32),
        last_touch=z(torch.int32),
    )


def dram_record_access(
    d: DramState, slot: torch.Tensor, is_write: torch.Tensor, now
) -> DramState:
    """Record a batch of DRAM-tier accesses (slot < 0 lanes ignored)."""
    valid = slot >= 0
    s = torch.where(valid, slot, 0).long()
    r_inc = (valid & ~is_write).float()
    w_inc = (valid & is_write).float()
    zero = torch.zeros_like(slot)
    state_v = torch.where(valid & is_write, torch.full_like(slot, DIRTY), zero)
    touch_v = torch.where(valid, torch.as_tensor(now, dtype=torch.int32,
                                                 device=slot.device), zero)
    return DramState(
        slot_state=d.slot_state.scatter_reduce(0, s, state_v, "amax"),
        slot_sp=d.slot_sp,
        slot_page=d.slot_page,
        slot_reads=d.slot_reads.index_add(0, s, r_inc),
        slot_writes=d.slot_writes.index_add(0, s, w_inc),
        last_touch=d.last_touch.scatter_reduce(0, s, touch_v, "amax"),
    )


class MigrationPlan(NamedTuple):
    """Output of plan_migrations -- aligned tensors of length K (candidates).

    migrate:   bool[K]   candidate admitted
    dst_slot:  int32[K]  destination performance-tier slot (-1 if not migrated)
    evict_sp / evict_page: int32[K] previous occupant (-1 if the slot was free)
    evict_dirty: bool[K] previous occupant needs full writeback
    benefit:   float32[K] adjusted benefit used for the decision
    """

    migrate: torch.Tensor
    dst_slot: torch.Tensor
    evict_sp: torch.Tensor
    evict_page: torch.Tensor
    evict_dirty: torch.Tensor
    benefit: torch.Tensor


def order_desc(x: torch.Tensor) -> torch.Tensor:
    """Indices of `x` in descending order, ties lower index first.

    The reference's ``lax.top_k`` order; a stable sort keeps it exactly where
    a bare ``torch.topk`` promises no tie order.
    """
    return torch.sort(x, descending=True, stable=True).indices


def plan_migrations(
    cand_sp: torch.Tensor,  # int32[K] candidate superpage ids (-1 = empty lane)
    cand_page: torch.Tensor,  # int32[K]
    cand_reads: torch.Tensor,  # float32[K] predicted next-interval reads
    cand_writes: torch.Tensor,  # float32[K]
    dram: DramState,
    timing: TimingParams,
    threshold: torch.Tensor,
) -> MigrationPlan:
    """Admit candidates best-first into victims cheapest-first (free->clean->dirty).

    Candidate order is by Eq. 1 benefit descending; victims by class priority
    then LRU, so the hottest pages land on the cheapest slots.
    """
    k = cand_sp.shape[0]
    dev = cand_sp.device
    base = migration_benefit(cand_reads, cand_writes, timing)
    base = torch.where(cand_sp >= 0, base, -math.inf)
    cand_order = order_desc(base)
    c_base = base[cand_order]

    # prio = state * 1e9 + last_touch, two float32 roundings (the product is
    # exact, so a fused multiply-add gives the same value)
    prio = dram.slot_state.float() * 1e9 + dram.last_touch.float()
    n_slots = dram.slot_state.shape[0]
    take = min(k, n_slots)
    vslots = order_desc(-prio)[:take].to(torch.int32)
    if k > take:  # pad victim columns up to k with -1
        vslots = torch.cat(
            [vslots, torch.full((k - take,), -1, dtype=torch.int32, device=dev)]
        )

    v_valid = vslots >= 0
    vs = torch.where(v_valid, vslots, 0).long()
    v_state = torch.where(v_valid, dram.slot_state[vs], DIRTY)
    v_sp = torch.where(v_valid, dram.slot_sp[vs], -1)
    v_page = torch.where(v_valid, dram.slot_page[vs], -1)
    v_reads = torch.where(v_valid, dram.slot_reads[vs], math.inf)
    v_writes = torch.where(v_valid, dram.slot_writes[vs], math.inf)
    v_dirty = v_state == DIRTY
    v_free = v_state == FREE

    c_sp = cand_sp[cand_order]
    c_page = cand_page[cand_order]
    c_r = cand_reads[cand_order]
    c_w = cand_writes[cand_order]

    adj = torch.where(
        v_free, c_base, swap_benefit(c_r, c_w, v_reads, v_writes, timing, v_dirty)
    )
    migrate = (adj > threshold) & (c_sp >= 0) & v_valid
    evicts = migrate & ~v_free
    plan_sorted = MigrationPlan(
        migrate=migrate,
        dst_slot=torch.where(migrate, vslots, -1),
        evict_sp=torch.where(evicts, v_sp, -1),
        evict_page=torch.where(evicts, v_page, -1),
        evict_dirty=evicts & v_dirty,
        benefit=adj,
    )
    # un-sort back to the caller's candidate order (inverse permutation)
    inv = torch.empty_like(cand_order)
    inv[cand_order] = torch.arange(k, device=dev)
    return MigrationPlan(*(a[inv] for a in plan_sorted))


def _set_drop(arr: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """``arr`` with ``arr[idx] = value``; lanes with idx == len(arr) dropped."""
    n = arr.shape[0]
    out = torch.cat([arr, arr[:1]])
    out[idx.long()] = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        value, dtype=arr.dtype, device=arr.device)
    return out[:n]


def dram_apply_plan(
    d: DramState, plan: MigrationPlan, cand_sp, cand_page, now
) -> DramState:
    """Install migrated pages into their slots; reset their per-interval counters."""
    n = d.slot_state.shape[0]
    slot = torch.where(plan.migrate, plan.dst_slot, n)
    now_t = torch.as_tensor(now, dtype=torch.int32, device=slot.device)
    return DramState(
        slot_state=_set_drop(d.slot_state, slot, CLEAN),
        slot_sp=_set_drop(d.slot_sp, slot, cand_sp.to(torch.int32)),
        slot_page=_set_drop(d.slot_page, slot, cand_page.to(torch.int32)),
        slot_reads=_set_drop(d.slot_reads, slot, 0.0),
        slot_writes=_set_drop(d.slot_writes, slot, 0.0),
        last_touch=_set_drop(d.last_touch, slot, now_t),
    )


def dram_new_interval(d: DramState) -> DramState:
    """Zero the per-interval access counters (keep residency + dirty bits)."""
    return d._replace(
        slot_reads=torch.zeros_like(d.slot_reads),
        slot_writes=torch.zeros_like(d.slot_writes),
    )


def adapt_threshold(
    threshold: torch.Tensor,
    evictions: torch.Tensor,
    *,
    up_per_eviction: float = 8.0,
    decay: float = 0.9,
    floor: float = 0.0,
    ceil: float = 1e6,
) -> torch.Tensor:
    """§III-C: raise the benefit threshold with bidirectional traffic, decay it back."""
    t = fma_f32(f32(decay), threshold, evictions.float() * f32(up_per_eviction))
    return torch.clamp(t, f32(floor), f32(ceil))
