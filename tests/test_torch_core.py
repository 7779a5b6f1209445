"""repro_torch core primitives held bitwise against the JAX package:
bitmap, remap, split-TLB shootdown, two-stage counting, migration and
selection, on random and edge inputs (ties included).

Functions whose float arithmetic the reference's compiler contracts into
fused multiply-adds are compared against the jitted reference, which is what
its engine runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as ref_bitmap
from repro.core import counting as ref_counting
from repro.core import migration as ref_mig
from repro.core import remap as ref_remap
from repro.core import tlb as ref_tlb
from repro.utils import select as ref_select
from repro_torch import interop
from repro_torch.core import bitmap, counting, migration, remap, tlb
from repro_torch.utils import select
from torch_port_util import same_bits, t, tree_diff

P = 512


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


# -- bitmap / remap -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("value", [True, False])
def test_bitmap_update_and_get(seed, value):
    rng = np.random.default_rng(seed)
    bm = rng.integers(0, 2**32, (7, P // 32), dtype=np.uint64).astype(np.uint32)
    sp = rng.integers(-1, 7, 300).astype(np.int32)
    page = rng.integers(0, P, 300).astype(np.int32)
    sp[:20], page[:20] = sp[20:40], page[20:40]  # duplicates
    page[:8] = 31 + 32 * rng.integers(0, 16, 8)  # bit 31 of a word (sign bit here)
    ref = ref_bitmap.bitmap_update(jnp.asarray(bm), jnp.asarray(sp), jnp.asarray(page), value)
    port = bitmap.bitmap_update(t(bm), t(sp), t(page), value)
    assert same_bits(_u32(port), ref)
    q_sp = np.maximum(sp, 0)
    assert same_bits(
        bitmap.bitmap_get(port, t(q_sp), t(page)).numpy(),
        ref_bitmap.bitmap_get(ref, jnp.asarray(q_sp), jnp.asarray(page)),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_remap_install_evict_translate(seed):
    rng = np.random.default_rng(seed)
    num_sp = 9
    ref_st = ref_remap.remap_init(num_sp, P)
    port_st = remap.remap_init(num_sp, P, "cpu")
    for step in range(4):
        k = 64
        flat = rng.choice(num_sp * P, k, replace=False)
        sp = (flat // P).astype(np.int32)
        page = (flat % P).astype(np.int32)
        sp[rng.random(k) < 0.2] = -1  # dropped lanes
        slot = rng.integers(0, 1000, k).astype(np.int32)
        if step % 2 == 0:
            ref_st = ref_remap.remap_install(ref_st, *map(jnp.asarray, (sp, page, slot)))
            port_st = remap.remap_install(port_st, t(sp), t(page), t(slot))
        else:
            ref_st = ref_remap.remap_evict(ref_st, jnp.asarray(sp), jnp.asarray(page))
            port_st = remap.remap_evict(port_st, t(sp), t(page))
        assert not tree_diff(interop.to_numpy(port_st), ref_st)
    q_sp = rng.integers(0, num_sp, 500).astype(np.int32)
    q_pg = rng.integers(0, P, 500).astype(np.int32)
    r_in, r_slot = ref_remap.translate(ref_st, jnp.asarray(q_sp), jnp.asarray(q_pg))
    p_in, p_slot = remap.translate(port_st, t(q_sp), t(q_pg))
    assert same_bits(p_in.numpy(), r_in) and same_bits(p_slot.numpy(), r_slot)


# -- split TLB shootdown -------------------------------------------------------


@pytest.mark.parametrize("sets,ways", [(1, 2), (4, 8), (31, 8)])
def test_split_tlb_invalidate_many(sets, ways):
    rng = np.random.default_rng(sets)
    tags = rng.integers(-1, 200, (sets, ways)).astype(np.int32)  # adversarial rows
    lru = rng.integers(0, 50, (sets, ways)).astype(np.int32)
    vpns = np.concatenate([rng.choice(tags.ravel(), 20), [-1, -1, 5, 5]]).astype(np.int32)
    ref_l = ref_tlb.TLBState(tags=jnp.asarray(tags), lru=jnp.asarray(lru), sets=sets, ways=ways)
    ref = ref_tlb.split_tlb_invalidate_many(ref_tlb.SplitTLB(ref_l, ref_l), jnp.asarray(vpns))
    port_l = tlb.TLBState(t(tags), t(lru))
    port = tlb.split_tlb_invalidate_many(tlb.SplitTLB(port_l, port_l), t(vpns))
    for lvl in ("l1", "l2"):
        assert same_bits(getattr(port, lvl).tags.numpy(), getattr(ref, lvl).tags)
        assert same_bits(getattr(port, lvl).lru.numpy(), getattr(ref, lvl).lru)


# -- counting ------------------------------------------------------------------


def _counter_cases():
    rng = np.random.default_rng(5)
    yield "all_zero", np.zeros(40, np.uint16)
    yield "ties", rng.integers(0, 3, 120).astype(np.uint16)
    sat = rng.integers(0, 2**16, 80).astype(np.uint16)  # overflow bits set
    yield "overflow", sat
    yield "fewer_than_top_n", rng.integers(0, 5, 30).astype(np.uint16)


@pytest.mark.parametrize("name,counts", list(_counter_cases()))
def test_select_top_n_ties_lower_index_first(name, counts):
    ref_psn, ref_vals = ref_counting.select_top_n(
        ref_counting.Stage1State(counts=jnp.asarray(counts)), 100)
    psn, vals = counting.select_top_n(counting.Stage1State(counts=t(counts)), 100)
    assert same_bits(psn.numpy(), ref_psn)
    assert same_bits(vals.numpy(), ref_vals)


@pytest.mark.parametrize("seed", [0, 1])
def test_saturating_merge_sticky_overflow(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 2**16, 500).astype(np.uint16)
    counts[:50] = 32760  # just below saturation
    hist = rng.integers(0, 20, 500).astype(np.uint32)
    ref = ref_counting.saturating_merge(jnp.asarray(counts), jnp.asarray(hist))
    port = counting.saturating_merge(t(counts), torch.from_numpy(hist.astype(np.int32)))
    assert same_bits(port.numpy().astype(np.uint16), ref)
    assert same_bits(counting.counter_value(t(counts)).numpy(),
                     ref_counting.counter_value(jnp.asarray(counts)))


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_counting_equal(seed):
    rng = np.random.default_rng(seed)
    nsp, n, b = 30, 6, 2000
    sp = rng.integers(-1, nsp, b).astype(np.int32)
    page = rng.integers(0, P, b).astype(np.int32)
    wr = rng.random(b) < 0.3
    psn = np.full(n, -1, np.int32)
    psn[:4] = rng.choice(nsp, 4, replace=False)
    s1 = rng.integers(0, 2**16, nsp).astype(np.uint16)
    s2 = rng.integers(32700, 32767, (n, P)).astype(np.uint16)  # saturates
    ref1 = ref_counting.stage1_record(ref_counting.Stage1State(jnp.asarray(s1)),
                                      jnp.asarray(sp), jnp.asarray(wr), 3)
    port1 = counting.stage1_record(counting.Stage1State(t(s1)), t(sp), t(wr), 3)
    assert same_bits(port1.counts.numpy().astype(np.uint16), ref1.counts)
    ref2 = ref_counting.stage2_record_weighted(
        ref_counting.Stage2State(jnp.asarray(psn), jnp.asarray(s2)),
        jnp.asarray(sp), jnp.asarray(page), jnp.asarray(wr).astype(jnp.uint32))
    port2 = counting.stage2_record_weighted(
        counting.Stage2State(t(psn), t(s2)), t(sp), t(page), t(wr))
    assert same_bits(port2.counts.numpy().astype(np.uint16), ref2.counts)


# -- selection -----------------------------------------------------------------


@pytest.mark.parametrize("mask", ["all", "none", "few", "random"])
def test_first_k_valid(mask):
    rng = np.random.default_rng(3)
    vals = rng.integers(-600, 60000, 512).astype(np.int32)
    valid = {"all": np.ones(512, bool), "none": np.zeros(512, bool),
             "few": np.arange(512) % 97 == 0, "random": rng.random(512) < 0.7}[mask]
    for k in (1, 8, 256, 600):
        ref = ref_select.first_k_valid(jnp.asarray(vals), jnp.asarray(valid), k)
        port = select.first_k_valid(t(vals), t(valid), k)
        assert same_bits(port.numpy(), ref)


# -- migration -----------------------------------------------------------------

TIMING = dict(t_nr=62.4, t_nw=547.2, t_dr=43.2, t_dw=91.2, t_mig=1531.0, t_writeback=1531.0)


def _dram(rng, n_slots, frac_used, touch_hi):
    state = np.where(rng.random(n_slots) < frac_used, rng.integers(1, 3, n_slots), 0)
    used = state > 0
    return ref_mig.DramState(
        slot_state=state.astype(np.int32),
        slot_sp=np.where(used, rng.integers(0, 50, n_slots), -1).astype(np.int32),
        slot_page=np.where(used, rng.integers(0, P, n_slots), -1).astype(np.int32),
        slot_reads=rng.integers(0, 40, n_slots).astype(np.float32),
        slot_writes=rng.integers(0, 10, n_slots).astype(np.float32),
        last_touch=np.where(used, rng.integers(0, touch_hi, n_slots), 0).astype(np.int32),
    )


@jax.jit
def _ref_plan(cs, cp, cr, cw, dram, threshold):
    return ref_mig.plan_migrations(cs, cp, cr, cw, dram,
                                   ref_mig.make_timing(**TIMING), threshold)


@pytest.mark.parametrize("case", ["free", "part_full", "full_dirty", "big_touch", "few_slots"])
def test_plan_migrations(case):
    rng = np.random.default_rng(len(case))
    n_slots, k = {"few_slots": (40, 64)}.get(case, (300, 64))
    frac = {"free": 0.0, "part_full": 0.5}.get(case, 1.0)
    touch_hi = 2**26 if case == "big_touch" else 6  # float32 ties in prio
    dram = _dram(rng, n_slots, frac, touch_hi)
    cs = rng.integers(-1, 50, k).astype(np.int32)
    cp = rng.integers(0, P, k).astype(np.int32)
    cr = rng.integers(0, 200, k).astype(np.float32)
    cw = rng.integers(0, 30, k).astype(np.float32)
    cr[:10], cw[:10] = cr[10:20], cw[10:20]  # equal benefits
    thr = np.float32(rng.random() * 500)
    ref = _ref_plan(*map(jnp.asarray, (cs, cp, cr, cw)),
                    jax.tree.map(jnp.asarray, dram), jnp.asarray(thr))
    port = migration.plan_migrations(
        t(cs), t(cp), t(cr), t(cw), interop.from_numpy(migration.DramState, dram),
        migration.make_timing(**TIMING), torch.tensor(thr))
    assert not tree_diff(interop.to_numpy(port), ref)


def test_benefits_and_threshold_match_compiled_reference(rng):
    tm = ref_mig.make_timing(**TIMING)
    a = rng.integers(0, 32769, 4000).astype(np.float32)
    b = rng.integers(0, 32769, 4000).astype(np.float32)
    c = rng.integers(0, 32769, 4000).astype(np.float32)
    d = rng.integers(0, 32769, 4000).astype(np.float32)
    dirty = rng.random(4000) < 0.5
    ptm = migration.make_timing(**TIMING)
    ref = jax.jit(ref_mig.migration_benefit)(jnp.asarray(a), jnp.asarray(b), tm)
    assert same_bits(migration.migration_benefit(t(a), t(b), ptm).numpy(), ref)
    ref = jax.jit(ref_mig.swap_benefit)(*map(jnp.asarray, (a, b, c, d)), tm, jnp.asarray(dirty))
    assert same_bits(migration.swap_benefit(t(a), t(b), t(c), t(d), ptm, t(dirty)).numpy(), ref)
    thr = (rng.random(4000) * 2e6).astype(np.float32)
    ev = rng.integers(0, 600, 4000).astype(np.int32)
    ref = jax.jit(jax.vmap(ref_mig.adapt_threshold))(jnp.asarray(thr), jnp.asarray(ev))
    assert same_bits(migration.adapt_threshold(t(thr), t(ev)).numpy(), ref)


def test_dram_record_apply_new_interval(rng):
    dram = _dram(rng, 200, 0.6, 50)
    slot = rng.integers(-1, 200, 3000).astype(np.int32)
    wr = rng.random(3000) < 0.4
    ref = ref_mig.dram_record_access(jax.tree.map(jnp.asarray, dram), jnp.asarray(slot),
                                     jnp.asarray(wr), jnp.int32(77))
    port = migration.dram_record_access(interop.from_numpy(migration.DramState, dram),
                                        t(slot), t(wr), torch.tensor(77, dtype=torch.int32))
    assert not tree_diff(interop.to_numpy(port), ref)
    k = 64
    migrate = rng.random(k) < 0.5
    dst = np.where(migrate, rng.choice(200, k, replace=False), -1).astype(np.int32)
    plan = ref_mig.MigrationPlan(
        migrate=migrate, dst_slot=dst, evict_sp=np.full(k, -1, np.int32),
        evict_page=np.full(k, -1, np.int32), evict_dirty=np.zeros(k, bool),
        benefit=np.zeros(k, np.float32))
    cs = rng.integers(0, 50, k).astype(np.int32)
    cp = rng.integers(0, P, k).astype(np.int32)
    ref2 = ref_mig.dram_apply_plan(ref, jax.tree.map(jnp.asarray, plan),
                                   jnp.asarray(cs), jnp.asarray(cp), jnp.int32(9))
    port2 = migration.dram_apply_plan(port, interop.from_numpy(migration.MigrationPlan, plan),
                                      t(cs), t(cp), torch.tensor(9, dtype=torch.int32))
    assert not tree_diff(interop.to_numpy(port2), ref2)
    assert not tree_diff(interop.to_numpy(migration.dram_new_interval(port2)),
                         ref_mig.dram_new_interval(ref2))
