"""The interval controller, phase by phase: observe_tiers, plan_and_apply,
rotate_monitors, rainbow.interval_step and the whole engine_step, held
bitwise against the JAX package (jitted, as its engine runs them) from the
same mid-run state: warmed TLBs, a part-full or a full DRAM."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import counting as ref_counting
from repro.core import rainbow as ref_rb
from repro.engine import control as ref_control
from repro.engine import simloop as ref_loop
from repro.sim import config as ref_cfg
from repro.sim.policies import machine_timing as ref_machine_timing
from repro_torch import interop
from repro_torch.core import counting, rainbow, remap
from repro_torch.engine import control, simloop
from repro_torch.sim import config
from repro_torch.sim.policies import machine_timing
from torch_port_util import t, tree_diff

# DRAM geometries: the default 65 536 slots (part-full after two intervals)
# and 128 slots (full, so admission evicts clean and dirty victims)
DRAMS = {"part_full": {}, "full": dict(dram_bytes=128 * 4096)}
APP, ACCESSES = "DICT", 4000


@functools.lru_cache(maxsize=None)
def _midrun(dram: str):
    """(reference spec, state after 3 intervals, numpy chunk of interval 4)."""
    mc = ref_cfg.MachineConfig(**DRAMS[dram])
    chunks, meta = ref_loop.make_chunks(APP, "rainbow", mc, 7, 4, ACCESSES)
    spec = ref_loop.EngineSpec(policy="rainbow", mc=mc,
                               num_superpages=meta["num_superpages"],
                               footprint_pages=meta["footprint_pages"])
    state, _ = ref_loop.engine_run(spec, ref_loop.engine_init(spec),
                                   jax.tree.map(lambda x: x[:3], chunks))
    chunk = jax.tree.map(lambda x: np.asarray(x[3]), chunks)
    return spec, state, chunk


def _port(dram: str, backend: str = "kernel"):
    spec, state, chunk = _midrun(dram)
    pspec = simloop.EngineSpec(
        policy="rainbow", mc=config.MachineConfig(**DRAMS[dram]),
        num_superpages=spec.num_superpages, footprint_pages=spec.footprint_pages,
        counter_backend=backend)
    pstate = interop.engine_state_from_numpy(jax.tree.map(np.asarray, state))
    return pspec, pstate, simloop.TraceChunks(*(t(x) for x in chunk))


def _ctrl(spec):
    return spec.control_policy().control_config(spec.num_superpages, 512)


def test_midrun_state_is_warm_and_partly_full():
    _, state, _ = _midrun("part_full")
    assert int(np.asarray(state.sim.t)) == 3 * ACCESSES
    used = int((np.asarray(state.pol.dram.slot_state) > 0).sum())
    assert 0 < used < state.pol.dram.slot_state.shape[0]
    _, full, _ = _midrun("full")
    assert bool((np.asarray(full.pol.dram.slot_state) > 0).all())
    assert int(np.asarray(full.pol.evictions_total)) > 0


@pytest.mark.parametrize("dram", list(DRAMS))
@pytest.mark.parametrize("backend", ["kernel", "scatter"])
def test_observe_tiers(dram, backend):
    spec, state, chunk = _midrun(dram)
    pspec, pstate, pchunk = _port(dram, backend)
    p = state.pol
    ref = jax.jit(ref_control.observe_tiers, static_argnums=0)(
        _ctrl(spec), p.s1, p.s2_reads, p.s2_writes, p.dram, p.remap,
        chunk.sp, chunk.page, chunk.is_write, p.interval)
    q = pstate.pol
    port = control.observe_tiers(
        _ctrl(pspec), q.s1, q.s2_reads, q.s2_writes, q.dram, q.remap,
        pchunk.sp, pchunk.page, pchunk.is_write, q.interval)
    for a, b in zip(port, ref):
        assert not tree_diff(interop.to_numpy(a), b)


@pytest.mark.parametrize("dram", list(DRAMS))
def test_plan_and_apply_and_rotate(dram):
    spec, state, chunk = _midrun(dram)
    pspec, pstate, pchunk = _port(dram)
    cfg = ref_loop._rainbow_cfg(spec)
    ref_obs = jax.jit(ref_rb.observe, static_argnums=0)(
        cfg, state.pol, chunk.sp, chunk.page, chunk.is_write, state.pol.interval)
    pcfg = simloop._rainbow_cfg(pspec)
    obs = rainbow.observe(pcfg, pstate.pol, pchunk.sp, pchunk.page, pchunk.is_write,
                          pstate.pol.interval)
    assert not tree_diff(interop.to_numpy(obs), ref_obs)

    def ref_plan(st):
        reads, writes = ref_counting.stage2_split_rw(st.s2_reads, st.s2_writes)
        return ref_control.plan_and_apply(
            _ctrl(spec), reads, writes, st.s2_reads.psn, st.remap, st.dram,
            st.threshold, ref_machine_timing(spec.mc), st.interval)

    ref_out = jax.jit(ref_plan)(ref_obs)
    out = control.plan_and_apply(
        _ctrl(pspec), counting.counter_value(obs.s2_reads.counts),
        counting.counter_value(obs.s2_writes.counts), obs.s2_reads.psn, obs.remap,
        obs.dram, obs.threshold, machine_timing(pspec.mc), obs.interval)
    assert not tree_diff(interop.to_numpy(out), ref_out)
    if dram == "full":
        assert int(out.n_evicted) > 0 and int(out.n_dirty) > 0

    ref_rot = jax.jit(ref_control.rotate_monitors, static_argnums=0)(
        _ctrl(spec), ref_obs.s1, ref_out.dram)
    rot = control.rotate_monitors(_ctrl(pspec), obs.s1, out.dram)
    assert not tree_diff(interop.to_numpy(rot[0]), ref_rot[0])
    assert np.array_equal(rot[1].numpy(), np.asarray(ref_rot[1]))
    assert not tree_diff(interop.to_numpy(rot[2]), ref_rot[2])


@pytest.mark.parametrize("dram", list(DRAMS))
def test_interval_step(dram):
    spec, state, chunk = _midrun(dram)
    pspec, pstate, pchunk = _port(dram)
    ref_st, ref_rep = jax.jit(ref_rb.interval_step, static_argnums=0)(
        ref_loop._rainbow_cfg(spec), state.pol, chunk.sp, chunk.page, chunk.is_write,
        ref_machine_timing(spec.mc))
    st, rep = rainbow.interval_step(simloop._rainbow_cfg(pspec), pstate.pol, pchunk.sp,
                                    pchunk.page, pchunk.is_write, machine_timing(pspec.mc))
    assert not tree_diff(interop.to_numpy(st), ref_st)
    assert not tree_diff(interop.to_numpy(rep), ref_rep)


@pytest.mark.parametrize("dram", list(DRAMS))
def test_engine_step(dram):
    spec, state, chunk = _midrun(dram)
    pspec, pstate, pchunk = _port(dram)
    ref_st, ref_stats = jax.jit(ref_loop.engine_step, static_argnums=0)(spec, state, chunk)
    st, stats = simloop.engine_step(pspec, pstate, pchunk)
    assert not tree_diff(interop.engine_state_to_numpy(st), ref_st)
    assert not tree_diff(interop.to_numpy(stats), ref_stats)


def test_unknown_counter_backend_raises():
    with pytest.raises(ValueError, match="counter_backend"):
        _port("part_full", backend="jax")[0].validate()
    cfg = control.ControlConfig(num_units=4, pages_per_unit=8, counter_backend="jax")
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="counter_backend"):
        control.observe_tiers(cfg, counting.stage1_init(4, "cpu"),
                              counting.stage2_init(2, 8, "cpu"),
                              counting.stage2_init(2, 8, "cpu"), None,
                              remap.remap_init(4, 8, "cpu"), z, z, z.bool(), z[0])
