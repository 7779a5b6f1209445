"""The interval walk ("rainbow" kind): the port's plain walker held bitwise
against the JAX package's run_interval_fast over the whole SimState (tags,
LRU, clock, 14 counters), from warmed states with mixed residency.
tests/test_torch_gpu.py holds the CUDA kernel to the plain walker on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import simloop as ref_loop
from repro.sim import config as ref_cfg
from repro.sim import tlbsim as ref_tlbsim
from repro_torch import interop
from repro_torch.sim import config, tlbsim
from torch_port_util import t, tree_diff

SMALL = dict(l2_tlb_entries=8, bitmap_cache_entries=24)  # more evictions


def _mcs(geometry):
    kw = SMALL if geometry == "small" else {}
    return ref_cfg.MachineConfig(**kw), config.MachineConfig(**kw)


def _intervals(app, accesses, n, seed=7):
    chunks, _ = ref_loop.make_chunks_np(app, "rainbow", ref_cfg.MachineConfig(), seed, n, accesses)
    rng = np.random.default_rng(seed)
    for i in range(n):
        in_dram = rng.random(chunks.sp.shape[1]) < 0.15  # mixed residency
        yield chunks.vpn[i], chunks.sp[i], in_dram, chunks.is_write[i]


def _warm_pair(ref_mc, mc, app, accesses):
    """The same warmed state in both packages (one reference interval)."""
    args = next(iter(_intervals(app, accesses, 1, seed=11)))
    ref_state = ref_tlbsim.run_interval_fast(
        "rainbow", ref_mc, ref_tlbsim.init_state(ref_mc), *map(jnp.asarray, args))
    port_state = interop.from_numpy(tlbsim.SimState, jax.tree.map(np.asarray, ref_state))
    return ref_state, port_state


@pytest.mark.parametrize("geometry", ["default", "small"])
@pytest.mark.parametrize("app,accesses", [("streamcluster", 3000), ("GUPS", 3000),
                                          ("mcf", 4000), ("mix1", 4000)])
def test_plain_walker_matches_reference(app, accesses, geometry):
    ref_mc, mc = _mcs(geometry)
    ref_state, port_state = _warm_pair(ref_mc, mc, app, accesses)
    for args in _intervals(app, accesses, 2):
        ref_state = ref_tlbsim.run_interval_fast("rainbow", ref_mc, ref_state,
                                                 *map(jnp.asarray, args))
        port_state = tlbsim.walk_plain("rainbow", mc, port_state, *map(t, args))
        assert not tree_diff(interop.to_numpy(port_state), ref_state)


def test_empty_interval():
    ref_mc, mc = _mcs("default")
    ref_state, port_state = _warm_pair(ref_mc, mc, "DICT", 2000)
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, bool), np.zeros(0, bool))
    ref_state = ref_tlbsim.run_interval_fast("rainbow", ref_mc, ref_state, *map(jnp.asarray, empty))
    port_state = tlbsim.run_interval("rainbow", mc, port_state, *map(t, empty))
    assert not tree_diff(interop.to_numpy(port_state), ref_state)


def test_walk_costs_are_the_reference_float32_constants():
    mc = config.MachineConfig()
    c = tlbsim.walk_costs(mc)
    assert c.walk2m == np.float32(mc.ptw_refs_2m * mc.t_dr)
    assert c.bmp_miss == np.float32(np.float32(mc.bitmap_cache_lat) + np.float32(mc.t_nr))
    assert c.remap == np.float32(mc.remap_read_lat)
    assert all(isinstance(x, np.float32) for x in c)


def test_run_interval_on_cpu_is_the_plain_walker():
    mc = config.MachineConfig()
    args = [t(x) for x in next(iter(_intervals("DICT", 1500, 1)))]
    state = tlbsim.init_state(mc, "cpu")
    before = tlbsim.run_interval.launches
    a = tlbsim.run_interval("rainbow", mc, state, *args)
    b = tlbsim.walk_plain("rainbow", mc, state, *args)
    assert tlbsim.run_interval.launches == before
    assert not tree_diff(interop.to_numpy(a), interop.to_numpy(b))


@pytest.mark.parametrize("kind", ["flat4k", "sp2m"])
def test_other_walk_kinds_are_not_ported(kind):
    mc = config.MachineConfig()
    state = tlbsim.init_state(mc, "cpu")
    e = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tlbsim.run_interval(kind, mc, state, e, e, e.bool(), e.bool())

