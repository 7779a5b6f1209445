"""repro_torch configuration, timing presets, trace generator and energy model
held against the JAX package: equal fields, byte-equal trace chunks."""
import dataclasses

import numpy as np
import pytest

from repro.core import migration as ref_mig
from repro.engine import simloop as ref_loop
from repro.sim import config as ref_cfg
from repro.sim import energy as ref_energy
from repro.sim import trace as ref_trace
from repro_torch.core import migration as mig
from repro_torch.engine import simloop
from repro_torch.sim import config, energy, trace

WORKLOADS = list(ref_cfg.APPS) + list(ref_cfg.MIXES)


def test_machine_config_fields_equal():
    ref, port = ref_cfg.MachineConfig(), config.MachineConfig()
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for prop in ("dram_pages", "dram_superpages", "nvm_superpages"):
        assert getattr(ref, prop) == getattr(port, prop)


def test_tables_and_constants_equal():
    assert {k: dataclasses.asdict(v) for k, v in ref_cfg.APPS.items()} == {
        k: dataclasses.asdict(v) for k, v in config.APPS.items()}
    assert ref_cfg.MIXES == config.MIXES
    assert ref_cfg.POLICIES == config.POLICIES
    for name in ("PAGES_PER_SP", "SCALE_DOWN", "CPU_GHZ", "PAGE_BYTES", "SP_BYTES"):
        assert getattr(ref_cfg, name) == getattr(config, name), name
    assert ref_mig.TIMING_PRESETS == mig.TIMING_PRESETS


@pytest.mark.parametrize("name", sorted(ref_mig.TIMING_PRESETS))
def test_preset_timing_is_the_float32_of_the_reference(name):
    ref, port = ref_mig.preset_timing(name), mig.preset_timing(name)
    for field in mig.TimingParams._fields:
        assert np.float32(getattr(ref, field)) == np.float32(getattr(port, field))
        assert getattr(port, field) == float(np.float32(getattr(port, field)))


@pytest.mark.parametrize("bad", [
    dict(t_nr=0.0), dict(t_dw=-1.0), dict(t_mig=-0.5), dict(t_dr=float("nan")),
    dict(t_nw=float("inf")), dict(t_writeback="fast"),
])
def test_make_timing_rejects_what_the_reference_rejects(bad):
    kw = dict(t_nr=62.4, t_nw=547.2, t_dr=43.2, t_dw=91.2, t_mig=10.0, t_writeback=10.0)
    kw.update(bad)
    with pytest.raises(ValueError):
        ref_mig.make_timing(**kw)
    with pytest.raises(ValueError):
        mig.make_timing(**kw)


def test_unknown_preset_raises():
    with pytest.raises(KeyError):
        mig.preset_timing("no-such-preset")


@pytest.mark.parametrize("name", WORKLOADS)
def test_make_chunks_np_byte_equal(name):
    mc_ref, mc = ref_cfg.MachineConfig(), config.MachineConfig()
    ref_chunks, ref_meta = ref_loop.make_chunks_np(name, "rainbow", mc_ref, 3, 2, 800)
    chunks, meta = simloop.make_chunks_np(name, "rainbow", mc, 3, 2, 800)
    assert ref_meta == meta
    for field in simloop.TraceChunks._fields:
        a, b = getattr(ref_chunks, field), getattr(chunks, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    assert ref_trace.probe_meta(name, 800) == trace.probe_meta(name, 800)


def test_chunks_of_unported_policies_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        simloop.make_chunks_np("mcf", "flat-static", config.MachineConfig(), 5, 1, 500)


def test_full_size_probe_meta_equal():
    for name in WORKLOADS:
        assert ref_trace.probe_meta(name) == trace.probe_meta(name)


def test_scenario_names_are_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        trace.generate("stress/phase-shift", 7, 0, 100)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        trace.probe_meta("stress/phase-shift")


def test_energy_equal(rng):
    for cap in (1.0, 8.0):
        vals = [float(x) for x in rng.random(6) * 1e6]
        ref = ref_energy.energy_joules(ref_cfg.MachineConfig(), *vals, dram_capacity_factor=cap)
        port = energy.energy_joules(config.MachineConfig(), *vals, dram_capacity_factor=cap)
        assert ref == port
