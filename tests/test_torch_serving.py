"""The Rainbow-paged serving slice against the JAX package on the CPU, at
reduced sizes: configs, the model layers, the controller glue Layer B adds
(weighted stage-1 counting, plan_and_apply's extra_exclude, the
serving-default preset), observe_block_mass / end_interval_promote on the
whole RainbowKV, rainbow_decode_step over several intervals (weights carried
across with interop.params_from_numpy), launch.serve's main, and the
full-width golden file's maker and checker."""
import dataclasses
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import counting as ref_counting
from repro.engine import control as ref_control
from repro.engine import policy as ref_policy
from repro.memory import kvcache as ref_kv
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.serving.rainbow_decode import rainbow_decode_step as ref_decode_step
from repro_torch import configs, interop
from repro_torch.core import counting
from repro_torch.engine import control, policy
from repro_torch.launch import serve
from repro_torch.memory import kvcache
from repro_torch.models import attention, layers
from repro_torch.serving.rainbow_decode import rainbow_decode_step
from repro_torch.serving.steps import greedy_sample
from torch_port_util import same_bits, t, tree_diff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-4b"  # tests/test_paged_kv.py's reduced config
B, S = 2, 24
PAGED = dict(block_size=4, blocks_per_seq=S // 4, hot_slots=6, top_n=4,
             max_promotions=4, interval_steps=4)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs(dtype: str, arch: str = ARCH):
    def cast(cfg):
        return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    return cast(ref_configs.get_reduced_config(arch)), cast(configs.get_reduced_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_params(dtype: str):
    rcfg, _ = _cfgs(dtype)
    return ref_model.init_params(rcfg, jax.random.PRNGKey(3), tp=1)


def _port_params(dtype: str):
    _, pcfg = _cfgs(dtype)
    return interop.params_from_numpy(pcfg, jax.tree.map(np.asarray, _ref_params(dtype)))


def _stream():
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs, policy, counting, control
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-4b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(arch, reduced):
    get = "get_reduced_config" if reduced else "get_config"
    ref, port = getattr(ref_configs, get)(arch), getattr(configs, get)(arch)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.padded_vocab == ref.padded_vocab
    assert (port.padded_heads(1), port.kv_store(1)) == (ref.padded_heads(1), ref.kv_store(1))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        port.kv_store(2)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        configs.get_config("mamba2-1.3b")


def test_serving_default_preset_matches_reference():
    ref, port = ref_policy.get_policy("serving-default"), policy.get_policy("serving-default")
    for f in dataclasses.fields(port):
        if f.name != "counter_backend":  # the port names its backends itself
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert policy.get_policy("sim-rainbow").interval_steps == 1
    assert port.replace(top_n=3).top_n == 3
    with pytest.raises(ValueError, match="interval_steps"):
        port.replace(interval_steps=0)


def test_stage1_record_weighted_matches_reference(rng):
    counts = rng.integers(0, 1 << 16, 64).astype(np.uint16)  # some overflowed
    ids = rng.integers(-1, 64, 500).astype(np.int32)
    w = rng.integers(0, 1025, 500).astype(np.uint32)  # quantize_mass's range
    want = ref_counting.stage1_record_weighted(
        ref_counting.Stage1State(counts=jnp.asarray(counts)), jnp.asarray(ids), jnp.asarray(w))
    got = counting.stage1_record_weighted(
        counting.Stage1State(counts=t(counts)), t(ids), t(w))
    assert same_bits(got.counts.numpy().astype(np.uint16), np.asarray(want.counts))


def _paged_state(dtype="float32", steps=11):
    """Reference (cfg, pcfg, kv) after `steps` decode steps: warm monitors,
    resident blocks, and an interval about to close."""
    rcfg, _ = _cfgs(dtype)
    pcfg = ref_kv.PagedConfig(**PAGED)
    step = jax.jit(lambda p, tok, k: ref_decode_step(rcfg, pcfg, p, tok, k,
                                                      collect_mass=True))
    kv = ref_kv.paged_init(rcfg, pcfg, B, 1, rcfg.num_layers)
    toks = _stream()
    mass = None
    for i in range(steps):
        _, kv, mass = step(_ref_params(dtype), jnp.asarray(toks[:, i:i + 1]), kv)
    return rcfg, pcfg, kv, mass


@functools.lru_cache(maxsize=None)
def _midrun():
    return _paged_state()


def test_plan_and_apply_extra_exclude_matches_reference(rng):
    _, pcfg, kv, _ = _midrun()
    ctrl_ref = pcfg.policy.control_config(num_units=B, pages_per_unit=pcfg.blocks_per_seq)
    ctrl = policy.get_policy("serving-default").replace(**{
        k: PAGED[k] for k in ("hot_slots", "top_n", "max_promotions", "interval_steps")
    }).control_config(num_units=B, pages_per_unit=pcfg.blocks_per_seq)
    reads = rng.integers(0, 3000, (PAGED["top_n"], PAGED["blocks_per_seq"])).astype(np.int32)
    exclude = rng.random(reads.shape) < 0.3
    timing = ref_kv.default_timing()
    want = jax.jit(lambda r, ex: ref_control.plan_and_apply(
        ctrl_ref, r, jnp.zeros_like(r), kv.s2.psn, kv.remap, kv.dram, kv.threshold,
        timing, now=jnp.int32(0), extra_exclude=ex))(jnp.asarray(reads), jnp.asarray(exclude))
    pkv = interop.kv_from_numpy(jax.tree.map(np.asarray, kv))
    got = control.plan_and_apply(
        ctrl, t(reads), torch.zeros(reads.shape, dtype=torch.int32), pkv.s2.psn, pkv.remap,
        pkv.dram, pkv.threshold, kvcache.default_timing(),
        now=torch.zeros((), dtype=torch.int32), extra_exclude=torch.from_numpy(exclude))
    assert not tree_diff(interop.to_numpy(got), want)
    # the mask is live: there are candidates, and none is an excluded block
    psn = np.asarray(kv.s2.psn)
    cands = [(int(np.flatnonzero(psn == sp)[0]), int(pg))
             for sp, pg in zip(got.cand_sp.tolist(), got.cand_page.tolist()) if sp >= 0]
    assert cands and not any(exclude[r, c] for r, c in cands)


def test_observe_and_end_interval_promote_match_reference():
    """Fed the reference's own step mass, the port's observe + interval close
    leave the whole RainbowKV bitwise equal to the reference's."""
    _, pcfg, kv, mass = _midrun()
    ref_obs = jax.jit(lambda k, m: ref_kv.observe_block_mass(k, pcfg, m))(kv, mass)
    ref_new, ref_rep = jax.jit(lambda k: ref_kv.end_interval_promote(k, pcfg))(ref_obs)
    ppcfg = kvcache.PagedConfig(**PAGED)
    pkv = interop.kv_from_numpy(jax.tree.map(np.asarray, kv))
    obs = kvcache.observe_block_mass(pkv, ppcfg, t(mass))
    assert not tree_diff(interop.kv_to_numpy(obs), ref_obs)
    assert obs.step_in_interval == ppcfg.interval_steps  # the interval is due
    new, rep = kvcache.end_interval_promote(obs, ppcfg)
    assert not tree_diff(interop.kv_to_numpy(new), ref_new)
    assert int(rep["promoted"]) == int(ref_rep["promoted"]) > 0
    assert int(rep["evicted"]) == int(ref_rep["evicted"])


# ---------------------------------------------------------------------------
# model layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layers_match_reference(dt, rng):
    rcfg, pcfg = _cfgs(dt)
    rp, pp = _ref_params(dt), _port_params(dt)
    lay = 1
    r_attn = {k: v[lay] for k, v in rp["segments"]["blocks"]["attn"].items()}
    p_attn = {k: v[lay] for k, v in pp["segments"]["blocks"]["attn"].items()}
    r_mlp = {k: v[lay] for k, v in rp["segments"]["blocks"]["mlp"].items()}
    p_mlp = {k: v[lay] for k, v in pp["segments"]["blocks"]["mlp"].items()}
    x = jnp.asarray(rng.standard_normal((B, 1, rcfg.d_model), dtype=np.float32), dt)
    pos = jnp.full((B, 1), 37, jnp.int32)
    tol = 1e-6 if dt == "float32" else 1e-2
    pairs = [
        (ref_layers.apply_norm(rcfg, {"scale": rp["final_norm"]["scale"]}, x),
         layers.apply_norm(pcfg, {"scale": pp["final_norm"]["scale"]}, t(x))),
        (ref_layers.apply_mlp(rcfg, r_mlp, x), layers.apply_mlp(pcfg, p_mlp, t(x))),
        (ref_layers.lm_logits(rcfg, rp["embed"], x), layers.lm_logits(pcfg, pp["embed"], t(x))),
        (ref_layers.embed_lookup(rcfg, rp["embed"], jnp.asarray([[5], [200]])),
         layers.embed_lookup(pcfg, pp["embed"], torch.tensor([[5], [200]]))),
    ]
    rq, rk, rv = ref_attn.qkv_project(rcfg, r_attn, x, pos, use_rope=True)
    pq, pk, pv = attention.qkv_project(pcfg, p_attn, t(x), t(pos), use_rope=True)
    pairs += [(rq, pq), (rk, pk), (rv, pv),
              (ref_attn.attn_output(r_attn, rq), attention.attn_output(p_attn, t(rq))),
              (ref_attn._expand_kv(rk, 4), attention._expand_kv(t(rk), 4))]
    for i, (want, got) in enumerate(pairs):
        assert got.dtype == t(want).dtype, i
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol, err_msg=f"pair {i}")
    vp = pcfg.padded_vocab
    logits = layers.lm_logits(pcfg, pp["embed"], t(x))
    assert logits.shape[-1] == vp and bool((logits[..., pcfg.vocab_size:] == -1e9).all())
    ties = torch.tensor([[[1.0, 3.0, 3.0, 0.0]]])
    assert greedy_sample(ties, 3).tolist() == [[1]]  # the first maximum, as jnp.argmax


# ---------------------------------------------------------------------------
# the decode step and the launcher
# ---------------------------------------------------------------------------

# logits (and pools) tolerance; the controller state is held bitwise
DECODE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rainbow_decode_step_matches_reference(dt):
    """Six intervals of decode (promotions and evictions): logits within
    tolerance, argmax tokens equal, controller state (remap, counters, slot
    manager, threshold) bitwise, pools within the logits' tolerance."""
    rcfg, pcfg_m = _cfgs(dt)
    rp, pp = _ref_params(dt), _port_params(dt)
    rpc, ppc = ref_kv.PagedConfig(**PAGED), kvcache.PagedConfig(**PAGED)
    step = jax.jit(lambda p, tok, k: ref_decode_step(rcfg, rpc, p, tok, k))
    kv = ref_kv.paged_init(rcfg, rpc, B, 1, rcfg.num_layers)
    pkv = kvcache.paged_init(pcfg_m, ppc, B, 1, pcfg_m.num_layers, "cpu")
    toks = _stream()
    reports = []
    for i in range(S):
        want, kv = step(rp, jnp.asarray(toks[:, i:i + 1]), kv)
        got, pkv = rainbow_decode_step(pcfg_m, ppc, pp, torch.from_numpy(toks[:, i:i + 1]),
                                       pkv, reports=reports)
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=DECODE_TOL[dt], rtol=DECODE_TOL[dt])
        assert (greedy_sample(got, rcfg.vocab_size).numpy()
                == np.asarray(jnp.argmax(want[..., :rcfg.vocab_size], -1))).all()
    assert len(reports) == S // PAGED["interval_steps"]
    assert sum(int(r["promoted"]) for r in reports) > 0
    assert sum(int(r["evicted"]) for r in reports) > 0
    got, ref = interop.kv_to_numpy(pkv), jax.tree.map(np.asarray, kv)
    pools = ("cap_k", "cap_v", "hot_k", "hot_v")
    assert not tree_diff({k: v for k, v in got.items() if k not in pools}, ref)
    for k in pools:
        np.testing.assert_allclose(got[k], np.asarray(getattr(ref, k), np.float32),
                                   atol=DECODE_TOL[dt], rtol=DECODE_TOL[dt])


def test_decode_step_refuses_unported_modes():
    _, pcfg_m = _cfgs("float32")
    ppc = kvcache.PagedConfig(**PAGED)
    pkv = kvcache.paged_init(pcfg_m, ppc, B, 1, pcfg_m.num_layers, "cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        rainbow_decode_step(pcfg_m, ppc, _port_params("float32"),
                            torch.zeros((B, 1), dtype=torch.int32), pkv, mode="sparse")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        kvcache.PagedConfig(quantize=True)


SERVE_ARGV = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "2", "--prompt-len", "10",
              "--tokens", "6", "--block-size", "4", "--interval-steps", "4"]


def test_serve_main_on_cpu(capsys):
    res = serve.main(SERVE_ARGV + ["--device", "cpu"])
    assert res["device"].type == "cpu"
    assert tuple(res["tokens"].shape) == (2, 6) and res["tokens"].dtype == torch.int32
    assert res["decode_steps"] == 15 and len(res["reports"]) == 15 // 4
    assert 0 < res["resident"] <= res["pcfg"].hot_slots
    assert res["pcfg"].hot_slots == 8 and res["pcfg"].top_n == 4  # serving-default sizing
    assert "promoted hot blocks" in capsys.readouterr().out
    again = serve.main(SERVE_ARGV + ["--device", "cpu"])  # seeded: the same tokens
    assert torch.equal(again["tokens"], res["tokens"])


def test_serve_main_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SERVE_ARGV)


@pytest.mark.parametrize("flags", [["--kv", "flat"], ["--autotune"],
                                   ["--timing-model", "queueing"],
                                   ["--queue-geometry", "default"]])
def test_serve_main_refuses_unported_flags(flags):
    with pytest.raises(SystemExit):
        serve.main(SERVE_ARGV + ["--device", "cpu"] + flags)


# ---------------------------------------------------------------------------
# the full-width golden file (chip_smoke.py's serve parity)
# ---------------------------------------------------------------------------


def test_serve_golden_file_matches_its_maker():
    maker = _load("make_torch_serve_golden", "scripts/make_torch_serve_golden.py")
    with open(os.path.join(ROOT, "tests", "data", "torch_serve_golden.json")) as f:
        doc = json.load(f)
    assert (doc["arch"], doc["num_layers"], doc["seed"], doc["reduced"]) == (
        maker.ARCH, maker.LAYERS, maker.SEED, False)
    assert doc["paged"] == maker.paged_knobs(maker.STEPS, maker.BLOCK)
    assert np.asarray(doc["stream"]).shape == (maker.BATCH, maker.STEPS)
    assert np.asarray(doc["logits"]).shape == (maker.STEPS, maker.BATCH, maker.N_LOGIT_IDS)
    assert len(doc["intervals"]) == maker.STEPS // doc["paged"]["interval_steps"]
    assert sum(i["promoted"] for i in doc["intervals"]) > 0
    assert sum(i["evicted"] for i in doc["intervals"]) > 0


def test_serve_golden_maker_and_checker_agree_at_reduced_size():
    """The maker (JAX) and chip_smoke.py's checker (the port) on a reduced
    config: the same weights digest, logits and interval counts."""
    maker = _load("make_torch_serve_golden", "scripts/make_torch_serve_golden.py")
    smoke = _load("chip_smoke", "chip_smoke.py")
    doc = maker.make_golden(reduced=True, layers=2, batch=3, steps=24, block=4)
    assert sum(i["promoted"] for i in doc["intervals"]) > 0
    rec = smoke.check_serve_golden(torch, np, doc, torch.device("cpu"))
    assert rec["max_logit_err"] <= smoke.SERVE_LOGIT_TOL
    assert rec["argmax_agree"] == rec["argmax_total"]
