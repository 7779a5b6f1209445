"""The training slice against the JAX package on the CPU, at reduced sizes and
in float32: loss_fn and its gradients (dense and chunked attention) from one
carried-across state, build_train_step's AdamW steps with the warmup-cosine
schedule (and gradient accumulation), SyntheticLM's batches byte for byte,
checkpoints written by either package restored by the other, the Trainer's
resume / retry / NaN-guard / preemption behaviour (tests/test_system.py's,
on the port), launch.train's main, and the full-width golden file's maker
and checker.  Every checkpoint goes to pytest's tmp_path."""
import dataclasses
import importlib.util
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import restore_state as ref_restore
from repro.checkpoint import save_state as ref_save
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import model as ref_model
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import linear_warmup_cosine as ref_schedule
from repro.train import step as ref_step
from repro_torch import configs, interop
from repro_torch.checkpoint import latest_step, restore_state, save_state
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train
from repro_torch.models import layers, model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, linear_warmup_cosine
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.step import TrainStepConfig, build_train_step, init_train_state
from repro_torch.utils.tree import tree_items, tree_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-0.6b"
SEED = 3
B, S = 2, 40  # S not a multiple of the kernel's tiles: a ragged last tile
LR = 3e-3
STEPS = 3
LOSS_TOL = 1e-5  # float32, the same arithmetic in another order
GRAD_TOL = 1e-6  # absolute, per gradient element (gradients are ~1e-2)
PARAM_TOL = 1e-6  # absolute, per parameter after STEPS AdamW steps
BF16_GRAD_TOL = 2e-2  # bf16 relative norm per leaf; measured worst 8.3e-3 (P kept in f32 here)


def _cfgs(dtype="float32"):
    def cast(cfg):
        return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    return (cast(ref_configs.get_reduced_config(ARCH)),
            cast(configs.get_reduced_config(ARCH)))


def _tree(dtype="float32"):
    """float32 numpy params in the reference's layout, and the same cast to `dtype`."""
    _, pcfg = _cfgs()
    tree = interop.numpy_params(pcfg, SEED)
    if dtype == "float32":
        return tree
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), tree)


def _batch(seq=S, batch=B, seed=1):
    return SyntheticLM(256, seq, batch, seed=seed).next_batch()


def _ref_state(tree):
    p = jax.tree.map(jnp.asarray, tree)
    return {"params": p, "opt": ref_adamw_init(p)}


def _grad_leaves(grads):
    return [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def ref_results():
    """The reference's loss / grads and train steps, computed once."""
    rcfg, _ = _cfgs()
    tree = _tree()
    params = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    out = {}
    for impl in ("dense", "chunked"):
        loss, grads = jax.value_and_grad(
            lambda p: ref_model.loss_fn(rcfg, p, jb, attn_impl=impl))(params)
        out["grad", impl] = (float(loss), _grad_leaves(grads))
    rcfg16, _ = _cfgs("bfloat16")
    loss, grads = jax.value_and_grad(
        lambda p: ref_model.loss_fn(rcfg16, p, jb, attn_impl="chunked"))(
            jax.tree.map(jnp.asarray, _tree("bfloat16")))
    out["loss_bf16"] = float(loss)
    out["grad_bf16"] = _grad_leaves(grads)
    for accum in (1, 2):
        tcfg = ref_step.TrainStepConfig(remat="none", attn_impl="chunked", accum_steps=accum,
                                        adamw=RefAdamWConfig(lr=LR))
        step = jax.jit(ref_step.build_train_step(
            rcfg, tcfg, lr_schedule=ref_schedule(LR, STEPS // 10 + 1, STEPS)))
        state, hist = _ref_state(tree), []
        data = RefSyntheticLM(256, S, 4, seed=2)
        for _ in range(STEPS):
            state, m = step(state, data.next_batch())
            hist.append({k: float(v) for k, v in m.items()})
        out["steps", accum] = (hist, jax.tree.map(np.asarray, state))
    return out


def _port_value_and_grad(pcfg, params, batch, impl, remat="none"):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    loss = model.loss_fn(pcfg, tree_map(lambda _: next(it), params),
                         {k: torch.as_tensor(v) for k, v in batch.items()},
                         attn_impl=impl, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_loss_and_grads_match_reference(impl, ref_results):
    _, pcfg = _cfgs()
    params = interop.params_from_numpy(pcfg, _tree())
    loss, grads = _port_value_and_grad(pcfg, params, _batch(), impl)
    want_loss, want_grads = ref_results["grad", impl]
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL, rtol=1e-4)


def test_remat_full_recomputes_the_same_gradients():
    _, pcfg = _cfgs()
    params = interop.params_from_numpy(pcfg, _tree())
    l0, g0 = _port_value_and_grad(pcfg, params, _batch(), "chunked", "none")
    l1, g1 = _port_value_and_grad(pcfg, params, _batch(), "chunked", "full")
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    with pytest.raises(NotImplementedError, match="dots"):
        _port_value_and_grad(pcfg, params, _batch(), "chunked", "dots")


def test_bf16_loss_matches_reference(ref_results):
    """bf16 weights and activations: products accumulate in float32 on both
    sides; the port keeps P in float32 where the reference rounds it."""
    _, pcfg = _cfgs("bfloat16")
    params = interop.params_from_numpy(pcfg, _tree("bfloat16"))
    loss = model.loss_fn(pcfg, params, {k: torch.as_tensor(v) for k, v in _batch().items()},
                         attn_impl="chunked")
    assert abs(float(loss) - ref_results["loss_bf16"]) <= 2e-3 * ref_results["loss_bf16"]


def test_bf16_grads_match_reference(ref_results):
    """bf16 gradients of every parameter (the float32-output products of the
    MLP and the LM head go through layers._MatmulF32's backward) within
    BF16_GRAD_TOL of the reference's, as a norm relative to the leaf's."""
    _, pcfg = _cfgs("bfloat16")
    params = interop.params_from_numpy(pcfg, _tree("bfloat16"))
    _, grads = _port_value_and_grad(pcfg, params, _batch(), "chunked")
    want_grads = ref_results["grad_bf16"]
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        assert g.dtype == torch.bfloat16
        err = np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w)
        assert err <= BF16_GRAD_TOL, err


def test_bf16_matmul_float32_output_gradient_matches_reference(rng):
    """The gradient of a bf16 product with a float32 output: JAX's transpose
    keeps the float32 output gradient in the products, so both sides round
    the same float32 sums to bf16.  Differences come only from summation
    order: at most one bf16 ulp, in under 1% of the elements.  (Rounding
    the output gradient to bf16 first moves ~40% of them, some by far more.)"""
    x = rng.standard_normal((64, 96), dtype=np.float32)
    w = rng.standard_normal((96, 4, 16), dtype=np.float32)
    g = rng.standard_normal((64, 4, 16), dtype=np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jax.grad(lambda a, b: (jnp.einsum(
        "sd,dhk->shk", a, b, preferred_element_type=jnp.float32) * g).sum(),
        argnums=(0, 1))(xb, wb)
    tx, tw = (torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16().requires_grad_(True)
              for a in (xb, wb))
    y = layers.matmul(tx, tw, torch.float32)
    assert y.dtype == torch.float32
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), (tx, tw))
    for a, j in zip(got, want):
        assert a.dtype == torch.bfloat16
        a, j = a.float().numpy(), np.asarray(j.astype(jnp.float32))
        assert (a != j).mean() <= 1e-2
        assert np.all(np.abs(a - j) <= 2.0 ** -7 * np.abs(j))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum, ref_results):
    """STEPS AdamW steps with the warmup-cosine schedule from one state."""
    _, pcfg = _cfgs()
    tcfg = TrainStepConfig(remat="full", attn_impl="chunked", accum_steps=accum,
                           adamw=AdamWConfig(lr=LR))
    step = build_train_step(pcfg, tcfg, lr_schedule=linear_warmup_cosine(
        LR, STEPS // 10 + 1, STEPS))
    state = interop.train_state_from_numpy(
        pcfg, jax.tree.map(np.asarray, _ref_state(_tree())))
    data = SyntheticLM(256, S, 4, seed=2)
    hist = []
    for _ in range(STEPS):
        state, m = step(state, data.next_batch())
        hist.append({k: float(v) for k, v in m.items()})
    want_hist, want_state = ref_results["steps", accum]
    for h, w in zip(hist, want_hist):
        assert set(h) == set(w)
        for k in w:
            assert abs(h[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1.0), (k, h[k], w[k])
    got = interop.train_state_to_numpy(state)
    assert int(got["opt"]["step"]) == STEPS == int(want_state["opt"]["step"])
    for (path, g), w in zip(tree_items(got), jax.tree.leaves(want_state)):
        np.testing.assert_allclose(g, np.asarray(w), atol=PARAM_TOL, rtol=1e-5, err_msg=path)


def test_adamw_and_schedule_match_reference(rng):
    tree = {"a": rng.standard_normal((5, 3), dtype=np.float32),
            "b": {"c": rng.standard_normal(7, dtype=np.float32)}}
    grads = jax.tree.map(lambda x: 30 * x, tree)  # large: the clip engages
    cfg = dict(lr=0.05, b1=0.8, b2=0.9, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref_adamw_init(rp)
    pp = tree_map(torch.from_numpy, tree)
    ps = adamw_init(pp)
    for _ in range(3):
        rp, rs, rm = ref_adamw_update(RefAdamWConfig(**cfg), jax.tree.map(jnp.asarray, grads),
                                      rs, rp)
        pp, ps, pm = adamw_update(AdamWConfig(**cfg), tree_map(torch.from_numpy, grads), ps, pp)
    for k in ("grad_norm", "clip_scale"):
        assert abs(float(pm[k]) - float(rm[k])) <= 1e-6 * abs(float(rm[k]))
    for g, w in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
    ref_lr, port_lr = ref_schedule(1.0, 10, 100), linear_warmup_cosine(1.0, 10, 100)
    for s in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        want = float(ref_lr(jnp.int32(s)))
        got = float(port_lr(torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7, (s, got, want)


def test_synthetic_lm_matches_reference_byte_for_byte():
    ref, port = RefSyntheticLM(1000, 24, 3, seed=7), SyntheticLM(1000, 24, 3, seed=7)
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        assert set(a) == set(b)
        assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)
    resumed = SyntheticLM(1000, 24, 3)
    resumed.load_state(port.state())
    assert resumed.next_batch()["tokens"].tobytes() == ref.next_batch()["tokens"].tobytes()


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


def _mixed_state():
    """A train state with bf16 params, float32 optimizer trees and the step."""
    _, pcfg = _cfgs("bfloat16")
    params = interop.params_from_numpy(pcfg, _tree("bfloat16"))
    opt = adamw_init(params)
    opt["step"] = torch.tensor(5, dtype=torch.int32)
    opt["m"] = tree_map(lambda x: x + 0.25, opt["m"])
    return {"params": params, "opt": opt}


def _same(port_tree, ref_tree):
    for (path, a), b in zip(tree_items(port_tree), jax.tree.leaves(ref_tree)):
        b = np.asarray(b)
        a = a.detach()
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16, path
            assert np.array_equal(a.view(torch.int16).numpy().view(np.uint16),
                                  b.view(np.uint16)), path
        else:
            assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), path


def test_port_checkpoint_restores_in_reference(tmp_path):
    state = _mixed_state()
    save_state(str(tmp_path), 5, state)
    like = tree_map(lambda x: jax.ShapeDtypeStruct(
        tuple(x.shape), jnp.bfloat16 if x.dtype == torch.bfloat16 else x.numpy().dtype), state)
    restored, step = ref_restore(str(tmp_path), like)
    assert step == 5
    _same(state, restored)


def test_reference_checkpoint_restores_in_port(tmp_path):
    state = _mixed_state()
    ref_tree = jax.tree.map(
        lambda x: jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16.dtype))
        if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy()), state)
    ref_save(str(tmp_path), 7, ref_tree)
    like = tree_map(torch.zeros_like, state)
    restored, step = restore_state(str(tmp_path), like)
    assert step == 7 and latest_step(str(tmp_path)) == 7
    _same(restored, ref_tree)


def test_checkpoint_retention_and_corruption(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32)}
    for s in (1, 2, 3, 4):
        save_state(str(tmp_path), s, tree_map(lambda x: x * s, state), keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    restored, step = restore_state(str(tmp_path), state)
    assert step == 4 and torch.equal(restored["w"], state["w"] * 4)
    shard = tmp_path / "step_00000004" / "shard_00000.npz"
    with np.load(shard) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["w"] = arrays["w"] + 1
    np.savez(shard, **arrays)
    with pytest.raises(ValueError, match="checksum"):
        restore_state(str(tmp_path), state)


# ---------------------------------------------------------------------------
# the Trainer (tests/test_system.py:16-93 on the port)
# ---------------------------------------------------------------------------


def _small_step(lr=3e-3):
    _, pcfg = _cfgs()
    tcfg = TrainStepConfig(remat="none", attn_impl="chunked", adamw=AdamWConfig(lr=lr))
    state = init_train_state(pcfg, np.random.default_rng(0), tcfg)
    return pcfg, state, build_train_step(pcfg, tcfg)


def _loop(tmp_path, total, every=100):
    return LoopConfig(total_steps=total, checkpoint_every=every,
                      checkpoint_dir=str(tmp_path), log_every=1000)


def test_training_loss_decreases(tmp_path):
    pcfg, state, step = _small_step()
    data = iter(SyntheticLM(pcfg.vocab_size, 32, 8, seed=5))
    _, hist = Trainer(step, data, _loop(tmp_path, 30, 10)).run(state, 0)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, f"loss did not fall: {first:.3f} -> {last:.3f}"


def test_trainer_resume_from_checkpoint(tmp_path):
    pcfg, state, step = _small_step()
    tr = Trainer(step, iter(SyntheticLM(pcfg.vocab_size, 16, 4, seed=1)),
                 _loop(tmp_path, 6, 3))
    final, _ = tr.run(state, 0)
    restored, start = tr.ckpt.restore_or_init(lambda: _small_step()[1])
    assert start == 6 and int(restored["opt"]["step"]) == start
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(final)))


def test_trainer_retries_transient_failures(tmp_path):
    pcfg, state, real = _small_step()
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated transient fault")
        return real(state, batch)

    tr = Trainer(flaky, iter(SyntheticLM(pcfg.vocab_size, 16, 4, seed=2)), _loop(tmp_path, 3))
    _, hist = tr.run(state, 0)
    assert len(hist) == 3
    assert any(e["event"] == "retry" for e in tr.events)


def test_trainer_reraises_after_max_retries(tmp_path):
    pcfg, state, _ = _small_step()

    def broken(state, batch):
        raise RuntimeError("kernel fault")

    tr = Trainer(broken, iter(SyntheticLM(pcfg.vocab_size, 16, 4)), _loop(tmp_path, 3))
    with pytest.raises(RuntimeError, match="kernel fault"):
        tr.run(state, 0)
    assert sum(e["event"] == "retry" for e in tr.events) == tr.lcfg.max_retries + 1
    assert latest_step(str(tmp_path)) == 0  # the last good state was saved


def test_trainer_nan_guard(tmp_path):
    pcfg, state, real = _small_step()
    calls = {"n": 0}

    def poisoned(state, batch):
        s, m = real(state, batch)
        calls["n"] += 1
        if calls["n"] == 2:
            m = dict(m, loss=torch.tensor(float("nan")))
        return s, m

    tr = Trainer(poisoned, iter(SyntheticLM(pcfg.vocab_size, 16, 4, seed=3)),
                 _loop(tmp_path, 4))
    _, hist = tr.run(state, 0)
    assert any(e["event"] == "nan_skip" for e in tr.events)
    assert len(hist) == 3  # the poisoned step was dropped


def test_trainer_preemption_saves_and_restores_handlers(tmp_path):
    pcfg, state, real = _small_step()
    before = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}

    def preempted(state, batch):
        handler = signal.getsignal(signal.SIGTERM)
        assert handler not in before.values() and callable(handler)
        handler(signal.SIGTERM, None)  # what a delivered SIGTERM runs
        return real(state, batch)

    tr = Trainer(preempted, iter(SyntheticLM(pcfg.vocab_size, 16, 4)), _loop(tmp_path, 5))
    _, hist = tr.run(state, 0)
    assert len(hist) == 1 and tr.events[-1] == {"step": 1, "event": "preempted"}
    assert latest_step(str(tmp_path)) == 1
    assert {sig: signal.getsignal(sig) for sig in before} == before


# ---------------------------------------------------------------------------
# launch.train and the golden file
# ---------------------------------------------------------------------------


def _argv(tmp_path):
    return ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2", "--seq", "24",
            "--attn", "chunked", "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2"]


def test_train_main_on_cpu_and_resume(tmp_path, capsys):
    res = train.main(_argv(tmp_path) + ["--device", "cpu"])
    assert res["device"].type == "cpu" and res["start"] == 0
    assert [h["step"] for h in res["history"]] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert "final loss" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002", "step_00000003"]
    again = train.main(_argv(tmp_path) + ["--device", "cpu", "--steps", "4"])
    assert again["start"] == 3 and [h["step"] for h in again["history"]] == [3]
    assert "resumed from step 3" in capsys.readouterr().out


def test_train_main_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(_argv(tmp_path))


@pytest.mark.parametrize("flags", [["--model-parallel", "2"], ["--remat", "dots"],
                                   ["--arch", "mamba2-1.3b"]])
def test_train_main_refuses_unported_flags(flags, tmp_path):
    with pytest.raises(SystemExit):
        train.main(_argv(tmp_path) + ["--device", "cpu"] + flags)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_golden_file_matches_its_maker():
    maker = _load("make_torch_train_golden", "scripts/make_torch_train_golden.py")
    with open(os.path.join(ROOT, "tests", "data", "torch_train_golden.json")) as f:
        doc = json.load(f)
    assert (doc["arch"], doc["num_layers"], doc["seed"], doc["reduced"]) == (
        maker.ARCH, maker.LAYERS, maker.SEED, False)
    assert (doc["batch"], doc["seq"], doc["steps"], doc["lr"]) == (
        maker.BATCH, maker.SEQ, maker.STEPS, maker.LR)
    assert len(doc["history"]) == maker.STEPS
    assert doc["history"][-1]["loss"] < doc["history"][0]["loss"]
    full = dataclasses.replace(configs.get_config(ARCH), num_layers=maker.LAYERS)
    assert sorted(doc["param_sums"]) == sorted(k for k, _ in tree_items(model.param_shapes(full)))


def test_train_golden_maker_and_checker_agree_at_reduced_size(tmp_path):
    """The maker (JAX) and chip_smoke.py's checkers (the port) on a reduced
    config: the same weights digest, losses, grad norms and parameter sums,
    and a checkpointed resume equal to the uninterrupted run."""
    maker = _load("make_torch_train_golden", "scripts/make_torch_train_golden.py")
    smoke = _load("chip_smoke", "chip_smoke.py")
    doc = maker.make_golden(reduced=True, layers=2, seq=S)
    rec = smoke.check_train_golden(torch, np, doc, torch.device("cpu"))
    assert rec["loss_rel_err"] <= smoke.TRAIN_LOSS_RTOL and rec["same_leaves"]
    res = smoke.check_train_resume(torch, np, doc, torch.device("cpu"), str(tmp_path))
    assert res["restored_step"] == 2 and res["rel_err"] <= smoke.RESUME_RTOL
