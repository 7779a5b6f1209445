"""repro_torch's CUDA kernels held against their plain PyTorch versions on a
card (bitwise, or within the attention's stated tolerance), and the slices
end to end on the GPU against the CPU port (which the other test_torch_*
files hold to the JAX package).  Every test here needs a
CUDA device and skips itself without one; the file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, interop
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.engine.simloop import make_chunks_np
from repro_torch.kernels.block_gather import ops as gather_ops
from repro_torch.kernels.block_gather.ref import block_gather_ref_
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (
    expand_kv, flash_attention_lse_ref, flash_attention_ref,
)
from repro_torch.kernels.page_counter import ops
from repro_torch.kernels.page_counter.ref import fused_observe_count_ref, two_stage_count_ref
from repro_torch.kernels.rainbow_attention import ops as attn_ops
from repro_torch.kernels.rainbow_attention.ref import rainbow_attention_ref
from repro_torch.launch import serve, train
from repro_torch.memory import kvcache
from repro_torch.models import layers, model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving.rainbow_decode import rainbow_decode_step
from repro_torch.sim import config, runner, tlbsim
from repro_torch.train.step import TrainStepConfig, build_train_step
from repro_torch.utils.tree import tree_leaves
from torch_port_util import cuda_device, metrics_diff, t, tree_diff  # noqa: F401

pytestmark = pytest.mark.gpu

# (accesses, num_superpages, pages_per_sp, monitored rows, write_weight)
COUNTER_SHAPES = {
    "300a": (300, 16, 8, 4, 3),
    "517a": (517, 8, 32, 2, 2),
    "zero_access": (0, 16, 8, 4, 2),
    "single_row": (129, 8, 8, 1, 2),
    "main_path": (260_000, 54, 512, 100, 2),
}


def _counter_inputs(rng, a, nsp, pages, n):
    sp = rng.integers(-1, nsp, a).astype(np.int32)
    pg = rng.integers(0, pages, a).astype(np.int32)
    wr = rng.random(a) < 0.3
    mon = np.full(n, -1, np.int32)
    k = min(max(n - 1, 1), nsp)
    mon[:k] = rng.choice(nsp, k, replace=False)
    return sp, pg, wr, mon


@pytest.mark.parametrize("shape", list(COUNTER_SHAPES))
def test_counter_kernel_matches_plain(shape, cuda_device, rng):
    a, nsp, pages, n, ww = COUNTER_SHAPES[shape]
    args = [t(x).to(cuda_device) for x in _counter_inputs(rng, a, nsp, pages, n)]
    before = ops.fused_observe_count.launches
    got = ops.fused_observe_count(*args, nsp, pages, ww)
    want = fused_observe_count_ref(*args, nsp, pages, ww)
    torch.cuda.synchronize()
    assert ops.fused_observe_count.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_counter_wrapper_rejects_wrong_dtype(cuda_device):
    sp = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    z = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="sp must be"):
        ops.fused_observe_count(sp, z, z.bool(), z[:2], 4, 8)


@pytest.mark.parametrize("accesses", [0, 4000, 260_000])
def test_walk_kernel_matches_plain_walker(accesses, cuda_device):
    mc = config.MachineConfig()
    chunks, _ = make_chunks_np("mcf", "rainbow", mc, 7, 2)
    rng = np.random.default_rng(0)

    def interval(i, n):
        in_dram = rng.random(chunks.sp.shape[1]) < 0.15
        return [t(x[:n]).to(cuda_device)
                for x in (chunks.vpn[i], chunks.sp[i], in_dram, chunks.is_write[i])]

    warm = tlbsim.run_interval("rainbow", mc, tlbsim.init_state(mc, cuda_device),
                               *interval(0, chunks.sp.shape[1]))
    args = interval(1, accesses)
    before = tlbsim.run_interval.launches
    got = tlbsim.run_interval("rainbow", mc, warm, *args)
    want = tlbsim.walk_plain("rainbow", mc, warm, *args)
    torch.cuda.synchronize()
    assert tlbsim.run_interval.launches == before + 1
    assert not tree_diff(interop.to_numpy(got), interop.to_numpy(want))


def test_walk_rejects_negative_ids(cuda_device):
    mc = config.MachineConfig()
    state = tlbsim.init_state(mc, cuda_device)
    v = torch.tensor([3, -1], dtype=torch.int32, device=cuda_device)
    f = torch.zeros(2, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="non-negative"):
        tlbsim.run_interval("rainbow", mc, state, v, v, f, f)


@pytest.mark.parametrize("app", ["streamcluster", "mix1"])
@pytest.mark.parametrize("backend", ["kernel", "scatter"])
def test_simulate_on_gpu_equals_cpu_port(app, backend, cuda_device):
    kw = dict(intervals=2, accesses=4000, counter_backend=backend)
    ops.fused_observe_count.launches = 0
    tlbsim.run_interval.launches = 0
    gpu = runner.simulate(app, "rainbow", device=cuda_device, **kw)
    assert tlbsim.run_interval.launches == 2
    assert ops.fused_observe_count.launches == (2 if backend == "kernel" else 0)
    assert not metrics_diff(runner.simulate(app, "rainbow", device="cpu", **kw), gpu)


# (B, HP, KVS, hd, block, nblk, hot, length, fresh lane + mass)
ATTN_CASES = {
    "pallas-3blk": (1, 4, 4, 16, 4, 3, 4, 10, False),
    "pallas-4blk": (3, 8, 2, 64, 16, 4, 4, 62, False),
    "pallas-single_block": (2, 4, 2, 32, 8, 1, 4, 6, False),
    "serve-len0": (8, 16, 8, 128, 16, 20, 10, 0, True),
    "serve-len150": (8, 16, 8, 128, 16, 20, 10, 150, True),
    "serve-len319": (8, 16, 8, 128, 16, 20, 10, 319, True),
}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MASS_TOL = 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_kernel_matches_plain(case, dtype, cuda_device, rng):
    b, hp, kvs, hd, block, nblk, hot, length, fresh = ATTN_CASES[case]
    nb = b * nblk

    def rand(*shape):
        return t(rng.standard_normal(shape, dtype=np.float32)).to(cuda_device, dtype)

    pools = [rand(nb, block, kvs, hd), rand(nb, block, kvs, hd),
             rand(hot, block, kvs, hd), rand(hot, block, kvs, hd)]
    vidx = t(rng.integers(0, nb + hot, (b, nblk)).astype(np.int32)).to(cuda_device)
    extra = [rand(b, kvs, hd), rand(b, kvs, hd)] if fresh else [None, None]
    q = rand(b, hp, hd)
    before = attn_ops.rainbow_attention.launches
    got = attn_ops.rainbow_attention(q, *pools, vidx, length, *extra, with_mass=fresh)
    want = rainbow_attention_ref(q, *pools, vidx, length, *extra, with_mass=fresh)
    torch.cuda.synchronize()
    assert attn_ops.rainbow_attention.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
    if fresh:
        torch.testing.assert_close(got[1], want[1], atol=MASS_TOL, rtol=MASS_TOL)


def test_attention_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    z = torch.zeros((1, 4, 8), device=cuda_device)
    pool = torch.zeros((2, 4, 1, 8), device=cuda_device)
    vidx = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="no readable position"):
        attn_ops.rainbow_attention(z, pool, pool, pool, pool, vidx, 0)
    with pytest.raises(ValueError, match="group"):  # 16 query heads on one kv head
        attn_ops.rainbow_attention(torch.zeros((1, 16, 8), device=cuda_device),
                                   pool, pool, pool, pool, vidx, 1)


# (layers, NB, HOT, lanes, row, pairs, all_skip)
GATHER_CASES = {
    "24nb": (1, 24, 6, 6, (4, 2, 8), 1, False),
    "single_lane": (1, 64, 16, 1, (4, 2, 8), 1, False),
    "no_valid_lanes": (1, 16, 4, 4, (4, 2, 8), 1, True),
    "odd_row": (3, 12, 5, 5, (3, 1, 3), 2, False),
    "serve": (28, 160, 10, 10, (16, 8, 128), 2, False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_kernel_matches_plain(case, dtype, cuda_device, rng):
    layers, nb, hot, k, row, npairs, skip = GATHER_CASES[case]
    src = rng.integers(-1, nb, k).astype(np.int32)
    if skip:
        src[:] = -1
    dst = rng.permutation(hot)[:k].astype(np.int32)
    src, dst = t(src).to(cuda_device), t(dst).to(cuda_device)
    pairs = [tuple(t(rng.standard_normal((layers, n, *row), dtype=np.float32))
                   .to(cuda_device, dtype) for n in (nb, hot)) for _ in range(npairs)]
    want = [(c.clone(), h.clone()) for c, h in pairs]
    before = gather_ops.block_gather_.launches
    gather_ops.block_gather_(pairs, src, dst)
    block_gather_ref_(want, src, dst)
    torch.cuda.synchronize()
    assert gather_ops.block_gather_.launches == before + 1
    for (_, h), (_, w) in zip(pairs, want):
        assert torch.equal(h.view(torch.uint8), w.view(torch.uint8))


SERVE_ARGV = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "2", "--prompt-len", "10",
              "--tokens", "6", "--block-size", "4", "--interval-steps", "4"]


def test_serve_on_gpu_launches_each_kernel_as_the_path_implies(cuda_device):
    attn_ops.rainbow_attention.launches = 0
    gather_ops.block_gather_.launches = 0
    res = serve.main(SERVE_ARGV)
    assert res["device"].type == "cuda"
    steps, cfg = res["decode_steps"], res["cfg"]
    assert attn_ops.rainbow_attention.launches == cfg.num_layers * steps
    assert gather_ops.block_gather_.launches == steps // 4 == len(res["reports"])
    assert res["resident"] > 0


def test_teacher_forced_decode_on_gpu_equals_cpu_port(cuda_device):
    """float32, TF32 off (the default): logits within 1e-5, the same
    promotions and evictions interval by interval."""
    cfg = dataclasses.replace(configs.get_reduced_config("qwen3-4b"),
                              dtype="float32", param_dtype="float32")
    pcfg = kvcache.PagedConfig(block_size=4, blocks_per_seq=6, hot_slots=6, top_n=4,
                               max_promotions=4, interval_steps=4)
    tree = interop.numpy_params(cfg, 3)
    toks = np.random.default_rng(0).integers(0, 256, (2, 24)).astype(np.int32)
    runs = {}
    for dev in ("cpu", cuda_device):
        params = interop.params_from_numpy(cfg, tree, dev)
        kv = kvcache.paged_init(cfg, pcfg, 2, 1, cfg.num_layers, dev)
        reports, logits = [], []
        for i in range(24):
            out, kv = rainbow_decode_step(cfg, pcfg, params, t(toks[:, i:i + 1]).to(dev),
                                          kv, reports=reports)
            logits.append(out.cpu())
        runs[str(dev)] = (torch.stack(logits),
                          [(int(r["promoted"]), int(r["evicted"])) for r in reports])
    (cl, cr), (gl, gr) = runs["cpu"], runs[str(cuda_device)]
    torch.testing.assert_close(gl, cl, atol=1e-5, rtol=1e-5)
    assert gr == cr and sum(p for p, _ in cr) > 0


# (B, S, HP, KVS, hd, causal): tests/test_kernels.py's sweep, GQA, ragged
# lengths, every head_dim the kernel is built for
FLASH_CASES = {
    "1x128x2x32-causal": (1, 128, 2, 2, 32, True),
    "2x256x4x64-causal": (2, 256, 4, 4, 64, True),
    "1x256x1x128-full": (1, 256, 1, 1, 128, False),
    "gqa-2x128x16on8x128": (2, 128, 16, 8, 128, True),
    "ragged-1x200x4on2x64": (1, 200, 4, 2, 64, True),
    "ragged-full-1x77x2x32": (1, 77, 2, 2, 32, False),
    "hd16-2x40x4on2x16": (2, 40, 4, 2, 16, True),
    "single-row-1x1x2x16": (1, 1, 2, 1, 16, True),
}
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}
# bf16 out vs the plain version with P kept in float32 (as the kernel keeps
# it) on the same inputs: two roundings of nearly equal float32 sums, so at
# most one bf16 ulp apart (2**-7 relative at worst)
FLASH_BF16_P32_TOL = {"atol": 1e-5, "rtol": 1e-2}


def _flash_inputs(shape, dtype, device, rng, grad=False):
    b, s, hp, kvs, hd, _ = shape
    return [t(rng.standard_normal(sh, dtype=np.float32)).to(device, dtype).requires_grad_(grad)
            for sh in ((b, s, hp, hd), (b, s, kvs, hd), (b, s, kvs, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernel_matches_plain(case, dtype, cuda_device, rng):
    shape = FLASH_CASES[case]
    hp, causal = shape[2], shape[5]
    q, k, v = _flash_inputs(shape, dtype, cuda_device, rng)
    before = flash_ops.flash_attention.launches
    out, lse = flash_ops.flash_attention(q, k, v, causal)
    ke, ve = expand_kv(k, hp), expand_kv(v, hp)
    want = flash_attention_ref(q, ke, ve, causal)
    want_lse = flash_attention_lse_ref(q, ke, causal)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    if dtype == torch.bfloat16:
        want32 = flash_attention_ref(q.float(), ke.float(), ve.float(), causal)
        torch.testing.assert_close(out.float(), want32.to(dtype).float(), **FLASH_BF16_P32_TOL)


@pytest.mark.parametrize("case", ["gqa-2x128x16on8x128", "ragged-1x200x4on2x64",
                                  "ragged-full-1x77x2x32"])
def test_flash_gradient_matches_autograd_of_plain(case, cuda_device, rng):
    shape = FLASH_CASES[case]
    hp, causal = shape[2], shape[5]
    q, k, v = _flash_inputs(shape, torch.float32, cuda_device, rng, grad=True)
    dout = t(rng.standard_normal(tuple(q.shape), dtype=np.float32)).to(cuda_device)
    got = torch.autograd.grad((flash_ops.attention(q, k, v, causal) * dout).sum(), (q, k, v))
    want = torch.autograd.grad(
        (flash_attention_ref(q, expand_kv(k, hp), expand_kv(v, hp), causal) * dout).sum(),
        (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_flash_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    q = torch.zeros((1, 8, 4, 24), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 24"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 3, 16), device=cuda_device)
    kv = torch.zeros((1, 8, 2, 16), device=cuda_device)
    with pytest.raises(ValueError, match="do not divide"):
        flash_ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q, q.transpose(1, 2), q)


def test_bf16_matmul_with_float32_output_has_the_widened_gradient(cuda_device, rng):
    x = t(rng.standard_normal((64, 48), dtype=np.float32)).to(cuda_device, torch.bfloat16)
    w = t(rng.standard_normal((48, 3, 8), dtype=np.float32)).to(cuda_device, torch.bfloat16)
    g = t(rng.standard_normal((64, 3, 8), dtype=np.float32)).to(cuda_device)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = layers.matmul(xr, wr, torch.float32)
    assert y.dtype == torch.float32
    dx, dw = torch.autograd.grad((y * g).sum(), (xr, wr))
    xf, wf = x.float().requires_grad_(True), w.float().requires_grad_(True)
    want = torch.autograd.grad(((xf @ wf.reshape(48, -1)).reshape(64, 3, 8) * g).sum(),
                               (xf, wf))
    assert dx.dtype == dw.dtype == torch.bfloat16
    # the float32 gradients rounded to bf16, as the reference's transpose
    # rounds them: at most one bf16 ulp apart (float32 sums in another order)
    for got, w_ in zip((dx, dw), want):
        torch.testing.assert_close(got.float(), w_.to(torch.bfloat16).float(),
                                   atol=1e-6, rtol=2.0 ** -7)


# (accesses, num_superpages, pages_per_sp, monitored rows): test_kernels.py's
# two-stage cases, then the simulator's interval shape
TWO_STAGE_CASES = {"100a": (100, 16, 8, 4), "517a": (517, 8, 32, 2),
                   "1000a": (1000, 32, 16, 8), "zero_access": (0, 16, 8, 4),
                   "single_row": (129, 8, 8, 1), "single_sp": (64, 1, 4, 1),
                   "main_path": (260_000, 54, 512, 100)}


@pytest.mark.parametrize("shape", list(TWO_STAGE_CASES))
def test_two_stage_kernel_matches_plain(shape, cuda_device, rng):
    a, nsp, pages, n = TWO_STAGE_CASES[shape]
    sp, pg, wr, mon = _counter_inputs(rng, a, nsp, pages, n)
    w = rng.integers(0, 1 << 32, a, dtype=np.uint64).astype(np.uint32)  # wraps mod 2^32
    args = [t(x).to(cuda_device) for x in (sp, pg, w, mon)]
    before = ops.two_stage_count.launches
    got = ops.two_stage_count(*args, nsp, pages)
    via = ops.count_accesses(*args, nsp, pages)
    want = two_stage_count_ref(args[0], args[1], args[2], nsp, args[3], pages)
    torch.cuda.synchronize()
    assert ops.two_stage_count.launches == before + 2  # zero accesses launch too
    assert all(torch.equal(g, x) and torch.equal(v_, x) for g, v_, x in zip(got, via, want))


def test_train_steps_on_gpu_equal_cpu_port(cuda_device):
    """Three float32 AdamW steps of the reduced config with chunked attention
    (the flash kernel on the card), TF32 off: losses within 1e-5; parameters
    within 1e-4, since Adam's m / sqrt(v) turns the last-bit differences of a
    near-zero gradient into a visible fraction of the step (lr 3e-3)."""
    cfg = dataclasses.replace(configs.get_reduced_config("qwen3-0.6b"),
                              dtype="float32", param_dtype="float32")
    tree = interop.numpy_params(cfg, 3)
    tcfg = TrainStepConfig(remat="full", attn_impl="chunked", adamw=AdamWConfig(lr=3e-3))
    runs = {}
    for dev in ("cpu", cuda_device):
        params = interop.params_from_numpy(cfg, tree, dev)
        state = {"params": params, "opt": adamw_init(params)}
        step = build_train_step(cfg, tcfg)
        data = SyntheticLM(cfg.vocab_size, 40, 4, seed=2)
        flash_ops.flash_attention.launches = 0
        losses = []
        for _ in range(3):
            state, m = step(state, data.next_batch())
            losses.append(float(m["loss"]))
        if str(dev) != "cpu":  # forward, then the recompute of remat "full"
            assert flash_ops.flash_attention.launches == 3 * 2 * cfg.num_layers
        runs[str(dev)] = (losses, [x.cpu() for x in tree_leaves(state["params"])])
    (cl, cp), (gl, gp) = runs["cpu"], runs[str(cuda_device)]
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    for a, b in zip(gp, cp):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


def test_train_main_on_gpu(cuda_device, tmp_path):
    flash_ops.flash_attention.launches = 0
    res = train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "4", "--batch", "2",
                      "--seq", "64", "--attn", "chunked", "--ckpt-dir", str(tmp_path)])
    assert res["device"].type == "cuda" and len(res["history"]) == 4
    assert flash_ops.flash_attention.launches == 4 * res["cfg"].num_layers
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert model.param_shapes(res["cfg"])["embed"]["tok"] == tuple(
        res["state"]["params"]["embed"]["tok"].shape)
