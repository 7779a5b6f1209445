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
from repro_torch.engine.simloop import make_chunks_np
from repro_torch.kernels.block_gather import ops as gather_ops
from repro_torch.kernels.block_gather.ref import block_gather_ref_
from repro_torch.kernels.page_counter import ops
from repro_torch.kernels.page_counter.ref import fused_observe_count_ref
from repro_torch.kernels.rainbow_attention import ops as attn_ops
from repro_torch.kernels.rainbow_attention.ref import rainbow_attention_ref
from repro_torch.launch import serve
from repro_torch.memory import kvcache
from repro_torch.serving.rainbow_decode import rainbow_decode_step
from repro_torch.sim import config, runner, tlbsim
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
