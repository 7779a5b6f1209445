"""repro_torch's CUDA kernels held bitwise against their plain PyTorch versions
on a card, and the slice end to end on the GPU against the CPU port (which the
other test_torch_* files hold to the JAX package).  Every test here needs a
CUDA device and skips itself without one; the file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.engine.simloop import make_chunks_np
from repro_torch.kernels.page_counter import ops
from repro_torch.kernels.page_counter.ref import fused_observe_count_ref
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
