"""The fused observe counter: the port's plain version held bitwise against the
JAX package's Pallas kernel (interpret mode) and its ref oracle, on the kernel
parity matrix's shapes.  tests/test_torch_gpu.py holds the CUDA kernel to the
plain version on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.page_counter.ops import observe_counts
from repro.kernels.page_counter.ref import fused_observe_count_ref as jax_ref
from repro_torch.kernels.page_counter import ops
from repro_torch.kernels.page_counter.ref import fused_observe_count_ref
from torch_port_util import same_bits, t

# (accesses, num_superpages, pages_per_sp, monitored rows, write_weight), as in
# tests/test_kernels.py's fused-observe cases
SHAPES = {
    "300a": (300, 16, 8, 4, 3),
    "517a": (517, 8, 32, 2, 2),
    "zero_access": (0, 16, 8, 4, 2),
    "single_row": (129, 8, 8, 1, 2),
}


def _inputs(rng, a, nsp, pages, n):
    sp = rng.integers(-1, nsp, a).astype(np.int32)
    pg = rng.integers(0, pages, a).astype(np.int32)
    wr = rng.random(a) < 0.3
    mon = np.full(n, -1, np.int32)  # -1 holes: partially-filled monitor set
    mon[: max(n - 1, 1)] = rng.choice(nsp, max(n - 1, 1), replace=False)
    return sp, pg, wr, mon


def _u32(outs):
    return [o.numpy().astype(np.uint32) for o in outs]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_pallas_interpret_and_ref(shape, rng):
    a, nsp, pages, n, ww = SHAPES[shape]
    sp, pg, wr, mon = _inputs(rng, a, nsp, pages, n)
    jargs = tuple(map(jnp.asarray, (sp, pg, wr, mon)))
    pallas = observe_counts(*jargs, nsp, pages, write_weight=ww, force="interpret")
    ref = jax_ref(*jargs, nsp, pages, write_weight=ww)
    port = _u32(fused_observe_count_ref(t(sp), t(pg), t(wr), t(mon), nsp, pages, ww))
    for p, k, r in zip(port, pallas, ref):
        assert same_bits(p, k) and same_bits(p, r)


def test_wrapper_takes_plain_version_on_cpu(rng):
    sp, pg, wr, mon = _inputs(rng, 400, 16, 8, 4)
    before = ops.fused_observe_count.launches
    got = ops.fused_observe_count(t(sp), t(pg), t(wr), t(mon), 16, 8, 2)
    want = fused_observe_count_ref(t(sp), t(pg), t(wr), t(mon), 16, 8, 2)
    assert ops.fused_observe_count.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_duplicate_rows_count_in_the_first_only():
    sp = np.array([3, 3, 5, -1], np.int32)
    pg = np.array([1, 1, 2, 0], np.int32)
    wr = np.array([False, True, False, True])
    mon = np.array([3, 3, -1], np.int32)
    _, s2r, s2w = fused_observe_count_ref(t(sp), t(pg), t(wr), t(mon), 8, 4, 2)
    jr = jax_ref(*map(jnp.asarray, (sp, pg, wr, mon)), 8, 4, write_weight=2)
    assert same_bits(s2r.numpy().astype(np.uint32), jr[1])
    assert same_bits(s2w.numpy().astype(np.uint32), jr[2])
    assert s2r[1].sum() == 0 and s2w[1].sum() == 0

