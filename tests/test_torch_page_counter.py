"""The two counters: the port's plain versions of the fused observe counter
and of the two-stage counter (behind count_accesses) held bitwise against the
JAX package's Pallas kernels (interpret mode) and their ref oracles, on the
kernel parity matrix's shapes.  tests/test_torch_gpu.py holds the CUDA
kernels to the plain versions on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.page_counter.ops import count_accesses as jax_count_accesses
from repro.kernels.page_counter.ops import observe_counts
from repro.kernels.page_counter.ref import fused_observe_count_ref as jax_ref
from repro_torch.kernels.page_counter import ops
from repro_torch.kernels.page_counter.ref import fused_observe_count_ref, two_stage_count_ref
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



# (accesses, num_superpages, pages_per_sp, monitored rows), as in
# tests/test_kernels.py's two-stage cases
TWO_STAGE_SHAPES = {
    "100a": (100, 16, 8, 4),
    "517a": (517, 8, 32, 2),
    "1000a": (1000, 32, 16, 8),
    "zero_access": (0, 16, 8, 4),
    "single_row": (129, 8, 8, 1),
    "single_sp": (64, 1, 4, 1),
}


@pytest.mark.parametrize("shape", list(TWO_STAGE_SHAPES))
def test_count_accesses_matches_pallas_interpret_and_ref(shape, rng):
    a, nsp, pages, n = TWO_STAGE_SHAPES[shape]
    sp, pg, wr, mon = _inputs(rng, a, nsp, pages, n)
    w = np.where(wr, 2, 1).astype(np.uint32)
    jargs = tuple(map(jnp.asarray, (sp, pg, w, mon)))
    ref = jax_count_accesses(*jargs, nsp, pages, force="ref")
    pallas = jax_count_accesses(*jargs, nsp, pages, force="interpret")
    port = _u32(ops.count_accesses(t(sp), t(pg), t(w), t(mon), nsp, pages))
    for p, k, r in zip(port, pallas, ref):
        assert same_bits(p, k) and same_bits(p, r)


def test_two_stage_weights_wrap_as_uint32(rng):
    """Large uint32 weights sum modulo 2^32, as the reference's scatter-add."""
    sp = np.array([2, 2, 2, 0, -1], np.int32)
    pg = np.array([1, 1, 3, 0, 0], np.int32)
    w = np.array([0xFFFFFFF0, 0x20, 7, 1 << 31, 5], np.uint32)
    mon = np.array([2, -1], np.int32)
    ref = jax_count_accesses(*map(jnp.asarray, (sp, pg, w, mon)), 4, 4, force="ref")
    port = _u32(two_stage_count_ref(t(sp), t(pg), t(w), 4, t(mon), 4))
    for p, r in zip(port, ref):
        assert same_bits(p, r)
    assert port[0][2] == 0x17  # (0xFFFFFFF0 + 0x20 + 7) mod 2^32


def test_two_stage_wrapper_takes_plain_version_on_cpu(rng):
    sp, pg, wr, mon = _inputs(rng, 400, 16, 8, 4)
    w = t(np.where(wr, 3, 1).astype(np.uint32))
    before = ops.two_stage_count.launches
    got = ops.two_stage_count(t(sp), t(pg), w, t(mon), 16, 8)
    want = two_stage_count_ref(t(sp), t(pg), w, 16, t(mon), 8)
    assert ops.two_stage_count.launches == before
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
