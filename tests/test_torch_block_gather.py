"""The block-migration copy's plain version (what the CUDA kernel is held to
on the card) against the JAX package, bitwise: the Pallas kernel's function
on tests/test_kernels.py's four _block_gather cases, through its jnp oracle
and the Pallas interpreter, and the layered K/V payload copy of
kvcache.end_interval_promote (repro/memory/kvcache.py:406-415)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_gather.ops import migrate_blocks
from repro_torch.kernels.block_gather import ops
from torch_port_util import same_bits, t

# (NB, HOT, lanes, all_skip), as tests/test_kernels.py's _block_gather
CASES = {
    "24nb": (24, 6, 6, False),
    "8nb": (8, 3, 5, False),
    "single_lane": (64, 16, 1, False),
    "no_valid_lanes": (16, 4, 4, True),
}
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _plan(rng, nb, hot, k, all_skip):
    """src/dst lanes: -1 skips, valid lanes name distinct dst slots."""
    src = rng.integers(-1, nb, k).astype(np.int32)
    if all_skip:
        src[:] = -1
    dst = np.resize(rng.choice(hot, min(k, hot), replace=False), k).astype(np.int32)
    seen = set()
    for i in range(k):
        if src[i] >= 0 and int(dst[i]) in seen:
            src[i] = -1
        elif src[i] >= 0:
            seen.add(int(dst[i]))
    return src, dst


def _pool(rng, shape, dtype):
    return jnp.asarray(rng.standard_normal(shape, dtype=np.float32), dtype)


def _f32(x) -> np.ndarray:
    """float32 view of a pool (exact for bfloat16), for a bitwise compare."""
    x = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
    return np.ascontiguousarray(x)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_kernel_function(case, dt, backend, rng):
    nb, hot, k, all_skip = CASES[case]
    cap, hotp = _pool(rng, (nb, 4, 2, 8), DTYPES[dt]), _pool(rng, (hot, 4, 2, 8), DTYPES[dt])
    src, dst = _plan(rng, nb, hot, k, all_skip)
    want = migrate_blocks(cap, hotp, jnp.asarray(src), jnp.asarray(dst), force=backend)
    got = t(hotp)  # one pool: a layer axis of one, updated in place
    ops.block_gather_([(t(cap)[None], got[None])], torch.from_numpy(src), torch.from_numpy(dst))
    assert same_bits(_f32(got), _f32(want))
    if all_skip:
        assert same_bits(_f32(got), _f32(hotp))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_layered_kv_copy_matches_end_interval_promote_copy(dt, rng):
    """Both pools, every layer, one call; skip lanes (migrate False) drop."""
    layers, nb, hot, k = 3, 12, 5, 5
    row = (4, 2, 8)
    pools = [_pool(rng, (layers, n, *row), DTYPES[dt]) for n in (nb, nb, hot, hot)]
    cap_k, cap_v, hot_k, hot_v = pools
    src, dst = _plan(rng, nb, hot, k, False)
    migrate = src >= 0
    # repro/memory/kvcache.py:407-415, on these lanes
    r_src = jnp.asarray(np.where(migrate, src, 0).astype(np.int32))
    r_dst = jnp.asarray(np.where(migrate, dst, hot).astype(np.int32))
    want_k = hot_k.at[:, r_dst].set(cap_k[:, r_src], mode="drop")
    want_v = hot_v.at[:, r_dst].set(cap_v[:, r_src], mode="drop")
    tk, tv, hk, hv = (t(x) for x in pools)
    before = ops.block_gather_.launches
    ops.block_gather_([(tk, hk), (tv, hv)], torch.from_numpy(np.where(migrate, src, -1)),
                      torch.from_numpy(dst))
    assert ops.block_gather_.launches == before  # CPU tensors: the plain version
    assert same_bits(_f32(hk), _f32(want_k)) and same_bits(_f32(hv), _f32(want_v))


def test_wrapper_rejects_bad_pairs():
    z = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="one or two"):
        ops.block_gather_([], z, z)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.block_gather_([(z, z)], z, z)
