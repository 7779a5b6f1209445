"""The paged decode attention's plain version (what the CUDA kernel is held
to on the card) against the JAX package: the Pallas kernel's function at
tests/test_kernels.py's shapes, through its jnp oracle and the Pallas
interpreter, and the serving form -- the step's own token as one more lane
plus the per-block mass -- against rainbow_decode._attend_with_mass."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rainbow_attention.ops import paged_decode_attention
from repro.serving.rainbow_decode import _attend_with_mass
from repro_torch.kernels.rainbow_attention import ops
from repro_torch.kernels.rainbow_attention.ref import rainbow_attention_ref
from torch_port_util import t

# (B, HP, KVS, hd, block, nblk), as tests/test_kernels.py's _rainbow_attention
PALLAS_SHAPES = {
    "3blk": (1, 4, 4, 16, 4, 3),
    "6blk": (2, 8, 4, 32, 8, 6),
    "4blk": (3, 8, 2, 64, 16, 4),
    "single_block": (2, 4, 2, 32, 8, 1),
}
TOL = {"f32": 2e-5, "bf16": 2e-2}  # test_kernels.py's tolerances
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _arrays(rng, dtype, *shapes):
    """jnp arrays of `dtype` and CPU tensors with the same values."""
    out = []
    for shape in shapes:
        x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32), dtype)
        out.append((x, t(x)))
    return out


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", list(PALLAS_SHAPES))
def test_plain_matches_pallas_kernel_function(shape, dt, backend, rng):
    b, hp, kvs, hd, block, nblk = PALLAS_SHAPES[shape]
    nb, hot = b * nblk, 4
    (q, tq), (pk, tpk), (pv, tpv) = _arrays(
        rng, DTYPES[dt], (b, hp, hd), (nb + hot, block, kvs, hd), (nb + hot, block, kvs, hd))
    vidx = rng.integers(0, nb + hot, (b, nblk)).astype(np.int32)
    length = max(nblk * block - 2, 1)
    want = paged_decode_attention(q, pk, pv, jnp.asarray(vidx), jnp.int32(length),
                                  force=backend)
    # the port reads the capacity rows [0, nb) and the hot rows [nb, nb + hot)
    # through two pools
    got, mass = ops.rainbow_attention(tq, tpk[:nb], tpv[:nb], tpk[nb:], tpv[nb:],
                                      torch.from_numpy(vidx), length)
    assert mass is None and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


# (B, HP, KVS, hd, block, nblk, hot, length): first step, partial block, full
SERVE_CASES = {
    "len0": (2, 4, 2, 16, 4, 5, 3, 0),
    "partial": (2, 4, 2, 16, 4, 5, 3, 13),
    "full": (3, 8, 4, 32, 8, 4, 2, 31),
    "gqa1": (1, 4, 4, 16, 4, 3, 2, 7),
}
SERVE_TOL = {"f32": (1e-5, 1e-6), "bf16": (2e-2, 1e-6)}  # (out, mass)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_plain_fresh_lane_and_mass_match_attend_with_mass(case, dt, rng):
    b, hp, kvs, hd, block, nblk, hot, length = SERVE_CASES[case]
    nb = b * nblk
    (q, tq), (ck, tck), (cv, tcv), (hk, thk), (hv, thv), (kn, tkn), (vn, tvn) = _arrays(
        rng, DTYPES[dt], (b, hp, hd), (nb, block, kvs, hd), (nb, block, kvs, hd),
        (hot, block, kvs, hd), (hot, block, kvs, hd), (b, kvs, hd), (b, kvs, hd))
    # home blocks, a few redirected to hot rows (the serving path's vidx)
    vidx = np.arange(nb, dtype=np.int32).reshape(b, nblk)
    vidx.reshape(-1)[rng.choice(nb, hot, replace=False)] = nb + np.arange(hot)
    pool_k = jnp.concatenate([ck, hk])
    pool_v = jnp.concatenate([cv, hv])
    k_r = jnp.concatenate([pool_k[vidx].reshape(b, -1, kvs, hd), kn[:, None]], axis=1)
    v_r = jnp.concatenate([pool_v[vidx].reshape(b, -1, kvs, hd), vn[:, None]], axis=1)
    pos = jnp.arange(k_r.shape[1])
    valid = (pos < length) | (pos == k_r.shape[1] - 1)
    want, want_mass = _attend_with_mass(q[:, None], k_r, v_r, valid, block, nblk)
    got, mass = ops.rainbow_attention(tq, tck, tcv, thk, thv, torch.from_numpy(vidx),
                                      length, tkn, tvn, with_mass=True)
    out_tol, mass_tol = SERVE_TOL[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want[:, 0], np.float32),
                               atol=out_tol, rtol=out_tol)
    np.testing.assert_allclose(mass.numpy(), np.asarray(want_mass), atol=mass_tol, rtol=0)
    if length == 0:  # only the fresh lane is readable: no block holds mass
        assert not mass.any()


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(rng):
    b, hp, kvs, hd, block, nblk = PALLAS_SHAPES["6blk"]
    args = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for s in (
        (b, hp, hd), (b * nblk, block, kvs, hd), (b * nblk, block, kvs, hd),
        (2, block, kvs, hd), (2, block, kvs, hd))]
    vidx = torch.from_numpy(rng.integers(0, b * nblk + 2, (b, nblk)).astype(np.int32))
    before = ops.rainbow_attention.launches
    got = ops.rainbow_attention(*args, vidx, 40)
    want = rainbow_attention_ref(*args, vidx, 40)
    assert torch.equal(got[0], want[0]) and ops.rainbow_attention.launches == before


def test_wrapper_rejects_other_devices():
    z = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rainbow_attention(z, z, z, z, z, z, 1)
