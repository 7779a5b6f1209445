"""The flash attention kernel's plain versions and the port's full-sequence
attention, held against the JAX package on the CPU: the plain forward
against the Pallas kernel in interpret mode and its ref oracle on
tests/test_kernels.py's shapes plus GQA and a ragged length, the
log-sum-exp and the float32 backward the card's autograd Function uses,
attend_chunked / attend_dense / _causal_window_mask against the reference's.
tests/test_torch_gpu.py holds the CUDA kernel to these plain versions on a
card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref,
)
from repro_torch.models import attention
from torch_port_util import t

TOL = {"float32": 3e-5, "bfloat16": 3e-2}  # the reference's own (test_kernels.py)
# (B, S, HP, KVS, hd, causal): test_kernels.py's sweep, then GQA and ragged S
SHAPES = {
    "1x128x2x32-causal": (1, 128, 2, 2, 32, True),
    "2x256x4x64-causal": (2, 256, 4, 4, 64, True),
    "1x256x1x128-full": (1, 256, 1, 1, 128, False),
    "gqa-2x128x4on2x32": (2, 128, 4, 2, 32, True),
    "ragged-1x200x2x32": (1, 200, 2, 2, 32, True),
}
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(shape, dtype, seed=0):
    b, s, hp, kvs, hd, _ = shape
    rng = np.random.default_rng(seed + s + hd)
    q = rng.standard_normal((b, s, hp, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, kvs, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, kvs, hd), dtype=np.float32)
    # round once to the working dtype so both packages see the same values
    return [np.asarray(jnp.asarray(x, DTYPES[dtype])) for x in (q, k, v)]


def _expand(x, hp):
    return jnp.repeat(x, hp // x.shape[2], axis=2)  # consecutive repeat (GQA)


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX side of every (shape, dtype): ref and, where the Pallas kernel
    takes the length (S % 128 == 0), interpret mode; computed once."""
    out = {}
    for name, shape in SHAPES.items():
        hp, causal = shape[2], shape[5]
        for dt in DTYPES:
            q, k, v = (jnp.asarray(x) for x in _inputs(shape, dt))
            k, v = _expand(k, hp), _expand(v, hp)
            ref = jax_attention(q, k, v, causal=causal, force="ref")
            interp = (jax_attention(q, k, v, causal=causal, force="interpret")
                      if shape[1] % 128 == 0 else None)
            out[name, dt] = (np.asarray(ref, np.float32),
                             None if interp is None else np.asarray(interp, np.float32))
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_matches_pallas_interpret_and_ref(name, dt, jax_outputs):
    shape = SHAPES[name]
    q, k, v = (t(x) for x in _inputs(shape, dt))
    got = ops.attention(q, k, v, causal=shape[5]).float().numpy()
    ref, interp = jax_outputs[name, dt]
    np.testing.assert_allclose(got, ref, atol=TOL[dt], rtol=TOL[dt])
    if interp is not None:
        np.testing.assert_allclose(got, interp, atol=TOL[dt], rtol=TOL[dt])


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = (t(x) for x in _inputs(SHAPES["gqa-2x128x4on2x32"], "float32"))
    before = ops.flash_attention.launches
    got = ops.attention(q, k, v)
    want = flash_attention_ref(q, k.repeat_interleave(2, 2), v.repeat_interleave(2, 2))
    assert ops.flash_attention.launches == before
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("name", ["2x256x4x64-causal", "1x256x1x128-full", "ragged-1x200x2x32"])
def test_lse_matches_reference_scores(name):
    shape = SHAPES[name]
    q, k, _ = _inputs(shape, "float32")
    scale = np.float32(1.0 / np.sqrt(shape[4]))
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if shape[5]:
        s = jnp.where(jnp.tril(jnp.ones((shape[1], shape[1]), bool)), s, -2.0e38)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    got = flash_attention_lse_ref(t(q), t(k), causal=shape[5]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["gqa-2x128x4on2x32", "1x256x1x128-full", "ragged-1x200x2x32"])
def test_backward_matches_autodiff_of_the_reference(name):
    """The card's backward (P recomputed from the log-sum-exp, float32) is the
    gradient of the reference's attention: against jax.grad of the JAX ref."""
    shape = SHAPES[name]
    hp, causal = shape[2], shape[5]
    q, k, v = _inputs(shape, "float32")
    dout = np.random.default_rng(9).standard_normal(q.shape, dtype=np.float32)

    def f(q, k, v):
        o = jax_attention(q, _expand(k, hp), _expand(v, hp), causal=causal, force="ref")
        return jnp.sum(o * dout)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = t(q), t(k), t(v)
    out = ops.attention(tq, tk, tv, causal=causal)
    lse = flash_attention_lse_ref(tq, tk.repeat_interleave(hp // shape[3], 2), causal)
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, t(dout), causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-4)


# ---------------------------------------------------------------------------
# the model's full-sequence attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("s", [40, 128])
def test_attend_chunked_matches_reference(s, dt):
    """qwen3's training case (causal, no window, positions 0..S-1) against
    the reference's scan over KV chunks; the port keeps P in float32 where
    the reference rounds it to bf16, hence the bf16 tolerance there."""
    q, k, v = _inputs((2, s, 4, 2, 16, True), dt)
    pos = np.arange(s, dtype=np.int32)
    want = ref_attn.attend_chunked(*map(jnp.asarray, (q, k, v, pos, pos)), 0, True)
    got = attention.attend_chunked(t(q), t(k), t(v), torch.arange(s), torch.arange(s), 0, True)
    tol = {"float32": 2e-6, "bfloat16": 3e-2}[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_attend_chunked_refuses_other_masks():
    q, k, v = (t(x) for x in _inputs((1, 16, 2, 2, 16, True), "float32"))
    pos = torch.arange(16)
    for args in ((pos, pos, 4, True), (pos, pos, 0, False), (pos + 3, pos + 3, 0, True)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            attention.attend_chunked(q, k, v, *args)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("window,causal", [(0, True), (5, True), (0, False)])
def test_attend_dense_and_mask_match_reference(window, causal, dt):
    q, k, v = _inputs((2, 24, 4, 2, 16, True), dt)
    pos = np.arange(24, dtype=np.int32)
    rmask = ref_attn._causal_window_mask(jnp.asarray(pos)[None], jnp.asarray(pos)[None],
                                         window, causal)
    pmask = attention._causal_window_mask(torch.arange(24)[None], torch.arange(24)[None],
                                          window, causal)
    assert np.array_equal(pmask.numpy(), np.asarray(rmask))
    want = ref_attn.attend_dense(*map(jnp.asarray, (q, k, v)), rmask[:, None])
    got = attention.attend_dense(t(q), t(k), t(v), pmask[:, None])
    tol = {"float32": 2e-6, "bfloat16": 1e-2}[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
