"""Model assembly of the dense family: the segment plan, parameter init and
the full-sequence forward and loss of the training path.

A dense model is one segment of identical layers (ln1 -> GQA attention ->
+res ; ln2 -> MLP -> +res); the reference runs it with one lax.scan, the
port with a Python loop over the layer-stacked params.  The parameter tree
has the reference's keys and shapes, so ``interop.params_from_numpy`` moves
the reference's parameters across; ``init_params`` draws its own from a
torch or numpy Generator (it does not reproduce ``jax.random``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params


@dataclasses.dataclass(frozen=True)
class SegSpec:
    name: str
    kind: str
    start: int
    length: int


def segments(cfg: ModelConfig) -> list[SegSpec]:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue 1 item 13)")
    return [SegSpec("blocks", "dense", 0, cfg.num_layers)]


def seg_windows(cfg: ModelConfig, seg: SegSpec) -> np.ndarray:
    """Per-layer attention window (0 = unlimited) for a segment: all zeros,
    since no ported configuration has a sliding window (the reference's
    sliding-window families wait in ROADMAP.md Queue 1 item 13)."""
    return np.zeros(seg.length, np.int32)


def init_params(cfg: ModelConfig, gen, tp: int = 1) -> Params:
    """Random parameters in the reference's tree layout, drawn from `gen`: a
    torch.Generator (on its device) or a numpy Generator (on the CPU)."""
    dev = L.init_device(gen)
    p: Params = {"embed": L.embed_init(cfg, gen)}
    p["segments"] = {}
    for seg in segments(cfg):
        n = seg.length
        p["segments"][seg.name] = {
            "ln1": L.norm_init(cfg, cfg.d_model, n, dev),
            "attn": attn.attn_init(cfg, gen, tp, stacked=n),
            "ln2": L.norm_init(cfg, cfg.d_model, n, dev),
            "mlp": L.mlp_init(cfg, gen, cfg.d_model, cfg.d_ff, stacked=n),
        }
    p["final_norm"] = L.norm_init(cfg, cfg.d_model, device=dev)
    return p


def param_shapes(cfg: ModelConfig, tp: int = 1) -> dict:
    """The parameter tree of `cfg` (init_params' keys) as nested dicts of shapes."""
    d, n, hd, f, vp = cfg.d_model, cfg.num_layers, cfg.head_dim, cfg.d_ff, cfg.padded_vocab
    hp, kvs = cfg.padded_heads(tp), cfg.kv_store(tp)
    attn_shapes = {"wq": (n, d, hp, hd), "wk": (n, d, kvs, hd),
                   "wv": (n, d, kvs, hd), "wo": (n, hp, hd, d)}
    if cfg.qk_norm:
        attn_shapes.update(q_norm=(n, hd), k_norm=(n, hd))
    embed = {"tok": (vp, d)}
    if not cfg.tie_embeddings:
        embed["head"] = (d, vp)
    blocks = {"ln1": {"scale": (n, d)}, "attn": attn_shapes, "ln2": {"scale": (n, d)},
              "mlp": {"wi": (n, d, f), "wo": (n, f, d), "wg": (n, d, f)}}
    return {"embed": embed, "segments": {seg.name: blocks for seg in segments(cfg)},
            "final_norm": {"scale": (d,)}}


# ---------------------------------------------------------------------------
# Full-sequence forward (train / score)
# ---------------------------------------------------------------------------


def _attn_full_seq(cfg, pl, x, positions, window, *, causal, use_rope, impl,
                   rope_cs=None):
    """Self-attention of one layer over the whole sequence; `positions` is a
    host int tensor [S] (attend_chunked checks it), `rope_cs` its RoPE tables
    on x's device."""
    q, k, v = attn.qkv_project(cfg, pl, x, positions, use_rope=use_rope, rope_cs=rope_cs)
    if impl == "chunked":
        o = attn.attend_chunked(q, k, v, positions, positions, window, causal)
    elif impl == "dense":
        qp = positions.to(x.device)[None]
        mask = attn._causal_window_mask(qp, qp, int(window), causal)[:, None]
        o = attn.attend_dense(q, k, v, mask)
    else:
        raise ValueError(f"unknown attention impl {impl!r} (dense | chunked)")
    return attn.attn_output(pl, o)


def _block_full_seq(cfg, kind, pl, x, positions, window, impl, rope_cs=None):
    """One dense layer over the full sequence -> x'."""
    if kind != "dense":
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP.md Queue 1 item 13)")
    h = L.apply_norm(cfg, pl["ln1"], x)
    x = x + _attn_full_seq(cfg, pl["attn"], h, positions, window, causal=True,
                           use_rope=True, impl=impl, rope_cs=rope_cs)
    h2 = L.apply_norm(cfg, pl["ln2"], x)
    return x + L.apply_mlp(cfg, pl["mlp"], h2)


def _remat_wrap(fn, remat: str):
    """none: keep every activation; full: recompute the layer in the backward
    (``torch.utils.checkpoint``, the reference's ``nothing_saveable``)."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save only the matrix products) is not ported yet "
            "(ROADMAP.md Queue 1 item 13)")
    raise ValueError(f"unknown remat {remat!r} (none | full | dots)")


def _layer(tree: Params, i: int) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _run_segment_full(cfg, seg: SegSpec, seg_params, x, positions, impl, remat,
                      rope_cs=None):
    """The segment's layers in a Python loop over the full sequence -> x."""
    windows = seg_windows(cfg, seg)

    def body(x, pl, w):
        return _block_full_seq(cfg, seg.kind, pl, x, positions, w, impl, rope_cs)

    body = _remat_wrap(body, remat)
    for i in range(seg.length):
        x = body(x, _layer(seg_params, i), int(windows[i]))
    return x


def forward(cfg: ModelConfig, params: Params, batch: dict, attn_impl: str = "dense",
            remat: str = "none") -> torch.Tensor:
    """Full-sequence logits float32 [B, S, Vp] (train / scoring path), on one
    device (the reference's tp and sharding constraints are not ported)."""
    tokens = batch["tokens"]
    x = L.embed_lookup(cfg, params["embed"], tokens)
    positions = torch.arange(x.shape[1])  # host-side: attend_chunked reads it
    rope_cs = L.rope_tables(positions.to(x.device), cfg.head_dim, cfg.rope_theta, x.device)
    for seg in segments(cfg):
        x = _run_segment_full(cfg, seg, params["segments"][seg.name], x, positions,
                              attn_impl, remat, rope_cs)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(cfg, params["embed"], x)


def loss_fn(cfg, params, batch, attn_impl="dense", remat="none"):
    logits = forward(cfg, params, batch, attn_impl, remat)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(batch["targets"], dtype=torch.float32)
    return L.softmax_xent(logits, batch["targets"], mask)
