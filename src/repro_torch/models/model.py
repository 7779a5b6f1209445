"""Model assembly of the dense family: the segment plan and parameter init.

A dense model is one segment of identical layers (ln1 -> GQA attention ->
+res ; ln2 -> MLP -> +res); the reference runs it with one lax.scan, the
port with a Python loop over the layer-stacked params.  The parameter tree
has the reference's keys and shapes, so ``interop.params_from_numpy`` moves
the reference's parameters across; ``init_params`` draws its own from a
torch or numpy Generator (it does not reproduce ``jax.random``).
"""
from __future__ import annotations

import dataclasses

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
