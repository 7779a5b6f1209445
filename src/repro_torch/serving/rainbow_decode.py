"""Rainbow-managed decode: paged KV with two-tier translation + hot-block stats.

One decode step of a dense model over the Rainbow-paged cache, in the
reference's "full" read mode (repro/serving/rainbow_decode.py): every block is
read through the translated pool index, so the output equals flat-cache
decode.  Each layer's attention is the rainbow_attention kernel, which reads
the capacity and hot pools through their own base pointers, adds the step's
own token as one more position, and returns the per-block softmax mass --
the access stream of the paper's memory controller.  Every
`interval_steps` steps, end_interval_promote() runs the two-stage
classification + utility admission and copies hot blocks with the
block_gather kernel.

The reference's lax.scan over layers is a Python loop here, and its
lax.cond on the interval counter a host `if`: the counter is a host integer,
so the loop never waits on the device.  Not ported yet (ROADMAP.md Queue 1
item 12): the sparse read mode, int8 pools, `collect_mass` and
`record_mass_trace`.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.remap import translate
from repro_torch.kernels.rainbow_attention.ops import rainbow_attention
from repro_torch.memory.kvcache import (
    PagedConfig,
    RainbowKV,
    append_token,
    end_interval_promote,
    observe_block_mass,
)
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import model as M


def pool_indices(kv: RainbowKV, pcfg: PagedConfig, batch: int):
    """Layer-invariant translated pool indices: (resident[B, nblk], vidx[B, nblk]).

    vidx < B * nblk names a capacity block (the block's home); a resident
    block redirects to B * nblk + its hot slot (Fig. 6 via one indirection).
    """
    nblk = pcfg.blocks_per_seq
    dev = kv.threshold.device
    blocks = torch.arange(nblk, device=dev)
    sp = torch.arange(batch, device=dev)[:, None].expand(batch, nblk)
    resident, slot = translate(kv.remap, sp, blocks[None, :].expand(batch, nblk))
    home = (sp * nblk + blocks[None, :]).to(torch.int32)
    vidx = torch.where(resident, batch * nblk + slot, home).to(torch.int32)
    return resident, vidx.contiguous()


def rainbow_decode_step(
    cfg,
    pcfg: PagedConfig,
    params: Any,
    tokens: torch.Tensor,  # int[B, 1]
    kv: RainbowKV,
    mode: str = "full",
    reports: list | None = None,
):
    """One decode step for a dense-family LM over the Rainbow paged cache.

    Returns (logits float32[B, 1, padded_vocab], kv).  The pools in `kv` are
    updated in place.  When an interval closes and `reports` is a list, the
    interval's report (end_interval_promote's dict) is appended to it.
    """
    if mode != "full":
        raise NotImplementedError(
            f"rainbow_decode_step mode={mode!r} is not ported yet; only 'full' "
            "(ROADMAP.md Queue 1 item 12)")
    if cfg.family != "dense":
        raise NotImplementedError("rainbow decode targets the dense family")
    b = tokens.shape[0]
    cur = kv.length
    x = L.embed_lookup(cfg, params["embed"], tokens)
    pos = torch.full((b, 1), cur, dtype=torch.int32, device=x.device)
    seg = M.segments(cfg)[0]
    sp = params["segments"][seg.name]
    _, vidx = pool_indices(kv, pcfg, b)
    rope_cs = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta, x.device)  # layer-invariant

    h = x
    k_all, v_all = [], []
    step_mass = None
    for layer in range(seg.length):
        pa = {name: w[layer] for name, w in sp["attn"].items()}
        hn = L.apply_norm(cfg, {"scale": sp["ln1"]["scale"][layer]}, h)
        q, k_new, v_new = attn.qkv_project(cfg, pa, hn, pos, use_rope=True, rope_cs=rope_cs)
        o, blk_mass = rainbow_attention(
            q[:, 0], kv.cap_k[layer], kv.cap_v[layer], kv.hot_k[layer],
            kv.hot_v[layer], vidx, cur, k_new[:, 0], v_new[:, 0], with_mass=True,
        )
        h = h + attn.attn_output(pa, o[:, None])
        h2 = L.apply_norm(cfg, {"scale": sp["ln2"]["scale"][layer]}, h)
        h = h + L.apply_mlp(cfg, {name: w[layer] for name, w in sp["mlp"].items()}, h2)
        k_all.append(k_new[:, 0])
        v_all.append(v_new[:, 0])
        # the controller's access stream: mass summed over layers in order
        step_mass = blk_mass if step_mass is None else step_mass + blk_mass

    kv = append_token(kv, pcfg, torch.stack(k_all), torch.stack(v_all))
    kv = observe_block_mass(kv, pcfg, step_mass)
    kv = kv._replace(length=kv.length + 1)
    if kv.step_in_interval >= pcfg.interval_steps:
        kv, report = end_interval_promote(kv, pcfg)
        if reports is not None:
            reports.append(report)

    h = L.apply_norm(cfg, params["final_norm"], h)
    return L.lm_logits(cfg, params["embed"], h), kv
