"""AdamW from scratch: fp32 master weights + moments, params in their own dtype.

The reference's order of operations is kept (clip scale from the global
norm, bias corrections from the incremented step, the decoupled weight decay
inside the update, the master copy cast back to each param's dtype).  The
update is functional: it returns new tensors and leaves the old state whole,
so the training loop can drop a poisoned update.  ZeRO sharding
(``adamw_specs``, ``zero_sharding``) has no use on one device and is not
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Any) -> dict[str, Any]:
    """{"step": int32 0-d tensor, "master": fp32 copies, "m", "v": fp32 zeros}."""
    some = tree_leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=some.device),
        "master": tree_map(lambda p: p.detach().float().clone(), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
    }


def global_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads)))


def adamw_update(
    cfg: AdamWConfig,
    grads: Any,
    opt_state: dict[str, Any],
    params: Any,
    lr: torch.Tensor | float | None = None,
) -> tuple[Any, dict[str, Any], dict[str, torch.Tensor]]:
    """Returns (new params in original dtype, new opt_state, metrics)."""
    step = opt_state["step"] + 1
    lr = cfg.lr if lr is None else lr
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd_m(g, m):
        return b1 * m + (1 - b1) * g.float() * scale

    def upd_v(g, v):
        gs = g.float() * scale
        return b2 * v + (1 - b2) * gs * gs

    ms = tree_map(upd_m, grads, opt_state["m"])
    vs = tree_map(upd_v, grads, opt_state["v"])

    def upd_p(m, v, p):
        return p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p)

    masters = tree_map(upd_p, ms, vs, opt_state["master"])
    new_params = tree_map(lambda mp, p: mp.to(p.dtype), masters, params)
    new_state = {"step": step, "master": masters, "m": ms, "v": vs}
    return new_params, new_state, {"grad_norm": gnorm, "clip_scale": scale}
