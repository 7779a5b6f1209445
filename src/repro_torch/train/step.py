"""Train-step builder: loss -> grads -> AdamW, with remat and grad accumulation.

The returned step is a function (state, batch) -> (state, metrics) of the
reference's shape (``repro.train.step.build_train_step``): `state` is
{"params", "opt": {step, master, m, v}}, `batch` the numpy dict of the data
pipeline (moved onto the params' device here), metrics loss / lr /
grad_norm / clip_scale as 0-d tensors.  The step is functional: it returns
a new state and leaves the old one whole.  PyTorch runs eagerly, so there
is no jit; the reference's tp, sharding constraints and specs are not
ported (one device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat: str = "full"  # none | full | dots
    attn_impl: str = "dense"  # dense | chunked
    accum_steps: int = 1
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def init_train_state(cfg: ModelConfig, gen, tcfg: TrainStepConfig) -> dict[str, Any]:
    """Random params drawn from `gen` (a torch or numpy Generator) + AdamW state."""
    params = M.init_params(cfg, gen)
    return {"params": params, "opt": adamw_init(params)}


def _device_batch(batch: dict, device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def build_train_step(
    cfg: ModelConfig,
    tcfg: TrainStepConfig,
    lr_schedule: Callable | None = None,
) -> Callable:
    def loss(params, batch):
        return M.loss_fn(cfg, params, batch, attn_impl=tcfg.attn_impl, remat=tcfg.remat)

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(req)
        l = loss(tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(l, req)
        it = iter(grads)
        return l.detach(), tree_map(lambda _: next(it), params)

    def grads_of(params, batch):
        if tcfg.accum_steps == 1:
            return value_and_grad(params, batch)
        a = tcfg.accum_steps
        tl = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        tg = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params)
        for i in range(a):  # the reference's lax.scan over micro-batches
            mb = {k: v.reshape(a, v.shape[0] // a, *v.shape[1:])[i] for k, v in batch.items()}
            l, g = value_and_grad(params, mb)
            tl = tl + l
            tg = tree_map(torch.add, tg, g)
        return tl / a, tree_map(lambda g: g / a, tg)

    def step(state, batch):
        params = state["params"]
        batch = _device_batch(batch, tree_leaves(params)[0].device)
        l, grads = grads_of(params, batch)
        lr = lr_schedule(state["opt"]["step"]) if lr_schedule else None
        new_params, new_opt, om = adamw_update(
            tcfg.adamw, grads, state["opt"], params, lr=lr
        )
        metrics = {"loss": l, "lr": torch.as_tensor(lr if lr is not None else tcfg.adamw.lr)}
        metrics.update(om)
        return {"params": new_params, "opt": new_opt}, metrics

    return step
