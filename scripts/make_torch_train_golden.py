"""Write the JAX package's training steps on full-width qwen3-0.6b weights as
the training port's golden file.

Builds the weights of ``qwen3-0.6b`` at full width (d 1024, 16/8 heads,
head_dim 128, vocab 151 936) with depth cut to LAYERS, in float32, from
``numpy.random.default_rng(SEED)`` in the reference's tree layout
(``repro_torch.interop.numpy_params``), with a fresh AdamW state, and runs
STEPS of the reference's ``build_train_step`` (``attn_impl="chunked"``,
``remat="none"``, AdamW at LR with ``launch.train``'s warmup-cosine
schedule) on ``SyntheticLM`` batches (seed 0).  The file
``tests/data/torch_train_golden.json`` holds the weights' sha256, each
step's loss, grad_norm, lr and clip_scale, and each parameter leaf's sum and
sum of magnitudes after the last step.  ``chip_smoke.py`` rebuilds the same
weights on the GPU machine (no JAX there), checks the digest, and holds the
port's steps to the file.

    PYTHONPATH=src python scripts/make_torch_train_golden.py    # ~2 min, ~12 GB
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

ARCH = "qwen3-0.6b"
LAYERS = 2  # full width, depth cut for the reference's run on a CPU
SEED = 13
BATCH = 2
SEQ = 256  # two 128-row flash tiles
STEPS = 3
LR = 3e-3  # launch.train's default
OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "data", "torch_train_golden.json",
)


def schedule_args(lr: float, steps: int) -> tuple:
    """launch.train's linear_warmup_cosine arguments for a run of `steps`."""
    return (lr, steps // 10 + 1, steps)


def make_golden(arch: str = ARCH, layers: int = LAYERS, reduced: bool = False,
                seed: int = SEED, batch: int = BATCH, seq: int = SEQ,
                steps: int = STEPS, lr: float = LR) -> dict:
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.data.pipeline import SyntheticLM
    from repro.optim import AdamWConfig, adamw_init, linear_warmup_cosine
    from repro.train.step import TrainStepConfig, build_train_step
    from repro_torch import configs as port_configs
    from repro_torch import interop

    def f32(cfg):
        return dataclasses.replace(cfg, num_layers=layers, dtype="float32",
                                   param_dtype="float32")

    get = "get_reduced_config" if reduced else "get_config"
    cfg = f32(getattr(ref_configs, get)(arch))
    tree = interop.numpy_params(f32(getattr(port_configs, get)(arch)), seed)
    digest = interop.weights_digest(tree)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    state = {"params": params, "opt": adamw_init(params)}

    tcfg = TrainStepConfig(tp=1, remat="none", attn_impl="chunked",
                           adamw=AdamWConfig(lr=lr))
    step = jax.jit(build_train_step(
        cfg, tcfg, lr_schedule=linear_warmup_cosine(*schedule_args(lr, steps))))
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    history = []
    for _ in range(steps):
        state, m = step(state, data.next_batch())
        history.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr", "clip_scale")})
    leaves = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
        key = "/".join(str(p.key) for p in path)
        arr = np.asarray(leaf, np.float64)
        leaves[key] = {"sum": float(arr.sum()), "abs_sum": float(np.abs(arr).sum())}
    return {
        "reference": "repro.train.step.build_train_step (float32, attn_impl chunked, "
                     "remat none) + repro.optim AdamW + linear_warmup_cosine",
        "arch": arch, "reduced": reduced, "num_layers": layers, "seed": seed,
        "batch": batch, "seq": seq, "steps": steps, "lr": lr, "data_seed": 0,
        "weights_sha256": digest, "history": history, "param_sums": leaves,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    doc = make_golden()
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}: losses {[h['loss'] for h in doc['history']]}")


if __name__ == "__main__":
    main()
