"""Write the JAX package's Rainbow-paged decode on full-width qwen3-0.6b weights
as the serving port's golden file.

Builds the weights of ``qwen3-0.6b`` at full width (d 1024, 16/8 heads,
head_dim 128, vocab 151 936) with depth cut to LAYERS, in float32, from
``numpy.random.default_rng(SEED)`` in the reference's tree layout
(``repro_torch.interop.numpy_params``), and runs the reference's
``rainbow_decode_step`` teacher-forced on a fixed token stream.  The file
``tests/data/torch_serve_golden.json`` holds the weights' sha256, the stream,
per-step argmax tokens, a few logits per row, and each closed interval's
promoted and evicted block counts.  ``chip_smoke.py`` rebuilds the same
weights on the GPU machine (no JAX there), checks the digest, and holds the
port's decode to the file.

The interval close is the reference's own ``end_interval_promote``, called
after each step that fills an interval (what the step's ``lax.cond`` does),
so that its report -- which the step does not return -- can be recorded.

    PYTHONPATH=src python scripts/make_torch_serve_golden.py    # ~1 min, ~4 GB
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

ARCH = "qwen3-0.6b"
LAYERS = 4  # full width, depth cut for the reference's run on a CPU
SEED = 11
BATCH = 4
STEPS = 64
BLOCK = 8
N_LOGIT_IDS = 8
OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "data", "torch_serve_golden.json",
)


def paged_knobs(steps: int, block: int) -> dict:
    """launch.serve's geometry-aware serving-default knobs for this stream."""
    nblk = (steps + block - 1) // block
    hot = max(8, nblk // 2)
    return {"block_size": block, "blocks_per_seq": nblk, "hot_slots": hot,
            "top_n": min(8, nblk), "max_promotions": min(16, hot),
            "interval_steps": 8}


def make_golden(arch: str = ARCH, layers: int = LAYERS, reduced: bool = False,
                seed: int = SEED, batch: int = BATCH, steps: int = STEPS,
                block: int = BLOCK) -> dict:
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.memory.kvcache import PagedConfig, end_interval_promote, paged_init
    from repro.serving.rainbow_decode import rainbow_decode_step
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

    knobs = paged_knobs(steps, block)
    pcfg = PagedConfig(**knobs)
    never = PagedConfig(**{**knobs, "interval_steps": 1 << 30})
    step = jax.jit(lambda p, t, k: rainbow_decode_step(cfg, never, p, t, k))
    close = jax.jit(lambda k: end_interval_promote(k, pcfg))

    rng = np.random.default_rng(seed + 1)
    stream = rng.integers(0, cfg.vocab_size, (batch, steps)).astype(np.int32)
    ids = np.sort(rng.choice(cfg.vocab_size, N_LOGIT_IDS, replace=False))
    kv = paged_init(cfg, pcfg, batch, 1, cfg.num_layers)
    argmax, top, logits, intervals = [], [], [], []
    for t in range(steps):
        out, kv = step(params, jnp.asarray(stream[:, t:t + 1]), kv)
        if int(kv.step_in_interval) >= pcfg.interval_steps:
            kv, rep = close(kv)
            intervals.append({"after_step": t, "promoted": int(rep["promoted"]),
                              "evicted": int(rep["evicted"])})
        row = np.asarray(out[:, 0, :cfg.vocab_size], np.float32)
        order = np.argsort(-row, axis=1, kind="stable")
        argmax.append(order[:, 0].tolist())
        top.append([[float(row[b, order[b, 0]]), float(row[b, order[b, 1]])]
                    for b in range(batch)])
        logits.append(row[:, ids].tolist())
    return {
        "reference": "repro.serving.rainbow_decode.rainbow_decode_step (float32, "
                     "teacher-forced) + repro.memory.kvcache.end_interval_promote",
        "arch": arch, "reduced": reduced, "num_layers": layers, "seed": seed,
        "batch": batch, "steps": steps, "paged": knobs,
        "weights_sha256": digest, "stream": stream.tolist(),
        "logit_ids": ids.tolist(), "argmax": argmax, "top2": top,
        "logits": logits, "intervals": intervals,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    doc = make_golden()
    with open(args.out, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {args.out}: {len(doc['intervals'])} intervals, "
          f"{sum(i['promoted'] for i in doc['intervals'])} promotions, "
          f"{sum(i['evicted'] for i in doc['intervals'])} evictions")


if __name__ == "__main__":
    main()
