"""Training launcher: ``PYTHONPATH=src python -m repro_torch.launch.train --arch <id>``.

Runs the fault-tolerant loop on one GPU (``--device cpu`` runs the kernels'
plain versions on the CPU) with checkpointing and auto-resume.  The flags
are the reference's (repro/launch/train.py) plus ``--device``; only
``--model-parallel 1`` runs (tensor parallelism is ROADMAP.md Queue 1 item
13).  ``--attn chunked`` sends each layer's causal self-attention through
the flash_attention kernel.  The weights are random (torch.Generator seeded
0 on the device; the port does not reproduce ``jax.random``), the data the
reference's SyntheticLM (seed 0), byte for byte.  As in the reference, a
resumed run restores params and optimizer state, and the data stream starts
again from its first batch.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim import AdamWConfig, linear_warmup_cosine
from repro_torch.sim.runner import resolve_device
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.step import TrainStepConfig, build_train_step, init_train_state


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--attn", default="dense", choices=["dense", "chunked"])
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        ap.error(f"--model-parallel {args.model_parallel}: tensor parallelism is not "
                 "ported yet (ROADMAP.md Queue 1 item 13); use 1")
    if args.remat == "dots":
        ap.error("--remat dots is not ported yet (ROADMAP.md Queue 1 item 13)")
    try:
        cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    except (KeyError, NotImplementedError) as e:
        ap.error(str(e.args[0]) if e.args else str(e))
    dev = resolve_device(args.device)

    tcfg = TrainStepConfig(remat=args.remat, attn_impl=args.attn,
                           adamw=AdamWConfig(lr=args.lr))
    schedule = linear_warmup_cosine(args.lr, args.steps // 10 + 1, args.steps)
    step = build_train_step(cfg, tcfg, lr_schedule=schedule)
    data = iter(SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0))
    trainer = Trainer(step, data, LoopConfig(
        total_steps=args.steps, checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir))
    state, start = trainer.ckpt.restore_or_init(
        lambda: init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), tcfg))
    if start:
        print(f"resumed from step {start}")
    state, hist = trainer.run(state, start)
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} after {hist[-1]['step'] + 1} steps")
    if trainer.events:
        print("events:", trainer.events)
    return {"cfg": cfg, "tcfg": tcfg, "state": state, "history": hist,
            "start": start, "trainer": trainer, "device": dev}


if __name__ == "__main__":
    main()
