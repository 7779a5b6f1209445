"""Serving launcher: batched prefill-by-decode + decode over the Rainbow-paged KV.

``PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --kv paged``

runs on the GPU (``--device cpu`` runs the kernels' plain versions on the
CPU).  The flags are the reference's (repro/launch/serve.py); the controller
knobs come from the ControlPolicy surface: ``--policy`` picks a registered
preset and ``--interval-steps/--top-n/--hot-slots/--max-promotions``
override it.  Not ported yet, and refused with an error rather than served
another way: ``--kv flat``, ``--autotune`` and ``--timing-model queueing``
(ROADMAP.md Queue 1 items 8 and 12).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.engine.policy import available_policies, get_policy
from repro_torch.memory.kvcache import PagedConfig, paged_init
from repro_torch.models import model as M
from repro_torch.serving.rainbow_decode import rainbow_decode_step
from repro_torch.serving.steps import greedy_sample
from repro_torch.sim.runner import resolve_device


def check_timing(args, error) -> None:
    """Refuse the timing flags this port cannot honour.

    Flat timing rejects an explicit --queue-geometry (it would otherwise be
    silently dropped); the queueing model is not ported yet.
    """
    if args.timing_model != "flat":
        error("--timing-model queueing is not ported yet (ROADMAP.md Queue 1 item 8)")
    if args.queue_geometry is not None:
        error(f"--queue-geometry {args.queue_geometry} has no effect under "
              "--timing-model flat; drop it or pass --timing-model queueing")


def build_paged_config(args, nblk: int) -> PagedConfig:
    """One PagedConfig from (preset, CLI overrides, geometry-aware defaults).

    Precedence: explicit CLI flags > the chosen --policy preset.  The
    geometry-aware fallbacks (hot pool sized to the sequence) apply only to
    the generic "serving-default" preset.
    """
    policy = get_policy(args.policy)
    overrides = {k: v for k, v in {
        "hot_slots": args.hot_slots,
        "top_n": args.top_n,
        "max_promotions": args.max_promotions,
        "interval_steps": args.interval_steps,
    }.items() if v is not None}
    if args.policy == "serving-default":
        hot = overrides.get("hot_slots", max(8, nblk // 2))
        overrides.setdefault("hot_slots", hot)
        overrides.setdefault("top_n", min(8, nblk))
        overrides.setdefault("max_promotions", min(16, hot))
    return PagedConfig(
        block_size=args.block_size,
        blocks_per_seq=nblk,
        policy=policy.replace(**overrides) if overrides else policy,
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--kv", choices=["flat", "paged"], default="paged")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--policy", default="serving-default",
                    help=f"registered preset, one of {available_policies()}")
    ap.add_argument("--interval-steps", type=int, default=None,
                    help="decode steps per monitoring interval")
    ap.add_argument("--top-n", type=int, default=None,
                    help="stage-2 monitored superblocks")
    ap.add_argument("--hot-slots", type=int, default=None,
                    help="hot-pool capacity in KV blocks")
    ap.add_argument("--max-promotions", type=int, default=None,
                    help="promotion-plan size per interval")
    ap.add_argument("--autotune", action="store_true",
                    help="(not ported yet) tune the policy on a pilot trace")
    ap.add_argument("--timing-model", choices=["flat", "queueing"], default="flat",
                    help="cost model for reporting/tuning (only flat is ported)")
    ap.add_argument("--queue-geometry", default=None,
                    help="QueueGeometry preset (queueing model only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def serve(cfg, pcfg: PagedConfig, params, prompt: torch.Tensor, tokens: int,
          on_step=None) -> dict:
    """Prefill-by-decode over `prompt` [B, P], then `tokens` greedy tokens.

    Returns {"tokens" int32[B, tokens], "kv", "reports" (one per closed
    interval), "decode_steps", "wall_s"}.  The wall time ends after a device
    synchronisation.  `on_step(i)`, when given, is called after decode step i
    (a profiler's step marker, for instance).
    """
    b, plen = prompt.shape
    dev = prompt.device
    kv = paged_init(cfg, pcfg, b, 1, cfg.num_layers, dev)
    reports: list = []
    t0 = time.perf_counter()
    logits = None
    for i in range(plen):
        logits, kv = rainbow_decode_step(cfg, pcfg, params, prompt[:, i:i + 1], kv,
                                         reports=reports)
        if on_step is not None:
            on_step(i)
    tok = greedy_sample(logits, cfg.vocab_size)
    out = [tok]
    for i in range(plen, plen + tokens - 1):
        logits, kv = rainbow_decode_step(cfg, pcfg, params, tok, kv, reports=reports)
        if on_step is not None:
            on_step(i)
        tok = greedy_sample(logits, cfg.vocab_size)
        out.append(tok)
    toks = torch.cat(out, dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"tokens": toks, "kv": kv, "reports": reports,
            "decode_steps": plen + tokens - 1, "wall_s": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    check_timing(args, ap.error)
    if args.kv == "flat":
        ap.error("--kv flat (models.model prefill/decode_step) is not ported yet "
                 "(ROADMAP.md Queue 1 item 12); use --kv paged")
    if args.autotune:
        ap.error("--autotune (engine.autotune, record_mass_trace) is not ported "
                 "yet (ROADMAP.md Queue 1 item 12)")
    if args.prompt_len < 1 or args.tokens < 1:
        ap.error("--prompt-len and --tokens must be >= 1")
    try:
        cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    except (KeyError, NotImplementedError) as e:
        ap.error(str(e.args[0]) if e.args else str(e))
    if cfg.family != "dense":
        ap.error(f"--kv paged targets dense-family archs; --arch {args.arch} is "
                 f"family {cfg.family!r}")
    total = args.prompt_len + args.tokens
    nblk = (total + args.block_size - 1) // args.block_size
    try:
        pcfg = build_paged_config(args, nblk)
    except (ValueError, KeyError) as e:
        ap.error(str(e.args[0]) if e.args else str(e))
    dev = resolve_device(args.device)

    gen = torch.Generator(device=dev).manual_seed(0)  # random weights and prompt
    params = M.init_params(cfg, gen, tp=1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    res = serve(cfg, pcfg, params, prompt, args.tokens)
    promoted = int((res["kv"].remap.remap >= 0).sum())
    dt = res["wall_s"]
    print(f"promoted hot blocks: {promoted}")
    print(f"decoded {args.tokens} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({1000 * dt / res['decode_steps']:.1f} ms/step over "
          f"{res['decode_steps']} decode steps, on {dev})")
    print("first sequence:", res["tokens"][0].tolist()[:16], "...")
    return {**res, "cfg": cfg, "pcfg": pcfg, "params": params, "prompt": prompt,
            "device": dev, "resident": promoted}


if __name__ == "__main__":
    main()
