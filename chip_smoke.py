#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one GPU and hold its kernels to account.

    python3 chip_smoke.py          # from the repository root, on a CUDA machine

Phases, each printed as a JSON record on its own line:

1. device: the card's name, the device count and its power limit;
2. build: the four CUDA kernels compiled from ``src/repro_torch/csrc`` (one
   nvcc per source, in parallel);
3. counter: the fused observe counter kernel against its plain version,
   bitwise, at the simulator's shapes and on edge cases;
4. walk: the interval-walk kernel against the plain walker, bitwise, over the
   whole SimState;
5. e2e: ``simulate(app, "rainbow", intervals=8)`` for mcf, GUPS and mix1 at
   each app's own accesses per interval, bitwise equal to the JAX golden
   file ``tests/data/torch_rainbow_golden.json``, with each kernel launched
   exactly once per interval;
6. attention: the paged decode attention kernel against its plain version in
   float32 and bfloat16, in the Pallas kernel's form at
   ``tests/test_kernels.py``'s shapes and in the serving form (fresh lane +
   block mass) at the serving shapes;
7. gather: the block-migration copy kernel against its plain version,
   bitwise, including all-skip and single-lane plans and bfloat16;
8. serve: ``repro_torch.launch.serve`` at qwen3-0.6b's full width (28
   layers), bf16, batch 8, 256 prompt + 64 generated tokens, with the
   attention kernel launched once per layer per decode step and the gather
   once per closed interval; then a profiled window of the same run; then
   the float32 teacher-forced decode held to the JAX golden file
   ``tests/data/torch_serve_golden.json`` (logits within tolerance, promoted
   and evicted counts exact);
9. the ``{"kernels": [...]}`` line: each kernel's launches, time, bound, the
   plain version's time and a library yardstick.

The last line is ``{"ok": true, "device": {...}}``.  Any mismatch raises, so
the script exits non-zero; it also exits non-zero, printing no result, where
there is no CUDA device or no repository around it.  Longer output (every
record, and ptxas's register and shared-memory report) goes to
``chip_smoke.json`` and ``ptxas.txt`` in ``--out`` (default
``build/chip_smoke/``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_rainbow_golden.json")
SERVE_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_serve_golden.json")
E2E_APPS = ("mcf", "GUPS", "mix1")
INTERVALS = 8
SEED = 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SERVE_ARGS = ["--arch", "qwen3-0.6b", "--kv", "paged", "--batch", "8",
              "--prompt-len", "256", "--tokens", "64", "--block-size", "16"]
# stated tolerances, kernel vs plain version on the card (max abs and rel)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the reference's own (test_kernels)
MASS_TOL = 1e-5  # block mass: float32 sums in another order, both dtypes
# port (float32, TF32 off) vs the JAX golden logits, full width
SERVE_LOGIT_TOL = 1e-4
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)

RECORDS: list[dict] = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean CUDA-event time of `fn` over `reps` back-to-back calls (ms).

    This is elapsed time on the device's clock; where the host issues work
    slower than the device runs it, it measures the host.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(prof):
    """(key, device time in ms, count) of every device kernel or copy traced."""
    out = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        # step markers and other user ranges span the timeline; not kernels
        if getattr(ev, "is_user_annotation", False) or ev.key.startswith("ProfilerStep"):
            continue
        dev_t = getattr(ev, "self_device_time_total", None)
        if dev_t is None:
            dev_t = getattr(ev, "self_cuda_time_total", 0)
        out.append((ev.key, dev_t / 1e3, ev.count))
    return out


def device_ms(torch, fn, reps: int) -> float | None:
    """Device busy time per call of `fn` (ms): the sum of the durations of the
    kernels and copies it launches, from torch.profiler (None if it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(ms for _, ms, _ in _device_events(prof))
    return total / reps if total > 0 else None


def bitwise_equal(torch, a, b) -> bool:
    """Same dtype, shape and bits (floats compared as integer patterns)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def leaves(x, path=""):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for name in x._fields:
            yield from leaves(getattr(x, name), f"{path}.{name}")
    else:
        yield path, x


def decode(value):
    """Golden-file value -> Python value (floats are stored with float.hex)."""
    if isinstance(value, dict):
        if set(value) == {"hex"}:
            return float.fromhex(value["hex"])
        return {k: decode(v) for k, v in value.items()}
    return value


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def check_counter(torch, np) -> dict:
    from repro_torch.engine.simloop import make_chunks_np
    from repro_torch.kernels.page_counter.ops import fused_observe_count
    from repro_torch.kernels.page_counter.ref import fused_observe_count_ref
    from repro_torch.sim.config import PAGES_PER_SP, MachineConfig

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    chunks, meta = make_chunks_np("mcf", "rainbow", MachineConfig(), SEED, 1)
    nsp, a = meta["num_superpages"], meta["accesses_per_interval"]
    sp = chunks.sp[0].copy()
    sp[rng.random(a) < 0.1] = -1  # DRAM-resident lanes skip the NVM counters
    hot = np.argsort(-np.bincount(sp[sp >= 0], minlength=nsp), kind="stable")
    mon = np.full(100, -1, np.int32)  # -1 holes: more rows than superpages
    n_hot = min(100, nsp)
    mon[:n_hot] = hot[:n_hot]
    main = (sp, chunks.page[0], chunks.is_write[0], mon, nsp)
    r_sp = rng.integers(-1, 16, 517).astype(np.int32)
    r_mon = np.full(4, -1, np.int32)
    r_mon[:3] = rng.choice(16, 3, replace=False)
    cases = {
        "main_mcf": main,
        "zero_access": (sp[:0], chunks.page[0][:0], chunks.is_write[0][:0], mon, nsp),
        "single_row": (sp, chunks.page[0], chunks.is_write[0], mon[:1], nsp),
        "random_517": (r_sp, rng.integers(0, PAGES_PER_SP, 517).astype(np.int32),
                       rng.random(517) < 0.3, r_mon, 16),
    }
    results = {}
    for name, (c_sp, c_pg, c_wr, c_mon, c_nsp) in cases.items():
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (c_sp, c_pg, c_wr, c_mon)]
        ker = fused_observe_count(*args, c_nsp, PAGES_PER_SP, 2)
        ref = fused_observe_count_ref(*args, c_nsp, PAGES_PER_SP, 2)
        torch.cuda.synchronize()
        same = all(bitwise_equal(torch, k, r) for k, r in zip(ker, ref))
        results[name] = same
        if not same:
            fail(f"fused_observe_count kernel != plain version on case {name}")
        if name == "main_mcf":
            main_args = args
    kw = dict(num_superpages=nsp, pages_per_sp=PAGES_PER_SP, write_weight=2)

    def kernel():
        fused_observe_count(*main_args, **kw)

    def plain():
        fused_observe_count_ref(*main_args, **kw)

    # yardstick: three torch.bincount calls over the same lanes, with the
    # sp -> row lookup done beforehand (untimed); the port never calls it
    t_sp, t_pg, t_wr, t_mon = main_args
    valid = t_sp >= 0
    w1 = torch.where(t_wr, 2, 1) * valid
    table = torch.full((nsp,), -1, dtype=torch.int64, device=dev)
    keep = t_mon >= 0
    table[t_mon[keep].long()] = torch.arange(100, device=dev)[keep]
    row = torch.where(valid, table[t_sp.clamp(min=0).long()], -1)
    flat = row * PAGES_PER_SP + t_pg
    n_cells = 100 * PAGES_PER_SP
    idx_r = torch.where((row >= 0) & ~t_wr, flat, n_cells)
    idx_w = torch.where((row >= 0) & t_wr, flat, n_cells)
    sp_c = t_sp.clamp(min=0)

    def library():
        torch.bincount(sp_c, weights=w1.float(), minlength=nsp)
        torch.bincount(idx_r, minlength=n_cells + 1)
        torch.bincount(idx_w, minlength=n_cells + 1)

    nbytes = a * (4 + 4 + 1) + 100 * 4 + (nsp + 2 * 100 * PAGES_PER_SP) * 4
    rec = {
        "phase": "counter", "cases": results, "accesses": a, "num_superpages": nsp,
        "monitored_rows": 100, "pages_per_sp": PAGES_PER_SP,
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }
    for name, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        rec[f"{name}event_ms"] = cuda_ms(torch, fn, reps=20)
        rec[f"{name}ms"] = device_ms(torch, fn, reps=20) or rec[f"{name}event_ms"]
    emit(rec)
    return rec


def check_walk(torch, np) -> dict:
    from repro_torch.engine.simloop import make_chunks_np
    from repro_torch.sim import tlbsim
    from repro_torch.sim.config import MachineConfig

    dev = torch.device("cuda")
    mc = MachineConfig()
    rng = np.random.default_rng(SEED)
    chunks, meta = make_chunks_np("mcf", "rainbow", mc, SEED, 2)
    a = meta["accesses_per_interval"]

    def interval(i, n=None):
        n = a if n is None else n
        in_dram = rng.random(a) < 0.1  # mixed residency
        return [torch.from_numpy(np.ascontiguousarray(x[:n])).to(dev)
                for x in (chunks.vpn[i], chunks.sp[i], in_dram, chunks.is_write[i])]

    warm = tlbsim.run_interval("rainbow", mc, tlbsim.init_state(mc, dev), *interval(0))
    full = interval(1)
    cases = {"full_mcf": full, "short_4000": interval(1, 4000), "zero_access": interval(1, 0)}
    results = {}
    for name, args in cases.items():
        ker = tlbsim.run_interval("rainbow", mc, warm, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = tlbsim.walk_plain("rainbow", mc, warm, *args)
        plain_s = time.perf_counter() - t0
        bad = [p for (p, k), (_, r) in zip(leaves(ker), leaves(ref))
               if not bitwise_equal(torch, k, r)]
        results[name] = not bad
        if bad:
            fail(f"walk kernel != plain walker on case {name}: {bad}")
        if name == "full_mcf":
            plain_ms = plain_s * 1e3
    def kernel():
        tlbsim.run_interval("rainbow", mc, warm, *full)

    event_ms = cuda_ms(torch, kernel, reps=3)
    ms = device_ms(torch, kernel, reps=3) or event_ms
    n_state = sum(x.numel() for _, x in leaves(warm)) * 4
    nbytes = a * (4 + 4 + 1 + 1) + 2 * n_state
    rec = {
        "phase": "walk", "cases": results, "accesses": a, "ms": ms,
        "event_ms": event_ms, "plain_ms": plain_ms, "plain_clock": "host",
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "ns_per_access": event_ms * 1e6 / a,
    }
    emit(rec)
    return rec


def profile_kernels(torch, run) -> dict:
    """Device time per kernel (by name) and in all over one run, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    out = {"wall_ms": wall_ms, "device_ms": sum(ms for _, ms, _ in events)}
    for k, n in (("counter", "fused_observe_count_kernel"),
                 ("walk", "tlb_walk_rainbow_kernel")):
        hits = [(ms, c) for key, ms, c in events if n in key]
        out[f"{k}_ms_per_launch"] = (sum(ms for ms, _ in hits) / sum(c for _, c in hits)
                                     if hits else "not measured")
    if out["device_ms"] > 0:
        out["device_idle_share"] = max(0.0, 1.0 - out["device_ms"] / wall_ms)
    else:
        out["device_ms"] = "not measured"
    return out


def check_e2e(torch, golden: dict) -> dict:
    from repro_torch.engine.simloop import make_chunks_np
    from repro_torch.kernels.page_counter.ops import fused_observe_count
    from repro_torch.sim import tlbsim
    from repro_torch.sim.config import MachineConfig
    from repro_torch.sim.runner import simulate

    launches = {"counter": 0, "walk": 0}
    runs = {}
    for app in E2E_APPS:
        t0 = time.perf_counter()
        _, meta = make_chunks_np(app, "rainbow", MachineConfig(), SEED, INTERVALS)
        tracegen_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_observe_count.launches = 0
        tlbsim.run_interval.launches = 0
        t0 = time.perf_counter()
        m = simulate(app, "rainbow", intervals=INTERVALS, seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_counter, n_walk = fused_observe_count.launches, tlbsim.run_interval.launches
        if n_counter != INTERVALS or n_walk != INTERVALS:
            fail(f"{app}: launches counter={n_counter} walk={n_walk}, "
                 f"expected {INTERVALS} each")
        launches["counter"] += n_counter
        launches["walk"] += n_walk
        want = {k: decode(v) for k, v in golden["apps"][app].items()}
        got = dataclasses.asdict(m)
        bad = {k: [want[k], got[k]] for k in want if want[k] != got[k]}
        if bad:
            fail(f"{app}: SimMetrics differ from the JAX golden file: {bad}")
        accesses = INTERVALS * meta["accesses_per_interval"]
        prof = profile_kernels(torch, lambda: simulate(
            app, "rainbow", intervals=INTERVALS, seed=SEED))
        runs[app] = {
            "golden": "bitwise", "wall_s": wall, "tracegen_s": tracegen_s,
            "accesses": accesses, "accesses_per_s": accesses / wall,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "launches": {"counter": n_counter, "walk": n_walk},
            "ipc": m.ipc, "mpki": m.mpki, "migrations": m.migrations,
            "profile": prof,
        }
        emit({"phase": "e2e", "app": app, **runs[app]})
    return {"runs": runs, "launches": launches}


def _max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _within(torch, got, want, tol: float) -> bool:
    return bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))


# test_kernels.py's _rainbow_attention shapes: (B, HP, KVS, hd, block, nblk)
PALLAS_ATTN_SHAPES = ((1, 4, 4, 16, 4, 3), (2, 8, 4, 32, 8, 6),
                      (3, 8, 2, 64, 16, 4), (2, 4, 2, 32, 8, 1))
# the serve phase's shapes: qwen3-0.6b heads, batch 8, 20 blocks of 16, 10 hot slots
SERVE_ATTN = dict(b=8, hp=16, kvs=8, hd=128, block=16, nblk=20, hot=10)


def attention_inputs(torch, np, rng, dtype, b, hp, kvs, hd, block, nblk, hot,
                     fresh: bool, dev):
    """(q, cap_k, cap_v, hot_k, hot_v, vidx, k_new, v_new): a capacity pool of
    b * nblk blocks, `hot` hot rows, and vidx redirecting some blocks (serving
    form: home blocks, a few resident) or random pool rows (Pallas form)."""
    nb = b * nblk

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    q = rand(b, hp, hd)
    cap_k, cap_v = rand(nb, block, kvs, hd), rand(nb, block, kvs, hd)
    hot_k, hot_v = rand(hot, block, kvs, hd), rand(hot, block, kvs, hd)
    if fresh:
        vidx = np.arange(nb, dtype=np.int32).reshape(b, nblk)
        flat = rng.choice(nb, min(hot, nb), replace=False)
        vidx.reshape(-1)[flat] = nb + np.arange(len(flat), dtype=np.int32)
        k_new, v_new = rand(b, kvs, hd), rand(b, kvs, hd)
    else:
        vidx = rng.integers(0, nb + hot, (b, nblk)).astype(np.int32)
        k_new = v_new = None
    vidx = torch.from_numpy(vidx).to(dev)
    return q, cap_k, cap_v, hot_k, hot_v, vidx, k_new, v_new


def check_attention(torch, np) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.rainbow_attention.ops import rainbow_attention
    from repro_torch.kernels.rainbow_attention.ref import rainbow_attention_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    cases = {}
    worst = {"out": 0.0, "mass": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        shapes = [(f"pallas-{b}x{hp}x{kvs}x{hd}x{blk}x{nblk}", False,
                   dict(b=b, hp=hp, kvs=kvs, hd=hd, block=blk, nblk=nblk, hot=4),
                   max(nblk * blk - 2, 1))
                  for b, hp, kvs, hd, blk, nblk in PALLAS_ATTN_SHAPES]
        full = SERVE_ATTN["nblk"] * SERVE_ATTN["block"]
        shapes += [(f"serve-len{n}", True, SERVE_ATTN, n) for n in (0, 1, 150, full - 1)]
        for name, fresh, shape, length in shapes:
            args = attention_inputs(torch, np, rng, dtype, **shape, fresh=fresh, dev=dev)
            ker = rainbow_attention(*args[:6], length, *args[6:], with_mass=fresh)
            ref = rainbow_attention_ref(*args[:6], length, *args[6:], with_mass=fresh)
            torch.cuda.synchronize()
            tol = ATTN_TOL[tag]
            rec = {"out_err": _max_err(torch, ker[0], ref[0]), "tol": tol,
                   "ok": _within(torch, ker[0], ref[0], tol)}
            worst["out"] = max(worst["out"], rec["out_err"] / tol)
            if fresh:
                rec["mass_err"] = _max_err(torch, ker[1], ref[1])
                rec["mass_ok"] = _within(torch, ker[1], ref[1], MASS_TOL)
                rec["ok"] = rec["ok"] and rec["mass_ok"]
                worst["mass"] = max(worst["mass"], rec["mass_err"])
            cases[f"{tag}-{name}"] = rec
            if not rec["ok"]:
                fail(f"rainbow_attention kernel != plain version on {tag}-{name}: {rec}")

    # timing at the serving shape in bf16 at the last decode step's length
    s = SERVE_ATTN
    length = s["nblk"] * s["block"] - 1
    args = attention_inputs(torch, np, rng, torch.bfloat16, **s, fresh=True, dev=dev)

    def kernel():
        rainbow_attention(*args[:6], length, *args[6:], with_mass=True)

    def plain():
        rainbow_attention_ref(*args[:6], length, *args[6:], with_mass=True)

    # yardstick: SDPA over the already-gathered, head-expanded K/V (untimed prep)
    q, cap_k, cap_v, hot_k, hot_v, vidx, k_new, v_new = args
    b, hp, hd, kvs = s["b"], s["hp"], s["hd"], s["kvs"]
    idx = vidx.long()
    kk = torch.cat([torch.cat([cap_k, hot_k])[idx].reshape(b, -1, kvs, hd)[:, :length],
                    k_new[:, None]], 1)
    vv = torch.cat([torch.cat([cap_v, hot_v])[idx].reshape(b, -1, kvs, hd)[:, :length],
                    v_new[:, None]], 1)
    k4 = kk.repeat_interleave(hp // kvs, 2).transpose(1, 2).contiguous()
    v4 = vv.repeat_interleave(hp // kvs, 2).transpose(1, 2).contiguous()
    q4 = q[:, :, None]

    def library():
        F.scaled_dot_product_attention(q4, k4, v4)

    elem = 2
    nbytes = (2 * b * (length + 1) * kvs * hd * elem  # readable K and V rows, once
              + b * s["nblk"] * 4  # vidx
              + 2 * b * hp * hd * elem  # q in, out
              + b * s["nblk"] * 4)  # mass out
    flops = 4 * b * hp * (length + 1) * hd
    rec = {"phase": "attention", "cases": cases, "worst_out_err_over_tol": worst["out"],
           "worst_mass_err": worst["mass"], "mass_tol": MASS_TOL,
           "timed_shape": {**s, "length": length, "dtype": "bfloat16"},
           "bytes": nbytes, "flops": flops,
           "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
           else "operations"}
    for name, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        rec[f"{name}event_ms"] = cuda_ms(torch, fn, reps=50)
        rec[f"{name}ms"] = device_ms(torch, fn, reps=50) or rec[f"{name}event_ms"]
    emit(rec)
    return rec


def check_gather(torch, np) -> dict:
    from repro_torch.kernels.block_gather.ops import block_gather_
    from repro_torch.kernels.block_gather.ref import block_gather_ref_

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def plan(nb, hot, k, all_skip=False):
        """test_kernels.py's _block_gather plan: distinct dst among valid lanes."""
        src = rng.integers(-1, nb, k).astype(np.int32)
        if all_skip:
            src[:] = -1
        dst = np.resize(rng.choice(hot, min(k, hot), replace=False), k).astype(np.int32)
        seen = set()
        for i in range(k):
            if src[i] >= 0 and int(dst[i]) in seen:
                src[i] = -1
            elif src[i] >= 0:
                seen.add(int(dst[i]))
        return torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)

    def pools(layers, nb, hot, row, dtype, pairs):
        out = []
        for _ in range(pairs):
            cap = torch.from_numpy(rng.standard_normal((layers, nb, *row), dtype=np.float32))
            h = torch.from_numpy(rng.standard_normal((layers, hot, *row), dtype=np.float32))
            out.append((cap.to(dev, dtype), h.to(dev, dtype)))
        return out

    serve_row = (16, 8, 128)
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        specs = {  # name: (layers, NB, HOT, lanes, row, pairs, all_skip)
            "24nb": (1, 24, 6, 6, (4, 2, 8), 1, False),
            "8nb": (1, 8, 3, 5, (4, 2, 8), 1, False),
            "single_lane": (1, 64, 16, 1, (4, 2, 8), 1, False),
            "no_valid_lanes": (1, 16, 4, 4, (4, 2, 8), 1, True),
            "odd_row": (3, 12, 5, 5, (3, 1, 3), 2, False),
            "serve": (28, 160, 10, 10, serve_row, 2, False),
            "serve_all_skip": (28, 160, 10, 10, serve_row, 2, True),
        }
        for name, (layers, nb, hot, k, row, npairs, skip) in specs.items():
            src, dst = plan(nb, hot, k, skip)
            ker = pools(layers, nb, hot, row, dtype, npairs)
            ref = [(c.clone(), h.clone()) for c, h in ker]
            before = [h.clone() for _, h in ker]
            block_gather_(ker, src, dst)
            block_gather_ref_(ref, src, dst)
            torch.cuda.synchronize()
            same = all(bitwise_equal(torch, a[1], b[1]) for a, b in zip(ker, ref))
            if skip:
                same = same and all(bitwise_equal(torch, a[1], b) for a, b in zip(ker, before))
            cases[f"{tag}-{name}"] = same
            if not same:
                fail(f"block_gather kernel != plain version on {tag}-{name}")

    layers, nb, hot, k = 28, 160, 10, 10
    src, dst = plan(nb, hot, k)
    pairs = pools(layers, nb, hot, serve_row, torch.bfloat16, 2)
    valid = src >= 0
    s_ok, d_ok = src[valid].long(), dst[valid].long()
    n_valid = int(valid.sum())

    def kernel():
        block_gather_(pairs, src, dst)

    def plain():
        block_gather_ref_(pairs, src, dst)

    def library():  # index_select + index_copy_ on the valid lanes (untimed filter)
        for cap, h in pairs:
            h.index_copy_(1, d_ok, cap.index_select(1, s_ok))

    row_bytes = 16 * 8 * 128 * 2
    nbytes = 2 * n_valid * layers * 2 * row_bytes + 2 * k * 4
    rec = {"phase": "gather", "cases": cases, "timed_shape": {
               "layers": layers, "capacity_blocks": nb, "hot_slots": hot, "lanes": k,
               "valid_lanes": n_valid, "row": list(serve_row), "dtype": "bfloat16"},
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    for name, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        rec[f"{name}event_ms"] = cuda_ms(torch, fn, reps=50)
        rec[f"{name}ms"] = device_ms(torch, fn, reps=50) or rec[f"{name}event_ms"]
    emit(rec)
    return rec


def check_serve(torch) -> dict:
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.block_gather.ops import block_gather_
    from repro_torch.kernels.rainbow_attention.ops import rainbow_attention
    from repro_torch.launch import serve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rainbow_attention.launches = 0
    block_gather_.launches = 0
    res = serve.main(SERVE_ARGS)
    n_attn, n_gather = rainbow_attention.launches, block_gather_.launches
    cfg, pcfg, steps = res["cfg"], res["pcfg"], res["decode_steps"]
    want_attn = cfg.num_layers * steps
    want_gather = steps // pcfg.interval_steps
    if n_attn != want_attn or n_gather != want_gather or len(res["reports"]) != want_gather:
        fail(f"serve launches: attention {n_attn} (expected {want_attn} = "
             f"{cfg.num_layers} layers x {steps} steps), gather {n_gather} "
             f"(expected {want_gather} closed intervals)")
    promoted = sum(int(r["promoted"]) for r in res["reports"])
    evicted = sum(int(r["evicted"]) for r in res["reports"])
    toks = res["tokens"]
    b, gen = toks.shape
    if (gen != 64 or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
            or promoted <= 0 or res["resident"] > pcfg.hot_slots):
        fail(f"serve output: tokens {tuple(toks.shape)}, promoted {promoted}, "
             f"resident {res['resident']} of {pcfg.hot_slots} hot slots")
    wall = res["wall_s"]
    rec = {
        "phase": "serve", "args": " ".join(SERVE_ARGS), "layers": cfg.num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
        "vocab": cfg.vocab_size, "dtype": cfg.dtype,
        "paged": {"block_size": pcfg.block_size, "blocks_per_seq": pcfg.blocks_per_seq,
                  "hot_slots": pcfg.hot_slots, "top_n": pcfg.top_n,
                  "max_promotions": pcfg.max_promotions,
                  "interval_steps": pcfg.interval_steps},
        "decode_steps": steps, "wall_s": wall, "ms_per_step": wall * 1e3 / steps,
        "tokens_per_s": b * steps / wall, "generated_tokens_per_s": b * gen / wall,
        "launches": {"rainbow_attention": n_attn, "block_gather": n_gather},
        "intervals": len(res["reports"]), "promoted": promoted, "evicted": evicted,
        "resident_at_end": res["resident"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "first_tokens": toks[0, :8].tolist(),
    }

    # profiled window of the same run: the prompt's last 16 decode steps
    plen = res["prompt"].shape[1]
    active = min(16, steps // 4)
    start = max(1, plen - active)
    mark = {}

    def on_step(i):  # after decode step i; the window is steps start..start+active-1
        if i in (start - 1, start + active - 1):
            torch.cuda.synchronize()
            mark[i] = time.perf_counter()
        prof.step()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=start - 1, warmup=1, active=active,
                                   repeat=1)) as prof:
        serve.serve(cfg, pcfg, res["params"], res["prompt"], gen, on_step=on_step)
    events = _device_events(prof)
    window_ms = (mark[start + active - 1] - mark[start - 1]) * 1e3
    busy = sum(ms for _, ms, _ in events)
    by = {}
    for key, ms, c in events:
        name = ("rainbow_attention" if "rainbow_attention_kernel" in key
                or "mass_reduce_kernel" in key else "block_gather"
                if "block_gather_kernel" in key else "gemm"
                if any(w in key.lower() for w in ("gemm", "gemv", "nvjet")) else "other")
        by[name] = by.get(name, 0.0) + ms
    rec["profile"] = {
        "window_steps": active, "window_first_step": start, "wall_ms": window_ms,
        "device_ops_per_step": sum(c for _, _, c in events) / active,  # kernels + copies
        "device_busy_ms": busy if busy > 0 else "not measured",
        "device_idle_share": max(0.0, 1.0 - busy / window_ms) if busy > 0 else "not measured",
        "device_ms_by_kind": by,
        "top_kernels": [[key, round(ms, 4), c] for key, ms, c in
                        sorted(events, key=lambda e: -e[1])[:12]],
    }
    # every weight is read once per step, except the token table (B rows)
    tok = res["params"]["embed"]["tok"]
    read = (sum(t.numel() * t.element_size() for t in _leaves_of(res["params"]))
            - tok.numel() * tok.element_size() + b * tok[0].numel() * tok.element_size())
    rec["profile"]["weights_read_bytes_per_step"] = read
    rec["profile"]["weights_bound_ms_per_step"] = read / HBM_BYTES_PER_S * 1e3
    emit(rec)
    return rec


def _leaves_of(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves_of(v)
        else:
            yield v


def check_serve_golden(torch, np, golden: dict, device) -> dict:
    """The port's teacher-forced float32 decode vs the JAX golden (see
    scripts/make_torch_serve_golden.py): same weights (digest), logits within
    SERVE_LOGIT_TOL, per-interval promoted/evicted counts exact."""
    from repro_torch import configs, interop
    from repro_torch.memory.kvcache import PagedConfig, paged_init
    from repro_torch.serving.rainbow_decode import rainbow_decode_step

    get = configs.get_reduced_config if golden["reduced"] else configs.get_config
    cfg = dataclasses.replace(get(golden["arch"]), num_layers=golden["num_layers"],
                              dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    tree = interop.numpy_params(cfg, golden["seed"])
    digest = interop.weights_digest(tree)
    if digest != golden["weights_sha256"]:
        fail(f"serve golden: numpy's stream made other weights here (sha256 {digest}, "
             f"golden {golden['weights_sha256']}); numpy {np.__version__}")
    params = interop.params_from_numpy(cfg, tree, device)
    del tree
    setup_s = time.perf_counter() - t0
    pcfg = PagedConfig(**golden["paged"])
    stream = torch.tensor(golden["stream"], dtype=torch.int32, device=device)
    ids = torch.tensor(golden["logit_ids"], device=device)
    b, steps = stream.shape
    kv = paged_init(cfg, pcfg, b, 1, cfg.num_layers, device)
    reports, logits, at_ref, port_arg, closed_after = [], [], [], [], []
    ref_arg = np.asarray(golden["argmax"], dtype=np.int64)
    for t in range(steps):
        n = len(reports)
        out, kv = rainbow_decode_step(cfg, pcfg, params, stream[:, t:t + 1], kv,
                                      reports=reports)
        if len(reports) > n:
            closed_after.append(t)
        row = out[:, 0, :cfg.vocab_size]
        logits.append(row[:, ids])
        at_ref.append(row[torch.arange(b, device=device),
                          torch.from_numpy(ref_arg[t]).to(device)])
        port_arg.append(row.argmax(dim=1))
    got = torch.stack(logits).cpu().double().numpy()
    want = np.asarray(golden["logits"], dtype=np.float64)
    top = np.asarray(golden["top2"], dtype=np.float64)
    # the logit at the reference's argmax too, against the reference's value
    err = max(float(np.abs(got - want).max()),
              float(np.abs(torch.stack(at_ref).cpu().double().numpy() - top[:, :, 0]).max()))
    decidable = (top[:, :, 0] - top[:, :, 1]) > 2 * SERVE_LOGIT_TOL
    agree = torch.stack(port_arg).cpu().numpy().astype(np.int64) == ref_arg
    ivals = [{"after_step": t, "promoted": int(r["promoted"]), "evicted": int(r["evicted"])}
             for t, r in zip(closed_after, reports)]
    rec = {"phase": "serve_golden", "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "batch": b, "steps": steps, "dtype": "float32",
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32) if device.type == "cuda"
           else False, "weights_sha256": digest, "setup_s": setup_s,
           "max_logit_err": err, "tol": SERVE_LOGIT_TOL,
           "argmax_agree": int(agree.sum()), "argmax_total": int(agree.size),
           "argmax_decidable_disagree": int((~agree & decidable).sum()),
           "intervals": ivals, "golden_intervals": golden["intervals"]}
    if device.type == "cuda":
        emit(rec)
    if err > SERVE_LOGIT_TOL or rec["argmax_decidable_disagree"]:
        fail(f"serve golden: logits differ by {err} (tol {SERVE_LOGIT_TOL}) or "
             f"{rec['argmax_decidable_disagree']} decidable argmax differ")
    if ivals != golden["intervals"]:
        fail(f"serve golden: intervals {ivals} != golden {golden['intervals']}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chip_smoke"),
                    help="directory for chip_smoke.json and ptxas.txt")
    out_dir = ap.parse_args().out
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build
        with open(GOLDEN) as f:
            golden = json.load(f)
        with open(SERVE_GOLDEN) as f:
            serve_golden = json.load(f)
    except (ImportError, OSError) as exc:
        print(f"chip_smoke: the repository is not here ({exc})", file=sys.stderr)
        return 1
    os.makedirs(out_dir, exist_ok=True)

    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "numpy": np.__version__})

    t0 = time.perf_counter()
    built = build.build()
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for name, info in built.items():
            f.write(f"== {name}\n{info['ptxas']}\n")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: v["seconds"] for k, v in built.items()}})

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    counter = timed("counter", check_counter, torch, np)
    walk = timed("walk", check_walk, torch, np)
    e2e = timed("e2e", check_e2e, torch, golden)
    attn = timed("attention", check_attention, torch, np)
    gather = timed("gather", check_gather, torch, np)
    srv = timed("serve", check_serve, torch)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    try:
        timed("serve_golden", check_serve_golden, torch, np, serve_golden,
              torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    emit({"phase": "seconds", **seconds})
    if any(m in ("jax", "repro") or m.startswith(("jax.", "repro.")) for m in sys.modules):
        fail("the port imported JAX or the JAX package")

    kernels = {"kernels": [
        {
            "name": "fused_observe_count", "route": "cuda",
            "source": "src/repro_torch/csrc/page_counter.cu",
            "replaces": "src/repro/kernels/page_counter/page_counter.py:209",
            "launches": e2e["launches"]["counter"], "max_abs_err": 0,
            "parity": "bitwise", "ms": counter["ms"], "plain_ms": counter["plain_ms"],
            "bound_ms": counter["bound_ms"], "bound_by": "bytes",
            "library_ms": counter["library_ms"], "event_ms": counter["event_ms"],
            "timing": "ms, plain_ms, library_ms: device busy time per call "
                      "(torch.profiler); event_ms: CUDA-event time per call",
        },
        {
            "name": "tlb_walk_rainbow", "route": "cuda",
            "source": "src/repro_torch/csrc/tlb_walk.cu",
            "replaces": "src/repro/sim/tlbsim.py:328",
            "launches": e2e["launches"]["walk"], "max_abs_err": 0,
            "parity": "bitwise", "ms": walk["ms"], "plain_ms": walk["plain_ms"],
            "bound_ms": walk["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "event_ms": walk["event_ms"],
            "timing": "ms: device busy time per launch (torch.profiler); plain_ms: "
                      "host clock of the Python walker; event_ms: CUDA-event time",
            "note": "latency-bound: one serial dependence chain through the LRU state",
        },
        {
            "name": "rainbow_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/rainbow_attention.cu",
            "replaces": "src/repro/kernels/rainbow_attention/rainbow_attention.py:94",
            "launches": srv["launches"]["rainbow_attention"],
            "max_abs_err": max(max(c["out_err"], c.get("mass_err", 0.0))
                               for c in attn["cases"].values()),
            "parity": f"out atol=rtol {ATTN_TOL}, mass {MASS_TOL}",
            "ms": attn["ms"], "plain_ms": attn["plain_ms"],
            "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
            "library_ms": attn["library_ms"], "event_ms": attn["event_ms"],
            "shape": attn["timed_shape"],
            "timing": "ms, plain_ms, library_ms (F.scaled_dot_product_attention on "
                      "the gathered K/V): device busy time per call (torch.profiler); "
                      "event_ms: CUDA-event time per call",
        },
        {
            "name": "block_gather", "route": "cuda",
            "source": "src/repro_torch/csrc/block_gather.cu",
            "replaces": "src/repro/kernels/block_gather/block_gather.py:31",
            "launches": srv["launches"]["block_gather"], "max_abs_err": 0,
            "parity": "bitwise", "ms": gather["ms"], "plain_ms": gather["plain_ms"],
            "bound_ms": gather["bound_ms"], "bound_by": "bytes",
            "library_ms": gather["library_ms"], "event_ms": gather["event_ms"],
            "shape": gather["timed_shape"],
            "timing": "ms, plain_ms, library_ms (index_select + index_copy_ per "
                      "pool): device busy time per call (torch.profiler); "
                      "event_ms: CUDA-event time per call",
        },
    ]}
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"records": RECORDS, **kernels, "card": card}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
