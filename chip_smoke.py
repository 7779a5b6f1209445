#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one GPU and hold its kernels to account.

    python3 chip_smoke.py          # from the repository root, on a CUDA machine

Phases, each printed as a JSON record on its own line:

1. device: the card's name, the device count and its power limit;
2. build: the five CUDA sources compiled from ``src/repro_torch/csrc`` (one
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
   block mass) at the serving shapes, at and past the KV split boundaries,
   with 1 and 16 blocks per split and with capacity and hot rows mixed
   within a split;
7. gather: the block-migration copy kernel against its plain version,
   bitwise, including all-skip and single-lane plans and bfloat16;
8. serve: ``repro_torch.launch.serve`` at qwen3-0.6b's full width (28
   layers), bf16, batch 8, 256 prompt + 64 generated tokens, with the
   attention kernel launched once per layer per decode step and the gather
   once per closed interval; then a profiled window of the same run; then
   the float32 teacher-forced decode held to the JAX golden file
   ``tests/data/torch_serve_golden.json`` (logits within tolerance, promoted
   and evicted counts exact);
9. flash: the flash attention kernel (output and log-sum-exp) against its
   plain version in float32 and bfloat16 (bf16 also against the plain
   version with P kept in float32), at ``tests/test_kernels.py``'s shapes,
   GQA (4-on-1 at head dims 16 and 32), ragged lengths (S 1 to 1000, ending
   inside an MMA fragment), non-causal cases and the full-width training
   shape, and its autograd Function's gradient against autograd of the
   plain version;
10. count: the two-stage counter behind ``count_accesses`` against its plain
    version, bitwise, at ``tests/test_kernels.py``'s six shapes, after
    ``count_accesses`` is driven over the mcf trace's intervals;
11. train: ``repro_torch.launch.train`` at qwen3-0.6b's full width (28
    layers), bf16, ``--attn chunked --remat none``, batch 8 x 1024 tokens,
    20 steps, with the flash kernel launched once per layer per step, every
    loss finite and falling; then a profiled window of two more steps;
12. train_golden: three float32 steps at full width with depth cut to 2
    layers held to the JAX golden file ``tests/data/torch_train_golden.json``
    (per-step loss and grad_norm, per-leaf parameter sums), then 2 steps,
    a checkpoint, a restore into a fresh Trainer and 2 more steps, against
    an uninterrupted 4-step run;
13. the ``{"kernels": [...]}`` line: each kernel's launches, time, bound, the
    plain version's time and a library yardstick, every time per call from
    one profiler timer (``device_ms``).

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
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_rainbow_golden.json")
SERVE_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_serve_golden.json")
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_train_golden.json")
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
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
FLASH_TOL = {"float32": 3e-5, "bfloat16": 3e-2}  # the reference's own (test_kernels)
# bf16 kernel vs the plain version with P kept in float32, as the kernel keeps
# it, on the same inputs: two roundings of nearly equal float32 sums, at most
# one bf16 ulp (2**-7 relative) apart.  FLASH_TOL's bf16 bound is for the
# plain version that rounds P to bf16 (the reference's form).
FLASH_BF16_P32_TOL = {"atol": 1e-5, "rtol": 1e-2}
LSE_TOL = 1e-4  # log-sum-exp: float32 sums of up to 1024 terms in another order
FLASH_GRAD_TOL = 1e-4  # float32 backward vs autograd of the plain version
TRAIN_STEPS = 20
TRAIN_ARGS = ["--arch", "qwen3-0.6b", "--attn", "chunked", "--remat", "none",
              "--batch", "8", "--seq", "1024", "--steps", str(TRAIN_STEPS)]
# port (float32, TF32 off) vs the JAX golden steps, full width, 2 layers
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GNORM_RTOL = 1e-3
TRAIN_SUM_TOL = 1e-5  # |sum - golden sum| <= TRAIN_SUM_TOL * golden sum of |p|
RESUME_RTOL = 1e-6  # resumed vs uninterrupted losses, the same program

# how the kernel rows' times were taken (device_ms and cuda_ms)
TIMING = ("ms, plain_ms, library_ms: device time per call, launches per call x mean "
          "time per record (torch.profiler, CPU + CUDA; ms_trace: records and "
          "launches); event_ms: CUDA-event time per call")
WALK_TIMING = ("ms: device time per call as the other rows (run_interval); plain_ms: "
               "host clock of the Python walker; event_ms: CUDA-event time")

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


def device_ms(torch, fn, reps: int) -> tuple[float, dict]:
    """Device time per call of `fn` (ms) from torch.profiler traces of CPU
    and CUDA, and the trace's records against the launches the calls made.

    A trace of one call gives how often `fn` launches each kernel (or copy);
    a trace of `reps` calls gives each one's mean time per record.  The time
    per call is the sum of launches per call times mean time, so records the
    trace drops do not lower it (one run on an H100 kept 10 of 20 flash
    launches).  Every kernel row's ms, plain_ms and library_ms come from here.
    """
    from torch.profiler import ProfilerActivity, profile

    def trace(n):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return {key: (ms, c) for key, ms, c in _device_events(prof)}

    one, many = trace(1), trace(reps)
    if not many:
        fail("the profiler saw no device work")
    ms, records, expected = 0.0, 0, 0
    for key, (total, c) in many.items():
        per_call = max(one.get(key, (0.0, 0))[1], -(-c // reps))
        ms += per_call * total / c
        records += c
        expected += per_call * reps
    return ms, {"records": records, "launches": expected}


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
        rec[f"{name}ms"], rec[f"{name}trace"] = device_ms(torch, fn, reps=20)
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
    ms, trace = device_ms(torch, kernel, reps=3)
    n_state = sum(x.numel() for _, x in leaves(warm)) * 4
    nbytes = a * (4 + 4 + 1 + 1) + 2 * n_state
    rec = {
        "phase": "walk", "cases": results, "accesses": a, "ms": ms, "trace": trace,
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
                     fresh: bool, dev, mix: bool = False):
    """(q, cap_k, cap_v, hot_k, hot_v, vidx, k_new, v_new): a capacity pool of
    b * nblk blocks, `hot` hot rows, and vidx redirecting some blocks (serving
    form: home blocks, a few resident; `mix`: every odd block hot, so each
    KV split reads both pools) or random pool rows (Pallas form)."""
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
        if mix:
            odd = vidx[:, 1::2]
            vidx[:, 1::2] = nb + np.arange(odd.size, dtype=np.int32).reshape(odd.shape) % hot
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
        # the KV split (64 positions, 4 blocks of 16): at a split boundary and
        # one past it, a partial last split, 1 and 16 blocks per split, both
        # pools within one split
        shapes += [(f"split-len{n}", True, SERVE_ATTN, n) for n in (64, 65, 128)]
        shapes += [
            ("split-nblk21", True, {**SERVE_ATTN, "nblk": 21}, 21 * SERVE_ATTN["block"] - 1),
            ("block64", True, dict(b=4, hp=16, kvs=8, hd=128, block=64, nblk=5, hot=4), 250),
            ("block4", True, dict(b=4, hp=16, kvs=8, hd=128, block=4, nblk=40, hot=8), 150),
            ("mixed-len319", True, {**SERVE_ATTN, "mix": True}, full - 1),
        ]
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
        rec[f"{name}ms"], rec[f"{name}trace"] = device_ms(torch, fn, reps=50)
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
        rec[f"{name}ms"], rec[f"{name}trace"] = device_ms(torch, fn, reps=50)
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
                or "rainbow_attention_combine_kernel" in key else "block_gather"
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


# test_kernels.py's flash sweep (B, S, H, H, hd, causal), then GQA, ragged S,
# the reduced configs' head_dim and the full-width training shape
FLASH_SHAPES = {
    "1x128x2x32-causal": (1, 128, 2, 2, 32, True),
    "2x256x4x64-causal": (2, 256, 4, 4, 64, True),
    "1x256x1x128-full": (1, 256, 1, 1, 128, False),
    "gqa-2x256x16on8x128": (2, 256, 16, 8, 128, True),
    "ragged-2x200x16on8x128": (2, 200, 16, 8, 128, True),
    "hd16-2x40x4on2x16": (2, 40, 4, 2, 16, True),
    "s1-1x1x4on2x128": (1, 1, 4, 2, 128, True),
    "s17-2x17x4on2x128": (2, 17, 4, 2, 128, True),
    "s63-1x63x4on2x64": (1, 63, 4, 2, 64, True),
    "s64-1x64x4on2x128": (1, 64, 4, 2, 128, True),
    "s65-1x65x4on2x128": (1, 65, 4, 2, 128, True),
    "s1000-1x1000x4on2x128": (1, 1000, 4, 2, 128, True),
    "gqa4-hd16-2x96x4on1x16": (2, 96, 4, 1, 16, True),
    "gqa4-hd32-2x96x4on1x32": (2, 96, 4, 1, 32, True),
    "full-1x200x4on2x64": (1, 200, 4, 2, 64, False),
    "train-8x1024x16on8x128": (8, 1024, 16, 8, 128, True),
}


def check_flash(torch, np) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        expand_kv, flash_attention_lse_ref, flash_attention_ref,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def inputs(shape, dtype):
        b, s, hp, kvs, hd, _ = shape
        return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(dev, dtype)
                for sh in ((b, s, hp, hd), (b, s, kvs, hd), (b, s, kvs, hd))]

    cases = {}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        for name, shape in FLASH_SHAPES.items():
            hp, causal = shape[2], shape[5]
            q, k, v = inputs(shape, dtype)
            out, lse = ops.flash_attention(q, k, v, causal)
            ke, ve = expand_kv(k, hp), expand_kv(v, hp)
            want = flash_attention_ref(q, ke, ve, causal)
            want_lse = flash_attention_lse_ref(q, ke, causal)
            torch.cuda.synchronize()
            tol = FLASH_TOL[tag]
            rec = {"out_err": _max_err(torch, out, want), "tol": tol,
                   "lse_err": _max_err(torch, lse, want_lse), "lse_tol": LSE_TOL}
            rec["ok"] = (_within(torch, out, want, tol)
                         and _within(torch, lse, want_lse, LSE_TOL))
            if dtype == torch.bfloat16:
                want32 = flash_attention_ref(q.float(), ke.float(), ve.float(), causal)
                want32 = want32.to(dtype)
                rec["p32_err"] = _max_err(torch, out, want32)
                rec["p32_tol"] = FLASH_BF16_P32_TOL
                rec["ok"] = rec["ok"] and bool(torch.allclose(
                    out.float(), want32.float(), **FLASH_BF16_P32_TOL))
                del want32
            worst = max(worst, rec["out_err"])
            cases[f"{tag}-{name}"] = rec
            if not rec["ok"]:
                fail(f"flash_attention kernel != plain version on {tag}-{name}: {rec}")
            del q, k, v, out, lse, ke, ve, want, want_lse

    # the card's gradient (the autograd Function) vs autograd of the plain version
    grads = {}
    for name in ("gqa-2x256x16on8x128", "ragged-2x200x16on8x128", "1x256x1x128-full"):
        shape = FLASH_SHAPES[name]
        hp, causal = shape[2], shape[5]
        q, k, v = (x.requires_grad_(True) for x in inputs(shape, torch.float32))
        dout = torch.randn(q.shape, device=dev, generator=torch.Generator(dev).manual_seed(1))
        got = torch.autograd.grad((ops.attention(q, k, v, causal) * dout).sum(), (q, k, v))
        want = torch.autograd.grad(
            (flash_attention_ref(q, expand_kv(k, hp), expand_kv(v, hp), causal) * dout).sum(),
            (q, k, v))
        errs = [_max_err(torch, g, w) for g, w in zip(got, want)]
        ok = all(_within(torch, g, w, FLASH_GRAD_TOL) for g, w in zip(got, want))
        grads[name] = {"dq_dk_dv_err": errs, "tol": FLASH_GRAD_TOL, "ok": ok}
        if not ok:
            fail(f"flash attention gradient != autograd of the plain version on {name}: {errs}")

    # timing at the training shape in bf16
    b, s, hp, kvs, hd, _ = FLASH_SHAPES["train-8x1024x16on8x128"]
    q, k, v = inputs(FLASH_SHAPES["train-8x1024x16on8x128"], torch.bfloat16)
    ke, ve = expand_kv(k, hp), expand_kv(v, hp)
    # yardstick: SDPA on [B, H, S, hd] with K/V expanded (untimed layout changes)
    q4, k4, v4 = (x.transpose(1, 2).contiguous() for x in (q, ke, ve))

    def kernel():
        ops.flash_attention(q, k, v, True)

    def plain():
        flash_attention_ref(q, ke, ve, True)

    def library():
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    pairs = s * (s + 1) // 2  # unmasked (i, j) per head
    flops = 4 * hd * pairs * b * hp
    nbytes = 2 * (2 * b * s * hp * hd + 2 * b * s * kvs * hd) + 4 * b * hp * s
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    rec = {"phase": "flash", "cases": cases, "grad_cases": grads, "worst_out_err": worst,
           "timed_shape": {"batch": b, "seq": s, "heads": [hp, kvs], "head_dim": hd,
                           "causal": True, "dtype": "bfloat16"},
           "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    for name, fn, reps in (("", kernel, 20), ("plain_", plain, 5), ("library_", library, 20)):
        rec[f"{name}event_ms"] = cuda_ms(torch, fn, reps=reps)
        rec[f"{name}ms"], rec[f"{name}trace"] = device_ms(torch, fn, reps=reps)
    rec["kernel_tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    emit(rec)
    return rec


# test_kernels.py's two-stage cases: (accesses, num_superpages, pages_per_sp, rows)
COUNT_SHAPES = {"100a": (100, 16, 8, 4), "517a": (517, 8, 32, 2),
                "1000a": (1000, 32, 16, 8), "zero_access": (0, 16, 8, 4),
                "single_row": (129, 8, 8, 1), "single_sp": (64, 1, 4, 1)}


def check_count(torch, np) -> dict:
    from repro_torch.engine.simloop import make_chunks_np
    from repro_torch.kernels.page_counter import ops
    from repro_torch.kernels.page_counter.ref import two_stage_count_ref
    from repro_torch.sim.config import PAGES_PER_SP, MachineConfig

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def on_card(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in xs]

    # count_accesses (its one entry point) over the mcf trace's intervals,
    # each weighted as the fused counter weighs it (writes 2, reads 1)
    chunks, meta = make_chunks_np("mcf", "rainbow", MachineConfig(), SEED, INTERVALS)
    nsp, a = meta["num_superpages"], meta["accesses_per_interval"]
    hot = np.argsort(-np.bincount(chunks.sp[0][chunks.sp[0] >= 0], minlength=nsp),
                     kind="stable")
    mon = np.full(100, -1, np.int32)
    mon[:min(100, nsp)] = hot[:min(100, nsp)]
    t_mon, = on_card(mon)
    torch.cuda.synchronize()
    ops.two_stage_count.launches = 0
    for i in range(INTERVALS):
        w = np.where(chunks.is_write[i], 2, 1).astype(np.uint32).view(np.int32)
        t_sp, t_pg, t_w = on_card(chunks.sp[i], chunks.page[i], w)
        ops.count_accesses(t_sp, t_pg, t_w, t_mon, nsp, PAGES_PER_SP)
    torch.cuda.synchronize()
    launches = ops.two_stage_count.launches
    if launches != INTERVALS:
        fail(f"count_accesses launched two_stage_count {launches} times over "
             f"{INTERVALS} intervals")

    cases = {}
    for name, (n_acc, c_nsp, pages, n) in COUNT_SHAPES.items():
        sp = rng.integers(-1, c_nsp, n_acc).astype(np.int32)
        pg = rng.integers(0, pages, n_acc).astype(np.int32)
        wr = rng.random(n_acc) < 0.3
        c_mon = np.full(n, -1, np.int32)
        c_mon[: max(n - 1, 1)] = rng.choice(c_nsp, max(n - 1, 1), replace=False)
        w = np.where(wr, 2, 1).astype(np.int32)
        args = on_card(sp, pg, w, c_mon)
        want = two_stage_count_ref(args[0], args[1], args[2], c_nsp, args[3], pages)
        got = ops.two_stage_count(*args, c_nsp, pages)  # the kernel, even for 0 accesses
        via = ops.count_accesses(*args, c_nsp, pages)
        torch.cuda.synchronize()
        same = all(bitwise_equal(torch, g, x) and bitwise_equal(torch, v_, x)
                   for g, v_, x in zip(got, via, want))
        cases[name] = same
        if not same:
            fail(f"two_stage_count kernel != plain version on case {name}")

    # timing at the main shape: the last interval (weights uint32 as int32)
    main_args = (t_sp, t_pg, t_w, t_mon)

    def kernel():
        ops.two_stage_count(*main_args, nsp, PAGES_PER_SP)

    def plain():
        two_stage_count_ref(t_sp, t_pg, t_w, nsp, t_mon, PAGES_PER_SP)

    # yardstick: two weighted torch.bincount calls, the sp -> row lookup and
    # the flat indices made beforehand (untimed); the port never calls it
    valid = t_sp >= 0
    table = torch.full((nsp,), -1, dtype=torch.int64, device=dev)
    keep = t_mon >= 0
    table[t_mon[keep].long()] = torch.arange(100, device=dev)[keep]
    row = torch.where(valid, table[t_sp.clamp(min=0).long()], -1)
    n_cells = 100 * PAGES_PER_SP
    idx = torch.where(row >= 0, row * PAGES_PER_SP + t_pg, n_cells)
    wf = (t_w * valid).float()
    sp_c = t_sp.clamp(min=0)

    def library():
        torch.bincount(sp_c, weights=wf, minlength=nsp)
        torch.bincount(idx, weights=wf, minlength=n_cells + 1)

    nbytes = a * (4 + 4 + 4) + 100 * 4 + (nsp + 100 * PAGES_PER_SP) * 4
    rec = {"phase": "count", "cases": cases, "launches": launches,
           "path": f"count_accesses over mcf's {INTERVALS} intervals", "accesses": a,
           "num_superpages": nsp, "monitored_rows": 100, "pages_per_sp": PAGES_PER_SP,
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    for name, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        rec[f"{name}event_ms"] = cuda_ms(torch, fn, reps=20)
        rec[f"{name}ms"], rec[f"{name}trace"] = device_ms(torch, fn, reps=20)
    emit(rec)
    return rec


def _param_count(state) -> dict:
    p = state["params"]
    total = sum(t.numel() for t in _leaves_of(p))
    return {"total": total, "token_table": p["embed"]["tok"].numel()}


def check_train(torch, np) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import train

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        res = train.main(TRAIN_ARGS + ["--ckpt-dir", ckpt, "--ckpt-every",
                                       str(10 * TRAIN_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_flash = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        saved = sorted(os.listdir(ckpt))
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, d, f))
                         for d in saved for f in os.listdir(os.path.join(ckpt, d)))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    cfg, hist, state = res["cfg"], res["history"], res["state"]
    losses = [h["loss"] for h in hist]
    want = cfg.num_layers * TRAIN_STEPS
    if (len(losses) != TRAIN_STEPS or res["start"] != 0
            or not all(np.isfinite(x) for x in losses)
            or not np.mean(losses[-5:]) < losses[0] or n_flash != want
            or saved != [f"step_{TRAIN_STEPS:08d}"]):
        fail(f"train: {len(losses)} losses {losses}, start {res['start']}, flash "
             f"launches {n_flash} (expected {want} = {cfg.num_layers} layers x "
             f"{TRAIN_STEPS} steps), checkpoints {saved}")
    args = dict(zip(TRAIN_ARGS[::2], TRAIN_ARGS[1::2]))
    b, s = int(args["--batch"]), int(args["--seq"])
    tokens = b * s
    steady = [h["time_s"] for h in hist[2:]]
    step_s = float(np.mean(steady))
    counts = _param_count(state)
    n_mm = counts["total"] - counts["token_table"]  # parameters in matrix products
    # causal attention: 4 * hd flops per unmasked (i, j) pair and head forward,
    # three times that with the backward
    attn_flops = 3 * 4 * cfg.head_dim * (s * (s + 1) // 2) * b * cfg.num_heads * cfg.num_layers
    model_flops = 6 * n_mm * tokens + attn_flops
    rec = {
        "phase": "train", "args": " ".join(TRAIN_ARGS), "layers": cfg.num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "steps": len(hist),
        "losses": losses, "first_step_ms": hist[0]["time_s"] * 1e3,
        "ms_per_step": step_s * 1e3, "ms_per_step_steps": "mean of steps 2..",
        "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
        "params": counts, "model_flops_per_step": model_flops,
        "mfu_bf16_dense_peak": model_flops / step_s / BF16_FLOPS_PER_S,
        "launches": {"flash_attention": n_flash}, "peak_device_bytes": peak,
        "wall_s": wall, "steps_s": sum(h["time_s"] for h in hist),
        "checkpoint_bytes": ckpt_bytes,
    }

    # profiled window: two more steps on the trained state (not counted above)
    data = SyntheticLM(cfg.vocab_size, s, b, seed=0, step=TRAIN_STEPS)
    step_fn = res["trainer"].step_fn
    del res
    batches = [data.next_batch() for _ in range(2)]
    state, _ = step_fn(state, batches[0])  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[1])
        float(m["loss"])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    busy = sum(ms for _, ms, _ in events)
    by = {}
    for key, ms, c in events:
        low = key.lower()
        kind = ("flash_attention" if "flash_attention_kernel" in key
                or "flash_attention_mma_kernel" in key
                else "gemm_fp32" if any(w in low for w in ("f32f32", "sgemm"))
                else "gemm" if any(w in low for w in ("gemm", "gemv", "nvjet", "cutlass"))
                else "other")
        by[kind] = by.get(kind, 0.0) + ms
    rec["profile"] = {
        "window_steps": 1, "wall_ms": window_ms,
        "device_busy_ms": busy if busy > 0 else "not measured",
        "device_idle_share": max(0.0, 1.0 - busy / window_ms) if busy > 0 else "not measured",
        "device_ops": sum(c for _, _, c in events), "device_ms_by_kind": by,
        "top_kernels": [[key, round(ms, 4), c] for key, ms, c in
                        sorted(events, key=lambda e: -e[1])[:15]],
    }
    rec["phases_ms"] = _step_phases(torch, cfg, state, data.next_batch())
    del state, step_fn, m
    torch.cuda.empty_cache()
    emit(rec)
    return rec


def _step_phases(torch, cfg, state, batch) -> dict:
    """CUDA-event time of one train step's parts, run one after the other as
    build_train_step runs them: forward + loss, backward, AdamW update."""
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.utils.tree import tree_leaves, tree_map

    dev = tree_leaves(state["params"])[0].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    marks[0].record()
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state["params"])]
    it = iter(leaves)
    loss = M.loss_fn(cfg, tree_map(lambda _: next(it), state["params"]), batch,
                     attn_impl="chunked", remat="none")
    marks[1].record()
    grads = torch.autograd.grad(loss, leaves)
    marks[2].record()
    it = iter(grads)
    adamw_update(AdamWConfig(), tree_map(lambda _: next(it), state["params"]), state["opt"],
                 state["params"], lr=1e-4)
    marks[3].record()
    torch.cuda.synchronize()
    names = ("forward_loss", "backward", "adamw")
    return {n: marks[i].elapsed_time(marks[i + 1]) for i, n in enumerate(names)}


def _golden_setup(torch, np, golden: dict, device):
    """(cfg, params, step builder, data factory) of a train golden file."""
    from repro_torch import configs, interop
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import AdamWConfig, linear_warmup_cosine
    from repro_torch.train.step import TrainStepConfig, build_train_step

    get = configs.get_reduced_config if golden["reduced"] else configs.get_config
    cfg = dataclasses.replace(get(golden["arch"]), num_layers=golden["num_layers"],
                              dtype="float32", param_dtype="float32")
    tree = interop.numpy_params(cfg, golden["seed"])
    digest = interop.weights_digest(tree)
    if digest != golden["weights_sha256"]:
        fail(f"train golden: numpy's stream made other weights here (sha256 {digest}, "
             f"golden {golden['weights_sha256']}); numpy {np.__version__}")
    params = interop.params_from_numpy(cfg, tree, device)
    del tree
    tcfg = TrainStepConfig(remat="none", attn_impl="chunked",
                           adamw=AdamWConfig(lr=golden["lr"]))

    def make_step(total_steps):
        lr = golden["lr"]
        return build_train_step(cfg, tcfg, lr_schedule=linear_warmup_cosine(
            lr, total_steps // 10 + 1, total_steps))

    def data(start=0):
        return SyntheticLM(cfg.vocab_size, golden["seq"], golden["batch"],
                           seed=golden["data_seed"], step=start)

    return cfg, params, make_step, data


def check_train_golden(torch, np, golden: dict, device) -> dict:
    """The port's float32 train steps vs the JAX golden (see
    scripts/make_torch_train_golden.py): same weights (digest), per-step loss
    and grad_norm, per-leaf parameter sums after the last step."""
    from repro_torch.optim import adamw_init
    from repro_torch.utils.tree import tree_items

    t0 = time.perf_counter()
    cfg, params, make_step, data = _golden_setup(torch, np, golden, device)
    setup_s = time.perf_counter() - t0
    state = {"params": params, "opt": adamw_init(params)}
    del params
    step, stream = make_step(golden["steps"]), data()
    hist = []
    for _ in range(golden["steps"]):
        state, m = step(state, stream.next_batch())
        hist.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr", "clip_scale")})
    want = golden["history"]
    loss_err = max(abs(h["loss"] - w["loss"]) / abs(w["loss"]) for h, w in zip(hist, want))
    gnorm_err = max(abs(h["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
                    for h, w in zip(hist, want))
    sums = {}
    for key, leaf in tree_items(state["params"]):
        sums[key] = float(leaf.double().sum())
    ref = golden["param_sums"]
    sum_err = max(abs(sums[k] - ref[k]["sum"]) / ref[k]["abs_sum"] for k in ref)
    rec = {"phase": "train_golden", "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "batch": golden["batch"], "seq": golden["seq"],
           "steps": golden["steps"], "dtype": "float32",
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32) if device.type == "cuda"
           else False, "weights_sha256": golden["weights_sha256"], "setup_s": setup_s,
           "losses": [h["loss"] for h in hist], "golden_losses": [w["loss"] for w in want],
           "loss_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL,
           "grad_norm_rel_err": gnorm_err, "grad_norm_rtol": TRAIN_GNORM_RTOL,
           "param_sum_err_over_abs_sum": sum_err, "param_sum_tol": TRAIN_SUM_TOL,
           "leaves": len(ref), "same_leaves": sorted(sums) == sorted(ref)}
    if device.type == "cuda":
        emit(rec)
    if (loss_err > TRAIN_LOSS_RTOL or gnorm_err > TRAIN_GNORM_RTOL
            or not rec["same_leaves"] or sum_err > TRAIN_SUM_TOL):
        fail(f"train golden: loss rel err {loss_err} (tol {TRAIN_LOSS_RTOL}), "
             f"grad_norm rel err {gnorm_err} (tol {TRAIN_GNORM_RTOL}), param sums "
             f"{sum_err} (tol {TRAIN_SUM_TOL}), leaves equal {rec['same_leaves']}")
    return rec


def check_train_resume(torch, np, golden: dict, device, directory: str) -> dict:
    """2 steps through a Trainer, its checkpoint restored into a fresh Trainer
    for 2 more, against 4 uninterrupted steps: the losses within RESUME_RTOL."""
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import LoopConfig, Trainer

    cfg, params, make_step, data = _golden_setup(torch, np, golden, device)
    step = make_step(4)
    state = {"params": params, "opt": adamw_init(params)}
    del params
    stream, whole = data(), []
    cur = state
    for _ in range(4):
        cur, m = step(cur, stream.next_batch())
        whole.append(float(m["loss"]))
    del cur

    def trainer(total, start):
        return Trainer(step, iter(data(start)), LoopConfig(
            total_steps=total, checkpoint_every=1000, checkpoint_dir=directory,
            log_every=1000))

    def like():
        zeros = _zeros_params(torch, cfg, device)
        return {"params": zeros, "opt": adamw_init(zeros)}

    t0 = time.perf_counter()
    first = trainer(2, 0)
    _, h1 = first.run(state, 0)
    del state, first
    second = trainer(4, 2)
    restored, start = second.ckpt.restore_or_init(like)
    _, h2 = second.run(restored, start)
    resumed = [h["loss"] for h in h1 + h2]
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole))
    rec = {"phase": "train_resume", "restored_step": start, "losses": resumed,
           "uninterrupted": whole, "rel_err": err, "rtol": RESUME_RTOL,
           "seconds": time.perf_counter() - t0}
    if device.type == "cuda":
        emit(rec)
    if start != 2 or len(resumed) != 4 or err > RESUME_RTOL:
        fail(f"train resume: restored step {start}, losses {resumed} vs "
             f"uninterrupted {whole} (rel err {err}, tol {RESUME_RTOL})")
    return rec


def _zeros_params(torch, cfg, device):
    """A parameter tree of `cfg`'s shapes and dtype on `device` (zeros): the
    structure a checkpoint is restored into."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import dtype_of

    def build(spec):
        if isinstance(spec, dict):
            return {k: build(v) for k, v in spec.items()}
        return torch.zeros(spec, dtype=dtype_of(cfg), device=device)

    return build(M.param_shapes(cfg))


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
        with open(TRAIN_GOLDEN) as f:
            train_golden = json.load(f)
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
    flash = timed("flash", check_flash, torch, np)
    count = timed("count", check_count, torch, np)
    trn = timed("train", check_train, torch, np)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        timed("train_golden", check_train_golden, torch, np, train_golden,
              torch.device("cuda"))
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_resume_")
        try:
            timed("train_resume", check_train_resume, torch, np, train_golden,
                  torch.device("cuda"), ckpt)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
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
            "ms_trace": counter["trace"], "timing": TIMING,
            "library": "three torch.bincount calls",
        },
        {
            "name": "tlb_walk_rainbow", "route": "cuda",
            "source": "src/repro_torch/csrc/tlb_walk.cu",
            "replaces": "src/repro/sim/tlbsim.py:328",
            "launches": e2e["launches"]["walk"], "max_abs_err": 0,
            "parity": "bitwise", "ms": walk["ms"], "plain_ms": walk["plain_ms"],
            "bound_ms": walk["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "event_ms": walk["event_ms"],
            "ms_trace": walk["trace"], "timing": WALK_TIMING,
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
            "ms_trace": attn["trace"], "timing": TIMING,
            "library": "F.scaled_dot_product_attention on the gathered, head-expanded K/V",
            "shape": attn["timed_shape"], "redesigned": 16, "ms_before": 0.0557,
        },
        {
            "name": "block_gather", "route": "cuda",
            "source": "src/repro_torch/csrc/block_gather.cu",
            "replaces": "src/repro/kernels/block_gather/block_gather.py:31",
            "launches": srv["launches"]["block_gather"], "max_abs_err": 0,
            "parity": "bitwise", "ms": gather["ms"], "plain_ms": gather["plain_ms"],
            "bound_ms": gather["bound_ms"], "bound_by": "bytes",
            "library_ms": gather["library_ms"], "event_ms": gather["event_ms"],
            "ms_trace": gather["trace"], "timing": TIMING,
            "library": "index_select + index_copy_ per pool on the valid lanes",
            "shape": gather["timed_shape"],
        },
        {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:70",
            "launches": trn["launches"]["flash_attention"],
            "max_abs_err": flash["worst_out_err"],
            "parity": (f"out atol=rtol {FLASH_TOL}; bf16 vs P in float32 "
                       f"{FLASH_BF16_P32_TOL}; lse {LSE_TOL}"),
            "ms": flash["ms"], "plain_ms": flash["plain_ms"],
            "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
            "library_ms": flash["library_ms"], "event_ms": flash["event_ms"],
            "ms_trace": flash["trace"], "timing": TIMING,
            "library": "F.scaled_dot_product_attention(is_causal=True), K/V expanded",
            "shape": flash["timed_shape"], "redesigned": 16, "ms_before": 2.62,
        },
        {
            "name": "two_stage_count", "route": "cuda",
            "source": "src/repro_torch/csrc/page_counter.cu",
            "replaces": "src/repro/kernels/page_counter/page_counter.py:78",
            "launches": count["launches"], "max_abs_err": 0, "parity": "bitwise",
            "ms": count["ms"], "plain_ms": count["plain_ms"],
            "bound_ms": count["bound_ms"], "bound_by": "bytes",
            "library_ms": count["library_ms"], "event_ms": count["event_ms"],
            "ms_trace": count["trace"], "timing": TIMING,
            "library": "two weighted torch.bincount calls",
            "path": count["path"],
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
