#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one GPU and hold its kernels to account.

    python3 chip_smoke.py          # from the repository root, on a CUDA machine

Phases, each printed as a JSON record on its own line:

1. device: the card's name, the device count and its power limit;
2. build: both CUDA kernels compiled from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel);
3. counter: the fused observe counter kernel against its plain version,
   bitwise, at the main path's shapes and on edge cases;
4. walk: the interval-walk kernel against the plain walker, bitwise, over the
   whole SimState;
5. e2e: ``simulate(app, "rainbow", intervals=8)`` for mcf, GUPS and mix1 at
   each app's own accesses per interval, bitwise equal to the JAX golden
   file ``tests/data/torch_rainbow_golden.json``, with each kernel launched
   exactly once per interval;
6. the ``{"kernels": [...]}`` line: each kernel's launches, time, bound, the
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
E2E_APPS = ("mcf", "GUPS", "mix1")
INTERVALS = 8
SEED = 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)

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
    """Same dtype, shape and bits (float32 compared as int32 patterns)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
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
    except (ImportError, OSError) as exc:
        print(f"chip_smoke: the repository is not here ({exc})", file=sys.stderr)
        return 1
    os.makedirs(out_dir, exist_ok=True)

    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = build.build()
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for name, info in built.items():
            f.write(f"== {name}\n{info['ptxas']}\n")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: v["seconds"] for k, v in built.items()}})

    counter = check_counter(torch, np)
    walk = check_walk(torch, np)
    e2e = check_e2e(torch, golden)
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
