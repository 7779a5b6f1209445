"""Synthetic memory-access trace generation, calibrated to paper Tables I/II.

SPEC/Parsec/PBBS binaries are not available offline; the paper's own measured
statistics are the calibration targets instead (DESIGN.md Layer A):

  * footprint  -> page population size (scaled by SCALE_DOWN)
  * working set per interval -> pages touched per interval
  * hot-page % + CHOP 70%-rule -> fraction of accesses on the hot set
  * Table II  -> how hot pages cluster inside superpages
  * zipf alpha -> skew of accesses across hot pages

Traces are numpy (generation is host-side), staged to the device per run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.config import APPS, MIXES, PAGES_PER_SP, SCALE_DOWN, AppProfile

HOT_TRAFFIC_FRACTION = 0.70  # CHOP: hot pages receive 70% of references


@dataclasses.dataclass
class Trace:
    """One interval's accesses. sp/page identify the 4KB page; vpn = sp*512+page."""

    sp: np.ndarray  # int32[A] superpage id
    page: np.ndarray  # int32[A] page-in-superpage
    is_write: np.ndarray  # bool[A]
    num_superpages: int
    footprint_pages: int
    inst_per_access: float

    @property
    def vpn(self) -> np.ndarray:
        return self.sp.astype(np.int64) * PAGES_PER_SP + self.page


def _mb_to_pages(mb: float) -> int:
    return max(64, int(mb * 1024 * 1024 / 4096 / SCALE_DOWN))


def _pick_hot_pages(
    rng: np.random.Generator, prof: AppProfile, ws_pages: np.ndarray
) -> np.ndarray:
    """Choose hot pages inside the working set so their clustering across
    superpages follows the Table II bucket distribution."""
    n_hot = max(1, int(len(ws_pages) * prof.hot_page_pct / 100.0))
    sp_of = ws_pages // PAGES_PER_SP
    sps, counts = np.unique(sp_of, return_counts=True)
    probs = np.asarray(prof.sp_hot_dist, np.float64)
    probs = probs / probs.sum()
    uppers = np.array([32, 64, 128, 256, 384, 512])
    lowers = np.array([1, 33, 65, 129, 257, 385])

    hot: list[np.ndarray] = []
    order = rng.permutation(len(sps))
    budget = n_hot
    for i in order:
        if budget <= 0:
            break
        b = rng.choice(6, p=probs)
        lo, hi = lowers[b], uppers[b]
        want = int(rng.integers(lo, hi + 1)) // SCALE_DOWN or 1
        pages_here = ws_pages[sp_of == sps[i]]
        take = min(want, len(pages_here), budget)
        hot.append(rng.choice(pages_here, size=take, replace=False))
        budget -= take
    if not hot:
        return ws_pages[:1]
    return np.concatenate(hot)


HOT_CHURN = 0.08  # fraction of the hot set replaced per interval (phase drift)
WS_CHURN = 0.10


def generate_interval(
    prof: AppProfile, seed: int, interval: int, accesses: int | None = None
) -> Trace:
    """Generate one monitoring interval of accesses for an app.

    Hot/working sets are *persistent with slow churn* across intervals (derived
    deterministically from (seed, interval) so history-based policies see the
    temporal locality the paper measures; churn models phase drift).
    """
    rng0 = np.random.default_rng(seed & 0x7FFFFFFF)  # interval-invariant choices
    rng = np.random.default_rng((seed * 1000003 + interval * 7919) & 0x7FFFFFFF)
    fp_pages = _mb_to_pages(prof.footprint_mb)
    ws_pages_n = min(_mb_to_pages(prof.working_set_mb), fp_pages)
    a = accesses or prof.accesses_per_interval

    # Base working set (stable): contiguous block + scattered tail.
    ws_start = int(rng0.integers(0, max(fp_pages - ws_pages_n, 1)))
    ws_pages = np.arange(ws_start, ws_start + ws_pages_n, dtype=np.int64)
    # scattered tail clusters inside a few superpages (Table II: references
    # concentrate within superpages even for irregular apps)
    n_scatter = ws_pages_n // 4
    if n_scatter:
        n_sp = max(1, fp_pages // PAGES_PER_SP)
        n_scatter_sp = max(1, n_scatter // (PAGES_PER_SP // 4))
        homes = rng0.integers(0, n_sp, n_scatter_sp) * PAGES_PER_SP
        offs = rng0.integers(0, min(PAGES_PER_SP, fp_pages), n_scatter)
        ws_pages[-n_scatter:] = np.minimum(
            homes[rng0.integers(0, n_scatter_sp, n_scatter)] + offs, fp_pages - 1
        )
    # Hot pages are selected from the STABLE base working set (before churn)
    # so the rng0 stream — and therefore the hot set and its zipf rank order —
    # is identical across intervals (the paper's history-based premise).
    hot = _pick_hot_pages(rng0, prof, ws_pages.copy())

    # churn: replace a slice of the ws per interval (phase drift)
    n_churn = int(ws_pages_n * WS_CHURN)
    if n_churn and interval:
        idx = (np.arange(n_churn) + interval * n_churn) % ws_pages_n
        ws_pages[idx] = rng.integers(0, fp_pages, n_churn)
    n_hot_churn = int(len(hot) * HOT_CHURN)
    if n_hot_churn and interval:
        idx = (np.arange(n_hot_churn) + interval * n_hot_churn) % len(hot)
        hot = hot.copy()
        hot[idx] = rng.choice(ws_pages, size=n_hot_churn)

    n_hot_acc = int(a * HOT_TRAFFIC_FRACTION)
    n_cold_acc = a - n_hot_acc

    # zipf-ranked hot accesses (rank order stable across intervals)
    ranks = np.arange(1, len(hot) + 1, dtype=np.float64)
    w = ranks ** (-prof.zipf_alpha)
    w /= w.sum()
    hot_idx = rng.choice(len(hot), size=n_hot_acc, p=w)
    hot_acc = hot[hot_idx]
    cold_acc = rng.choice(ws_pages, size=n_cold_acc)

    pages = np.concatenate([hot_acc, cold_acc])
    rng.shuffle(pages)
    is_write = rng.random(a) < prof.write_ratio

    num_sp = (fp_pages + PAGES_PER_SP - 1) // PAGES_PER_SP
    return Trace(
        sp=(pages // PAGES_PER_SP).astype(np.int32),
        page=(pages % PAGES_PER_SP).astype(np.int32),
        is_write=is_write,
        num_superpages=int(num_sp),
        footprint_pages=int(fp_pages),
        inst_per_access=prof.inst_per_access,
    )


def generate_mix(
    mix: str, seed: int, interval: int, accesses_per_app: int | None = None
) -> Trace:
    """Interleave member apps' traces in a shared (offset) address space."""
    members = MIXES[mix]
    traces = []
    sp_base = 0
    for i, name in enumerate(members):
        t = generate_interval(APPS[name], seed + i, interval, accesses_per_app)
        traces.append((t, sp_base))
        sp_base += t.num_superpages
    a = sum(t.sp.shape[0] for t, _ in traces)
    sp = np.concatenate([t.sp + base for t, base in traces])
    page = np.concatenate([t.page for t, _ in traces])
    wr = np.concatenate([t.is_write for t, _ in traces])
    # round-robin interleave by shuffling with a fixed permutation
    rng = np.random.default_rng(seed)
    perm = rng.permutation(a)
    ipa = float(np.mean([t.inst_per_access for t, _ in traces]))
    return Trace(
        sp=sp[perm],
        page=page[perm],
        is_write=wr[perm],
        num_superpages=sp_base,
        footprint_pages=sum(t.footprint_pages for t, _ in traces),
        inst_per_access=ipa,
    )


def generate(name: str, seed: int, interval: int, accesses: int | None = None) -> Trace:
    """One interval of a numpy app profile or mix."""
    if name in MIXES:
        per_app = (accesses // len(MIXES[name])) if accesses else None
        return generate_mix(name, seed, interval, per_app)
    if name in APPS:
        return generate_interval(APPS[name], seed, interval, accesses)
    raise _not_ported(name)


def _not_ported(name: str) -> Exception:
    return NotImplementedError(
        f"{name!r} is not an app profile or mix; workload scenarios are not "
        "ported yet (ROADMAP.md Queue 1 item 10)"
    )


def probe_meta(name: str, accesses: int | None = None) -> dict:
    """Shape metadata of `generate(name, ...)` without materializing accesses.

    Seed/interval-invariant by construction (footprints and access counts are
    profile-derived).  Keys match engine.simloop.make_chunks_np meta.
    """
    if name not in APPS and name not in MIXES:
        raise _not_ported(name)

    def one(prof: AppProfile, a: int | None) -> tuple[int, int, int, float]:
        fp = _mb_to_pages(prof.footprint_mb)
        nsp = (fp + PAGES_PER_SP - 1) // PAGES_PER_SP
        return fp, nsp, a or prof.accesses_per_interval, prof.inst_per_access

    if name in MIXES:
        per_app = (accesses // len(MIXES[name])) if accesses else None
        parts = [one(APPS[m], per_app) for m in MIXES[name]]
        fp = sum(p[0] for p in parts)
        nsp = sum(p[1] for p in parts)
        a = sum(p[2] for p in parts)
        ipa = float(np.mean([p[3] for p in parts]))
    else:
        fp, nsp, a, ipa = one(APPS[name], accesses)
    return {
        "num_superpages": nsp,
        "footprint_pages": fp,
        "inst_per_access": ipa,
        "accesses_per_interval": a,
    }
