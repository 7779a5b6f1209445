"""Write the JAX package's full-size rainbow SimMetrics as the port's golden file.

Runs ``repro.sim.runner.simulate(app, "rainbow", intervals=8, seed=7)`` at each
app's own ``accesses_per_interval`` with the default ``MachineConfig()`` and
stores every ``SimMetrics`` field in ``tests/data/torch_rainbow_golden.json``.
Floats are written with ``float.hex`` so the file holds them bit for bit;
``chip_smoke.py`` reads the file back without importing JAX.

    PYTHONPATH=src python scripts/make_torch_golden.py [--apps mcf GUPS mix1]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

GOLDEN_APPS = ("mcf", "GUPS", "mix1")
INTERVALS = 8
SEED = 7
OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "data", "torch_rainbow_golden.json",
)


def encode(value):
    """SimMetrics field value -> JSON value (floats as float.hex)."""
    if isinstance(value, dict):
        return {k: encode(v) for k, v in value.items()}
    if isinstance(value, bool) or isinstance(value, (int, str)):
        return value
    if isinstance(value, float):
        return {"hex": float(value).hex()}
    raise TypeError(f"unexpected SimMetrics field type {type(value).__name__}")


def golden_entry(app: str) -> dict:
    from repro.sim.runner import simulate

    m = simulate(app, "rainbow", intervals=INTERVALS, seed=SEED)
    return {f.name: encode(getattr(m, f.name)) for f in dataclasses.fields(m)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--apps", nargs="+", default=list(GOLDEN_APPS))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    doc = {
        "reference": "repro.sim.runner.simulate(app, 'rainbow', "
                     f"intervals={INTERVALS}, seed={SEED}), MachineConfig()",
        "intervals": INTERVALS,
        "seed": SEED,
        "apps": {},
    }
    if os.path.exists(args.out):
        with open(args.out) as f:
            doc["apps"].update(json.load(f).get("apps", {}))
    for app in args.apps:
        doc["apps"][app] = golden_entry(app)
        print(f"{app}: done", flush=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
