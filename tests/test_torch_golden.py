"""The golden file the GPU smoke test holds the port to
(tests/data/torch_rainbow_golden.json, written by scripts/make_torch_golden.py)
still matches the JAX package, so it cannot drift from the reference."""
import dataclasses
import importlib.util
import json
import os

import pytest

from repro_torch.sim.runner import SimMetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_rainbow_golden.json")


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(ROOT, "scripts", "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_covers_the_chip_apps_and_every_field(golden):
    maker = _maker()
    assert sorted(golden["apps"]) == sorted(maker.GOLDEN_APPS)
    assert golden["intervals"] == maker.INTERVALS and golden["seed"] == maker.SEED
    fields = {f.name for f in dataclasses.fields(SimMetrics)}
    for app, entry in golden["apps"].items():
        assert set(entry) == fields, app


def test_mcf_entry_matches_the_reference(golden):
    assert _maker().golden_entry("mcf") == golden["apps"]["mcf"]
