"""The slice end to end: repro_torch.sim.runner.simulate(app, "rainbow") on the
CPU gives SimMetrics bitwise equal to the JAX package's, under both counter
backends; the entry point's device and import contracts."""
import functools
import os
import subprocess
import sys

import pytest
import torch

from repro.sim import runner as ref_runner
from repro_torch.sim import runner
from torch_port_util import metrics_diff

APPS = ["streamcluster", "DICT", "mcf", "mix1"]


@functools.lru_cache(maxsize=None)
def _reference(app: str):
    return ref_runner.simulate(app, "rainbow", intervals=2, accesses=4000)


@pytest.mark.parametrize("backend", ["kernel", "scatter"])
@pytest.mark.parametrize("app", APPS)
def test_simulate_bitwise_equal_to_reference(app, backend):
    port = runner.simulate(app, "rainbow", intervals=2, accesses=4000,
                           counter_backend=backend, device="cpu")
    assert not metrics_diff(_reference(app), port)


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.simulate("streamcluster", "rainbow", intervals=1, accesses=100)


@pytest.mark.parametrize("kwargs,item", [
    (dict(policy="hscc-4kb-mig"), "item 6"),
    (dict(policy="dram-only"), "item 6"),
    (dict(policy="nomad"), "item 9"),
    (dict(timing_model="queueing"), "item 8"),
    (dict(fused=True), "item 10"),
    (dict(app="stress/phase-shift"), "item 10"),
])
def test_outside_the_slice_raises(kwargs, item):
    kw = dict(app="streamcluster", policy="rainbow", intervals=1, accesses=100,
              device="cpu")
    kw.update(kwargs)
    with pytest.raises(NotImplementedError, match=item):
        runner.simulate(**kw)


def test_unknown_counter_backend_raises():
    with pytest.raises(ValueError, match="counter_backend"):
        runner.simulate("streamcluster", "rainbow", intervals=1, accesses=100,
                        counter_backend="jax", device="cpu")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.sim.runner, repro_torch.interop, repro_torch.kernels.build\n"
        "repro_torch.sim.runner.simulate('streamcluster', 'rainbow', "
        "intervals=1, accesses=200, device='cpu')\n"
        "bad = [k for k in sys.modules if k in ('jax', 'repro') "
        "or k.startswith(('jax.', 'repro.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
