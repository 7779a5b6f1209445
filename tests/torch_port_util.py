"""Shared helpers of the differential tests that hold repro_torch against repro."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch


def t(x) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor, uint16/uint32 carried as int32,
    bfloat16 kept as bfloat16 (same bits)."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr.view(np.uint16), copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.int32)
    elif arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True))


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes (so float32 is compared bit for bit)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def tree_diff(port: dict, ref, path: str = "") -> list[str]:
    """Paths where a port numpy tree (interop.to_numpy) differs from the
    reference object tree (fields read by name); the reference's bfloat16
    arrays are compared as the float32 the port's tree holds."""
    bad = []
    for name, val in port.items():
        sub = ref[name] if isinstance(ref, dict) else getattr(ref, name)
        if isinstance(val, dict):
            bad += tree_diff(val, sub, f"{path}.{name}")
            continue
        want = np.asarray(sub)
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        if not same_bits(val, want):
            bad.append(f"{path}.{name}")
    return bad


def metrics_diff(ref, port) -> dict:
    """Fields where two SimMetrics differ (floats compared exactly)."""
    a, b = dataclasses.asdict(ref), dataclasses.asdict(port)
    return {k: (a[k], b.get(k)) for k in a if a[k] != b.get(k)}


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none (decided in the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
