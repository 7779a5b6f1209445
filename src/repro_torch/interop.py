"""Carry state and parameters between this package and the JAX reference as numpy.

The reference's ``EngineState`` (``SimState`` + ``RainbowState``), its
serving ``RainbowKV`` and its model parameter tree share field names and
keys with this package's, so they are exchanged as nested numpy arrays
looked up by field name: attributes of the reference's objects (after
``jax.tree.map(np.asarray, state)``) or keys of nested dicts.  The
reference's uint16 stage counters and uint32 bitmap words travel in their
own dtypes; here they are int32.  bfloat16 arrays (numpy's ``bfloat16``
extension dtype, as JAX hands them out) become torch bfloat16 with the same
bits; numpy has no bfloat16 of its own, so they come back as float32, which
holds every bfloat16 value exactly.  No JAX import is needed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import typing

import numpy as np
import torch

from repro_torch.core.counting import Stage1State, Stage2State
from repro_torch.core.remap import RemapState
from repro_torch.engine.simloop import EngineState
from repro_torch.memory.kvcache import RainbowKV
from repro_torch.models import model as M

#: (port class, field) -> the reference's numpy dtype where it differs.
_REF_DTYPES = {
    (Stage1State, "counts"): np.uint16,
    (Stage2State, "counts"): np.uint16,
    (RemapState, "bitmap"): np.uint32,
}


def _is_record(cls) -> bool:
    return isinstance(cls, type) and issubclass(cls, tuple) and hasattr(cls, "_fields")


def _field(node, name: str):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr.view(np.uint16), copy=True).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.int32)
    elif arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_numpy(cls, tree, device="cpu"):
    """A port record of type `cls` from a numpy tree with the same field names."""
    hints = typing.get_type_hints(cls)
    vals = {}
    for name in cls._fields:
        sub = _field(tree, name)
        typ = hints[name]
        if _is_record(typ):
            vals[name] = from_numpy(typ, sub, device)
        elif typ is int:
            vals[name] = int(np.asarray(sub))
        else:
            vals[name] = _tensor(np.asarray(sub), device)
    return cls(**vals)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_numpy(record) -> dict:
    """A port record -> nested dict of numpy arrays in the reference's dtypes."""
    out = {}
    for name in record._fields:
        val = getattr(record, name)
        if _is_record(type(val)):
            out[name] = to_numpy(val)
            continue
        if isinstance(val, int):
            out[name] = np.int32(val)
            continue
        arr = _array(val)
        ref = _REF_DTYPES.get((type(record), name))
        if ref is np.uint16:
            arr = arr.astype(np.uint16)
        elif ref is np.uint32:
            arr = arr.view(np.uint32)
        out[name] = arr
    return out


def engine_state_from_numpy(tree, device="cpu") -> EngineState:
    """The reference's rainbow EngineState (as numpy, by field name) -> port state."""
    return from_numpy(EngineState, tree, device)


def engine_state_to_numpy(state: EngineState) -> dict:
    """Port EngineState -> nested dict of numpy arrays in the reference's dtypes."""
    return to_numpy(state)


def kv_from_numpy(tree, device="cpu") -> RainbowKV:
    """The reference's RainbowKV (as numpy, by field name) -> port RainbowKV."""
    return from_numpy(RainbowKV, tree, device)


def kv_to_numpy(kv: RainbowKV) -> dict:
    """Port RainbowKV -> nested dict of numpy arrays (the reference's dtypes,
    bfloat16 pools as float32), to compare field by field."""
    return to_numpy(kv)


def params_from_numpy(cfg, tree, device="cpu") -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's, on `device`.

    The keys and shapes must be those of ``models.model.init_params(cfg)``;
    dtypes are kept (bfloat16 stays bfloat16).
    """
    want = M.param_shapes(cfg)

    def conv(node, spec, path):
        if isinstance(spec, dict):
            got = sorted(node) if isinstance(node, dict) else type(node).__name__
            if got != sorted(spec):
                raise ValueError(f"params{path}: keys {got} != {sorted(spec)}")
            return {k: conv(node[k], spec[k], f"{path}.{k}") for k in spec}
        arr = np.asarray(node)
        if arr.shape != spec:
            raise ValueError(f"params{path}: shape {arr.shape} != {spec} for {cfg.name}")
        return _tensor(arr, device)

    return conv(tree, want, "")


def numpy_params(cfg, seed: int) -> dict:
    """Parameters of `cfg` in the reference's tree layout as float32 numpy
    arrays, drawn from ``numpy.random.default_rng(seed)`` (the same on any
    machine whose numpy keeps the stream; `weights_digest` checks that)."""
    f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    return _map(M.init_params(f32, np.random.default_rng(seed)), lambda t: t.numpy())


def weights_digest(tree) -> str:
    """sha256 over a parameter tree's leaves (sorted paths, shapes, bytes)."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
            return
        arr = np.ascontiguousarray(np.asarray(node))
        h.update(f"{path}:{arr.dtype.str}:{arr.shape}".encode())
        h.update(arr.tobytes())

    walk(tree, "")
    return h.hexdigest()


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}
