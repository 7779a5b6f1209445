"""Carry engine state between this package and the JAX reference as numpy.

The reference's ``EngineState`` (``SimState`` + ``RainbowState``) and this
package's share field names, so a state is exchanged as nested numpy arrays
looked up by field name: attributes of the reference's objects (after
``jax.tree.map(np.asarray, state)``) or keys of nested dicts.  The
reference's uint16 stage counters and uint32 bitmap words travel in their
own dtypes; here they are int32.  No JAX import is needed.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from repro_torch.core.counting import Stage1State, Stage2State
from repro_torch.core.remap import RemapState
from repro_torch.engine.simloop import EngineState

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
        vals[name] = (from_numpy(typ, sub, device) if _is_record(typ)
                      else _tensor(np.asarray(sub), device))
    return cls(**vals)


def to_numpy(record) -> dict:
    """A port record -> nested dict of numpy arrays in the reference's dtypes."""
    out = {}
    for name in record._fields:
        val = getattr(record, name)
        if _is_record(type(val)):
            out[name] = to_numpy(val)
            continue
        arr = val.detach().cpu().numpy()
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
