"""Checkpointing in the reference's format: npz shards + a JSON manifest.

``directory/step_<N>/`` holds ``shard_<pid>.npz`` (one array per leaf, keyed
by its path with "/" written as "|") and ``manifest.json`` (step, each
leaf's shape, dtype name and a sha256 prefix of its bytes).  bfloat16 leaves
are stored as their uint16 bits under the dtype name "bfloat16".  The
layout, keys and checksums are those of ``repro.checkpoint.store``, so
either package restores the other's checkpoints.  Writes are atomic (tmp
dir, then rename); retention keeps the newest `keep_last`.  One process
writes everything here (tp = 1, one host).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.utils.tree import tree_items, tree_map

MANIFEST = "manifest.json"


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """(numpy array as stored, dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz can't hold bfloat16; store bits
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_state(
    directory: str,
    step: int,
    state: Any,
    keep_last: int = 3,
) -> str:
    """Atomically write `state` under directory/step_<N>/. Returns final path."""
    pid = 0  # the one process; the reference names shards by process index
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp.{pid}.{int(time.time() * 1e6)}"
    os.makedirs(tmp, exist_ok=True)

    arrays = {}
    manifest_leaves = {}
    for key, leaf in tree_items(state):
        arr, dtype_name = _host_array(leaf)
        arrays[key] = arr
        manifest_leaves[key] = {
            "shape": list(arr.shape),
            "dtype": dtype_name,
            "crc": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
        }
    shard_file = os.path.join(tmp, f"shard_{pid:05d}.npz")
    np.savez(shard_file, **{k.replace("/", "|"): v for k, v in arrays.items()})
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump({"step": step, "leaves": manifest_leaves, "num_processes": 1,
                   "time": time.time()}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    _gc(directory, keep_last)
    return final


def _gc(directory: str, keep_last: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.count(".tmp")
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    for d in os.listdir(directory):  # orphaned tmp dirs from crashes
        if ".tmp." in d:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and ".tmp" not in d
        and os.path.exists(os.path.join(directory, d, MANIFEST))
    ]
    return max(steps) if steps else None


def restore_state(
    directory: str,
    like: Any,
    step: int | None = None,
    verify: bool = True,
) -> tuple[Any, int]:
    """Restore into the structure of `like` (a tree of tensors): each leaf
    takes its prototype's dtype and device."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)

    arrays: dict[str, np.ndarray] = {}
    for fname in sorted(os.listdir(path)):
        if fname.startswith("shard_") and fname.endswith(".npz"):
            with np.load(os.path.join(path, fname)) as z:
                for k in z.files:
                    arrays[k.replace("|", "/")] = z[k]

    if verify:
        for key, info in manifest["leaves"].items():
            if key not in arrays:
                raise ValueError(f"checkpoint missing leaf {key}")
            crc = hashlib.sha256(arrays[key].tobytes()).hexdigest()[:16]
            if crc != info["crc"]:
                raise ValueError(f"checksum mismatch for {key}")

    keys = iter(k for k, _ in tree_items(like))

    def load(proto):
        key = next(keys)
        arr = arrays[key]
        if manifest["leaves"][key]["dtype"] == "bfloat16":  # the stored uint16 bits
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=proto.device, dtype=proto.dtype)

    return tree_map(load, like), step


class CheckpointManager:
    """Train-loop helper: periodic + emergency (preemption) checkpointing."""

    def __init__(self, directory: str, every_steps: int = 100, keep_last: int = 3):
        self.directory = directory
        self.every = every_steps
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        if force or (step > 0 and step % self.every == 0):
            save_state(self.directory, step, state, self.keep_last)
            return True
        return False

    def restore_or_init(self, init_fn: Callable[[], Any]):
        """(state, step): the newest checkpoint restored into the structure,
        dtypes and devices of ``init_fn()``, or ``(init_fn(), 0)`` if none."""
        step = latest_step(self.directory)
        if step is None:
            return init_fn(), 0
        return restore_state(self.directory, init_fn(), step)
