"""Checkpoints in the JAX package's layout (``ft/checkpoint.py``), so that
either package restores the other's::

    <dir>/step_000100/
        manifest.json            # step, keys, shapes, dtypes
        host0000.npz             # this process's arrays
    <dir>/LATEST                 # the newest complete step, renamed into place

Keys are the JAX tree paths of the saved tree (``tree.flatten_with_paths``:
``params/mlp/w/0``, ``opt/.step``, ``opt/.m/users``), with ``/`` written as
``__`` inside the ``.npz``. Every file is written to a temporary name,
fsynced and renamed, the shard before the manifest and the manifest before
``LATEST``: a crash mid-save leaves ``LATEST`` on the previous step.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import flatten_with_paths, tree_unflatten


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _write_atomic(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    process_index: int = 0, n_processes: int = 1) -> str:
    """Write this process's arrays and (process 0) the manifest, then move
    LATEST to this step. Returns the step's directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    arrays = {k: _host_array(v) for k, v in flatten_with_paths(tree)}

    tmp = tempfile.NamedTemporaryFile(
        dir=step_dir, prefix=f"host{process_index:04d}_", suffix=".tmp",
        delete=False)
    np.savez(tmp, **{k.replace("/", "__"): v for k, v in arrays.items()})
    tmp.flush()
    os.fsync(tmp.fileno())
    tmp.close()
    os.replace(tmp.name, os.path.join(step_dir,
                                      f"host{process_index:04d}.npz"))

    if process_index == 0:
        manifest = {
            "step": step,
            "n_processes": n_processes,
            "keys": list(arrays),
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
        }
        _write_atomic(os.path.join(step_dir, "manifest.json"),
                      json.dumps(manifest))
        _write_atomic(os.path.join(ckpt_dir, "LATEST"), f"step_{step:08d}")
    return step_dir


def latest_step(ckpt_dir: str) -> Optional[int]:
    lp = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(lp):
        return None
    with open(lp) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore_checkpoint(ckpt_dir: str, tree_like: Any,
                       step: Optional[int] = None, device="cuda",
                       process_index: int = 0) -> Any:
    """Restore into the structure of ``tree_like`` (its leaves' shapes are
    checked against the checkpoint's), as tensors on ``device``."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    with np.load(os.path.join(step_dir,
                              f"host{process_index:04d}.npz")) as data:
        for key, like in flatten_with_paths(tree_like):
            arr = data[key.replace("/", "__")]
            exp = tuple(manifest["shapes"][key])
            if tuple(arr.shape) != exp:
                raise ValueError(f"checkpoint shape mismatch at {key}: "
                                 f"{arr.shape} vs manifest {exp}")
            if hasattr(like, "shape") and tuple(like.shape) != arr.shape:
                raise ValueError(
                    f"restore template mismatch at {key}: checkpoint has "
                    f"{arr.shape}, template expects {tuple(like.shape)}")
            leaves.append(torch.from_numpy(arr).to(dev))
    return tree_unflatten(tree_like, leaves)


def prune_old_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
