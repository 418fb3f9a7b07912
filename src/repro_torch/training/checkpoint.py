"""numpy checkpoints of parameter trees, in the JAX package's layout.

A directory per step, ``step_XXXXXXXX/``, holds ``arrays.npz`` (the leaves
as ``leaf_i``, in JAX's flattening order: dict keys sorted, lists in
order) and ``meta.json`` (``step``, ``treedef``, ``n_leaves``,
``metadata``).  A checkpoint written by ``repro.training`` restores here
and one written here restores there: both check only the leaf count and
the shapes against the target.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.tree import describe, leaves, unflatten


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None, keep: int = 3) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = leaves(tree)
    np.savez(
        os.path.join(tmp, "arrays.npz"),
        **{f"leaf_{i}": _host(l) for i, l in enumerate(flat)},
    )
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(
            {
                "step": step,
                "treedef": describe(tree),
                "n_leaves": len(flat),
                "metadata": metadata or {},
            },
            f,
        )
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _gc(ckpt_dir, keep)
    return path


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_")
        and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int,
                       target: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target`` (shapes validated): each
    leaf a tensor on the device of the target's leaf it replaces."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    t_leaves = leaves(target)
    if len(t_leaves) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, target {len(t_leaves)}"
        )
    for i, (a, b) in enumerate(zip(arrays, t_leaves)):
        if tuple(a.shape) != tuple(np.shape(b)):
            raise ValueError(f"leaf {i} shape {a.shape} != target "
                             f"{tuple(np.shape(b))}")
    out = [torch.from_numpy(np.array(a, copy=True)).to(
        b.device if torch.is_tensor(b) else "cpu")
        for a, b in zip(arrays, t_leaves)]
    return unflatten(target, out), meta["metadata"]
