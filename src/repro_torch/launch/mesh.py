"""Device meshes — the port of ``repro.launch.mesh``.

A :class:`Mesh` is a grid of ``torch.device``s with named axes, as a JAX
mesh is a grid of JAX devices.  The same device may appear more than once:
that is how two tensor-parallel ranks share one card, or run on the CPU in
the tests.  Pods are cut from the device list by position.  Nothing here
touches a card when it is imported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` shaped like the
    mesh (as ``jax.sharding.Mesh.devices``); ``axis_names`` name its
    axes."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def ranks(self) -> List[torch.device]:
        """The devices in row-major order: rank r of a ``("model",)`` mesh
        holds the r-th shard."""
        return list(self.devices.ravel())


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device once (empty without a card)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape, axes=("data", "model"), *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the first ``prod(shape)`` of ``devices`` (default: every
    visible CUDA device once).  Raises ``ValueError`` when ``shape`` and
    ``axes`` differ in length and ``RuntimeError`` when there are too few
    devices."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} / axes {tuple(axes)} mismatch")
    n = int(np.prod(shape))
    devices = list(visible_devices() if devices is None else devices)
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {len(devices)} — pass "
            "devices= (a device may be listed more than once)")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = resolve_device(d)
    return Mesh(grid.reshape(shape), tuple(axes))


def pod_meshes(mesh) -> List[Mesh]:
    """Split a (…, data, model) mesh into independent single-axis
    ``("model",)`` meshes, one per data row: each data-parallel pod is a
    tensor-parallel island, and the frontend places whole requests on one
    pod."""
    if "model" not in mesh.axis_names:
        raise ValueError(f"mesh has no 'model' axis: {mesh.axis_names}")
    tp = int(mesh.devices.shape[list(mesh.axis_names).index("model")])
    rows = np.asarray(mesh.devices).reshape(-1, tp)
    return [make_mesh((tp,), ("model",), devices=list(row)) for row in rows]

