"""Device meshes — the port of ``repro.launch.mesh``.

A :class:`Mesh` is a grid of ``torch.device``s with named axes, as a JAX
mesh is a grid of JAX devices.  The same device may appear more than once:
that is how two tensor-parallel ranks share one card, or run on the CPU in
the tests.  Pods are cut from the device list by position.  Nothing here
touches a card when it is imported.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

#: NVIDIA H100 SXM5 (700 W), per card, from NVIDIA's H100 Tensor Core GPU
#: data sheet: HBM3 bytes/s, dense peak flop/s by operand type (bf16 on
#: the tensor cores, fp32 outside them), and NVLink 4's bytes/s in each
#: direction (900 GB/s in all, 18 links)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
NVLINK_BYTES_S = 450e9


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


def _resolve(d) -> torch.device:
    d = torch.device(d)
    return d if d.type == "meta" else resolve_device(d)


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
        grid[i] = _resolve(d)
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



def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes over the meta device: 16 x 16
    ``("data", "model")`` (256 ranks), or 2 x 16 x 16 ``("pod", "data",
    "model")`` (512) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=["meta"] * int(np.prod(shape)))


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# --------------------------------------------------------------------------- #
# Collectives: the data the port moves between ranks
# --------------------------------------------------------------------------- #

#: XLA's collective kinds, the keys of the reference's ``collective_bytes``.
#: The port records: an "all-reduce" for a sum (or max) of the ranks'
#: partials that every rank reads, the context-parallel cache's merge of
#: the data indices' attention partials among them; an "all-gather" where
#: every rank (or rank 0) reads every rank's piece (the logits, the
#: ZeRO-1 and ZeRO-3 param gathers, a sequence-sharded cache's query
#: heads); a "reduce-scatter" for ZeRO's gradient sums; an "all-to-all"
#: where each rank sends each other rank the part that rank owns (the
#: sequence-sharded cache's new K/V rows, sent to the ranks that own
#: their positions, and its attention partials, sent to the ranks that
#: own their heads); a "collective-permute" where one rank sends the
#: others its data (the MoE routing from rank 0).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COUNTERS: List[Dict[str, float]] = []


def collective(kind: str, nbytes: float) -> None:
    """Record one collective of ``kind`` whose output on each device is
    ``nbytes`` (as XLA's per-device count of a collective's output
    operand) in every active :func:`counting_collectives`; nothing when
    none is active."""
    for c in _COUNTERS:
        c[kind] += float(nbytes)
        c["count"] += 1


@contextlib.contextmanager
def counting_collectives():
    """Count the collectives recorded while the block runs; yields the
    dict of the reference's keys (bytes by kind, ``count``), whose
    ``total`` is set when the block ends."""
    c: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    c["count"] = 0
    _COUNTERS.append(c)
    try:
        yield c
    finally:
        _COUNTERS.remove(c)
        c["total"] = sum(c[k] for k in COLLECTIVES)
