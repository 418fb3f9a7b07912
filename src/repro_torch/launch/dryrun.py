"""Dry run of every (arch x input shape x mesh) on the meta device: the
port of ``repro.launch.dryrun``.

For each combination it builds the production mesh over the meta device
(16 x 16 ``("data", "model")``, or 2 x 16 x 16 with a ``"pod"`` axis),
lays out the per-rank parameters (``partition.shard_params``, each rank
with its own copy of the replicated leaves, as on separate cards), the
per-rank caches (``transformer.init_cache(mesh=pod)``, int8 too) and,
for training, the ZeRO-1 moments (``steps.zero1_init``), and runs the
step (train, prefill or decode) of one pod over the batch rows one data
index holds (``steps.pod_rows``) on meta tensors, which have shapes and
dtypes and allocate nothing.  It records per device:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count, which
  takes the matmul-family ops (elementwise ops count nothing, so the adds
  of a cross-rank sum count nothing either) and each kernel wrapper as
  one op with its shape-only formula (``kernels.ops``);
* ``bytes_accessed``: the bytes of every op's tensor operands and
  results (views excluded), as XLA's "bytes accessed" counts an HLO op's
  (an in-place write, as XLA's in-place dynamic-update-slice, counts the
  bytes it writes, and a gather the rows it reads, not the whole buffer
  or table);
* ``memory_analysis``: the bytes of the step's arguments (the unique
  storages of params, cache or moments, and batch rows), of its outputs
  (``alias`` those that are arguments: the cache updated in place),
  ``temp``: the most bytes of storage the step made that were alive at
  once, and ``peak`` the arguments plus that;
* ``collectives``: the reference's keys, counted where the port moves
  data between ranks (``launch.mesh.collective``: the ranks' sums, the
  gated norm's sum of squares, the MoE routing sent from rank 0, the
  int8 writes' max, the logits gathered on rank 0, ZeRO's gradient sum
  and param gathers, and a split cache's moves: ``models.kv_split``).
  The reference parses them from XLA's optimized HLO (its
  ``collective_bytes``); the port has no HLO, so its counter fills the
  same dict, one entry per collective with its output bytes on one device.

One process runs every rank of the pod, and the counters charge each
op to the rank whose loop runs it: the model's loops over a pod's
ranks mark the rank (``ranks.ranked``), a kernel wrapper's op over
every rank is one op a rank, the backward's ops take the rank of the
autograd node that runs them (a hook marks it), and an op outside every
rank loop is rank 0's, which runs it in a real pod (the sums of the
ranks' partials and the logits gathered on rank 0's device, the MoE
routing, the loss, ZeRO's gathers of the pod's pieces).  ``flops``,
``bytes_accessed`` and ``memory_analysis`` report the busiest rank's
figure of each (:func:`measure`), as the reference's padded GSPMD shards
are the largest shard's; a rank's arguments are its own params, cache
or moments and the batch rows every rank holds.  The pod's totals stay
in the record beside them, for the checks against a run of the whole
pod on one card: ``cost_analysis["pod flops"]`` and
``memory_analysis``'s ``pod_argument_size_in_bytes`` and
``pod_peak_memory_in_bytes``.  Collectives are counted once per
operation, which is each device's count already.  The remat'd layers'
recomputation stops where the step's own does (``torch.utils.checkpoint``'s
early stop: once the backward has every saved activation back), so the
pod's totals are the step's.  One process runs the ranks in turn, so it
stops after the last rank's last saved activation: the last rank is
charged what it recomputes on a card of its own, and each earlier rank
also the ops of its layers after its own last one (its MLP slice's down
projection), which it would skip there.  A train record's busiest rank
is over by those ops (4.8% of a (2, 2) step of the reduced qwen2-1.5b
at 2 layers); one rank is exact.  ``lower_s`` is the
trace's time; ``compile_s`` is 0.0: nothing is compiled, the port's
kernels being built once by nvcc (``kernels.build``) and its model run
eagerly.  The cost analysis's ``optimal_seconds`` is the card's roofline
of the record: the largest of its flops, bytes and collective bytes over
``launch.mesh``'s H100 rates (NVLink for the collectives).

Heads and widths the model axis does not divide are laid out as whole
units, the first ranks one more (``partition.split_range``; qwen2-1.5b's
12 heads over 16 ranks leave four ranks none).  The cache takes the
layout the reference's ``cache_pspecs`` picks for ``kv_shard``
(``partition.kv_layout``): "auto" the heads where the model axis divides
the KV heads, else the sequence (``models.kv_split``: every KV head over
a range of rows a rank), "seq", "head_dim" or "heads" as asked; a decode
whose global batch is under 16 (long_500k) the context-parallel cache
(:func:`context_parallel`: its data index's rows, the head layout on
"model", every batch row); the record's ``kv_shard`` names the layout
laid out ("heads" for the context-parallel one, whose heads are on
"model").  ``params_data_sharded`` is ZeRO-3 (``steps.zero3_shard``:
each rank its data index's slice of its leaves, gathered in the step).
``moe_scheme`` is the reference's: "tensor" (each routed expert's
hidden axis on "model") or "expert" (whole experts a rank,
``partition.expert_range``; where the ranks do not divide the experts the
first ranks hold one more, and a rank may hold none).  :func:`lower_one`
keeps two of the reference's arguments only for signature parity, so
that its calls run unchanged: ``save_record``, unused there as here
(:func:`main` saves), and ``attn_head_shard``, which changes nothing
because the port always splits attention by head (the record echoes it).

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k \
      --kv-shard head_dim --params-data-sharded
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape decode_32k \
      --moe-scheme expert --mesh-shape 2,8
Records go to ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import functools
import json
from contextlib import nullcontext
import os
import time
import traceback
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import partition as PT
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (HBM_BYTES_S, NVLINK_BYTES_S,
                                     PEAK_FLOPS, counting_collectives,
                                     make_mesh, make_production_mesh,
                                     pod_meshes)
from repro_torch.launch.shapes import SHAPES, input_specs, supported
from repro_torch.models import transformer as T
from repro_torch.ranks import current_rank, on_rank, set_rank

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _storages(tree) -> Dict[int, int]:
    """The unique storages of a tree's tensors: key -> bytes."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a nested dict/list/tuple/KVCache/AdamWState."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "k") and hasattr(tree, "v"):  # a KVCache
        return [t for t in (tree.k, tree.v, tree.k_scale, tree.v_scale)
                if t is not None]
    return []


#: gathers: like XLA's gather, they count the rows they read (their
#: output) and their indices, not the table they read from
_GATHERS = {torch.ops.aten.index, torch.ops.aten.index_select,
            torch.ops.aten.gather, torch.ops.aten.embedding}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Counts, for each rank of a pod, the flops and the bytes of every op
    its loops run (``ranks.ranked``; an op outside every rank
    loop is rank 0's: the sums of partials and the logits are gathered on
    rank 0's device, and the MoE routing runs there), and the storages
    its ops make.  Bytes are those of an op's tensor operands and results
    (views excluded; an op that writes into an operand, as a cache write
    does, counts its other operands and as many bytes written, not the
    buffer it writes into); flops are ``flop_counter``'s, read from the
    ``FlopCounterMode`` below this mode around each op.  Storages: the
    bytes alive at once for each rank, and the most of them (storages of
    ``arguments`` excluded)."""

    def __init__(self, arguments: Dict[int, int], counter: FlopCounterMode,
                 tp: int = 1):
        super().__init__()
        self.arguments = arguments
        self.counter = counter
        self.flops = [0.0] * tp
        self.bytes = [0.0] * tp
        self.out_bytes = [0.0] * tp
        self.live: Dict[int, tuple] = {}
        self.made: Dict[int, int] = {}
        self.current = [0] * tp
        self.peak = [0] * tp
        self.pod_current = self.pod_peak = 0

    def _freed(self, key: int) -> None:
        rank, nbytes = self.live.pop(key, (0, 0))
        self.current[rank] -= nbytes
        self.pod_current -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rank = current_rank() or 0
        before = self.counter.get_total_flops()
        out = func(*args, **kwargs)
        self.flops[rank] += self.counter.get_total_flops() - before
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not func.is_view:
            schema = func._schema.arguments
            vals = list(args) + [kwargs.get(a.name)
                                 for a in schema[len(args):]]
            written = [a.alias_info is not None and a.alias_info.is_write
                       for a in schema]
            ins = _nbytes([v for v, w in zip(vals, written) if not w])
            if func.overloadpacket in _GATHERS:  # the rows read, not the table
                ins = _nbytes(outs) + _nbytes(vals[1:])
            if any(written):  # in place: as many bytes written as read
                self.bytes[rank] += 2 * ins
                self.out_bytes[rank] += ins
            else:
                res = _nbytes(outs)
                self.bytes[rank] += res + ins
                self.out_bytes[rank] += res
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.arguments or key in self.live:
                continue
            self.live[key] = (rank, st.nbytes())
            self.made[key] = rank
            weakref.finalize(st, self._freed, key)
            self.current[rank] += st.nbytes()
            self.peak[rank] = max(self.peak[rank], self.current[rank])
            self.pod_current += st.nbytes()
            self.pod_peak = max(self.pod_peak, self.pod_current)
        return out


class _NodeRanks(TorchFunctionMode):
    """Marks each autograd node made in a rank's loop with that rank: the
    autograd engine runs the backward outside the loops, so a hook on
    each node marks its rank current while it runs (None: rank 0)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            rank = current_rank()
            for t in tree_flatten(out)[0]:
                node = t.grad_fn if isinstance(t, torch.Tensor) else None
                if node is not None and "rank" not in node.metadata:
                    node.metadata["rank"] = rank
                    node.register_prehook(functools.partial(_enter, rank))
        return out


def _enter(rank, grad_outputs):
    set_rank(rank)


def measure(step, *inputs, owners: Optional[List] = None) -> Dict:
    """Run ``step(*inputs)`` under the counters (flops, bytes, storages,
    collectives) and return the busiest rank's figures: ``flops``,
    ``bytes_accessed``, ``bytes_output``, ``argument``, ``output``,
    ``alias``, ``temp``, ``peak`` (each the largest over the ranks, as
    the reference's padded GSPMD shards are the largest shard's), each
    rank's in ``ranks``, the pod's totals in ``pod`` (``flops``,
    ``bytes_accessed``, ``argument``, and ``peak`` over the pod's
    storages on one device), ``collectives`` (per device already, each
    operation once), ``seconds``, and ``result`` (the step's outputs).
    ``owners[r]``: the inputs rank r alone holds (its params, cache or
    moments); every other input (the batch) every rank holds.  Without
    ``owners`` one rank holds them all.  A remat'd step's earlier ranks
    also count the recomputed ops after their last saved activation
    (module docstring).  Any device: the dry run gives
    meta tensors, the tests and the card real ones."""
    arguments = _storages(inputs)
    owners = owners or [inputs]
    tp = len(owners)
    owned = [_storages(o) for o in owners]
    shared = {k: b for k, b in arguments.items()
              if not any(k in o for o in owned)}
    flops = FlopCounterMode(display=False)
    mode = CostMode(arguments, flops, tp)
    grads = _NodeRanks() if torch.is_grad_enabled() else nullcontext()
    t0 = time.perf_counter()
    with counting_collectives() as coll:
        with flops, mode, grads, on_rank(None):
            result = step(*inputs)
    seconds = time.perf_counter() - t0
    outputs = _storages(result)
    ranks = []
    for r in range(tp):
        args_r = {**shared, **owned[r]}
        mine = {k: b for k, b in outputs.items()
                if k in args_r or (k not in arguments
                                   and mode.made.get(k, 0) == r)}
        alias = sum(b for k, b in mine.items() if k in args_r)
        out_bytes = sum(mine.values())
        arg_bytes = sum(args_r.values())
        ranks.append({
            "flops": mode.flops[r], "bytes_accessed": mode.bytes[r],
            "bytes_output": mode.out_bytes[r], "argument": float(arg_bytes),
            "output": float(out_bytes), "alias": float(alias),
            "temp": float(max(mode.peak[r] - (out_bytes - alias), 0)),
            "peak": float(arg_bytes + mode.peak[r])})
    busiest = {k: max(r[k] for r in ranks) for k in ranks[0]}
    pod = {"flops": sum(mode.flops), "bytes_accessed": sum(mode.bytes),
           "argument": float(sum(arguments.values())),
           "peak": float(sum(arguments.values()) + mode.pod_peak)}
    return {**busiest, "ranks": ranks, "pod": pod,
            "collectives": dict(coll), "seconds": seconds, "result": result}


def own_copies(shards: List) -> List:
    """Rank trees in which no two leaves share a storage: a leaf that an
    earlier rank holds too (``shard_params`` shares a replicated leaf
    between ranks on one device), or a slice of a larger storage (a rank's
    rows of the embedding), is cloned, as separate cards hold their own
    copies of their own pieces."""
    seen = set()

    def fix(tree):
        if isinstance(tree, dict):
            return {k: fix(v) for k, v in tree.items()}
        st = tree.untyped_storage()
        if st._cdata in seen or st.nbytes() > tree.nbytes:
            return tree.clone()
        seen.add(st._cdata)
        return tree

    return [fix(tree) for tree in shards]


def _skip(arch, shape_name, multi_pod, reason, **extra) -> Dict:
    return {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single", "status": "skipped",
            "reason": reason, **extra}


def skip_reason(cfg, shape, mesh, *, kv_shard: str = "auto",
                params_data_sharded: bool = False,
                moe_scheme: str = "tensor") -> Optional[str]:
    """Why the port has no layout for this combination, or None."""
    if not supported(cfg, shape):
        return "long_500k unsupported (see DESIGN.md)"
    PT.moe_rules(moe_scheme)  # raises for an unknown scheme
    tp = dict(zip(mesh.axis_names, np.shape(mesh.devices)))["model"]
    reason = PT.layout_reason(cfg, tp)
    if reason is not None:
        return reason
    if cfg.family == "ssm":  # no KV cache to lay out
        return None
    return None


def _rows_batch(specs: Dict, rows: slice) -> Dict:
    """Fresh meta tensors of one data index's rows of a batch."""
    out = {}
    for k, v in specs.items():
        shape = list(v.shape)
        dim = 1 if k == "positions" else 0
        shape[dim] = len(range(shape[dim])[rows])
        out[k] = torch.empty(shape, dtype=v.dtype, device=v.device)
    return out


def context_parallel(shape, mesh) -> bool:
    """Whether the reference lays ``shape``'s cache out context-parallel
    on ``mesh``: a decode whose global batch is under 16, on a mesh with
    a "data" axis of more than one index."""
    sizes = dict(zip(mesh.axis_names, np.shape(mesh.devices)))
    return (shape.kind == "decode" and shape.global_batch < 16
            and sizes.get("data", 1) > 1)


def rank_program(cfg, shape, mesh, *, kv_dtype=None, remat: bool = True,
                 params=None, kv_shard: str = "auto",
                 params_data_sharded: bool = False,
                 moe_scheme: str = "tensor"):
    """The program of one data index of ``mesh`` (its first pod over its
    rows, ``steps.pod_rows``), on the mesh's devices: (step, inputs, the
    pod's ranks).  ``params``: the unsharded tree on that device (default
    ``abstract_params`` on meta, else random weights from seed 0); each
    rank owns its copies (:func:`own_copies`).  Train shapes run
    ``make_train_step(mesh=, data_index=0)`` over ZeRO-1 moments, prefill
    and decode shapes the step functions on the pod over its caches,
    laid out as ``kv_shard`` picks (``partition.kv_layout``); a decode
    :func:`context_parallel` takes every batch row and its data index's
    rows of the cache (``transformer.init_cache(context=)``).
    ``params_data_sharded`` (ZeRO-3): each rank holds its data index's
    slice of its leaves (``steps.zero3_shard``), and the step all-gathers
    them first.  ``moe_scheme``: the MoE experts' layout
    (``partition.shard_params``)."""
    pod = pod_meshes(mesh)[0]
    device = pod.ranks[0]
    rows = ST.pod_rows(mesh, shape.global_batch)[0]
    b = len(range(shape.global_batch)[rows])
    specs = input_specs(cfg, shape, kv_dtype=kv_dtype, device="meta")
    batch = _rows_batch({k: v for k, v in specs.items() if k != "cache"},
                        rows)
    if device.type != "meta":
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in batch.items()}
    if params is None:
        params = (T.abstract_params(cfg) if device.type == "meta" else
                  T.init_params(cfg, torch.Generator(device=device)
                                .manual_seed(0)))
    shards = own_copies(PT.shard_params(params, cfg, pod,
                                        moe_scheme=moe_scheme))
    del params
    if shape.kind == "train":
        opt = ST.zero1_init([shards], cfg, mesh)
        step = ST.make_train_step(cfg, remat=remat, mesh=mesh, data_index=0,
                                  params_data_sharded=params_data_sharded)
        if params_data_sharded:
            shards = ST.zero3_shard([shards], cfg, mesh)[0]
        return step, ([shards], opt, batch), len(pod.ranks)
    kv = specs["cache"].get("kv")
    ctx = context_parallel(shape, mesh)
    n_data = dict(zip(mesh.axis_names, np.shape(mesh.devices)))["data"] \
        if ctx else 1
    cache = T.init_cache(cfg, b, shape.seq_len, mesh=pod, kv_dtype=kv_dtype,
                         sliding_window=kv.k.shape[2] if kv is not None
                         and kv.ring else None,
                         kv_shard="heads" if ctx else kv_shard,
                         context=(n_data, [0]) if ctx else None)
    step = (ST.make_prefill_step(cfg, mesh=pod) if shape.kind == "prefill"
            else ST.make_serve_step(cfg, mesh=pod))
    if params_data_sharded:
        shards = ST.zero3_shard([shards], cfg, mesh)[0]
        step = functools.partial(_gathered, step, cfg, mesh)
    if shape.kind == "prefill":
        return step, (shards, {**batch, "cache": cache}), len(pod.ranks)
    return step, (shards, batch["tokens"], cache), len(pod.ranks)


def _gathered(step, cfg, mesh, slices, *rest):
    """``step`` of one data index over its ZeRO-3 slices, all-gathered
    first (``steps.zero3_gather``)."""
    return step(ST.zero3_gather([slices], cfg, mesh)[0], *rest)


def rank_owners(inputs, kind: str) -> List:
    """What each rank of :func:`rank_program`'s inputs holds alone: its
    params and its cache, or for training its params and its ZeRO-1
    moments (:func:`measure`'s ``owners``)."""
    if kind == "train":
        (shards,), opt, _ = inputs
        return [(p, mu, nu)
                for p, mu, nu in zip(shards, opt.mu[0], opt.nu[0])]
    shards, cache = inputs[0], inputs[-1]
    if kind == "prefill":
        cache = cache["cache"]
    return [(p, c) for p, c in zip(shards, cache)]


def lower_one(arch: str, shape_name: str, multi_pod: bool,
              *, moe_scheme: str = "tensor", remat: bool = True,
              extra_tag: str = "", cfg_override=None,
              save_record: bool = True, kv_dtype=None,
              kv_shard: str = "auto", params_data_sharded: bool = False,
              mesh_shape=None, attn_head_shard: bool = False,
              input_shape=None) -> Dict:
    """Trace one combination on the meta device; returns the record.

    ``cfg_override`` substitutes the config (the cost probes' depths);
    ``mesh_shape`` (e.g. ``(8, 32)``) overrides the single-pod mesh;
    ``input_shape`` (an ``InputShape``) the shape ``shape_name`` names.
    ``save_record`` and ``attn_head_shard`` have no effect (module
    docstring)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = input_shape if input_shape is not None else SHAPES[shape_name]
    if mesh_shape is not None:
        mesh = make_mesh(mesh_shape, ("data", "model"),
                         devices=["meta"] * int(np.prod(mesh_shape)))
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    reason = skip_reason(cfg, shape, mesh, kv_shard=kv_shard,
                         params_data_sharded=params_data_sharded,
                         moe_scheme=moe_scheme)
    if reason is not None:
        return _skip(arch, shape_name, multi_pod, reason)
    step, inputs, tp = rank_program(cfg, shape, mesh, kv_dtype=kv_dtype,
                                    remat=remat, kv_shard=kv_shard,
                                    params_data_sharded=params_data_sharded,
                                    moe_scheme=moe_scheme)
    with torch.no_grad() if shape.kind != "train" else nullcontext():
        m = measure(step, *inputs, owners=rank_owners(inputs, shape.kind))
    mem = {"argument_size_in_bytes": m["argument"],
           "output_size_in_bytes": m["output"],
           "temp_size_in_bytes": m["temp"],
           "alias_size_in_bytes": m["alias"],
           "generated_code_size_in_bytes": 0.0,
           "peak_memory_in_bytes": m["peak"],
           "pod_argument_size_in_bytes": m["pod"]["argument"],
           "pod_peak_memory_in_bytes": m["pod"]["peak"]}
    flops, nbytes = m["flops"], m["bytes_accessed"]
    dtype = "bfloat16" if cfg.dtype == "bfloat16" else "float32"
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "n_devices": int(np.prod(np.shape(mesh.devices))),
        "moe_scheme": moe_scheme,
        "remat": remat,
        "kv_dtype": kv_dtype,
        "kv_shard": ("heads" if context_parallel(shape, mesh)
                     else PT.kv_layout(cfg, tp, kv_shard)),
        "params_data_sharded": params_data_sharded,
        "attn_head_shard": attn_head_shard,
        "mesh_shape": list(np.shape(mesh.devices)),
        "tag": extra_tag,
        "status": "ok",
        "lower_s": round(m["seconds"], 2),
        "compile_s": 0.0,
        "memory_analysis": mem,
        "cost_analysis": {
            "flops": flops, "bytes accessed": nbytes,
            "bytes accessed output": m["bytes_output"],
            "pod flops": m["pod"]["flops"],
            "optimal_seconds": max(
                flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S,
                m["collectives"]["total"] / NVLINK_BYTES_S)},
        "flops": flops,
        "bytes_accessed": nbytes,
        "collectives": m["collectives"],
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }


def save(rec: Dict, out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"_{rec['tag']}" if rec.get("tag") else ""
    path = os.path.join(
        out_dir, f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=list(list_archs()))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape)")
    ap.add_argument("--moe-scheme", default="tensor",
                    choices=["tensor", "expert"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--kv-dtype", default=None, choices=[None, "int8"])
    ap.add_argument("--kv-shard", default="auto", choices=list(PT.KV_SHARDS))
    ap.add_argument("--params-data-sharded", action="store_true")
    ap.add_argument("--attn-head-shard", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="override single-pod mesh, e.g. 8,32")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    archs = list(list_archs()) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                try:
                    rec = lower_one(
                        arch, shape, mp, moe_scheme=args.moe_scheme,
                        remat=not args.no_remat, extra_tag=args.tag,
                        kv_dtype=args.kv_dtype, kv_shard=args.kv_shard,
                        params_data_sharded=args.params_data_sharded,
                        mesh_shape=mesh_shape,
                        attn_head_shard=args.attn_head_shard)
                except Exception as e:  # noqa: BLE001 — report and go on
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "tag": args.tag, "status": "error",
                           "error": repr(e)}
                    n_fail += 1
                path = save(rec, args.out)
                if rec["status"] == "ok":
                    print(f"OK   {label}: trace={rec['lower_s']}s "
                          f"flops={rec['flops']:.3e} "
                          f"bytes={rec['bytes_accessed']:.3e} "
                          f"coll={rec['collectives']['total']:.3e}B "
                          f"-> {path}", flush=True)
                    print("     mem:", rec["memory_analysis"], flush=True)
                elif rec["status"] == "skipped":
                    print(f"SKIP {label}: {rec['reason']}", flush=True)
                else:
                    print(f"FAIL {label}: {rec['error']}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} combinations failed")
    return 0


if __name__ == "__main__":
    main()
