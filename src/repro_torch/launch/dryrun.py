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
  int8 writes' max, the logits gathered on rank 0, and ZeRO-1's
  gradient sum and param gather).  The reference parses them from XLA's
  optimized HLO (its ``collective_bytes``); the port has no HLO, so its
  counter fills the same dict, one entry per collective with its output
  bytes on one device.

One process runs every rank of the pod, so the pod's totals become
per-device figures by dividing them by the pod's ranks (the ranks' work
is equal but for rank 0's gathers); collectives are counted once per
operation, which is each device's count already.  Where the ranks do
not divide a split axis their work differs: the ranks' ops interleave
in one trace on one device, which cannot tell them apart, so the record
reports the mean rank, not the busiest one that sets the step (the
reference's padded GSPMD shards are the largest shard's).  The busiest
rank's share of a split axis is ``ceil(n / tp) / (n / tp)`` of the mean
(qwen2-1.5b's attention at 16 ranks: 1 head of 12 against 0.75).  ``lower_s`` is the
trace's time; ``compile_s`` is 0.0: nothing is compiled, the port's
kernels being built once by nvcc (``kernels.build``) and its model run
eagerly.  The cost analysis's ``optimal_seconds`` is the card's roofline
of the record: the largest of its flops, bytes and collective bytes over
``launch.mesh``'s H100 rates (NVLink for the collectives).

Heads and widths the model axis does not divide are laid out as whole
units, the first ranks one more (``partition.split_range``; qwen2-1.5b's
12 heads over 16 ranks leave four ranks none).  Where the port has no
layout for a combination the record is skipped with a reason naming its
queue item (ROADMAP.md, queue 1): ``kv_shard="seq"`` or ``"head_dim"``,
a context-parallel cache (decode with a global batch under 16:
long_500k) and ``params_data_sharded`` (ZeRO-3), which are item 8.5.  ``kv_shard="auto"`` takes the port's head layout, and the
record says ``"heads"``.  The reference's ``moe_scheme="expert"`` is not
ported (``launch.partition``).  :func:`lower_one` keeps two of the
reference's arguments only for signature parity, so that its calls run
unchanged: ``save_record``, unused there as here (:func:`main` saves),
and ``attn_head_shard``, which changes nothing because the port always
splits attention by head (the record echoes it).

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
Records go to ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import json
from contextlib import nullcontext
import os
import time
import traceback
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
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

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

ITEM_85 = "ROADMAP.md, queue 1, item 8.5"


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
    """Counts the bytes of every op's tensor operands and results (views
    excluded; an op that writes into an operand, as a cache write does,
    counts its other operands and as many bytes written, not the buffer
    it writes into), and the storages the ops make: the bytes alive at
    once, and the most of them (storages of ``arguments`` excluded)."""

    def __init__(self, arguments: Dict[int, int]):
        super().__init__()
        self.arguments = arguments
        self.bytes = 0
        self.out_bytes = 0
        self.live: Dict[int, int] = {}
        self.refs: Dict[int, weakref.ref] = {}
        self.current = 0
        self.peak = 0

    def _freed(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)
        self.refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
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
                self.bytes += 2 * ins
                self.out_bytes += ins
            else:
                res = _nbytes(outs)
                self.bytes += res + ins
                self.out_bytes += res
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.arguments or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.refs[key] = weakref.ref(
                st, lambda _, key=key: self._freed(key))
            self.current += st.nbytes()
            self.peak = max(self.peak, self.current)
        return out


def measure(step, *inputs) -> Dict:
    """Run ``step(*inputs)`` under the counters (flops, bytes, storages,
    collectives) and return the pod's totals: ``flops``,
    ``bytes_accessed``, ``bytes_output``, ``argument``, ``output``,
    ``alias``, ``temp``, ``peak``, ``collectives`` (per device already),
    ``seconds``, and ``result`` (the step's outputs).  Any device: the
    dry run gives meta tensors, the tests and the card real ones."""
    arguments = _storages(inputs)
    mode = CostMode(arguments)
    t0 = time.perf_counter()
    with counting_collectives() as coll:
        with FlopCounterMode(display=False) as flops, mode:
            result = step(*inputs)
    seconds = time.perf_counter() - t0
    outputs = _storages(result)
    arg_bytes = sum(arguments.values())
    out_bytes = sum(outputs.values())
    alias = sum(b for k, b in outputs.items() if k in arguments)
    new_out = out_bytes - alias
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(mode.bytes),
            "bytes_output": float(mode.out_bytes),
            "argument": float(arg_bytes), "output": float(out_bytes),
            "alias": float(alias),
            "temp": float(max(mode.peak - new_out, 0)),
            "peak": float(arg_bytes + mode.peak),
            "collectives": dict(coll), "seconds": seconds,
            "result": result}


def own_copies(shards: List) -> List:
    """Rank trees in which no two leaves share a storage: a leaf that an
    earlier rank holds too (``shard_params`` shares a replicated leaf
    between ranks on one device) is cloned, as separate cards hold their
    own copies."""
    seen = set()

    def fix(tree):
        if isinstance(tree, dict):
            return {k: fix(v) for k, v in tree.items()}
        key = tree.untyped_storage()._cdata
        if key in seen:
            return tree.clone()
        seen.add(key)
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
    if moe_scheme != "tensor":
        return (f"moe_scheme={moe_scheme!r}: the port lays out the "
                "reference's baseline 'tensor' scheme only "
                "(launch/partition.py)")
    if params_data_sharded:
        return ("params_data_sharded (ZeRO-3: parameters sharded over the "
                f"data axes) has no port layout ({ITEM_85})")
    tp = dict(zip(mesh.axis_names, np.shape(mesh.devices)))["model"]
    reason = PT.layout_reason(cfg, tp)
    if reason is not None:
        return reason
    if cfg.family == "ssm":  # no KV cache to lay out
        return None
    if kv_shard in ("seq", "head_dim"):
        return (f"kv_shard={kv_shard!r}: the port caches KV by head only "
                f"({ITEM_85})")
    if shape.kind == "decode" and shape.global_batch < 16:
        return ("a context-parallel cache (the KV sequence axis on 'data', "
                f"global batch {shape.global_batch} < 16) has no port "
                f"layout ({ITEM_85})")
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


def rank_program(cfg, shape, mesh, *, kv_dtype=None, remat: bool = True,
                 params=None):
    """The program of one data index of ``mesh`` (its first pod over its
    rows, ``steps.pod_rows``), on the mesh's devices: (step, inputs, the
    pod's ranks).  ``params``: the unsharded tree on that device (default
    ``abstract_params`` on meta, else random weights from seed 0); each
    rank owns its copies (:func:`own_copies`).  Train shapes run
    ``make_train_step(mesh=, data_index=0)`` over ZeRO-1 moments, prefill
    and decode shapes the step functions on the pod over its caches."""
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
    shards = own_copies(PT.shard_params(params, cfg, pod))
    del params
    if shape.kind == "train":
        opt = ST.zero1_init([shards], cfg, mesh)
        step = ST.make_train_step(cfg, remat=remat, mesh=mesh, data_index=0)
        return step, ([shards], opt, batch), len(pod.ranks)
    kv = specs["cache"].get("kv")
    cache = T.init_cache(cfg, b, shape.seq_len, mesh=pod, kv_dtype=kv_dtype,
                         sliding_window=kv.k.shape[2] if kv is not None
                         and kv.ring else None)
    if shape.kind == "prefill":
        return (ST.make_prefill_step(cfg, mesh=pod),
                (shards, {**batch, "cache": cache}), len(pod.ranks))
    return (ST.make_serve_step(cfg, mesh=pod),
            (shards, batch["tokens"], cache), len(pod.ranks))


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
                                    remat=remat)
    with torch.no_grad() if shape.kind != "train" else nullcontext():
        m = measure(step, *inputs)
    per = 1.0 / tp
    mem = {"argument_size_in_bytes": m["argument"] * per,
           "output_size_in_bytes": m["output"] * per,
           "temp_size_in_bytes": m["temp"] * per,
           "alias_size_in_bytes": m["alias"] * per,
           "generated_code_size_in_bytes": 0.0,
           "peak_memory_in_bytes": m["peak"] * per}
    flops, nbytes = m["flops"] * per, m["bytes_accessed"] * per
    dtype = "bfloat16" if cfg.dtype == "bfloat16" else "float32"
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "n_devices": int(np.prod(np.shape(mesh.devices))),
        "moe_scheme": moe_scheme,
        "remat": remat,
        "kv_dtype": kv_dtype,
        "kv_shard": "heads",
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
            "bytes accessed output": m["bytes_output"] * per,
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
