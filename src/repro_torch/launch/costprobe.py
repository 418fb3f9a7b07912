"""Roofline cost probes: the port of ``repro.launch.costprobe``.

The reference lowers its layers as a rolled ``scan``, whose body XLA's
``cost_analysis`` counts once, so it lowers probe variants (the same
inputs, fewer layers, scans unrolled by ``repro.models.scanning``) and
extrapolates an affine model per family:

  dense/moe/vlm/ssm : cost(L) = a + L·b             probes L in {2, 4}
  audio (enc-dec)   : cost(k) = a + k·b (enc=dec=k) probes k in {2, 4}
  hybrid (zamba2)   : cost = a + G·g + T·t          probes L in {12, 15, 24}
                      (G groups of [6 mamba + shared attn], T tail mamba)

The port has no rolled scan and so no counterpart of
``models/scanning.py``: it runs its layers in a Python loop, and the dry
run (:mod:`repro_torch.launch.dryrun`) counts every layer.  The probe is
kept all the same, for the readers of the reference's records (its
``roofline.py`` looks for them): it traces the same probe depths through
``dryrun.lower_one`` and extrapolates them by the same models, which in
the port give the direct full-depth count (the tests hold them equal).
Corrected totals go to ``experiments/costmodel_torch/``.  The layout
flags are the dry run's: ``--kv-shard`` (the cache's layout, "auto" as
the reference's ``cache_pspecs`` picks it), ``--params-data-sharded``
(ZeRO-3) and ``--kv-dtype int8``; long_500k's decode takes the
context-parallel cache, as there.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, List

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.partition import KV_SHARDS
from repro_torch.launch.shapes import SHAPES, supported

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "costmodel_torch")

KEYS = ("flops", "bytes_accessed", "collective_bytes")


def _extract(rec: Dict) -> Dict[str, float]:
    return {
        "flops": rec["flops"],
        "bytes_accessed": rec["bytes_accessed"],
        "collective_bytes": rec["collectives"]["total"],
    }


def _axpy(a: Dict, b: Dict, sa=1.0, sb=1.0) -> Dict:
    return {k: sa * a[k] + sb * b[k] for k in KEYS}


def _probe_cfgs(cfg) -> List:
    r = dataclasses.replace
    if cfg.family == "audio":
        return [
            r(cfg, n_layers=2, encoder=r(cfg.encoder, n_layers=2)),
            r(cfg, n_layers=4, encoder=r(cfg.encoder, n_layers=4)),
        ]
    if cfg.family == "hybrid":
        return [r(cfg, n_layers=12), r(cfg, n_layers=15), r(cfg, n_layers=24)]
    return [r(cfg, n_layers=2), r(cfg, n_layers=4)]


def _extrapolate(cfg, costs: List[Dict]) -> Dict[str, float]:
    if cfg.family == "audio":
        c2, c4 = costs
        per = _axpy(c4, c2, 0.5, -0.5)  # per (enc+dec) layer pair
        return _axpy(c2, per, 1.0, cfg.n_layers - 2)
    if cfg.family == "hybrid":
        c12, c15, c24 = costs
        # L=12 -> 2 groups, L=24 -> 4 groups: per-group = (c24 - c12) / 2
        g = _axpy(c24, c12, 0.5, -0.5)             # per group (6 mamba + attn)
        t = _axpy(c15, c12, 1 / 3.0, -1 / 3.0)     # per tail mamba layer
        a = _axpy(c12, g, 1.0, -2.0)
        every = cfg.hybrid.attn_every
        n_groups = cfg.n_layers // every
        n_tail = cfg.n_layers - n_groups * every
        out = _axpy(a, g, 1.0, float(n_groups))
        return _axpy(out, t, 1.0, float(n_tail))
    c2, c4 = costs
    per = _axpy(c4, c2, 0.5, -0.5)
    return _axpy(c2, per, 1.0, cfg.n_layers - 2)


def probe(arch: str, shape_name: str, *, moe_scheme: str = "tensor",
          remat: bool = True, tag: str = "", cfg_override=None,
          out_dir: str = OUT_DIR, **perf_knobs) -> Dict:
    """``perf_knobs`` forward to ``lower_one`` (kv_dtype, kv_shard,
    params_data_sharded, mesh_shape); ``cfg_override`` replaces the
    arch's config (its probe depths are cut from it)."""
    from repro_torch.launch.dryrun import lower_one

    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    if not supported(cfg, shape):
        return {"arch": arch, "shape": shape_name, "status": "skipped"}
    t0 = time.time()
    costs = []
    probes_meta = []
    for pc in _probe_cfgs(cfg):
        rec = lower_one(arch, shape_name, False, moe_scheme=moe_scheme,
                        remat=remat, cfg_override=pc, save_record=False,
                        **perf_knobs)
        if rec["status"] != "ok":
            return {"arch": arch, "shape": shape_name,
                    "status": rec["status"],
                    "error": rec.get("error", rec.get("reason"))}
        costs.append(_extract(rec))
        probes_meta.append({"n_layers": pc.n_layers, **costs[-1]})
    corrected = _extrapolate(cfg, costs)
    out = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "single",
        "moe_scheme": moe_scheme,
        "tag": tag,
        "status": "ok",
        "perf_knobs": {k: str(v) for k, v in perf_knobs.items()},
        "probe_seconds": round(time.time() - t0, 1),
        "probes": probes_meta,
        "corrected": corrected,
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}_{shape_name}_single{suffix}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=list(list_archs()))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-scheme", default="tensor")
    ap.add_argument("--kv-dtype", default=None, choices=[None, "int8"])
    ap.add_argument("--kv-shard", default="auto", choices=list(KV_SHARDS))
    ap.add_argument("--params-data-sharded", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    knobs = {"kv_shard": args.kv_shard}
    if args.kv_dtype:
        knobs["kv_dtype"] = args.kv_dtype
    if args.params_data_sharded:
        knobs["params_data_sharded"] = True
    archs = list(list_archs()) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    for arch in archs:
        for shape in shapes:
            try:
                rec = probe(arch, shape, moe_scheme=args.moe_scheme,
                            tag=args.tag, out_dir=args.out, **knobs)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                print(f"FAIL {arch} x {shape}: {e!r}")
                continue
            if rec["status"] == "ok":
                c = rec["corrected"]
                print(f"OK   {arch} x {shape}: flops={c['flops']:.3e} "
                      f"bytes={c['bytes_accessed']:.3e} "
                      f"coll={c['collective_bytes']:.3e} "
                      f"({rec['probe_seconds']}s)")
            else:
                print(f"{rec['status'].upper()} {arch} x {shape}"
                      + (f": {rec['error']}" if rec.get("error") else ""))


if __name__ == "__main__":
    main()
