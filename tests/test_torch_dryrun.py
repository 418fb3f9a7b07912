"""The port's dry run (``repro_torch.launch.dryrun``), cost probes
(``repro_torch.launch.costprobe``) and the layouts they read, against the
JAX package on the CPU.

* Specs: for every arch, input shape and production mesh, the port's
  ``param_pspecs``, ``cache_pspecs`` (every ``kv_shard``, and
  ``context_parallel``), ``batch_pspecs``, ``opt_pspecs`` and
  ``sanitize_specs`` equal the reference's, each ``PartitionSpec`` read
  as a tuple; ``abstract_params`` / ``abstract_cache`` have the shapes
  and dtypes of the reference's ``jax.eval_shape`` trees.  The
  reference's ``opt_pspecs`` and ``sanitize_specs`` read only a mesh's
  ``axis_names`` and ``devices.shape``, so they get a stub mesh.
* The dry run: its record has the reference's keys; on small configs
  at (1, 1) and (2, 2) meshes its ``flops`` equal ``FlopCounterMode``
  over a real CPU run of the same rank program (exactly: the same ops)
  and its argument bytes those of that run's inputs; a TP=2 record
  counts the pod's cross-rank sums; the skip reasons name their items;
  the module runs as a program.
* The cost probes: the reference's cases of ``_axpy`` and
  ``_extrapolate``, and ``probe()`` equal to the direct full-depth count
  (relative 1e-9: the hybrid model divides by 3).
"""
import ast
from contextlib import nullcontext
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import partition as JPT  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.launch.mesh import batch_axes as jax_batch_axes  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import costprobe, dryrun  # noqa: E402
from repro_torch.launch import partition as PT  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import (batch_axes,  # noqa: E402
                                     make_production_mesh, pod_meshes)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import KVCache  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = [False, True]


def stub_mesh(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return SimpleNamespace(axis_names=axes,
                           devices=np.empty(shape, dtype=object))


def jax_leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))


def port_leaves(tree):
    """The port's spec (or tensor) tree in JAX's order: dict keys sorted,
    a KVCache's k, v, k_scale, v_scale (None skipped)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in port_leaves(tree[k])]
    if isinstance(tree, KVCache):
        return [x for t in (tree.k, tree.v, tree.k_scale, tree.v_scale)
                if t is not None for x in port_leaves(t)]
    return [tree]


def same_specs(port, ref):
    got = [tuple(s) for s in port_leaves(port)]
    want = [tuple(s) for s in jax_leaves(ref)]
    assert got == want


def same_shapes(port, ref):
    got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
           for t in port_leaves(port)]
    want = [(tuple(a.shape), str(a.dtype)) for a in jax_leaves(ref)]
    want = [(s, {"bfloat16": "bfloat16", "float32": "float32",
                 "int32": "int32", "int8": "int8"}[d]) for s, d in want]
    assert got == want


@pytest.mark.parametrize("arch", list_archs())
def test_specs_and_abstract_trees_equal_the_reference(arch):
    """Every spec function, every shape and both production meshes (the
    port's meshes and the reference's stub have the same axes and
    shapes), and the abstract trees' shapes and dtypes."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ap, jap = T.abstract_params(cfg), JT.abstract_params(jcfg)
    assert all(t.device.type == "meta" for t in port_leaves(ap))
    same_shapes(ap, jap)
    pspec, jpspec = PT.param_pspecs(cfg, ap), JPT.param_pspecs(jcfg, jap)
    same_specs(pspec, jpspec)
    for multi in MESHES:
        mesh, jmesh = make_production_mesh(multi_pod=multi), stub_mesh(multi)
        assert tuple(mesh.axis_names) == jmesh.axis_names
        assert np.shape(mesh.devices) == jmesh.devices.shape
        bax = batch_axes(mesh)
        assert bax == jax_batch_axes(jmesh)
        san = PT.sanitize_specs(mesh, pspec, ap)
        jsan = JPT.sanitize_specs(jmesh, jpspec, jap)
        same_specs(san, jsan)
        same_specs(PT.opt_pspecs(mesh, san, ap),
                   JPT.opt_pspecs(jmesh, jsan, jap))
        for shape in S.SHAPES.values():
            for kv_dtype in (None, "int8"):
                specs = S.input_specs(cfg, shape, kv_dtype=kv_dtype)
                jspecs = JS.input_specs(jcfg, shape, kv_dtype=kv_dtype)
                batch = {k: v for k, v in specs.items() if k != "cache"}
                jbatch = {k: v for k, v in jspecs.items() if k != "cache"}
                same_shapes(batch, jbatch)
                bspec = PT.batch_pspecs(batch, bax)
                jbspec = JPT.batch_pspecs(jbatch, bax)
                same_specs(bspec, jbspec)
                same_specs(PT.sanitize_specs(mesh, bspec, batch),
                           JPT.sanitize_specs(jmesh, jbspec, jbatch))
                if "cache" not in specs:
                    continue
                cache, jcache = specs["cache"], jspecs["cache"]
                same_shapes(cache, jcache)
                for kv_shard in PT.KV_SHARDS:
                    for ctx in (False, True):
                        kw = dict(context_parallel=ctx, model_size=16,
                                  kv_shard=kv_shard)
                        cs = PT.cache_pspecs(cfg, cache, bax, **kw)
                        jcs = JPT.cache_pspecs(jcfg, jcache, bax, **kw)
                        same_specs(cs, jcs)
                        same_specs(PT.sanitize_specs(mesh, cs, cache),
                                   JPT.sanitize_specs(jmesh, jcs, jcache))


def test_abstract_cache_equals_the_reference():
    """(The reference's hybrid and audio caches ignore ``sliding_window``;
    the input shapes never give them one.)"""
    for arch in ("zamba2-7b", "whisper-large-v3", "mixtral-8x7b"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        ring = [{"sliding_window": 64}] if cfg.family == "moe" else []
        for kw in [{}, {"kv_dtype": "int8"}] + ring:
            got = T.abstract_cache(cfg, 3, 512, **kw)
            assert all(t.device.type == "meta" for t in port_leaves(got))
            same_shapes(got, JT.abstract_cache(jcfg, 3, 512, **kw))


def test_local_shape_gives_one_devices_shard():
    mesh = make_production_mesh(multi_pod=True)
    leaf = torch.empty((64, 4096, 512), device="meta")
    assert PT.local_shape(mesh, PT.P(None, ("pod", "data"), "model"),
                          leaf) == (64, 128, 32)
    assert PT.local_shape(mesh, PT.P(), leaf) == (64, 4096, 512)


# --------------------------------------------------------------------------- #
# The dry run
# --------------------------------------------------------------------------- #


def reference_record_keys():
    """The keys of the reference's ``lower_one`` record, read from its
    source (importing it would set ``XLA_FLAGS`` for 512 devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id",
                                                     None) == "rec"
                and isinstance(node.value, ast.Dict)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no rec = {...} in the reference's dryrun.py")


def small(arch, **kw):
    """A reduced config in fp32 at 2 layers (the hybrid one group and a
    tail layer, the audio family's encoder 1 layer over 16 frames)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if cfg.family == "hybrid":
        kw.setdefault("n_layers", cfg.hybrid.attn_every + 1)
    if cfg.family == "audio":
        kw.setdefault("encoder", dataclasses.replace(cfg.encoder, n_layers=1,
                                                     n_frames=16))
    kw.setdefault("n_layers", 2)
    return dataclasses.replace(cfg, **kw)


#: a shape small enough to run on the CPU
SHAPE = S.InputShape("train_4k", 32, 4, "train")


@pytest.fixture()
def tiny_shapes(monkeypatch):
    """The four shapes cut to 4 rows of 32 tokens (decode over 32 rows)."""
    tiny = {"train_4k": S.InputShape("train_4k", 32, 4, "train"),
            "prefill_32k": S.InputShape("prefill_32k", 32, 4, "prefill"),
            "decode_32k": S.InputShape("decode_32k", 32, 16, "decode"),
            "long_500k": S.InputShape("long_500k", 64, 1, "decode")}
    monkeypatch.setattr(dryrun, "SHAPES", tiny)
    return tiny


def cpu_program(cfg, shape, mesh_shape):
    """The rank program of one data index on CPU tensors, built here
    from the step functions: (step, inputs, the pod's ranks)."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(mesh_shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(mesh_shape)))
    pod = pod_meshes(mesh)[0]
    rows = ST.pod_rows(mesh, shape.global_batch)[0]
    b = len(range(shape.global_batch)[rows])
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    shards = dryrun.own_copies(PT.shard_params(params, cfg, pod))
    specs = S.input_specs(cfg, shape, device="cpu")
    batch = {k: v[:b] if k != "positions" else v[:, :b]
             for k, v in specs.items() if k != "cache"}
    batch = {k: v.clone() for k, v in batch.items()}
    if shape.kind == "train":
        step = ST.make_train_step(cfg, mesh=mesh, data_index=0)
        return step, ([shards], ST.zero1_init([shards], cfg, mesh),
                      batch), len(pod.ranks)
    cache = T.init_cache(cfg, b, shape.seq_len, mesh=pod)
    if shape.kind == "prefill":
        return (ST.make_prefill_step(cfg, mesh=pod),
                (shards, {**batch, "cache": cache}), len(pod.ranks))
    return (ST.make_serve_step(cfg, mesh=pod),
            (shards, batch["tokens"], cache), len(pod.ranks))


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b",
                                  "mamba2-130m"])
def test_record_flops_and_arguments_equal_a_cpu_run(arch, mesh_shape, kind,
                                                    tiny_shapes):
    """The meta record against ``FlopCounterMode`` over the same rank
    program on CPU tensors (exact: the pod's flops), and its argument
    bytes against the bytes of that program's inputs (exact: the pod's).
    Its per-device figures are the busiest rank's, at least the mean; the
    MoE family's rank 0 routes every token, so its records exceed it."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, shape = small(arch), tiny_shapes[kind]
    rec = dryrun.lower_one(arch, kind, False, cfg_override=cfg,
                           mesh_shape=mesh_shape)
    assert rec["status"] == "ok", rec
    assert list(rec) == reference_record_keys()
    assert rec["compile_s"] == 0.0 and rec["kv_shard"] == "heads"
    step, inputs, tp = cpu_program(cfg, shape, mesh_shape)
    arg_bytes = sum(dryrun._storages(inputs).values())
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad() if shape.kind != "train" else nullcontext():
            step(*inputs)
    ma = rec["memory_analysis"]
    assert rec["cost_analysis"]["pod flops"] == fc.get_total_flops() > 0
    assert ma["pod_argument_size_in_bytes"] == arg_bytes
    assert rec["flops"] * tp >= fc.get_total_flops()
    assert ma["argument_size_in_bytes"] * tp >= arg_bytes
    if tp > 1 and cfg.family == "moe":
        assert rec["flops"] * tp > fc.get_total_flops()
    assert rec["bytes_accessed"] > 0
    assert ma["peak_memory_in_bytes"] >= ma["argument_size_in_bytes"]


def test_tp2_record_counts_the_pods_cross_rank_sums(tiny_shapes):
    """A dense prefill at TP=2 and L layers: the embedding's and each
    layer's two sums (attention, MLP) are all-reduces, the logits one
    all-gather on rank 0; an int8 cache adds one max a layer for K and
    one for V.  A MoE layer sends its routing from rank 0 (a
    collective-permute); the training step adds the backward's sums and
    ZeRO-1's gradient sum and param gather over the data axis."""
    cfg = small("qwen2-1.5b")
    L = cfg.n_layers
    rec = dryrun.lower_one("qwen2-1.5b", "prefill_32k", False,
                           cfg_override=cfg, mesh_shape=(1, 2))
    c = rec["collectives"]
    assert (c["all-reduce"] > 0 and c["all-gather"] > 0)
    assert c["count"] == 1 + 2 * L + 1
    assert c["total"] == sum(c[k] for k in ("all-gather", "all-reduce",
                                            "reduce-scatter", "all-to-all",
                                            "collective-permute"))
    rec8 = dryrun.lower_one("qwen2-1.5b", "prefill_32k", False,
                            cfg_override=cfg, mesh_shape=(1, 2),
                            kv_dtype="int8")
    assert rec8["collectives"]["count"] == c["count"] + 2 * L
    moe = small("qwen2-moe-a2.7b")
    recm = dryrun.lower_one("qwen2-moe-a2.7b", "decode_32k", False,
                            cfg_override=moe, mesh_shape=(1, 2))
    assert recm["collectives"]["count"] == 1 + 3 * moe.n_layers + 1
    one = dryrun.lower_one("qwen2-1.5b", "prefill_32k", False,
                           cfg_override=cfg, mesh_shape=(1, 1))
    assert one["collectives"]["count"] == 0
    tr = dryrun.lower_one("qwen2-1.5b", "train_4k", False, cfg_override=cfg,
                          mesh_shape=(2, 2))["collectives"]
    n_leaves = len(port_leaves(T.abstract_params(cfg)))
    assert tr["reduce-scatter"] > 0 and tr["all-gather"] > 0
    assert tr["count"] > 2 * n_leaves


def test_skip_reasons_name_their_items():
    """The layouts of items 8.4 to 8.6 are laid out (a sequence- or
    head-dim-sharded cache, ZeRO-3, a context-parallel cache, the
    reference's expert-parallel MoE scheme): no arch x shape x production
    mesh x layout is skipped but whisper's long_500k, and an unknown MoE
    scheme raises naming the choices.  Each record's ``kv_shard`` is the layout
    the reference's ``cache_pspecs`` picks at a model axis of 16: the
    sequence for the seven archs whose KV heads 16 does not divide, the
    heads for qwen2-moe and zamba2 (and the SSM family, with none); the
    context-parallel cache keeps the heads on "model"."""
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        for arch in list_archs():
            for shape in S.SHAPES.values():
                for kw in ({}, {"kv_shard": "seq"}, {"kv_shard": "head_dim"},
                           {"params_data_sharded": True},
                           {"moe_scheme": "expert"}):
                    why = dryrun.skip_reason(get_config(arch), shape, m, **kw)
                    assert why is None or why.startswith("long_500k"), (
                        arch, shape.name, why)
    seq = {a for a in list_archs()
           if PT.kv_layout(get_config(a), 16, "auto") == "seq"}
    assert seq == {"qwen2-1.5b", "llama3.2-3b", "yi-6b", "qwen1.5-32b",
                   "mixtral-8x7b", "qwen2-vl-7b", "whisper-large-v3"}
    assert PT.kv_layout(get_config("zamba2-7b"), 16) == "heads"
    with pytest.raises(ValueError, match="moe_scheme must be one of"):
        dryrun.skip_reason(get_config("qwen2-moe-a2.7b"),
                           S.SHAPES["decode_32k"], make_production_mesh(),
                           moe_scheme="replicated")
    for arch in list_archs():
        cfg = get_config(arch)
        if cfg.long_context_mode == "unsupported":
            r = dryrun.lower_one(arch, "long_500k", False)
            assert r["reason"] == "long_500k unsupported (see DESIGN.md)"


def test_dryrun_module_runs_as_a_program(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "decode_32k", "--mesh-shape", "2,2",
         "--kv-dtype", "int8", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK   qwen2-1.5b x decode_32k x single")
    rec = json.loads((tmp_path / "qwen2-1.5b_decode_32k_single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh_shape"] == [2, 2]
    assert rec["kv_dtype"] == "int8" and rec["collectives"]["count"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 1e9


def test_seq_layout_holds_an_eighth_of_the_busiest_head_rank():
    """qwen2-1.5b at decode_32k on the single production mesh, "auto": each
    of the 16 ranks holds both KV heads over 2048 of the 32768 rows,
    28 x 2 x 8 x 2048 x 2 x 128 x 2 B = 469,762,048 bytes (plus the 32
    bytes of ``len``), 1/8 of what a rank holding a whole KV head would
    hold in the head layout (only the cache is built, no step traced)."""
    cfg, shape = get_config("qwen2-1.5b"), S.SHAPES["decode_32k"]
    mesh = make_production_mesh()
    for kv_shard, want in (("auto", 469_762_048), ("heads", 3_758_096_384)):
        _, inputs, _ = dryrun.rank_program(cfg, shape, mesh,
                                           kv_shard=kv_shard)
        held = [sum(dryrun._storages(c).values()) - 32
                for _, c in dryrun.rank_owners(inputs, "decode")]
        assert max(held) == want
    assert 8 * 469_762_048 == 3_758_096_384


# --------------------------------------------------------------------------- #
# Cost probes
# --------------------------------------------------------------------------- #


def _cost(f, b, c):
    return {"flops": f, "bytes_accessed": b, "collective_bytes": c}


def test_axpy():
    out = costprobe._axpy(_cost(10, 20, 30), _cost(1, 2, 3), 1.0, 2.0)
    assert out == _cost(12, 24, 36)


def test_extrapolate_linear_dense():
    cfg = get_config("yi-6b")  # 32 layers
    # cost(L) = 5 + 3L  ->  c2 = 11, c4 = 17, want cost(32) = 101
    got = costprobe._extrapolate(cfg, [_cost(11, 11, 11), _cost(17, 17, 17)])
    assert got["flops"] == pytest.approx(5 + 3 * 32)


def test_extrapolate_hybrid_group_tail():
    cfg = get_config("zamba2-7b")  # 81L = 13 groups*6 + 3 tail
    a, g, t = 7.0, 11.0, 2.0
    c12 = _cost(*[a + 2 * g] * 3)             # G=2, T=0
    c15 = _cost(*[a + 2 * g + 3 * t] * 3)     # G=2, T=3
    c24 = _cost(*[a + 4 * g] * 3)             # G=4, T=0
    got = costprobe._extrapolate(cfg, [c12, c15, c24])
    assert got["flops"] == pytest.approx(a + 13 * g + 3 * t)


def test_extrapolate_audio_joint():
    cfg = get_config("whisper-large-v3")  # enc=dec=32
    got = costprobe._extrapolate(cfg, [_cost(16, 16, 16), _cost(28, 28, 28)])
    assert got["flops"] == pytest.approx(4 + 6 * 32)


@pytest.mark.parametrize("arch,n_layers", [("qwen2-1.5b", 5),
                                           ("zamba2-7b", 27),
                                           ("whisper-large-v3", 3)])
def test_probe_equals_the_direct_count(arch, n_layers, tiny_shapes,
                                       tmp_path):
    """The port counts every layer, so the reference's affine models give
    back the direct full-depth record (the hybrid at 4 groups of 6 and 3
    tail layers; the audio family with its encoder as deep as its
    decoder)."""
    cfg = small(arch, n_layers=n_layers)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=n_layers))
    if cfg.family == "hybrid":  # the probes' groups of 6, as published
        cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, attn_every=6))
    kw = dict(mesh_shape=(1, 2))
    got = costprobe.probe(arch, "prefill_32k", cfg_override=cfg,
                          out_dir=str(tmp_path), **kw)
    assert got["status"] == "ok", got
    direct = dryrun.lower_one(arch, "prefill_32k", False, cfg_override=cfg,
                              **kw)
    want = costprobe._extract(direct)
    for k in costprobe.KEYS:
        assert got["corrected"][k] == pytest.approx(want[k], rel=1e-9)
    assert (tmp_path / f"{arch}_prefill_32k_single.json").exists()
