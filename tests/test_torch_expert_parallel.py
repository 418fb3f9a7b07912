"""The reference's expert-parallel MoE scheme (``moe_scheme="expert"``,
experts on "model") in the port, against the JAX package on the CPU: the
partition specs against the reference's ``param_pspecs``, whole experts
a rank (``partition.expert_range``) and their round trip, pods at TP=2,
3 and 4 (one with a rank that holds no expert) through prefill and
decode with both MoE paths against the JAX single device, one pod train
step against ``jax.value_and_grad`` of the reference's ``loss_fn``, a
planted expert-range fault, and the dry run's expert records against a
CPU run.  Configs: the reduced qwen2-moe-a2.7b (4 experts top-2 and a
shared MLP) and mixtral-8x7b (4 experts top-2, normalised weights, SWA),
fp32; cases cut the experts to 3 so that 4 ranks leave one empty.

Tolerance: ``TOL`` = 2e-5 abs + rel on fp32 logits, loss and gradients
(the ranks' partials round once each before they add, in rank order),
the tolerance of ``tests/test_torch_tp_moe.py``; gradients are held
relative to each leaf's largest magnitude.  Partition specs, shard
contents and the dry run's counts are compared exactly."""
import dataclasses
from contextlib import nullcontext

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _lm_parity as H  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import partition as JPT  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, make_mesh  # noqa: E402
from repro_torch.launch import partition as PT  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import adamw_init  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.tree import leaves, unflatten  # noqa: E402

TOL = 2e-5
MOE_ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b"]
EXPERT = dict(moe_scheme="expert")
B, PROMPT, MAX_LEN, STEPS = 3, 12, 32, 3


def cpu_mesh(shape, names=("model",)):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _experts(cfg, n):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=n))


_SETUPS = {}


def setup(arch, n_experts=None):
    """(JAX config, port config, JAX params, port params) of the reduced
    ``arch`` in fp32, with ``n_experts`` routed experts when given: one
    parameter tree for both packages, the expert and attention weights
    scaled by 3 so that routing and greedy tokens are not flat."""
    key = (arch, n_experts)
    if key not in _SETUPS:
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                   dtype="float32")
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        if n_experts is not None:
            jcfg, cfg = _experts(jcfg, n_experts), _experts(cfg, n_experts)
        tree = jax.tree_util.tree_map(
            np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
        layers = tree["layers"]
        for group in (layers["attn"], layers["moe"],
                      layers["moe"].get("shared", {})):
            for name in group:
                if name.startswith("w"):
                    group[name] = group[name] * np.float32(3.0)
        _SETUPS[key] = (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                        params_from_numpy(tree, "cpu"))
    return _SETUPS[key]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _paths(tree, names=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, names + (k,))
    else:
        yield names, tree


def _get(tree, names):
    for k in names:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------- #
# Partition
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_pspecs_equal_the_references_expert_scheme(arch):
    """Every leaf's spec under ``moe_scheme="expert"`` is the reference's
    (published config): the routed experts' leading expert axis on
    "model", the router, the gate and the shared path as before."""
    port = PT.param_pspecs(get_config(arch), **EXPERT)
    ref = JPT.param_pspecs(jax_get_config(arch), **EXPERT)
    n = 0
    for names, spec in _paths(port):
        want = _get(ref, names)
        assert tuple(spec) == tuple(want), names
        n += 1
    routed = _get(port, ("layers", "moe", "w_down"))
    assert tuple(routed) == (None, "model", None, None)
    assert n == len(jax.tree_util.tree_leaves(
        ref, is_leaf=lambda x: isinstance(x, JPT.P)))
    with pytest.raises(ValueError, match="moe_scheme"):
        PT.param_pspecs(get_config(arch), moe_scheme="replicated")


@pytest.mark.parametrize("tp,n_experts", [(2, None), (3, None), (4, 3)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_shard_gives_whole_experts_and_round_trips(arch, tp, n_experts):
    """Rank r holds the whole experts ``split_range(E, tp, r)`` of every
    routed leaf (4 over 3 ranks: 2, 1, 1; 3 over 4: 1, 1, 1, 0), each a
    contiguous tensor, every other leaf as the tensor scheme lays it;
    ``gather_shards`` gives the tree back exactly."""
    _, cfg, _, params = setup(arch, n_experts)
    mesh = cpu_mesh((tp,))
    shards = PT.shard_params(params, cfg, mesh, **EXPERT)
    tensor = PT.shard_params(params, cfg, mesh)
    e = cfg.moe.num_experts
    assert [PT.expert_range(cfg, tp, r)[1] - PT.expert_range(cfg, tp, r)[0]
            for r in range(tp)] == [-(-e // tp)] * (e % tp) + [e // tp] * (
                tp - e % tp)
    for names, leaf in _paths(params):
        pieces = [_get(s, names) for s in shards]
        if names[:2] == ("layers", "moe") and len(names) == 3 and names[
                -1] in ("w_gate", "w_up", "w_down"):
            for r, p in enumerate(pieces):
                e0, e1 = PT.expert_range(cfg, tp, r)
                assert p.is_contiguous()
                assert torch.equal(p, leaf[:, e0:e1]), (names, r)
        else:
            for p, q in zip(pieces, (_get(s, names) for s in tensor)):
                assert torch.equal(p, q), names
    assert PT.shard_scheme(shards, cfg) == "expert"
    assert PT.shard_scheme(tensor, cfg) == "tensor"
    back = PT.gather_shards(shards, cfg, mesh)
    for (names, a), (_, b) in zip(_paths(back), _paths(params)):
        assert torch.equal(a, b), names


@pytest.mark.parametrize("scheme", ["tensor", "expert"])
def test_shard_scheme_reads_the_trees_and_their_zero3_slices(scheme):
    """``partition.shard_scheme`` reads the scheme off a pod's rank trees
    and off their ZeRO-3 slices at (2, 2), where 3 layers leave the layer
    axis undivided so that the tensor scheme's expert axis is the one the
    slices cut; a single rank reads "tensor" (both lay it out alike)."""
    cfg = dataclasses.replace(setup("qwen2-moe-a2.7b")[1], n_layers=3)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    grid = cpu_mesh((2, 2), ("data", "model"))
    pods = ST.shard_pods(params, cfg, grid, moe_scheme=scheme)
    assert PT.shard_scheme(pods[0], cfg) == scheme
    slices = ST.zero3_shard(pods, cfg, grid)
    w = slices[0][0]["layers"]["moe"]["w_gate"]
    assert PT.shard_scheme(slices[0], cfg) == scheme, w.shape
    for got, want in zip(ST.zero3_gather(slices, cfg, grid), pods):
        for a, b in zip(leaves(got), leaves(want)):
            assert torch.equal(a, b)
    one = PT.shard_params(params, cfg, cpu_mesh((1,)), moe_scheme=scheme)
    assert PT.shard_scheme(one, cfg) == "tensor"


def test_shards_that_disagree_with_expert_range_raise():
    """A rank whose shard holds another count of experts than its
    ``expert_range`` (rank 1 given rank 0's two of 4 over 3 ranks) makes
    the MoE block raise, not compute the wrong experts."""
    _, cfg, _, params = setup("mixtral-8x7b")
    mesh = cpu_mesh((3,))
    shards = PT.shard_params(params, cfg, mesh, **EXPERT)
    shards[1]["layers"]["moe"] = shards[0]["layers"]["moe"]
    toks = torch.zeros((B, PROMPT), dtype=torch.int32)
    with pytest.raises(ValueError, match="expert_range"):
        T.prefill(shards, cfg, {"tokens": toks},
                  T.init_cache(cfg, B, MAX_LEN, mesh=mesh), mesh=mesh)


# --------------------------------------------------------------------------- #
# Pods against the JAX single device
# --------------------------------------------------------------------------- #

#: (arch, experts, tp): 4 experts over 2 and 3 ranks (uneven), and 3 over 4
#: ranks, the last of which holds none
PODS = [("qwen2-moe-a2.7b", None, 2), ("mixtral-8x7b", None, 3),
        ("qwen2-moe-a2.7b", 3, 4), ("mixtral-8x7b", 3, 4)]


def _jax_trace(jcfg, jp, toks, impl):
    """JAX single device: prefill logits, then ``STEPS`` greedy decode
    steps, [(tokens fed, logits)]."""
    jc = JT.init_cache(jcfg, B, MAX_LEN)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc,
                        moe_impl=impl)
    first, trace = np.asarray(jl), []
    for _ in range(STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                moe_impl=impl)
        trace.append((tok, np.asarray(jl)))
    return first, trace


def _pod_trace(cfg, params, tp, toks, trace, impl, scheme="expert"):
    """The pod's prefill logits, then its decode logits fed the JAX
    trace's tokens."""
    mesh = cpu_mesh((tp,))
    shards = PT.shard_params(params, cfg, mesh, moe_scheme=scheme)
    cache = T.init_cache(cfg, B, MAX_LEN, mesh=mesh)
    lg, _ = T.prefill(shards, cfg, {"tokens": torch.from_numpy(toks)},
                      cache, moe_impl=impl, mesh=mesh)
    out = [lg]
    for tok, _ in trace:
        lg, _ = T.decode_step(shards, cfg, torch.from_numpy(tok.copy()),
                              cache, moe_impl=impl, mesh=mesh)
        out.append(lg)
    return out


@pytest.mark.parametrize("impl", ["dense", "grouped"])
@pytest.mark.parametrize("arch,n_experts,tp", PODS,
                         ids=[f"{a.split('-')[0]}-E{e or 4}-tp{t}"
                              for a, e, t in PODS])
def test_expert_pod_matches_jax_single_device(arch, n_experts, tp, impl):
    """Prefill and ``STEPS`` decode steps of an expert-parallel pod, the
    MoE block on ``impl`` in both packages, within ``TOL`` of the JAX
    single device at every step; the tensor-scheme pod agrees too."""
    jcfg, cfg, jp, params = setup(arch, n_experts)
    toks = np.random.RandomState(tp).randint(
        0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32)
    first, trace = _jax_trace(jcfg, jp, toks, impl)
    want = [first] + [lg for _, lg in trace]
    got = _pod_trace(cfg, params, tp, toks, trace, impl)
    for g, w in zip(got, want):
        _close(g, w)
    for g, w in zip(_pod_trace(cfg, params, tp, toks, trace, impl,
                               "tensor"), got):
        _close(g, w)


def test_planted_expert_range_shift_is_caught(monkeypatch):
    """Rank 1 of a TP=4 pod of 4 experts computing its range shifted by
    one (it reads rank 2's first expert's routing with its own weights)
    lies far outside ``TOL``: the gate ``chip_smoke.py`` holds the card
    to catches it."""
    jcfg, cfg, jp, params = setup("qwen2-moe-a2.7b")
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32)
    first, trace = _jax_trace(jcfg, jp, toks, "grouped")
    rank_experts = M.rank_experts

    def shifted(cfg, tp, rank):
        e0, e1 = rank_experts(cfg, tp, rank)
        return (e0 + 1, e1 + 1) if rank == 1 else (e0, e1)

    monkeypatch.setattr(M, "rank_experts", shifted)
    for impl in ("dense", "grouped"):
        got = _pod_trace(cfg, params, 4, toks, trace, impl)
        gap = max(float(np.abs(np.asarray(g) - w).max())
                  for g, w in zip(got, [first] + [lg for _, lg in trace]))
        assert gap > 100 * TOL, (impl, gap)


def test_expert_pod_train_step_matches_jax():
    """The loss and gradients of a TP=2 expert pod, gathered
    (``gather_shards(add=True)``), against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` within ``TOL``; one ZeRO-1 step at (1, 2)
    reads the same loss and moves the params as one device's step."""
    jcfg, cfg = H.configs("moe")
    jcfg, cfg = _experts(jcfg, 3), _experts(cfg, 3)
    jp, tp = H.params(jcfg)
    b = H.batch(cfg)
    jloss, _, jgrads = H.jax_loss_and_grads(jcfg, jp, b)
    mesh = cpu_mesh((2,))
    shards = PT.shard_params(tp, cfg, mesh, **EXPERT)
    flat = [[t.detach().clone().requires_grad_(True) for t in leaves(s)]
            for s in shards]
    trees = [unflatten(s, f) for s, f in zip(shards, flat)]
    loss, _ = loss_fn(trees, cfg, H.to_torch(b), mesh=mesh, remat=True)
    every = [t for f in flat for t in f]
    grads = torch.autograd.grad(loss, every, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(every, grads))
    rank_grads = [unflatten(s, [next(it) for _ in f])
                  for s, f in zip(shards, flat)]
    got = [g.numpy() for g in leaves(PT.gather_shards(
        rank_grads, cfg, mesh, add=True))]
    assert abs(loss.item() - jloss) <= TOL * (1 + abs(jloss))
    assert max(H.grad_gaps(got, jgrads)) <= TOL
    opt = AdamWConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    tb = H.to_torch(H.batch(cfg, mask=False))
    p1, _, m1 = ST.make_train_step(cfg, opt_cfg=opt)(tp, adamw_init(tp), tb)
    pods = ST.shard_pods(tp, cfg, mesh, **EXPERT)
    p2, _, m2 = ST.make_train_step(cfg, mesh=mesh, opt_cfg=opt)(
        pods, ST.zero1_init(pods, cfg, mesh), tb)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= TOL * (
        1 + abs(float(m1["loss"])))
    step = torch.cat([(a - w).flatten() for a, w in zip(leaves(p1),
                                                        leaves(tp))])
    gap = torch.cat([(a - w).flatten() for a, w in zip(
        leaves(PT.gather_shards(p2, cfg, mesh)), leaves(p1))])
    assert float(gap.norm() / step.norm()) <= 1e-3


# --------------------------------------------------------------------------- #
# The dry run
# --------------------------------------------------------------------------- #


def test_skip_reason_lays_out_the_expert_scheme():
    """No skip for either MoE arch under ``"expert"`` on either production
    mesh and shape but whisper's long_500k (not an MoE arch)."""
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in MOE_ARCHS:
            for shape in S.SHAPES.values():
                assert dryrun.skip_reason(get_config(arch), shape, mesh,
                                          **EXPERT) is None, (arch, shape)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,n_experts,mesh_shape",
                         [("qwen2-moe-a2.7b", None, (1, 2)),
                          ("mixtral-8x7b", 3, (2, 4))])
def test_expert_records_equal_a_cpu_run(arch, n_experts, mesh_shape, kind):
    """The dry run's expert record on the meta device against the same
    rank program on CPU tensors: the pod's flops and argument bytes exact,
    the busiest rank's flops and arguments and the collectives equal
    ``dryrun.measure`` of the CPU run (its bytes do not: on the CPU a
    kernel's wrapper runs its plain version's ops); the busiest rank holds the
    most experts' bytes (mixtral's 3 over 4: one rank holds none)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              n_layers=2)
    if n_experts:
        cfg = _experts(cfg, n_experts)
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    shape = S.InputShape(name, 32, 16 if kind == "decode" else 4, kind)
    rec = dryrun.lower_one(arch, name, False, cfg_override=cfg,
                           mesh_shape=mesh_shape, input_shape=shape,
                           **EXPERT)
    assert rec["status"] == "ok", rec
    assert rec["moe_scheme"] == "expert"
    mesh = cpu_mesh(mesh_shape, ("data", "model"))
    grad = nullcontext() if kind == "train" else torch.no_grad()
    step, inputs, tp = dryrun.rank_program(cfg, shape, mesh, **EXPERT)
    with grad, FlopCounterMode(display=False) as fc:
        step(*inputs)
    assert fc.get_total_flops() == rec["cost_analysis"]["pod flops"] > 0
    assert sum(dryrun._storages(inputs).values()) == (
        rec["memory_analysis"]["pod_argument_size_in_bytes"])
    step, inputs, tp = dryrun.rank_program(cfg, shape, mesh, **EXPERT)
    with grad:
        m = dryrun.measure(step, *inputs,
                           owners=dryrun.rank_owners(inputs, kind))
    assert m["flops"] == rec["flops"] and len(m["ranks"]) == tp
    assert m["argument"] == rec["memory_analysis"]["argument_size_in_bytes"]
    assert m["collectives"] == rec["collectives"]
    args = [r["argument"] for r in m["ranks"]]
    held = [PT.expert_range(cfg, tp, r) for r in range(tp)]
    most = max(range(tp), key=lambda r: held[r][1] - held[r][0])
    assert args[most] == max(args)
    if n_experts:
        assert min(args) < max(args)
