"""The layouts the dry run lowers, run on the CPU against one device and
the JAX package: int8 caches under a mesh, the data axes of the step
functions, and training under a mesh with ZeRO-1 moments.

* int8 pods (TP=2 of every family with K/V sites, and qwen2-1.5b-shaped
  heads at TP=4, where two ranks hold each KV head): the shared-scale
  write gives every rank the one-device cache's codes and scales bit for
  bit on the same K/V; the pod's fp32 greedy tokens over serve steps are
  one device's; its fp32 decode logits lie within ``INT8_POD_RTOL`` of
  the JAX single-device int8 serve step's (the JAX TP engine is no
  oracle here: its TP tests fail under the installed JAX, ROADMAP.md
  section 3), and the planted fault, each rank quantizing with its own
  heads' scale, lies outside it.  The reference's hybrid and audio
  prefills over an int8 cache raise (``dynamic_update_slice`` of int8
  codes with fp32 K), so those pods are held against the port's one
  device, which the other families show equal to the reference.
* Data axes: a (2, 2) mesh's prefill, serve and train steps equal one
  device's: fp32 tokens identical, and after one train step the ZeRO-1
  moments and params within ``ZERO1_MOMENT_RTOL`` and
  ``ZERO1_PARAM_RTOL`` of one device's.
* Training under a ("model",) mesh, TP=2 of dense, MoE and SSM: the
  pod's loss and gathered gradients equal one device's and the
  reference's ``jax.value_and_grad`` (``tests/_lm_parity.py``'s
  tolerances), and ZeRO-1's slices after one step equal the unsliced
  update within the same two limits, which a step that updates nothing,
  one that sums one pod's gradients alone and one that gathers a copy of
  its own slice in place of the other data index's all fail.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _lm_parity as H  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import make_mesh, shard_params  # noqa: E402
from repro_torch.launch import partition as PT  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import counting_collectives  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import adamw_init  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.tree import leaves, tree_map  # noqa: E402

#: fp32 decode logits of an int8 pod against the JAX single-device int8
#: step, largest difference over the largest |logit|: each rank's K/V
#: projection sums in another order than the whole one, which could move
#: a code by one step (1/127 of a token's amax) where a value sits on a
#: rounding edge.  Read here: 3e-7 to 4e-7 for the correct pods, 2.6e-3
#: to 3.0e-3 for the planted per-rank scales (every rank but the one
#: holding the token's amax rescales its codes); chip_smoke.py's phase 16
#: holds the card to the same limit
INT8_POD_RTOL = 3e-4
#: the ZeRO-1 checks' AdamW: a constant lr from the first step, so that
#: one step moves every param by about lr (the default's 100-step warmup
#: moves it by lr / 100, under any absolute limit a fault would read)
ZERO1_OPT = AdamWConfig(lr=1e-3, schedule="constant", warmup_steps=1)
#: ZeRO-1's moments gathered against one device's, each leaf's largest
#: difference over its largest |value|: the pods' gradients sum in another
#: order.  Read here: 4.4e-7 to 1.9e-6 sound; 1.0 to 1.5 for the planted
#: faults (test_zero1_planted_faults_fail_the_gates)
ZERO1_MOMENT_RTOL = 1e-4
#: ZeRO-1's params after one step against one device's, the norm of the
#: difference over the norm of one device's update: Adam's first step is
#: lr * g / (|g| + eps), so a gradient within its rounding of zero may
#: flip an element's step.  Read here: 1.1e-6 to 6.4e-5 sound; 0.93 to 62
#: for the planted faults
ZERO1_PARAM_RTOL = 1e-3
FAMILIES = ["dense", "moe", "hybrid", "vlm", "audio"]
B, MAX_LEN, STEPS = 2, 32, 4


def cpu_mesh(shape, names=("model",)):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def fp32(family):
    jcfg, cfg = H.configs(family)
    return (dataclasses.replace(jcfg, dtype="float32"),
            dataclasses.replace(cfg, dtype="float32"))


def prompt_batch(cfg, seed=2):
    b = H.batch(cfg, seed=seed, mask=False)
    out = {"tokens": b["tokens"]}
    for k in ("embeds", "positions", "frames"):
        if k in b:
            out[k] = b[k]
    return out


def serve(cfg, params, batch, cache, mesh=None, steps=STEPS):
    """Prefill then ``steps`` greedy serve steps through the step
    functions: (the tokens (B, steps + 1), the logits of the first
    decode step)."""
    logits, _ = ST.make_prefill_step(cfg, mesh=mesh, attn_impl="kernel")(
        params, {**H.to_torch(batch), "cache": cache})
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    toks, first = [tok], None
    for _ in range(steps):
        lg, _ = T.decode_step(params, cfg, tok[:, None], cache, mesh=mesh)
        first = lg[:, -1] if first is None else first
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, 1), first


def jax_first_decode(jcfg, jp, batch):
    cache = JT.init_cache(jcfg, B, MAX_LEN, kv_dtype="int8")
    logits, cache = JT.prefill(jp, jcfg, H.to_jax(batch), cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    lg, _ = JT.decode_step(jp, jcfg, tok[:, None], cache)
    return np.asarray(lg[:, -1])


def zero1_gaps(cfg, params, mesh, tb):
    """One AdamW step of ``ZERO1_OPT`` on one device and one ZeRO-1 step
    on ``mesh``: (the moments' gap, the params' gap, as ``ZERO1_*_RTOL``
    define them, and the two losses)."""
    p1, s1, m1 = ST.make_train_step(cfg, opt_cfg=ZERO1_OPT)(
        params, adamw_init(params), tb)
    pods = ST.shard_pods(params, cfg, mesh)
    p2, s2, m2 = ST.make_train_step(cfg, mesh=mesh, opt_cfg=ZERO1_OPT)(
        pods, ST.zero1_init(pods, cfg, mesh), tb)
    moment = 0.0
    for got, want in ((s2.mu, s1.mu), (s2.nu, s1.nu)):
        whole = ST.zero1_gather(got, pods, cfg, mesh)
        for g, w in zip(leaves(whole), leaves(want)):
            assert g.shape == w.shape
            moment = max(moment, float((g - w).abs().max()
                                       / w.abs().max().clamp(min=1e-30)))
    step = torch.cat([(a - b).flatten()
                      for a, b in zip(leaves(p1), leaves(params))])
    param = max(float(torch.cat([
        (a - w).flatten() for a, w in zip(
            leaves(PT.gather_shards(pp, cfg, pod)), leaves(p1))]).norm()
        / step.norm()) for pod, pp in zip(ST._pod_list(mesh)[0], p2))
    return moment, param, (float(m1["loss"]), float(m2["loss"]))


def per_rank_scales(xs):
    """The planted fault: each rank quantizes with its own heads' amax."""
    return [L.quantize_kv(x) for x in xs]


@pytest.mark.parametrize("family,tp", [(f, 2) for f in FAMILIES]
                         + [("dense", 4)])
def test_int8_pod_equals_one_device(family, tp, monkeypatch):
    jcfg, cfg = fp32(family)
    jp, params = H.params(jcfg)
    mesh = cpu_mesh((tp,))
    shards = shard_params(params, cfg, mesh)
    batch = prompt_batch(cfg)
    one = T.init_cache(cfg, B, MAX_LEN, "cpu", kv_dtype="int8")
    pod = T.init_cache(cfg, B, MAX_LEN, mesh=mesh, kv_dtype="int8")
    ops.reset_launches()
    want, want_first = serve(cfg, params, batch, one)
    got, got_first = serve(cfg, shards, batch, pod, mesh)
    assert torch.equal(got, want)
    for c in pod[1:]:  # every rank's copy of the scales is the same
        assert torch.equal(c["kv"].k_scale, pod[0]["kv"].k_scale)
        assert torch.equal(c["kv"].v_scale, pod[0]["kv"].v_scale)
    # on the CPU the wrappers run their plain versions and launch nothing
    assert ops.flash_decode_int8_sharded.launches == 0
    if family in ("hybrid", "audio"):
        with pytest.raises(TypeError, match="dynamic_update_slice"):
            jax_first_decode(jcfg, jp, batch)
        ref = want_first.numpy()
    else:
        ref = jax_first_decode(jcfg, jp, batch)
        assert H.rel_gap(want_first.numpy(), ref) <= INT8_POD_RTOL
    assert H.rel_gap(got_first.numpy(), ref) <= INT8_POD_RTOL
    if family in ("dense", "moe") and tp == 2:
        monkeypatch.setattr(L, "quantize_kv_shared", per_rank_scales)
        bad = T.init_cache(cfg, B, MAX_LEN, mesh=mesh, kv_dtype="int8")
        _, bad_first = serve(cfg, shards, batch, bad, mesh, steps=1)
        assert H.rel_gap(bad_first.numpy(), ref) > INT8_POD_RTOL


@pytest.mark.parametrize("tp", [2, 4])
def test_shared_scale_writes_the_one_device_codes(tp):
    """The same K/V split by KV head over the ranks (qwen2-1.5b's 2 KV
    heads at TP=4: ranks 0-1 hold head 0) write each rank the codes of
    its heads and the scales of the one-device cache, bit for bit, and
    record one all-reduce for K and one for V."""
    _, cfg = fp32("dense")
    gen = torch.Generator().manual_seed(0)
    k, v = (torch.randn((B, 9, cfg.n_kv_heads, cfg.head_dim), generator=gen)
            for _ in range(2))
    one = T.init_cache(cfg, B, 16, "cpu", kv_dtype="int8")["kv"]
    T._write_prompts([one], 1, [k], [v])
    pod = [c["kv"] for c in T.init_cache(cfg, B, 16, mesh=cpu_mesh((tp,)),
                                         kv_dtype="int8")]
    ranges = [PT.kv_head_range(cfg, tp, r) for r in range(tp)]
    with counting_collectives() as coll:
        T._write_prompts(pod, 1, [k[:, :, lo:hi] for lo, hi in ranges],
                         [v[:, :, lo:hi] for lo, hi in ranges])
    assert coll["all-reduce"] > 0 and coll["count"] == 2
    for c, (lo, hi) in zip(pod, ranges):
        assert torch.equal(c.k[:, :, :, :], one.k[:, :, :, lo:hi])
        assert torch.equal(c.v, one.v[:, :, :, lo:hi])
        assert torch.equal(c.k_scale, one.k_scale)
        assert torch.equal(c.v_scale, one.v_scale)


def test_data_axes_equal_one_device():
    """A (2, 2) mesh: two pods of two ranks, two rows each."""
    jcfg, cfg = fp32("dense")
    _, params = H.params(jcfg)
    mesh = cpu_mesh((2, 2), ("data", "model"))
    pods = ST.shard_pods(params, cfg, mesh)
    assert len(pods) == 2 and all(len(p) == 2 for p in pods)
    batch = H.to_torch(prompt_batch(cfg))
    b = 4
    batch = {"tokens": torch.cat([batch["tokens"]] * 2)[:b]}
    batch["tokens"][2:] = (batch["tokens"][2:] * 7 + 3) % cfg.vocab_size
    one = T.init_cache(cfg, b, MAX_LEN, "cpu")
    caches = ST.init_pod_caches(cfg, b, MAX_LEN, mesh)
    assert [c[0]["len"].shape[0] for c in caches] == [2, 2]
    lg1, _ = ST.make_prefill_step(cfg)(params, {**batch, "cache": one})
    lg2, _ = ST.make_prefill_step(cfg, mesh=mesh)(pods,
                                                  {**batch, "cache": caches})
    assert lg2.shape == lg1.shape
    assert float((lg1 - lg2).abs().max()) <= 1e-4
    tok = lg1[:, -1].argmax(-1).to(torch.int32)
    s1, s2 = ST.make_serve_step(cfg), ST.make_serve_step(cfg, mesh=mesh)
    t1 = t2 = tok[:, None]
    for _ in range(STEPS):
        n1, _ = s1(params, t1, one)
        n2, _ = s2(pods, t2, caches)
        assert torch.equal(n1, n2)
        t1, t2 = n1[:, None], n2[:, None]
    # a batch the pods do not divide goes whole to every pod
    assert ST.pod_rows(mesh, 3) == [slice(0, 3)] * 2
    # one train step, each pod on rows of its own
    halves = [H.to_torch(H.batch(cfg, seed=s)) for s in (1, 5)]
    tb = {k: torch.cat([h[k] for h in halves]) for k in halves[0]}
    moment, param, (l1, l2) = zero1_gaps(cfg, params, mesh, tb)
    assert abs(l1 - l2) <= 1e-5
    assert moment <= ZERO1_MOMENT_RTOL
    assert param <= ZERO1_PARAM_RTOL


@pytest.mark.parametrize("family", ["dense", "moe", "ssm"])
def test_pod_training_equals_one_device_and_the_reference(family):
    r = H.reference(family)
    cfg = r["cfg"]
    mesh = cpu_mesh((2,))
    shards = shard_params(r["tp"], cfg, mesh)
    flat = [[t.detach().clone().requires_grad_(True) for t in leaves(s)]
            for s in shards]
    trees = [H.unflatten(s, f) for s, f in zip(shards, flat)]
    loss, aux = loss_fn(trees, cfg, H.to_torch(r["batch"]), mesh=mesh,
                        remat=True)
    every = [t for f in flat for t in f]
    grads = torch.autograd.grad(loss, every, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(every, grads))
    rank_grads = [H.unflatten(s, [next(it) for _ in f])
                  for s, f in zip(shards, flat)]
    got = [g.numpy() for g in leaves(PT.gather_shards(rank_grads, cfg, mesh,
                                                      add=True))]
    assert abs(loss.item() - r["loss"]) <= H.LOSS_RTOL * abs(r["loss"])
    assert max(H.grad_gaps(got, r["grads"])) <= H.GRAD_RTOL
    one_loss, _, one = H.torch_loss_and_grads(loss_fn, cfg, r["tp"],
                                              r["batch"])
    assert abs(loss.item() - one_loss) <= H.LOSS_RTOL * abs(one_loss)
    assert max(H.grad_gaps(got, one)) <= H.GRAD_RTOL


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_zero1_slices_equal_the_unsliced_update(shape):
    r = H.reference("dense")
    cfg = r["cfg"]
    mesh = cpu_mesh(shape, ("data", "model"))
    assert any(d is not None for d in ST._zero1_dims(cfg, mesh, r["tp"]))
    pods = ST.shard_pods(r["tp"], cfg, mesh)
    state = ST.zero1_init(pods, cfg, mesh)
    whole = adamw_init(r["tp"])
    for got, want in ((state.mu, whole.mu), (state.nu, whole.nu)):
        assert [t.shape for t in leaves(ST.zero1_gather(got, pods, cfg, mesh))
                ] == [t.shape for t in leaves(want)]
    moment, param, _ = zero1_gaps(cfg, r["tp"], mesh,
                                  H.to_torch(H.batch(cfg, mask=False)))
    assert moment <= ZERO1_MOMENT_RTOL
    assert param <= ZERO1_PARAM_RTOL


@pytest.mark.parametrize("fault", ["no_update", "unsummed", "stale_slice"])
def test_zero1_planted_faults_fail_the_gates(fault, monkeypatch):
    """A ZeRO-1 step that updates nothing, one that sums the first pod's
    gradients alone, and one where every data index updates the first
    slice (so the gather joins copies of it) fail both limits."""
    if fault == "no_update":
        monkeypatch.setattr(ST, "adamw_leaf",
                            lambda opt, step, lr, p, g, m, v: (p, m, v))
    elif fault == "unsummed":
        pod_grads, calls = ST._pod_grads, [0]

        def first_pod_only(*args, **kwargs):
            g, m = pod_grads(*args, **kwargs)
            calls[0] += 1
            return (g if calls[0] % 2 else tree_map(torch.zeros_like, g)), m

        monkeypatch.setattr(ST, "_pod_grads", first_pod_only)
    else:
        cut = ST._cut
        monkeypatch.setattr(ST, "_cut",
                            lambda d, i, n, size: cut(d, 0, n, size))
    r = H.reference("dense")
    cfg = r["cfg"]
    moment, param, _ = zero1_gaps(cfg, r["tp"],
                                  cpu_mesh((2, 2), ("data", "model")),
                                  H.to_torch(H.batch(cfg, mask=False)))
    assert moment > ZERO1_MOMENT_RTOL
    assert param > ZERO1_PARAM_RTOL


def test_zero3_step_equals_zero1_and_one_device():
    """ZeRO-3 (``params_data_sharded``) at (2, 1): each data index holds
    its ZeRO-1 slice of every leaf, gathered each step.  One step's
    slices, gathered, equal the ZeRO-1 step's params bit for bit (the
    same sums in the same order), its loss ZeRO-1's, and ZeRO-1's lie
    within ``ZERO1_*_RTOL`` of one device's (``zero1_gaps``)."""
    jcfg, cfg = fp32("dense")
    _, params = H.params(jcfg)
    mesh = cpu_mesh((2, 1), ("data", "model"))
    halves = [H.to_torch(H.batch(cfg, seed=s)) for s in (1, 5)]
    tb = {k: torch.cat([h[k] for h in halves]) for k in halves[0]}
    pods = ST.shard_pods(params, cfg, mesh)
    p1, _, m1 = ST.make_train_step(cfg, mesh=mesh, opt_cfg=ZERO1_OPT)(
        pods, ST.zero1_init(pods, cfg, mesh), tb)
    sliced = ST.zero3_shard(pods, cfg, mesh)
    halved = [(a.numel(), b.numel()) for a, b in zip(leaves(sliced[0][0]),
                                                       leaves(pods[0][0]))]
    assert any(2 * a == b for a, b in halved)
    p3, _, m3 = ST.make_train_step(cfg, mesh=mesh, opt_cfg=ZERO1_OPT,
                                   params_data_sharded=True)(
        sliced, ST.zero1_init(pods, cfg, mesh), tb)
    assert float(m3["loss"]) == float(m1["loss"])
    for got, want in zip(ST.zero3_gather(p3, cfg, mesh), p1):
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(leaves(g),
                                                          leaves(w)))
    moment, param, (l1, l2) = zero1_gaps(cfg, params, mesh, tb)
    assert abs(l1 - l2) <= 1e-5
    assert moment <= ZERO1_MOMENT_RTOL and param <= ZERO1_PARAM_RTOL
