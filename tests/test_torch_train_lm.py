"""The port's LM training path against the JAX package on the CPU, dense,
MoE and vlm families (the recurrent and audio families, the CLI and the
trace generator: ``tests/test_torch_train_lm_recurrent.py``).

Configurations smaller than ``.reduced()`` (``tests/_lm_parity.py``:
2 layers, d_model 64, vocab 256, S = 16 plus the vlm's 4 patches), fp32,
the reference's parameters converted by the bridge, inputs from a numpy
seed.  Tolerances: logits 1e-5 and the loss 1e-5 relative; every
gradient leaf 1e-4 of its largest magnitude (two fp32 programs that sum
in different orders: ~1e-6 seen); remat changes nothing; one
``make_train_step`` against the reference's as argued at
:func:`test_train_step_matches_reference`.  Also the kernel wrappers'
refusal under autograd and the mesh refusal (their card test:
``tests/test_torch_train_lm_card.py``).
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import _lm_parity as H  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.training import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import dryrun, shard_params  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import forward, loss_fn  # noqa: E402
from repro_torch.training import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.training.tree import leaves  # noqa: E402

FAMILIES = ["dense", "moe", "vlm"]


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_reference(family):
    r = H.reference(family)
    with torch.no_grad():
        logits, aux = forward(r["tp"], r["cfg"], H.to_torch(r["batch"]))
    assert tuple(logits.shape) == r["logits"].shape
    assert H.rel_gap(logits.numpy(), r["logits"]) <= H.LOGIT_RTOL
    assert abs(aux.item() - r["aux"]) <= 1e-5 * max(1.0, abs(r["aux"]))
    assert (aux.item() > 0) == (family == "moe")


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_grads_match_reference(family):
    r = H.reference(family)
    loss, parts, grads = H.torch_loss_and_grads(loss_fn, r["cfg"], r["tp"],
                                                r["batch"])
    assert abs(loss - r["loss"]) <= H.LOSS_RTOL * abs(r["loss"])
    for k in ("ce", "aux"):
        assert abs(parts[k] - r["parts"][k]) <= H.LOSS_RTOL * max(
            1.0, abs(r["parts"][k]))
    gaps = H.grad_gaps(grads, r["grads"])
    assert max(gaps) <= H.GRAD_RTOL, gaps
    # every leaf is reached: a cut path would read zero here
    assert all(np.abs(g).max() > 0 for g in grads)


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_matches_no_remat(family):
    r = H.reference(family)
    plain = H.torch_loss_and_grads(loss_fn, r["cfg"], r["tp"], r["batch"])
    remat = H.torch_loss_and_grads(loss_fn, r["cfg"], r["tp"], r["batch"],
                                   remat=True)
    assert abs(plain[0] - remat[0]) < 1e-6
    assert max(H.grad_gaps(remat[2], plain[2])) < 1e-6


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_train_step_matches_reference(family):
    """One whole step from a fresh AdamW state, lr 1e-2, constant.  The
    first AdamW update of a component is lr * g / (|g| + eps) (plus the
    weight decay): about lr * sign(g) wherever |g| >> eps = 1e-8.  Where
    |g| is within the two programs' gradient gap of 0, the sign may
    differ, so no component may move more than 2 lr + 1e-6 from the
    reference's; where |g| is above 1e-3 of its leaf's largest gradient
    (well above both eps and the gap), the update's derivative eps / |g|^2
    times the gap keeps the params within 1e-6."""
    r = H.reference(family)
    lr = 1e-2
    jopt = JAdamWConfig(lr=lr, schedule="constant", warmup_steps=0)
    jstep = jax.jit(JSTEPS.make_train_step(r["jcfg"], opt_cfg=jopt))
    jp, _, jloss = jstep(r["jp"], jax_adamw_init(r["jp"]),
                         H.to_jax(r["batch"]))
    step = steps.make_train_step(r["cfg"], opt_cfg=AdamWConfig(
        lr=lr, schedule="constant", warmup_steps=0))
    tp, state, m = step(r["tp"], adamw_init(r["tp"]), H.to_torch(r["batch"]))
    assert abs(m["loss"].item() - float(jloss)) <= H.LOSS_RTOL * abs(
        float(jloss))
    assert int(state.step) == 1 and m["grad_norm"].item() > 0
    for got, want, old, g in zip(leaves(tp), jax.tree_util.tree_leaves(jp),
                                 leaves(r["tp"]), r["grads"]):
        got, want = got.numpy(), np.asarray(want)
        assert not np.array_equal(got, old.numpy())
        gap = np.abs(got - want)
        assert gap.max() <= 2 * lr + 1e-6
        clear = np.abs(g) > 1e-3 * np.abs(g).max()
        assert gap[clear].max() <= 1e-6


@pytest.mark.parametrize("family", FAMILIES)
def test_input_specs_train_batch_matches_reference(family):
    """Full width on the meta device: the reference's train batch, key by
    key; then a tiny batch on the CPU, whose loss equals the reference's
    on the same (zero) inputs."""
    arch = H.ARCHS[family]
    want = JS.input_specs(jax_get_config(arch), JS.SHAPES["train_4k"])
    got = S.input_specs(get_config(arch), S.SHAPES["train_4k"])
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    r = H.reference(family)
    shape = S.InputShape("tiny", H.S + r["cfg"].frontend_tokens
                         * (family == "vlm"), H.B, "train")
    b = S.input_specs(r["cfg"], shape, device="cpu")
    with torch.no_grad():
        loss, _ = loss_fn(r["tp"], r["cfg"], b)
    jloss, _, _ = H.jax_loss_and_grads(
        r["jcfg"], r["jp"], {k: v.numpy() for k, v in b.items()})
    assert abs(loss.item() - jloss) <= H.LOSS_RTOL * abs(jloss)


def _kernel_inputs(name):
    """Small CPU inputs of each wrapper, float ones requiring grad."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g).requires_grad_(True)

    q1, k, v = rand(1, 1, 4, 16), rand(1, 8, 2, 16), rand(1, 8, 2, 16)
    lens = dict(kv_len=8, q_offset=7)
    if name == "flash_attention":
        return (rand(1, 8, 4, 16), k, v), {}
    if name == "flash_decode":
        return (q1, k, v), lens
    if name == "flash_decode_sharded":
        return ([q1[:, :, :2], q1[:, :, 2:]], [k[:, :, :1], k[:, :, 1:]],
                [v[:, :, :1], v[:, :, 1:]]), lens
    if name == "flash_decode_partials":  # a rank's rows [4, 12) of 16
        return (q1, k, v), dict(lens, row0=4)
    if name == "flash_decode_combine":
        return (rand(1, 4, 3, 16), rand(1, 4, 3, 2).abs()), {}
    if name.startswith("flash_decode_int8"):
        codes = torch.randint(-127, 128, (1, 8, 2, 16), generator=g,
                              dtype=torch.int8)
        args = (q1, codes, codes.clone(), rand(1, 8), rand(1, 8))
        if name == "flash_decode_int8":
            return args, lens
        if name == "flash_decode_int8_partials":
            return args, dict(lens, row0=4)
        # two ranks, one KV head each, sharing the scales
        return ([q1[:, :, :2], q1[:, :, 2:]], [codes[:, :, :1].contiguous(),
                codes[:, :, 1:].contiguous()], [codes[:, :, :1].clone(),
                codes[:, :, 1:].clone()], [args[3]] * 2, [args[4]] * 2), lens
    return (rand(1, 8, 2, 16), -rand(1, 8, 2).abs(), rand(1, 8, 2, 16),
            rand(1, 8, 2, 16)), dict(chunk=4)


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_kernel_wrappers_refuse_autograd(name):
    """Under grad with an input that requires it, every wrapper raises on
    the CPU as on the card (no fallback to its differentiable plain
    version); under ``torch.no_grad()`` it runs, uncounted on the CPU."""
    fn = ops.KERNELS[name]
    args, kw = _kernel_inputs(name)
    ops.reset_launches()
    with pytest.raises(NotImplementedError, match="has no backward"):
        fn(*args, **kw)
    with torch.no_grad():
        out = fn(*args, **kw)
    plain = getattr(ref, name)(*args, **kw)
    for o, p in zip(*(x if isinstance(x, (list, tuple)) else [x]
                      for x in (out, plain))):
        assert torch.equal(o, p.detach())
    assert all(f.launches == 0 for f in ops.KERNELS.values())


def test_loss_through_kernels_refuses_grad_and_mesh():
    r = H.reference("dense")
    tp = {k: v for k, v in r["tp"].items()}
    tp["embed"] = tp["embed"].clone().requires_grad_(True)
    b = H.to_torch(r["batch"])
    with pytest.raises(NotImplementedError, match="flash_attention"):
        loss_fn(tp, r["cfg"], b, attn_impl="kernel")
    with torch.no_grad():
        got, _ = loss_fn(tp, r["cfg"], b, attn_impl="kernel")
    assert abs(got.item() - r["loss"]) <= H.LOSS_RTOL * r["loss"]
    # under a mesh (ROADMAP.md queue 1, item 8.5, landed) the loss is the
    # reference's, and the dry run lays ZeRO-3 out too: its parameter
    # slices gather back into the pod's leaves
    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    pod, _ = loss_fn(shard_params(r["tp"], r["cfg"], mesh), r["cfg"], b,
                     mesh=mesh)
    assert abs(pod.item() - r["loss"]) <= H.LOSS_RTOL * r["loss"]
    assert forward(shard_params(r["tp"], r["cfg"], mesh), r["cfg"], b,
                   mesh=mesh)[0].shape == forward(r["tp"], r["cfg"],
                                                   b)[0].shape
    assert dryrun.skip_reason(get_config("yi-6b"), S.SHAPES["train_4k"],
                              mesh, params_data_sharded=True) is None
    grid = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    pods = steps.shard_pods(r["tp"], r["cfg"], grid)
    back = steps.zero3_gather(steps.zero3_shard(pods, r["cfg"], grid),
                              r["cfg"], grid)
    for got, want in zip(back, pods):
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(leaves(g),
                                                          leaves(w)))


def test_abstract_opt_state_is_fp32_on_meta():
    cfg = get_config("qwen2-1.5b")
    params = S.input_specs(cfg, S.SHAPES["train_4k"])  # any tree of tensors
    state = steps.abstract_opt_state(params)
    assert state.step.device.type == "meta" and state.step.dtype == torch.int32
    for mu, nu, p in zip(leaves(state.mu), leaves(state.nu), leaves(params)):
        assert mu.device.type == nu.device.type == "meta"
        assert mu.dtype == nu.dtype == torch.float32
        assert mu.shape == p.shape == nu.shape
    assert steps.DRYRUN_OPT == AdamWConfig(**JSTEPS.DRYRUN_OPT.__dict__)
