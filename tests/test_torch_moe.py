"""The port's MoE family against the JAX reference on the reduced
qwen2-moe-a2.7b (4 experts top-2, one shared MLP with its sigmoid gate,
``norm_topk_prob=False``) and mixtral-8x7b (4 experts top-2, normalised
top-k weights, SWA), fp32: the router with planted ties, the aux loss, the
dense and grouped blocks, prefill logits and caches, masked decode steps,
chunked against one-shot prefill, the step functions, and the engine's
greedy tokens.

Tolerance: fp32 1e-5 abs + rel on every output (the same arithmetic summed
in another order); expert indices, lengths and tokens are compared
exactly.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import Job as JaxJob  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import (cache_from_numpy, params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 1e-5
ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b"]


def _setup(arch):
    """One parameter tree for both packages: the reference init with the
    layer weights scaled by 3, so that greedy streams do not settle on one
    repeated token."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    layers = tree["layers"]
    for group in (layers["attn"], layers["moe"], layers["moe"].get("shared",
                                                                   {})):
        for name in group:
            if name.startswith("w"):
                group[name] = group[name] * np.float32(3.0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, cfg, jp, params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _tied_layer(jp):
    """Layer 0's MoE parameters for both packages, with a router whose
    experts 0, 1 and 2 have equal columns of multiples of 1/8: over
    integer-valued tokens (:func:`_tied_tokens`) their logits are exact
    and tie, so a three-way tie at the top decides which two run."""
    lp = jax.tree_util.tree_map(lambda a: np.array(a[0]), jp["layers"]["moe"])
    rng = np.random.RandomState(11)
    router = rng.randint(-2, 3, size=lp["router"].shape).astype(np.float32)
    router[:, 1] = router[:, 2] = router[:, 0]
    lp["router"] = router / 8
    return (jax.tree_util.tree_map(jnp.asarray, lp),
            params_from_numpy(lp, "cpu"))


def _tied_tokens(cfg, n=24, seed=5):
    """Integer-valued inputs (T, d): their router logits are exact."""
    rng = np.random.RandomState(seed)
    return rng.randint(-2, 3, size=(n, cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------- #
# The MoE block
# --------------------------------------------------------------------------- #


def test_top_k_breaks_ties_like_lax_top_k():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1], [0.0, 0.5, 0.2, 0.5]],
                     np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = M.top_k(_t(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_router_probs_with_planted_ties(setup):
    jcfg, cfg, jp, tp = setup
    jl, tl = _tied_layer(jp)
    x = _tied_tokens(cfg)
    jprobs, jw, ji = JM.router_probs(jl, jcfg, jnp.asarray(x))
    probs, w, i = M.router_probs(tl, cfg, _t(x))
    logits = x @ np.asarray(jl["router"])
    top = logits.max(-1, keepdims=True)
    three_way = ((logits[:, :3] == top).all(-1)).sum()
    assert three_way > 0, "no token ties three experts at the top"
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(probs, jprobs)
    _close(w, jw)
    if cfg.moe.norm_topk_prob:
        _close(w.sum(-1), np.ones(len(x)))


def test_load_balance_loss_matches_reference(setup):
    jcfg, cfg, jp, tp = setup
    rng = np.random.RandomState(6)
    probs = rng.dirichlet(np.ones(cfg.moe.num_experts), 19).astype(
        np.float32)
    idx = rng.randint(0, cfg.moe.num_experts, (19, cfg.moe.top_k))
    want = JM.load_balance_loss(jnp.asarray(probs), jnp.asarray(idx),
                                cfg.moe.num_experts)
    got = M.load_balance_loss(_t(probs), _t(idx), cfg.moe.num_experts)
    _close(got, want)


@pytest.mark.parametrize("impl", ["dense", "grouped"])
def test_moe_block_matches_reference(setup, impl):
    """Each path against the reference's same path and against the port's
    other path, on integer-valued tokens (planted router ties) and on
    random ones."""
    jcfg, cfg, jp, tp = setup
    jl, tl = _tied_layer(jp)
    rng = np.random.RandomState(7)
    for x in (_tied_tokens(cfg).reshape(3, 8, -1),
              rng.randn(2, 5, cfg.d_model).astype(np.float32)):
        want, jaux = JM.moe_block(jl, jcfg, jnp.asarray(x), impl=impl)
        got, aux = M.moe_block(tl, cfg, _t(x), impl=impl)
        other, _ = M.moe_block(tl, cfg, _t(x), impl={
            "dense": "grouped", "grouped": "dense"}[impl])
        _close(got, want)
        _close(aux, jaux)
        _close(got, other)
    with pytest.raises(ValueError, match="moe impl"):
        M.moe_block(tl, cfg, _t(x), impl="sparse")


def test_moe_tree_crosses_the_bridge_unchanged(setup):
    """The JAX tree arrives with the reference's shapes and comes back bit
    for bit; no MoE leaf is forced to fp32."""
    jcfg, cfg, jp, tp = setup
    m, n, d = cfg.moe, cfg.n_layers, cfg.d_model
    moe = tp["layers"]["moe"]
    want = {"router": (n, d, m.num_experts),
            "w_gate": (n, m.num_experts, d, m.expert_d_ff),
            "w_up": (n, m.num_experts, d, m.expert_d_ff),
            "w_down": (n, m.num_experts, m.expert_d_ff, d)}
    if m.num_shared_experts:
        want.update({"shared.w_gate": (n, d, m.shared_d_ff),
                     "shared.w_up": (n, d, m.shared_d_ff),
                     "shared.w_down": (n, m.shared_d_ff, d),
                     "shared.gate": (n, d, 1)})
    got = {k: tuple(v.shape) for k, v in moe.items() if k != "shared"}
    got.update({f"shared.{k}": tuple(v.shape)
                for k, v in moe.get("shared", {}).items()})
    assert got == want
    back = params_to_numpy(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu",
        dtype=torch.bfloat16))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(
                lambda a: np.asarray(a.astype(jnp.bfloat16), np.float32),
                jp)):
        keys = [p.key for p in path]
        node = back
        for k in keys:
            node = node[k]
        np.testing.assert_array_equal(node, leaf, err_msg=str(keys))
    bf = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                           dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in
               jax.tree_util.tree_leaves(bf["layers"]["moe"]))


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", [("xla", "torch"), ("pallas", "kernel")])
def test_prefill_logits_and_cache_match_reference(setup, impl):
    jcfg, cfg, jp, tp = setup
    jimpl, timpl = impl
    rng = np.random.RandomState(2)
    toks = rng.randint(8, 512, size=(3, 32)).astype(np.int32)
    last = np.array([4, 31, 17], np.int32)  # right-padded rows
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        JT.init_cache(jcfg, 3, 64), attn_impl=jimpl,
                        last_index=jnp.asarray(last))
    tl, tc = T.prefill(tp, cfg, {"tokens": _t(toks)},
                       T.init_cache(cfg, 3, 64, "cpu"), attn_impl=timpl,
                       last_index=_t(last))
    assert tuple(tl.shape) == (3, 1, cfg.vocab_size)
    _close(tl, jl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    _close(tc["kv"].k, jc["kv"].k)
    _close(tc["kv"].v, jc["kv"].v)


def test_decode_steps_with_mixed_active_mask(setup):
    """Three grouped-MoE decode steps: live rows match the reference;
    frozen rows keep their cache bit for bit and do not advance."""
    jcfg, cfg, jp, tp = setup
    rng = np.random.RandomState(3)
    toks = rng.randint(8, 512, size=(4, 16)).astype(np.int32)
    _, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       JT.init_cache(jcfg, 4, 32))
    lens = np.array([16, 3, 9, 16], np.int32)  # ragged slot depths
    jc["len"] = jnp.asarray(lens)
    tc = cache_from_numpy(lens, np.asarray(jc["kv"].k),
                          np.asarray(jc["kv"].v), device="cpu")
    before = {"k": tc["kv"].k.clone(), "v": tc["kv"].v.clone()}
    active = np.array([True, False, True, False])
    live = np.flatnonzero(active)
    for i in range(3):
        step = rng.randint(8, 512, size=(4, 1)).astype(np.int32)
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(step), jc,
                                active=jnp.asarray(active))
        tl, tc = T.decode_step(tp, cfg, _t(step), tc, attn_impl="kernel",
                               active=_t(active))
        _close(tl.numpy()[live], np.asarray(jl)[live])
    np.testing.assert_array_equal(tc["len"].numpy(), lens + 3 * active)
    for name, buf, jbuf in (("k", tc["kv"].k, jc["kv"].k),
                            ("v", tc["kv"].v, jc["kv"].v)):
        for row in np.flatnonzero(~active):
            assert torch.equal(buf[:, row], before[name][:, row])
        _close(buf.numpy()[:, live], np.asarray(jbuf)[:, live])


def test_step_functions_match_reference(setup):
    """``make_prefill_step`` and 6 ``make_serve_step``s (dense MoE, as the
    reference's defaults) over an int8 cache, fed their own greedy
    tokens."""
    jcfg, cfg, jp, tp = setup
    prompts = np.random.RandomState(8).randint(8, 512, (2, 12)).astype(
        np.int32)
    jl, jc = JS.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(prompts),
             "cache": JT.init_cache(jcfg, 2, 32, kv_dtype="int8")})
    tl, tc = S.make_prefill_step(cfg)(
        tp, {"tokens": _t(prompts),
             "cache": T.init_cache(cfg, 2, 32, "cpu", kv_dtype="int8")})
    _close(tl, jl)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = tl[:, -1].argmax(-1).to(torch.int32)
    jstep, tstep = JS.make_serve_step(jcfg), S.make_serve_step(cfg)
    for _ in range(6):
        jtok, jc = jstep(jp, jtok[:, None], jc)
        ttok, tc = tstep(tp, ttok[:, None], tc)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


# --------------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------------- #


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(8, 512, size=n)] for n in lengths]


def test_engine_greedy_tokens_match_jax_engine(setup):
    """Batched bucketed prefill (dense MoE over padded rows), compacted
    grouped-MoE decode, eviction and recompute re-admission: token for
    token.  ``max_len`` 64 keeps mixtral's cache linear (its reduced
    window is 64), so the kernels read it."""
    jcfg, cfg, jp, tp = setup
    kw = dict(max_slots=4, max_len=64, max_output=48, eos_id=-1)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="pallas", **kw))
    teng = InferenceEngine(cfg, tp, EngineConfig(attn_impl="kernel", **kw),
                           device="cpu")
    prompts = _prompts(0, [5, 21, 9])
    jjobs = [JaxJob(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
             for i, p in enumerate(prompts)]
    tjobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
             for i, p in enumerate(prompts)]
    for w, ids in enumerate([[0, 1], [0, 1, 2], [1, 2], [0, 1, 2]]):
        if w == 2:  # preempt job 0: its slot is freed, resume recomputes
            jeng.evict_job(0)
            teng.evict_job(0)
        jt, jf = jeng.run_window([jjobs[i] for i in ids], 4)
        tt, tf = teng.run_window([tjobs[i] for i in ids], 4)
        assert tt == jt and tf == jf, f"window {w}"
        for i, t in zip(ids, tt):
            jjobs[i].generated.extend(t)
            tjobs[i].generated.extend(t)
        assert teng.cache["len"].tolist() == np.asarray(
            jeng.cache["len"]).tolist()
    assert len(set(tjobs[1].generated)) > 1  # not a degenerate stream
    assert teng.resume_context_tokens == jeng.resume_context_tokens


def _drive(cfg, params, plen, n_out, prefill_chunk):
    """One job to ``n_out`` greedy tokens, windows of 4."""
    eng = InferenceEngine(cfg, params, EngineConfig(
        max_slots=2, max_len=64, max_output=64, eos_id=-1), device="cpu")
    j = Job(job_id=0, prompt="p0",
            prompt_tokens=[11 + k % 60 for k in range(plen)],
            arrival_time=0.0)
    out = []
    while len(out) < n_out:
        toks, _ = eng.run_window([j], 4, prefill_chunk=prefill_chunk)
        j.generated.extend(toks[0])
        out.extend(toks[0])
    return out[:n_out], eng


def test_chunked_matches_oneshot(setup):
    """Chunked prefill (dense MoE per chunk, plain ``sdpa``) gives the
    greedy tokens of one-shot prefill, as in the reference's own test."""
    _, cfg, _, tp = setup
    ref, _ = _drive(cfg, tp, plen=21, n_out=8, prefill_chunk=None)
    got, eng = _drive(cfg, tp, plen=21, n_out=8, prefill_chunk=6)
    assert got == ref
    assert eng.num_chunk_dispatches >= 3


@pytest.mark.gpu
def test_kernel_engine_matches_plain_engine_on_card(setup):
    """On the card, the CUDA-kernel engine and the plain-PyTorch engine
    give the same greedy tokens (fp32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg, _, tp = setup
    params = jax.tree_util.tree_map(lambda t: t.to("cuda"), tp)
    streams = []
    for impl in ("kernel", "torch"):
        eng = InferenceEngine(cfg, params, EngineConfig(
            max_slots=4, max_len=64, max_output=48, eos_id=-1,
            attn_impl=impl), device="cuda")
        jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
                for i, p in enumerate(_prompts(6, [5, 40, 23]))]
        out = []
        for _ in range(3):
            toks, _ = eng.run_window(jobs, 8)
            for j, t in zip(jobs, toks):
                j.generated.extend(t)
            out.append(toks)
        streams.append(out)
    assert streams[0] == streams[1]
