"""The port's vlm family (qwen2-vl-7b) against the JAX package on the CPU.

The reduced config (2 layers, 4/2 heads of dim 32, M-RoPE sections (8, 4,
4), 8 stub patches), fp32, parameters made by the reference's init and
converted by ``repro_torch.bridge``.  Checked: the config and its
``param_count``; ``init_params`` and ``init_cache`` layouts; M-RoPE's
cos/sin at (3, B, S) positions and in the 2-D fallback, at the reduced
and the published sections; prefill over stub patch embeddings with 3-D
positions, and text-only, each followed by 3 decode steps, on both paths
(the reference's Pallas kernels in interpret mode against the port's
kernel wrappers, which run their plain versions on CPU tensors; XLA
against plain PyTorch), logits and every cache leaf; the step functions
with ``embeds`` and ``positions``; ``input_specs`` at every shape against
the reference's; a text-only ``InferenceEngine`` token for token against
the JAX engine; a pod's cache, its CLI run and the int8 refusal under
a mesh.

Tolerances: logits and cache leaves 2e-5 abs + rel, as the other family
tests (the same fp32 arithmetic summed in another order); cos/sin 1e-6;
greedy tokens identical.
"""
import dataclasses
import functools

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
from repro.launch import shapes as JS  # noqa: E402
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.launch import make_mesh, serve, steps  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch.partition import check_family  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "qwen2-vl-7b"
TOL = 2e-5
#: (JAX impl, port impl): the kernels, and the plain paths
IMPLS = [("pallas", "kernel"), ("xla", "torch")]


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX config, port config, JAX params, converted params); the layer
    weights scaled by 3, so that greedy streams do not settle on one
    repeated token."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    for group in tree["layers"].values():
        for name in group:
            if name.startswith("w"):
                group[name] = group[name] * np.float32(3.0)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _vision_batch(cfg, b: int, text: int, seed: int):
    """Stub patch embeddings on a grid at temporal 0, then ``text`` ids at
    the next position on all three axes, as numpy."""
    rng = np.random.RandomState(seed)
    n = cfg.frontend_tokens
    side = int(round(n ** 0.5))
    grid = np.arange(n)
    img = np.stack([np.zeros(n), grid // side, grid % side]).astype(np.int32)
    start = int(img.max()) + 1
    txt = np.broadcast_to(np.arange(start, start + text, dtype=np.int32),
                          (3, text))
    pos = np.broadcast_to(np.concatenate([img, txt], 1)[:, None],
                          (3, b, n + text)).copy()
    return {"tokens": rng.randint(8, 512, (b, text)).astype(np.int32),
            "embeds": rng.randn(b, n, cfg.d_model).astype(np.float32),
            "positions": pos}


# --------------------------------------------------------------------------- #
# Config, layout, M-RoPE
# --------------------------------------------------------------------------- #


def test_config_param_count_and_reduced_match_reference():
    for full in (True, False):
        want = jax_get_config(ARCH) if full else jax_get_config(ARCH).reduced()
        got = get_config(ARCH) if full else get_config(ARCH).reduced()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
    assert get_config(ARCH).param_count() == 7_615_616_512
    assert get_config(ARCH).reduced().mrope_sections == (8, 4, 4)


def test_init_params_and_cache_have_reference_layout():
    jcfg, cfg, jp, _ = _setup()
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        T.init_params(cfg, torch.Generator().manual_seed(0)))
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jp)
    assert got == want
    c, jc = T.init_cache(cfg, 3, 40, "cpu"), JT.init_cache(jcfg, 3, 40)
    assert set(c) == set(jc)
    assert tuple(c["kv"].k.shape) == jc["kv"].k.shape
    assert c["kv"].ring == jc["kv"].ring


@pytest.mark.parametrize("head_dim,sections", [(32, (8, 4, 4)),
                                               (128, (16, 24, 24))])
def test_mrope_cos_sin_matches_reference(head_dim, sections):
    """(3, B, S) positions with distinct axes, so that each band's gather
    of its axis shows."""
    pos = np.random.RandomState(3).randint(0, 5000, (3, 2, 9)).astype(
        np.int32)
    got = L.mrope_cos_sin(torch.from_numpy(pos), head_dim, 1e6, sections)
    want = JL.mrope_cos_sin(jnp.asarray(pos), head_dim, 1e6, sections)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 9, head_dim // 2)
        _close(g, w, 1e-6)


def test_mrope_text_only_fallback_matches_reference():
    """(B, S) positions go on all three axes: the same angles as RoPE."""
    jcfg, cfg, _, _ = _setup()
    pos = np.arange(24, dtype=np.int32).reshape(2, 12) * 7
    got = L.positional_cos_sin(cfg, torch.from_numpy(pos))
    want = JL.positional_cos_sin(jcfg, jnp.asarray(pos))
    rope = L.rope_cos_sin(torch.from_numpy(pos), cfg.head_dim,
                          cfg.rope_theta)
    for g, w, r in zip(got, want, rope):
        _close(g, w, 1e-6)
        assert torch.equal(g, r)


# --------------------------------------------------------------------------- #
# Prefill and decode
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("vision", [True, False], ids=["patches", "text"])
@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_prefill_and_decode_match_reference(vision, jimpl, timpl):
    """Prefill 3 rows (with 8 stub patches and 3-D positions, or text
    only), then 3 decode steps fed the reference's greedy tokens: logits
    and every cache leaf after each."""
    jcfg, cfg, jp, tp = _setup()
    batch = _vision_batch(cfg, 3, 13, 5)
    if not vision:
        batch = {"tokens": batch["tokens"]}
    jc = JT.init_cache(jcfg, 3, 40)
    jl, jc = JT.prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jc, attn_impl=jimpl)
    c = T.init_cache(cfg, 3, 40, "cpu")
    tl, c = T.prefill(tp, cfg, {k: torch.from_numpy(v) for k, v in
                                batch.items()}, c, attn_impl=timpl)
    _close(tl, jl)
    for step in range(4):
        got = cache_to_numpy(c)
        _close(got["k"], jc["kv"].k)
        _close(got["v"], jc["kv"].v)
        assert got["length"].tolist() == np.asarray(jc["len"]).tolist()
        if step == 3:
            break
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                attn_impl=jimpl)
        tl, c = T.decode_step(tp, cfg, torch.from_numpy(tok), c,
                              attn_impl=timpl)
        _close(tl, jl)


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_step_functions_carry_embeds_and_positions(jimpl, timpl):
    """``make_prefill_step`` over an ``input_specs``-shaped batch (patches,
    3-D positions, text) into a decode cache, then 3 serve steps: greedy
    tokens identical, prefill logits within tolerance."""
    jcfg, cfg, jp, tp = _setup()
    batch = _vision_batch(cfg, 2, 9, 11)
    jl, jc = JSTEPS.make_prefill_step(jcfg)(
        jp, {**{k: jnp.asarray(v) for k, v in batch.items()},
             "cache": JT.init_cache(jcfg, 2, 32)})
    tl, c = steps.make_prefill_step(cfg, attn_impl=timpl)(
        tp, {**{k: torch.from_numpy(v) for k, v in batch.items()},
             "cache": T.init_cache(cfg, 2, 32, "cpu")})
    _close(tl, jl)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = tl[:, -1].argmax(-1).to(torch.int32)
    jserve = JSTEPS.make_serve_step(jcfg)
    tserve = steps.make_serve_step(cfg, attn_impl=timpl)
    for _ in range(3):
        jtok, jc = jserve(jp, jtok[:, None], jc)
        ttok, c = tserve(tp, ttok[:, None], c)
        assert ttok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("shape", sorted(JS.SHAPES))
def test_input_specs_match_reference_on_meta(shape):
    """Full width: ``embeds`` (B, 256, 3584) and ``positions`` (3, B, S)
    with S - 256 text ids, as in the reference."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    want = JS.input_specs(jcfg, JS.SHAPES[shape])
    got = S.input_specs(cfg, S.SHAPES[shape])
    assert set(got) == set(want)
    for key in set(got) - {"cache"}:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).replace("torch.", "") == str(
            want[key].dtype), key
    if "cache" in got:
        assert tuple(got["cache"]["kv"].k.shape) == want["cache"]["kv"].k.shape
        assert got["cache"]["kv"].ring == want["cache"]["kv"].ring


# --------------------------------------------------------------------------- #
# Engine, refusals
# --------------------------------------------------------------------------- #


def test_text_only_engine_greedy_tokens_match_jax_engine():
    """The engine passes tokens only (M-RoPE's 2-D fallback), as the
    reference's: batched bucketed prefill, compacted decode, an eviction
    and a recompute re-admission, token for token."""
    jcfg, cfg, jp, tp = _setup()
    kw = dict(max_slots=4, max_len=64, max_output=48, eos_id=-1)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="pallas", **kw))
    teng = InferenceEngine(cfg, tp, EngineConfig(attn_impl="kernel", **kw),
                           device="cpu")
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(8, 512, size=n)]
               for n in (7, 19, 11)]
    jjobs = [JaxJob(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
             for i, p in enumerate(prompts)]
    tjobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
             for i, p in enumerate(prompts)]
    for w, ids in enumerate([[0, 1], [0, 1, 2], [1, 2], [0, 1, 2]]):
        if w == 2:
            jeng.evict_job(0)
            teng.evict_job(0)
        jt, jf = jeng.run_window([jjobs[i] for i in ids], 4)
        tt, tf = teng.run_window([tjobs[i] for i in ids], 4)
        assert tt == jt and tf == jf, f"window {w}"
        for i, t in zip(ids, tt):
            jjobs[i].generated.extend(t)
            tjobs[i].generated.extend(t)
    assert len(set(tjobs[1].generated)) > 1
    assert teng.cache["len"].tolist() == np.asarray(jeng.cache["len"]).tolist()


def test_tensor_parallelism_is_refused(capsys):
    """A vlm pod is served now (ROADMAP.md queue 1, item 8.2, landed;
    ``tests/test_torch_tp_vlm_audio.py`` holds it against the JAX
    package): ``check_family`` passes, each rank's cache holds the KV
    head its query heads read, and the CLI serves ``--mesh 1x2``.  An
    int8 cache under a mesh is built now (item 8.3, landed): the same
    heads in int8 codes, with each rank's copy of the per-token scales."""
    cfg = get_config(ARCH).reduced()
    check_family(cfg)
    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    caches = T.init_cache(cfg, 1, 32, mesh=mesh)
    assert [tuple(c["kv"].k.shape) for c in caches] == [(2, 1, 32, 1, 32)] * 2
    caches = T.init_cache(cfg, 1, 32, mesh=mesh, kv_dtype="int8")
    assert [tuple(c["kv"].k.shape) for c in caches] == [(2, 1, 32, 1, 32)] * 2
    assert all(c["kv"].k.dtype == torch.int8 for c in caches)
    assert [tuple(c["kv"].v_scale.shape) for c in caches] == [(2, 1, 32)] * 2
    responses, _ = serve.main(["--arch", ARCH, "--mesh", "1x2", "--n", "2",
                               "--max-output", "4", "--device", "cpu"])
    assert len(responses) == 2 and all(r.ok for r in responses)
    assert "1 TP=2 pod(s)" in capsys.readouterr().err


def test_cli_serves_qwen2_vl_text_on_cpu(capsys):
    """``--arch qwen2-vl-7b`` serves text (the reduced config on the
    CPU), as the reference's CLI does."""
    responses, _ = serve.main(["--arch", ARCH, "--n", "3", "--max-output",
                               "6", "--device", "cpu"])
    assert len(responses) == 3 and all(r.ok for r in responses)
    assert "(3/3 finished)" in capsys.readouterr().err
