"""The port's audio family (whisper-large-v3) against the JAX package on
the CPU.

The reduced config (2 encoder and 2 decoder layers, d_model 128, 4/2
heads of dim 32, 16 stub frames), fp32, parameters made by the
reference's init and converted by ``repro_torch.bridge``.  Checked: the
config and its ``param_count`` (encoder and cross-attention terms);
``init_params`` and ``init_cache`` layouts; LayerNorm through
``apply_norm``; the non-gated GELU MLP (``jax.nn.gelu``'s tanh form);
``encode_audio``; ``encode_cross_kv`` and ``cross_attention_block``;
prefill over stub frames followed by 3 decode steps on both paths (the
reference's Pallas kernels in interpret mode against the port's kernel
wrappers, which run their plain versions on CPU tensors; XLA against
plain PyTorch), logits and every cache leaf, ``cross_kv`` included;
decode steps past the last learned position (the position clamped, the
cache write dropped); the step functions with ``frames``; the audio cache
through the bridge; ``input_specs`` at every shape against the
reference's; the engine's refusal at its first prefill (the reference's
engine raises ``KeyError`` there); a pod's cache, and the refusals left:
full whisper over 4 ranks and the CLI.

Tolerances: logits, activations and cache leaves 2e-5 abs + rel, as the
other family tests (the same fp32 arithmetic summed in another order).
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
from repro_torch.bridge import (audio_cache_from_numpy,  # noqa: E402
                                cache_to_numpy, params_from_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.launch import make_mesh, serve, steps  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch.partition import (check_family,  # noqa: E402
                                          local_config, vocab_range)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "whisper-large-v3"
TOL = 2e-5
#: (JAX impl, port impl): the kernels, and the plain paths
IMPLS = [("pallas", "kernel"), ("xla", "torch")]


@functools.lru_cache(maxsize=None)
def _setup(max_pos=None):
    """(JAX config, port config, JAX params, converted params), with
    ``max_position_embeddings`` cut to ``max_pos`` when it is given; the
    norms' scales and biases drawn at random, so that a dropped bias or
    scale shows."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if max_pos is not None:
        jcfg = dataclasses.replace(jcfg, max_position_embeddings=max_pos)
        cfg = dataclasses.replace(cfg, max_position_embeddings=max_pos)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(2)

    def jitter(node):
        for k, v in node.items():
            if isinstance(v, dict):
                jitter(v)
            elif k in ("scale", "bias"):
                node[k] = (v + rng.uniform(-0.2, 0.2, v.shape)).astype(
                    np.float32)

    jitter(tree)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _batch(cfg, b: int, s: int, seed: int):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(8, 512, (b, s)).astype(np.int32),
            "frames": rng.randn(b, cfg.encoder.n_frames,
                                cfg.d_model).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _same_cache(c, jc):
    got = cache_to_numpy(c)
    assert got["length"].tolist() == np.asarray(jc["len"]).tolist()
    for key, want in (("k", jc["kv"].k), ("v", jc["kv"].v),
                      ("cross_k", jc["cross_kv"].k),
                      ("cross_v", jc["cross_kv"].v)):
        assert got[key].shape == want.shape, key
        _close(got[key], want)


# --------------------------------------------------------------------------- #
# Config, layout, layers
# --------------------------------------------------------------------------- #


def test_config_param_count_and_reduced_match_reference():
    for full in (True, False):
        want = jax_get_config(ARCH) if full else jax_get_config(ARCH).reduced()
        got = get_config(ARCH) if full else get_config(ARCH).reduced()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
    assert get_config(ARCH).param_count() == 1_534_600_960


def test_init_params_and_cache_have_reference_layout():
    jcfg, cfg, jp, _ = _setup()
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        T.init_params(cfg, torch.Generator().manual_seed(0)))
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jp)
    assert got == want
    for max_len in (40, 4096):
        c, jc = T.init_cache(cfg, 3, max_len, "cpu"), JT.init_cache(
            jcfg, 3, max_len)
        assert set(c) == set(jc)
        for name in ("kv", "cross_kv"):
            assert tuple(c[name].k.shape) == jc[name].k.shape, name
            assert c[name].ring == jc[name].ring is False


def test_layernorm_through_apply_norm_matches_reference():
    jcfg, cfg, jp, tp = _setup()
    x = np.random.RandomState(4).randn(2, 5, cfg.d_model).astype(np.float32)
    x = x * 3 + 1.5
    got = L.apply_norm(cfg, {k: v[0] for k, v in
                             tp["layers"]["attn_norm"].items()},
                       torch.from_numpy(x))
    want = JL.apply_norm(jcfg, {k: v[0] for k, v in
                                jp["layers"]["attn_norm"].items()},
                         jnp.asarray(x))
    _close(got, want)


def test_gelu_mlp_matches_reference():
    """Not gated, GELU in its tanh form (``jax.nn.gelu``'s default)."""
    jcfg, cfg, jp, tp = _setup()
    x = np.random.RandomState(5).randn(2, 5, cfg.d_model).astype(np.float32)
    tmlp = {k: v[1] for k, v in tp["layers"]["mlp"].items()}
    assert "w_gate" not in tmlp
    got = L.mlp_block(tmlp, cfg, torch.from_numpy(x))
    want = JL.mlp_block({k: v[1] for k, v in jp["layers"]["mlp"].items()},
                        jcfg, jnp.asarray(x))
    _close(got, want)


def test_encode_audio_matches_reference():
    jcfg, cfg, jp, tp = _setup()
    frames = _batch(cfg, 2, 4, 6)["frames"]
    _close(T.encode_audio(tp, cfg, torch.from_numpy(frames)),
           JT.encode_audio(jp, jcfg, jnp.asarray(frames)))


def test_cross_attention_matches_reference():
    """``encode_cross_kv`` of an encoder output, then
    ``cross_attention_block`` of 5 decoder positions over it."""
    jcfg, cfg, jp, tp = _setup()
    rng = np.random.RandomState(7)
    enc = rng.randn(2, cfg.encoder.n_frames, cfg.d_model).astype(np.float32)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    tc = {k: v[0] for k, v in tp["layers"]["cross"].items()}
    jc = {k: v[0] for k, v in jp["layers"]["cross"].items()}
    tkv = L.encode_cross_kv(tc, cfg, torch.from_numpy(enc))
    jkv = JL.encode_cross_kv(jc, jcfg, jnp.asarray(enc))
    for g, w in zip(tkv, jkv):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    _close(L.cross_attention_block(tc, cfg, torch.from_numpy(x), tkv),
           JL.cross_attention_block(jc, jcfg, jnp.asarray(x), jkv))


# --------------------------------------------------------------------------- #
# Prefill and decode
# --------------------------------------------------------------------------- #


def _run(jcfg, cfg, jp, tp, batch, max_len, n_steps, jimpl, timpl):
    """Prefill then ``n_steps`` decode steps fed the reference's greedy
    tokens, on both packages: logits and every cache leaf after each."""
    b = batch["tokens"].shape[0]
    jl, jc = JT.prefill(jp, jcfg, _jax(batch), JT.init_cache(jcfg, b, max_len),
                        attn_impl=jimpl)
    tl, c = T.prefill(tp, cfg, _torch(batch), T.init_cache(cfg, b, max_len,
                                                           "cpu"),
                      attn_impl=timpl)
    _close(tl, jl)
    _same_cache(c, jc)
    for _ in range(n_steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                attn_impl=jimpl)
        tl, c = T.decode_step(tp, cfg, torch.from_numpy(tok), c,
                              attn_impl=timpl)
        _close(tl, jl)
        _same_cache(c, jc)
    return c


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_prefill_and_decode_match_reference(jimpl, timpl):
    jcfg, cfg, jp, tp = _setup()
    _run(jcfg, cfg, jp, tp, _batch(cfg, 3, 11, 8), 40, 3, jimpl, timpl)


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_decode_past_the_last_position_matches_reference(jimpl, timpl):
    """``max_position_embeddings`` 16: a cache of 16 rows, prompts of 13
    ids, and 5 steps, the last two at ``len`` 16 and 16 again: their
    learned position is clamped at 15 and their K/V write is dropped,
    as in the reference."""
    jcfg, cfg, jp, tp = _setup(16)
    c = _run(jcfg, cfg, jp, tp, _batch(cfg, 2, 13, 9), 64, 5, jimpl, timpl)
    assert c["kv"].k.shape[2] == 16
    assert c["len"].tolist() == [18, 18]


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_step_functions_carry_frames(jimpl, timpl):
    """``make_prefill_step`` over frames and tokens into a decode cache,
    then 3 serve steps: greedy tokens identical, prefill logits within
    tolerance."""
    jcfg, cfg, jp, tp = _setup()
    batch = _batch(cfg, 2, 9, 10)
    jl, jc = JSTEPS.make_prefill_step(jcfg)(
        jp, {**_jax(batch), "cache": JT.init_cache(jcfg, 2, 32)})
    tl, c = steps.make_prefill_step(cfg, attn_impl=timpl)(
        tp, {**_torch(batch), "cache": T.init_cache(cfg, 2, 32, "cpu")})
    _close(tl, jl)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = tl[:, -1].argmax(-1).to(torch.int32)
    jserve = JSTEPS.make_serve_step(jcfg)
    tserve = steps.make_serve_step(cfg, attn_impl=timpl)
    for _ in range(3):
        jtok, jc = jserve(jp, jtok[:, None], jc)
        ttok, c = tserve(tp, ttok[:, None], c)
        assert ttok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("n_steps", [0, 2])
def test_bridge_round_trips_an_audio_cache(n_steps):
    """A JAX audio cache after prefill and ``n_steps`` decode steps -> the
    port -> numpy: every leaf bit for bit; the port then decodes from it
    as the reference does."""
    jcfg, cfg, jp, tp = _setup()
    batch = _batch(cfg, 2, 7, 12)
    _, jc = JT.prefill(jp, jcfg, _jax(batch), JT.init_cache(jcfg, 2, 24))
    tok = jnp.full((2, 1), 9, jnp.int32)
    for _ in range(n_steps):
        _, jc = JT.decode_step(jp, jcfg, tok, jc)
    kv = jc["kv"]
    c = audio_cache_from_numpy(
        np.asarray(jc["len"]), np.asarray(kv.k), np.asarray(kv.v),
        np.asarray(jc["cross_kv"].k), np.asarray(jc["cross_kv"].v),
        device="cpu")
    back = cache_to_numpy(c)
    assert back.keys() == {"length", "k", "v", "cross_k", "cross_v"}
    for key, want in (("length", jc["len"]), ("k", kv.k), ("v", kv.v),
                      ("cross_k", jc["cross_kv"].k),
                      ("cross_v", jc["cross_kv"].v)):
        np.testing.assert_array_equal(back[key], np.asarray(want))
    jl, _ = JT.decode_step(jp, jcfg, tok, jc)
    tl, _ = T.decode_step(tp, cfg, torch.from_numpy(np.asarray(tok)), c,
                          attn_impl="torch")
    _close(tl, jl)


@pytest.mark.parametrize("shape", sorted(JS.SHAPES))
def test_input_specs_match_reference_on_meta(shape):
    """Full width: ``frames`` (B, 1500, 1280), the decoder capped at 448
    rows, and the cross-K/V beside its cache, as in the reference."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    assert S.supported(cfg, S.SHAPES[shape]) == JS.supported(
        jcfg, JS.SHAPES[shape])
    want = JS.input_specs(jcfg, JS.SHAPES[shape])
    got = S.input_specs(cfg, S.SHAPES[shape])
    assert set(got) == set(want)
    for key in set(got) - {"cache"}:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).replace("torch.", "") == str(
            want[key].dtype), key
    if "cache" in got:
        for name in ("kv", "cross_kv"):
            assert tuple(got["cache"][name].k.shape) == want["cache"][
                name].k.shape, name


# --------------------------------------------------------------------------- #
# Engine, refusals
# --------------------------------------------------------------------------- #


def test_engine_refuses_at_its_first_prefill():
    """Both engines build the audio cache tree; the reference's fails at
    its first prefill (no frames: ``KeyError``), the port's says why."""
    jcfg, cfg, jp, tp = _setup()
    kw = dict(max_slots=2, max_len=32, max_output=8, eos_id=-1)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**kw))
    teng = InferenceEngine(cfg, tp, EngineConfig(**kw), device="cpu")
    assert set(teng.cache) == set(jeng.cache) == {"len", "kv", "cross_kv"}
    assert tuple(teng.cache["cross_kv"].k.shape) == jeng.cache[
        "cross_kv"].k.shape
    with pytest.raises(KeyError, match="frames"):
        jeng.add_job(JaxJob(job_id=0, prompt="", prompt_tokens=[5, 6, 7],
                            arrival_time=0.0))
    with pytest.raises(NotImplementedError, match="no frames"):
        teng.add_job(Job(job_id=0, prompt="", prompt_tokens=[5, 6, 7],
                         arrival_time=0.0))
    assert teng.num_prefill_dispatches == 0 and teng.free_slots() == 2


def test_tensor_parallelism_and_cli_are_refused(capsys):
    """An audio pod runs the model (ROADMAP.md queue 1, item 8.2, landed;
    ``tests/test_torch_tp_vlm_audio.py`` holds it against the JAX
    package): ``check_family`` passes and each rank's cache holds its
    query heads' cross K/V.  Full whisper over 4 ranks, whose vocab
    (51866) does not divide, is laid out now (item 8.4, landed: the
    first two ranks hold 12967 rows, the last two 12966).  Refused: the
    CLI, with or without ``--mesh``: a request carries no frames."""
    cfg = get_config(ARCH).reduced()
    check_family(cfg)
    caches = T.init_cache(cfg, 1, 32, mesh=make_mesh((2,), ("model",),
                                                     devices=["cpu"] * 2))
    assert [tuple(c["cross_kv"].k.shape) for c in caches] == [
        (2, 1, cfg.encoder.n_frames, 2, cfg.head_dim)] * 2
    full = get_config(ARCH)
    assert [local_config(full, 4, r).n_heads for r in range(4)] == [5] * 4
    assert [vocab_range(full, 4, r) for r in range(4)] == [
        (0, 12967), (12967, 25934), (25934, 38900), (38900, 51866)]
    for mesh in ([], ["--mesh", "1x2"]):
        with pytest.raises(SystemExit) as e:
            serve.main(["--arch", ARCH, "--n", "2", "--device", "cpu"]
                       + mesh)
        assert "no frames" in str(e.value.code)
    assert capsys.readouterr().out == ""
