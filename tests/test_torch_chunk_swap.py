"""The port's chunked prefill and KV swap against the JAX engine on the
reduced qwen2-1.5b (fp32, CPU): greedy streams with chunks of 1, 4 and 7
tokens, a job mid-prefill, the one-shot fallback of ring and SSM caches,
swap round trips bit for bit (one taken mid-prefill), the resume cost
(``resume_context_tokens``), the swap pool's watermark,
``masked_span_write`` and the executor's live calibration.  Greedy tokens
and counters must be identical; the calibration's fitted fields agree to
1e-12 relative (the same least-squares fit in float64 on both sides).
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import Job as JaxJob  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import EngineExecutor as JaxExecutor  # noqa: E402
from repro.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.layers import \
    masked_span_write as jax_span_write  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import (EngineConfig, EngineExecutor,  # noqa: E402
                                InferenceEngine)
from repro_torch.engine.engine import _gather_slots  # noqa: E402
from repro_torch.models.layers import masked_span_write  # noqa: E402

ARCH = "qwen2-1.5b"
ECFG = dict(max_slots=2, max_len=128, max_output=64, eos_id=-1)


def _tree(cfg_name, scale=3.0):
    """The reference init as numpy; the dense layers' weights scaled so
    greedy streams do not settle on one repeated token."""
    jcfg = jax_get_config(cfg_name).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    if "attn" in tree["layers"]:
        for group in tree["layers"]["attn"], tree["layers"]["mlp"]:
            for name in group:
                if name.startswith("w"):
                    group[name] = group[name] * np.float32(scale)
    return tree


@pytest.fixture(scope="module")
def setup():
    tree = _tree(ARCH)
    return (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced(),
            jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _pair(setup, jcfg=None, cfg=None, **kw):
    """A JAX engine and a port engine (cpu) over the same params."""
    j0, t0, jp, tp = setup
    ecfg = {**ECFG, **kw}
    return (JaxEngine(jcfg or j0, jp, JaxEngineConfig(**ecfg)),
            InferenceEngine(cfg or t0, tp, EngineConfig(**ecfg),
                            device="cpu"))


def _prompt(i, n):
    rng = np.random.RandomState(100 + i)
    return [int(t) for t in rng.randint(8, 512, size=n)]


def _jobs(i, n):
    """The same job for each engine: (JAX job, port job)."""
    p = _prompt(i, n)
    return (JaxJob(job_id=i, prompt=f"p{i}", prompt_tokens=p,
                   arrival_time=0.0),
            Job(job_id=i, prompt=f"p{i}", prompt_tokens=list(p),
                arrival_time=0.0))


def _drive(eng, job, n_out, chunk, window=6):
    """Run one job until it has ``n_out`` tokens; returns the stream."""
    out = []
    for _ in range(64):
        toks, _ = eng.run_window([job], window, prefill_chunk=chunk)
        job.generated.extend(toks[0])
        out.extend(toks[0])
        if len(out) >= n_out:
            break
    return out[:n_out]


@pytest.fixture(scope="module")
def oneshot(setup):
    """The JAX engine's one-shot stream of the chunking cases' job."""
    jeng, _ = _pair(setup)
    return _drive(jeng, _jobs(0, 21)[0], 12, None)


# --------------------------------------------------------------------------- #
# Chunked prefill
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("chunk", [1, 4, 7])
def test_chunked_streams_match_jax_engine(setup, oneshot, chunk):
    """Chunked streams equal the JAX engine's one-shot and chunked streams,
    with the same chunk dispatches and padded chunk shapes."""
    jeng, teng = _pair(setup)
    jj, tj = _jobs(0, 21)
    jax_stream = _drive(jeng, jj, 12, chunk)
    got = _drive(teng, tj, 12, chunk)
    assert jax_stream == oneshot
    assert got == jax_stream
    assert len(set(got)) > 1  # not a degenerate stream
    n_chunks = -(-21 // chunk)
    assert teng.num_chunk_dispatches == jeng.num_chunk_dispatches == n_chunks
    assert teng.num_chunk_traces == jeng.num_chunk_traces == 1
    assert tj.prefilled_tokens == jj.prefilled_tokens


def test_midprefill_job_emits_nothing(setup):
    """A chunk-admitted job joins decode only after its final chunk, and
    its batchmate's stream is the JAX engine's, window by window."""
    jeng, teng = _pair(setup)
    (j1, t1), (j2, t2) = _jobs(1, 5), _jobs(2, 30)
    for w in range(6):
        jt, _ = jeng.run_window([j1, j2], 4, prefill_chunk=8)
        incomplete = teng.prefill_incomplete(t2.job_id)
        tt, _ = teng.run_window([t1, t2], 4, prefill_chunk=8)
        assert tt == jt, f"window {w}"
        if incomplete:
            assert tt[1] == []
        for jj, tj, t in ((j1, t1, tt[0]), (j2, t2, tt[1])):
            jj.generated.extend(t)
            tj.generated.extend(t)
            assert tj.prefilled_tokens == jj.prefilled_tokens
    assert t2.generated, "the long job never started decoding"


def _ring_cfgs():
    """The reduced dense config with a sliding window shorter than the
    cache: its KV cache is a ring."""
    kw = dict(attention_type="swa", swa_window=16)
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@pytest.mark.parametrize("kind", ["ring", "ssm"])
def test_chunk_fallback_warns_once(setup, kind):
    """A ring cache and the SSM family cannot chunk: one warning, one-shot
    prefill, and the JAX engine's one-shot stream."""
    if kind == "ring":
        jcfg, cfg = _ring_cfgs()
        jeng, teng = _pair(setup, jcfg, cfg)
    else:
        tree = _tree("mamba2-130m")
        jeng = JaxEngine(jax_get_config("mamba2-130m").reduced(),
                         jax.tree_util.tree_map(jnp.asarray, tree),
                         JaxEngineConfig(**ECFG))
        teng = InferenceEngine(get_config("mamba2-130m").reduced(),
                               params_from_numpy(tree, "cpu"),
                               EngineConfig(**ECFG), device="cpu")
    assert not teng.chunk_supported() and not jeng.chunk_supported()
    jj, tj = _jobs(3, 19)
    ref = _drive(jeng, jj, 6, None, window=3)
    with pytest.warns(UserWarning, match="prefill_chunk is not supported"):
        toks, _ = teng.run_window([tj], 3, prefill_chunk=4)
    tj.generated.extend(toks[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the second call is silent
        t2, _ = teng.run_window([tj], 3, prefill_chunk=4)
    assert toks[0] + t2[0] == ref
    assert teng.num_chunk_dispatches == 0


def test_chunk_of_a_ring_cache_raises(setup):
    """The model's chunk refuses a ring cache, as the reference's does."""
    from repro_torch.models import transformer as T

    _, cfg = _ring_cfgs()
    cache = T.init_cache(cfg, 1, 128, "cpu")
    tokens = torch.ones((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="dense unquantized KV cache"):
        T.prefill_chunk(setup[3], cfg, {"tokens": tokens}, cache, start=0,
                        valid_len=8)


# --------------------------------------------------------------------------- #
# KV swap
# --------------------------------------------------------------------------- #


def _slot_copy(eng, job_id):
    sub = _gather_slots(eng.cache, torch.tensor([eng.slot_of[job_id]]))
    return [sub["len"], sub["kv"].k, sub["kv"].v]


def test_swap_roundtrip_bit_exact_and_stream_exact(setup):
    """Offload, run another job, restore: the slot's cache is bit for bit
    what it was, the stream continues as the JAX engine's (which swaps
    too) and as an uninterrupted run's, and nothing is recomputed."""
    jeng, teng = _pair(setup)
    (j0, t0), (j1, t1) = _jobs(4, 9), _jobs(5, 7)

    def both(jobs, window=5):
        jt, _ = jeng.run_window([j for j, _ in jobs], window)
        tt, _ = teng.run_window([t for _, t in jobs], window)
        assert tt == jt
        for (jj, tj), t in zip(jobs, tt):
            jj.generated.extend(t)
            tj.generated.extend(t)
        return tt

    both([(j0, t0), (j1, t1)])
    before = [t.clone() for t in _slot_copy(teng, t0.job_id)]
    assert teng.offload_job(t0.job_id) and jeng.offload_job(j0.job_id)
    assert teng.has_stash(t0.job_id) and not teng.has_job(t0.job_id)
    # the stash is a copy: overwriting the freed slot leaves it intact
    both([(j1, t1)])
    teng.restore_job(t0)
    jeng.restore_job(j0)
    after = _slot_copy(teng, t0.job_id)
    for a, b in zip(after, before):
        assert torch.equal(a, b), "swap round trip not bit for bit"
    ref_eng = _pair(setup)[1]
    rj = _jobs(4, 9)[1]
    ref = _drive(ref_eng, rj, 15, None, window=5)
    tt = both([(j0, t0), (j1, t1)])
    assert t0.generated == ref[:len(t0.generated)]
    assert tt[0] == ref[5:10]
    assert teng.resume_context_tokens == jeng.resume_context_tokens == 0


def test_swap_midprefill_roundtrip(setup, oneshot):
    """Offloading a job mid-chunked-prefill keeps its chunk cursor: the
    restored job finishes prefill on the JAX engine's one-shot stream."""
    jeng, teng = _pair(setup)
    jj, tj = _jobs(0, 21)
    jeng.run_window([jj], 3, prefill_chunk=6)
    teng.run_window([tj], 3, prefill_chunk=6)
    assert teng.prefill_incomplete(tj.job_id)
    cur = teng._prefill_cursor[tj.job_id]
    before = [t.clone() for t in _slot_copy(teng, tj.job_id)]
    assert teng.offload_job(tj.job_id) and jeng.offload_job(jj.job_id)
    teng.restore_job(tj)
    jeng.restore_job(jj)
    assert teng._prefill_cursor[tj.job_id] == cur == 6
    for a, b in zip(_slot_copy(teng, tj.job_id), before):
        assert torch.equal(a, b)
    assert _drive(teng, tj, 12, 6, window=3) == _drive(jeng, jj, 12, 6,
                                                      window=3) == oneshot


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("policy", ["recompute", "swap"])
def test_resume_cost_matches_jax_engine(setup, policy, chunk):
    """``resume_context_tokens`` after a recompute or a swap preemption is
    the JAX engine's: prompt + generated (the +1 seed token included) for
    a recompute, 0 for a swap."""
    jeng, teng = _pair(setup, max_slots=1)
    jj, tj = _jobs(6, 9)
    for _ in range(8):
        jt, _ = jeng.run_window([jj], 4, prefill_chunk=chunk)
        tt, _ = teng.run_window([tj], 4, prefill_chunk=chunk)
        assert tt == jt
        jj.generated.extend(jt[0])
        tj.generated.extend(tt[0])
        if tj.tokens_generated >= 4:
            break
    gen = tj.tokens_generated
    if policy == "swap":
        assert teng.offload_job(tj.job_id) and jeng.offload_job(jj.job_id)
    else:
        teng.evict_job(tj.job_id)
        jeng.evict_job(jj.job_id)
        tj.prefilled_tokens = jj.prefilled_tokens = 0
    for _ in range(8):
        jt, _ = jeng.run_window([jj], 4, prefill_chunk=chunk)
        tt, _ = teng.run_window([tj], 4, prefill_chunk=chunk)
        assert tt == jt
        if tt[0]:
            break
    assert teng.resume_context_tokens == jeng.resume_context_tokens
    assert teng.resume_context_tokens == (0 if policy == "swap" else 9 + gen)


def test_swap_pool_watermark(setup):
    """The coldest stash is evicted with a warning when the pool is full,
    an oversized fresh stash is refused (the caller recomputes), and the
    accounting returns to zero; every count is the JAX engine's."""
    jeng, teng = _pair(setup, max_slots=3)
    pairs = [_jobs(50 + i, 9) for i in range(3)]
    jt, _ = jeng.run_window([j for j, _ in pairs], 5)
    tt, _ = teng.run_window([t for _, t in pairs], 5)
    assert tt == jt
    for (jj, tj), t in zip(pairs, tt):
        jj.generated.extend(t)
        tj.generated.extend(t)

    def counts(e):
        return (e.stash_tokens, e.n_stash_evictions, e.stash_evicted_tokens,
                sorted(e._host_stash))

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # unbounded: no warning
        for e, j in ((jeng, pairs[0][0]), (teng, pairs[0][1])):
            assert e.offload_job(j.job_id)
    ctx = teng.stash_tokens
    assert ctx > 0 and counts(teng) == counts(jeng)
    for e, k in ((jeng, 0), (teng, 1)):
        e.swap_pool_tokens = 2 * ctx
        assert e.offload_job(pairs[1][k].job_id)
        with pytest.warns(UserWarning, match="swap pool exceeded"):
            assert e.offload_job(pairs[2][k].job_id)
    assert counts(teng) == counts(jeng) == (2 * ctx, 1, ctx, [51, 52])
    with pytest.raises(KeyError):  # the coldest victim recomputes
        teng.restore_job(pairs[0][1])
    teng.restore_job(pairs[1][1])
    teng.drop_stash(pairs[2][1].job_id)
    assert teng.stash_tokens == 0
    # a fresh stash larger than the pool is refused, loudly, and evicted
    teng.swap_pool_tokens = 1
    assert not teng.offload_job(pairs[1][1].job_id)
    assert (teng.stash_tokens, len(teng._host_stash)) == (0, 0)
    assert teng.n_stash_evictions == 2
    assert not teng.has_job(pairs[1][1].job_id)


def test_executor_threads_watermark_and_counters(setup):
    jeng, teng = _pair(setup)
    jex = JaxExecutor({0: jeng}, swap_pool_tokens=123)
    tex = EngineExecutor({0: teng}, swap_pool_tokens=123)
    assert teng.swap_pool_tokens == 123
    assert tex.counters() == jex.counters()
    EngineExecutor({0: teng})  # None leaves the engine's setting alone
    assert teng.swap_pool_tokens == 123


# --------------------------------------------------------------------------- #
# masked_span_write
# --------------------------------------------------------------------------- #


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_masked_span_write_matches_jax(data):
    """Rows [start, start + valid) are written, every other row (padding,
    past the buffer) keeps its value: exactly the JAX scatter's result."""
    b = data.draw(st.integers(1, 3))
    length = data.draw(st.integers(1, 12))
    c = data.draw(st.integers(1, 6))
    start = data.draw(st.lists(st.integers(0, length + 2), min_size=b,
                               max_size=b))
    valid = data.draw(st.lists(st.integers(0, c), min_size=b, max_size=b))
    rng = np.random.RandomState(data.draw(st.integers(0, 2 ** 16)))
    buf = rng.randn(b, length, 2, 3).astype(np.float32)
    val = rng.randn(b, c, 2, 3).astype(np.float32)
    want = jax_span_write(jnp.asarray(buf), jnp.asarray(start, jnp.int32),
                          jnp.asarray(val), jnp.asarray(valid, jnp.int32))
    got = masked_span_write(torch.from_numpy(buf.copy()),
                            torch.tensor(start, dtype=torch.int32),
                            torch.from_numpy(val),
                            torch.tensor(valid, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------- #
# Live calibration and the swap/recompute prices
# --------------------------------------------------------------------------- #


def test_calibrated_profile_and_preempt_costs_match_jax(setup):
    """The same ``window_log`` gives the same fitted profile, per-node
    profiles, token costs and (swap, recompute) prices on both executors
    (relative 1e-12)."""
    jeng, teng = _pair(setup)
    jex, tex = JaxExecutor({0: jeng}), EngineExecutor({0: teng})
    with pytest.raises(ValueError, match="no executed windows"):
        tex.calibrated_profile()
    rng = np.random.RandomState(7)
    log = [{"node": 0, "batch": int(b), "window": int(w),
            "duration_s": float(0.002 + w * 0.001 * (1 + 0.1 * (b - 1))
                                + rng.uniform(0, 1e-4)), "tokens": int(b * w)}
           for b, w in zip(rng.randint(1, 3, 40), rng.choice([4, 8, 16], 40))]
    jex.window_log = [dict(r) for r in log]
    tex.window_log = [dict(r) for r in log]
    jp, tp = jex.calibrated_profile(), tex.calibrated_profile()
    for name, want in dataclasses.asdict(jp).items():
        got = getattr(tp, name)
        if isinstance(want, float):
            assert got == pytest.approx(want, rel=1e-12), name
        else:
            assert got == want, name
    assert tex.fit_overhead_s == pytest.approx(jex.fit_overhead_s, rel=1e-12)
    assert tex.node_token_cost()[0] == pytest.approx(
        jex.node_token_cost()[0], rel=1e-12)
    tj, jj = Job(job_id=1, prompt="", prompt_tokens=[1], arrival_time=0.0), \
        JaxJob(job_id=1, prompt="", prompt_tokens=[1], arrival_time=0.0)
    assert tex.preempt_costs(0, tj) is None  # nothing materialised yet
    tj.prefilled_tokens = jj.prefilled_tokens = 37
    got, want = tex.preempt_costs(0, tj), jex.preempt_costs(0, jj)
    assert got == pytest.approx(want, rel=1e-12)
