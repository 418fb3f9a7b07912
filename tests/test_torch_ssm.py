"""The port's SSM family (mamba2-130m, reduced: 2 layers, d_model 128, 8
heads of head dim 32, d_state 16, chunk 32, fp32) against the JAX package:
the plain SSD scan against the Pallas kernel (interpret mode) and the
sequential recurrence, the Mamba2 block, prefill and masked decode, the
engine and ``ElisServer`` token streams, the reference's pending-first
rollback caveat, and — on a card only — the SSD-scan kernel against its
plain version.

Tolerances: the plain scan against the Pallas kernel and the sequential
recurrence 1e-4 abs, as ``tests/test_kernels.py`` holds the Pallas kernel
(the same sums in another association); model outputs, logits and states
2e-5 abs + rel in fp32; frozen states bit for bit; greedy tokens
identical.  On the card: fp32 (2e-5 of the largest |value| abs, 2e-5 rel),
sums of up to chunk x N products in another order; bf16 one bf16 ulp
(2^-7 rel) on top of that, since kernel and plain version each round an
fp32 result.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import ElisServer as JaxServer  # noqa: E402
from repro.core import FrontendConfig as JaxFrontendConfig  # noqa: E402
from repro.core import Job as JaxJob  # noqa: E402
from repro.core import OraclePredictor as JaxOracle  # noqa: E402
from repro.core import PreemptionConfig as JaxPreemptionConfig  # noqa: E402
from repro.core import Request as JaxRequest  # noqa: E402
from repro.core import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import EngineExecutor as JaxExecutor  # noqa: E402
from repro.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import (params_from_numpy,  # noqa: E402
                                ssm_cache_from_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ElisServer, FrontendConfig, Job,  # noqa: E402
                              OraclePredictor, PreemptionConfig, Request,
                              SchedulerConfig)
from repro_torch.engine import (EngineConfig, EngineExecutor,  # noqa: E402
                                InferenceEngine)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "mamba2-130m"
TOL = 2e-5
#: (JAX impl, port impl): the kernels, and the plain paths
IMPLS = [("pallas", "kernel"), ("xla", "torch")]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _prompts(seed, lengths, vocab=512):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(8, vocab, size=n)] for n in lengths]


def _scan_inputs(seed, b, s, h, p, n, decay=0.1):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, p).astype(np.float32),
            (-np.abs(rng.randn(b, s, h)) * decay).astype(np.float32),
            rng.randn(b, s, h, n).astype(np.float32),
            rng.randn(b, s, h, n).astype(np.float32))


# --------------------------------------------------------------------------- #
# The plain SSD scan
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("s,h,p,n,chunk", [
    (128, 2, 16, 8, 32),
    (256, 3, 32, 16, 64),
    (64, 1, 64, 128, 64),   # mamba2-130m's head
    (90, 2, 32, 16, 45),    # a chunk that is no power of two, S > chunk
    (100, 2, 32, 16, 100),  # exact-length prefill: chunk = S
])
def test_plain_ssd_scan_matches_pallas_and_sequential(s, h, p, n, chunk):
    x, a, bm, cm = _scan_inputs(s, 2, s, h, p, n)
    y, fs = ref.ssd_scan(*map(torch.from_numpy, (x, a, bm, cm)), chunk=chunk)
    jin = tuple(map(jnp.asarray, (x, a, bm, cm)))
    jy, jfs = jax_ops.ssd_scan(*jin, chunk=chunk)
    sy, sfs = JS.ssd_reference_sequential(*jin)
    for want_y, want_fs in ((jy, jfs), (sy, sfs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4)
        np.testing.assert_allclose(fs.numpy(), np.asarray(want_fs),
                                   atol=1e-4)


def test_plain_ssd_scan_keeps_the_input_dtype():
    x, a, bm, cm = (torch.from_numpy(v) for v in _scan_inputs(1, 1, 64, 2, 32,
                                                              16))
    y, fs = ref.ssd_scan(x.bfloat16(), a, bm.bfloat16(), cm.bfloat16(),
                         chunk=32)
    assert y.dtype == fs.dtype == torch.bfloat16
    assert tuple(fs.shape) == (1, 2, 32, 16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.ssd_scan(x, a, bm, cm, chunk=48)


def test_ssd_scan_wrapper_on_cpu_runs_the_plain_version():
    x, a, bm, cm = (torch.from_numpy(v) for v in _scan_inputs(2, 2, 64, 2, 32,
                                                              16))
    before = ops.ssd_scan.launches
    got = ops.ssd_scan(x, a, bm, cm, chunk=32)
    want = ref.ssd_scan(x, a, bm, cm, chunk=32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.ssd_scan.launches == before  # only a kernel launch counts
    assert ops.KERNELS["ssd_scan"] is ops.ssd_scan


def test_ssd_scan_wrapper_refuses_other_devices():
    """No fallback: a tensor on neither the CPU nor the card is refused."""
    x = torch.empty((1, 32, 2, 32), device="meta")
    a = torch.empty((1, 32, 2), device="meta")
    bm = torch.empty((1, 32, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd_scan(x, a, bm, bm, chunk=32)


# --------------------------------------------------------------------------- #
# The Mamba2 block
# --------------------------------------------------------------------------- #


def _layer(jp, tp, cfg, i=0):
    return (jax.tree_util.tree_map(lambda a: a[i], jp["layers"]["ssm"]),
            T._unstack(tp["layers"], cfg.n_layers)[i]["ssm"])


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
@pytest.mark.parametrize("s", [2, 45])
def test_ssm_forward_matches_reference(setup, jimpl, timpl, s):
    """S = 2 is shorter than the conv tail (padded state), S = 45 one
    chunk of 32 and a padded second."""
    jcfg, cfg, jp, tp = setup
    jl, tl = _layer(jp, tp, cfg)
    x = np.random.RandomState(s).randn(2, s, cfg.d_model).astype(np.float32)
    jout, jst = JS.ssm_forward(jl, jcfg, jnp.asarray(x), impl=jimpl,
                               return_state=True)
    tout, tst = S.ssm_forward(tl, cfg, _t(x), impl=timpl, return_state=True)
    _close(tout, jout)
    assert tst.keys() == jst.keys()
    for k in tst:
        assert tuple(tst[k].shape) == jst[k].shape
        _close(tst[k], jst[k])


def test_ssm_decode_step_matches_reference(setup):
    jcfg, cfg, jp, tp = setup
    jl, tl = _layer(jp, tp, cfg, 1)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    state = {"conv": rng.randn(3, S.conv_channels(cfg), 3).astype(np.float32),
             "ssm": rng.randn(3, cfg.ssm_n_heads, 32, 16).astype(np.float32)}
    jout, jst = JS.ssm_decode_step(jl, jcfg, jnp.asarray(x),
                                   {k: jnp.asarray(v) for k, v in
                                    state.items()})
    tstate = {k: _t(v) for k, v in state.items()}
    tout, tst = S.ssm_decode_step(tl, cfg, _t(x), tstate)
    _close(tout, jout)
    for k in tst:
        _close(tst[k], jst[k])
        np.testing.assert_array_equal(tstate[k].numpy(), state[k])


# --------------------------------------------------------------------------- #
# Model: init, prefill, decode
# --------------------------------------------------------------------------- #


def test_init_params_has_reference_layout_and_fp32_leaves(setup):
    """The port's own init builds the reference's tree (keys, shapes,
    dtypes), in bf16 too, where ``A_log``, ``dt_bias`` and ``D`` stay fp32;
    the bridge keeps those leaves fp32 whatever dtype it is asked for."""
    jcfg, cfg, jp, _ = setup
    for dtype in ("float32", "bfloat16"):
        jc = dataclasses.replace(jcfg, dtype=dtype)
        tc = dataclasses.replace(cfg, dtype=dtype)
        want = {jax.tree_util.keystr(p): (a.shape, str(a.dtype)) for p, a in
                jax.tree_util.tree_leaves_with_path(
                    jax.eval_shape(lambda k: jax_init_params(k, jc),
                                   jax.random.PRNGKey(0)))}
        tp = T.init_params(tc, torch.Generator().manual_seed(0))
        got = {jax.tree_util.keystr(p): (tuple(t.shape),
                                         str(t.dtype).split(".")[1])
               for p, t in jax.tree_util.tree_leaves_with_path(tp)}
        assert got == want
    ssm = tp["layers"]["ssm"]
    a = -torch.exp(ssm["A_log"])
    assert float(a.max()) <= -1.0 and float(a.min()) >= -16.0
    assert abs(float(ssm["conv_w"].float().std()) - 0.1) < 0.01
    tree = jax.tree_util.tree_map(np.asarray, jp)
    conv = params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    for name in ("A_log", "dt_bias", "D"):
        assert conv["layers"]["ssm"][name].dtype == torch.float32
        assert torch.equal(conv["layers"]["ssm"][name],
                           _t(tree["layers"]["ssm"][name]))
    assert conv["layers"]["ssm"]["in_proj"].dtype == torch.bfloat16


def test_init_cache_has_reference_shapes(setup):
    jcfg, cfg, _, _ = setup
    jc = JT.init_cache(jcfg, 3, 64)
    tc = T.init_cache(cfg, 3, 64, "cpu")
    assert tc.keys() == jc.keys() == {"len", "ssm"}
    for k in ("conv", "ssm"):
        assert tuple(tc["ssm"][k].shape) == jc["ssm"][k].shape
        assert not bool(tc["ssm"][k].any())
    with pytest.raises(NotImplementedError, match="next slice"):
        T.init_cache(dataclasses.replace(cfg, family="hybrid"), 1, 8, "cpu")


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
@pytest.mark.parametrize("s", [7, 32, 45, 100])
def test_prefill_logits_and_state_match_reference(setup, jimpl, timpl, s):
    """One chunk, an exact multiple of the chunk (32), padding, several
    chunks."""
    jcfg, cfg, jp, tp = setup
    toks = np.asarray(_prompts(s, [s]), np.int32)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        JT.init_cache(jcfg, 1, 128), attn_impl=jimpl)
    tl, tc = T.prefill(tp, cfg, {"tokens": _t(toks)},
                       T.init_cache(cfg, 1, 128, "cpu"), attn_impl=timpl)
    assert tuple(tl.shape) == (1, 1, cfg.vocab_size)
    _close(tl, jl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for k in ("conv", "ssm"):
        _close(tc["ssm"][k], jc["ssm"][k])


def test_decode_step_with_mixed_active_mask(setup):
    """Live rows match the reference; frozen rows keep their conv and SSM
    states bit for bit and do not advance ``len``."""
    jcfg, cfg, jp, tp = setup
    rng = np.random.RandomState(3)
    toks = rng.randint(8, 512, size=(4, 16)).astype(np.int32)
    _, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       JT.init_cache(jcfg, 4, 32))
    lens = np.array([16, 3, 9, 16], np.int32)
    jc["len"] = jnp.asarray(lens)
    tc = ssm_cache_from_numpy(lens, np.asarray(jc["ssm"]["conv"]),
                              np.asarray(jc["ssm"]["ssm"]), device="cpu")
    before = {k: v.clone() for k, v in tc["ssm"].items()}
    step = rng.randint(8, 512, size=(4, 1)).astype(np.int32)
    active = np.array([True, False, True, False])
    jl, jc2 = JT.decode_step(jp, jcfg, jnp.asarray(step), jc,
                             active=jnp.asarray(active))
    tl, tc = T.decode_step(tp, cfg, _t(step), tc, active=_t(active))
    live = np.flatnonzero(active)
    _close(tl.numpy()[live], np.asarray(jl)[live])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc2["len"]))
    np.testing.assert_array_equal(tc["len"].numpy(), lens + active)
    for k in ("conv", "ssm"):
        for row in np.flatnonzero(~active):
            assert torch.equal(tc["ssm"][k][:, row], before[k][:, row])
        np.testing.assert_array_equal(np.asarray(jc2["ssm"][k])[:, ~active],
                                      np.asarray(jc["ssm"][k])[:, ~active])
        _close(tc["ssm"][k].numpy()[:, live],
               np.asarray(jc2["ssm"][k])[:, live])


# --------------------------------------------------------------------------- #
# Engine and server
# --------------------------------------------------------------------------- #


def test_engine_greedy_tokens_match_jax_engine(setup):
    """Serial exact-length admissions, compacted decode, a full-width window
    with a frozen slot, eviction and recompute re-admission: token for
    token, with the same dispatch counts."""
    jcfg, cfg, jp, tp = setup
    kw = dict(max_slots=4, max_len=128, max_output=64, eos_id=-1)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="xla", **kw))
    teng = InferenceEngine(cfg, tp, EngineConfig(attn_impl="kernel", **kw),
                           device="cpu")
    prompts = _prompts(0, [5, 40, 9])
    jjobs = [JaxJob(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
             for i, p in enumerate(prompts)]
    tjobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
             for i, p in enumerate(prompts)]
    schedule = [[0, 1], [0, 1, 2], [1, 2], [0, 1, 2]]
    for w, ids in enumerate(schedule):
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
        assert teng.slot_job == jeng.slot_job
    assert len(set(tjobs[1].generated)) > 1  # not a degenerate stream
    for attr in ("num_prefill_dispatches", "num_decode_dispatches",
                 "resume_context_tokens"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    # 3 fresh admissions and 1 resume, each its own batch-1 dispatch
    assert teng.num_prefill_dispatches == 4


def _serve_with_late_arrivals(server_cls, cfg_cls, sched_cls, preemption,
                              oracle_cls, req_cls, executor, first, late):
    """Submit ``first``, run its first window, then submit ``late`` and
    drain: the late short jobs preempt the long one."""
    server = server_cls(
        cfg_cls(n_nodes=1,
                scheduler=sched_cls(policy="isrtf", window=4, batch_size=2),
                preemption=preemption, observe_in_flight=False),
        oracle_cls(), executor)
    server.submit(req_cls(**first))
    server.step()  # the arrival
    server.step()  # its first window
    for r in late:
        server.submit(req_cls(**r))
    return {r.request_id: (r.status.value, r.tokens, r.n_preemptions)
            for r in server.drain()}


def test_server_streams_match_jax_server_through_recompute_preemption(setup):
    """ISRTF over the SSM engine preempts a long job for two short late
    arrivals; the victim is evicted and resumes by recompute (an
    exact-length prefill of prompt + generated).  Token streams and
    preemption counts match the JAX server's."""
    jcfg, cfg, jp, tp = setup
    prompts = _prompts(7, [11, 6, 40])
    first = dict(prompt="long", prompt_tokens=prompts[0], arrival_time=0.0,
                 request_id=0, true_output_len=30)
    late = [dict(prompt=f"short{i}", prompt_tokens=p, arrival_time=0.0,
                 request_id=i, true_output_len=5)
            for i, p in enumerate(prompts[1:], start=1)]
    kw = dict(max_slots=2, max_len=128, max_output=32, eos_id=-1,
              respect_job_max=True)
    got = _serve_with_late_arrivals(
        ElisServer, FrontendConfig, SchedulerConfig,
        PreemptionConfig(enabled=True, margin=8.0), OraclePredictor, Request,
        EngineExecutor({0: InferenceEngine(cfg, tp, EngineConfig(**kw),
                                           device="cpu")}), first, late)
    want = _serve_with_late_arrivals(
        JaxServer, JaxFrontendConfig, JaxSchedulerConfig,
        JaxPreemptionConfig(enabled=True, margin=8.0, policy="recompute"),
        JaxOracle, JaxRequest,
        JaxExecutor({0: JaxEngine(jcfg, jp, JaxEngineConfig(
            attn_impl="xla", **kw))}), first, late)
    assert got == want
    assert got[0][2] == 1 and len(got[0][1]) == 30
    assert all(status == "finished" for status, _, _ in got.values())


def test_dispatch_shapes_exact_length_prefill_and_decode_bound(setup):
    """Exact-length families have no prefill shape bound: one (1, S) shape
    per prompt length.  The decode shapes stay within the batch buckets."""
    _, cfg, _, tp = setup
    eng = InferenceEngine(cfg, tp, EngineConfig(
        max_slots=4, max_len=64, max_output=8, eos_id=-1), device="cpu")
    executor = EngineExecutor({0: eng})
    lengths = [3, 40, 17, 40, 1, 33]
    jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
            for i, p in enumerate(_prompts(5, lengths))]
    for start in range(0, len(jobs), 3):
        batch = jobs[start:start + 3]
        res = executor.execute(0, batch, 2, 0.0)
        assert all(len(t) == 2 for t in res.tokens)
        for j in batch:
            executor.evict(0, j)
    c = executor.counters()
    assert c["prefill_dispatches"] == len(jobs) and c["decode_dispatches"] == 2
    assert eng._prefill_shapes == {(1, n) for n in lengths}
    assert 0 < c["decode_traces"] <= eng.decode_batch_buckets()
    assert eng.free_slots() == 4


def test_engine_reproduces_the_reference_rollback_caveat(setup):
    """After a fresh admission the engine emits the prefill's first token
    and drops the window's K-th output, rolling ``len`` back one place; a
    recurrent state cannot be rolled back, so the token fed at step K is
    absorbed twice.  The JAX engine and the port's give the same stream,
    and both leave the sequential prefill + decode_step greedy stream at
    token K + 1 (seed 0, a 7-token prompt, K = 8)."""
    jcfg, cfg, jp, tp = setup
    K = 8
    prompt = _prompts(0, [7])[0]
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(max_slots=1, max_len=64,
                                               max_output=64, eos_id=-1))
    teng = InferenceEngine(cfg, tp, EngineConfig(max_slots=1, max_len=64,
                                                 max_output=64, eos_id=-1),
                           device="cpu")
    streams = []
    for eng, job in ((jeng, JaxJob(job_id=0, prompt="", prompt_tokens=prompt,
                                   arrival_time=0.0)),
                     (teng, Job(job_id=0, prompt="", prompt_tokens=prompt,
                                arrival_time=0.0))):
        for _ in range(2):
            toks, _ = eng.run_window([job], K)
            job.generated.extend(toks[0])
        streams.append(list(job.generated))
    assert streams[0] == streams[1]
    # the sequential greedy stream of the port's model
    cache = T.init_cache(cfg, 1, 64, "cpu")
    logits, cache = T.prefill(tp, cfg, {"tokens": _t([prompt])}, cache)
    seq = [int(logits[0, -1].argmax())]
    while len(seq) < 2 * K:
        logits, cache = T.decode_step(tp, cfg, _t([[seq[-1]]]), cache)
        seq.append(int(logits[0, -1].argmax()))
    assert streams[1][:K] == seq[:K]
    assert streams[1][K] != seq[K]


# --------------------------------------------------------------------------- #
# On the card: the SSD-scan kernel against its plain version
# --------------------------------------------------------------------------- #


def requires_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _card_scan_inputs(gen, b, s, h, p, n, dtype, pad=0):
    """Model-like inputs with a trained Mamba2's long memory (dt in
    [1e-3, 0.1], A in [-16, -1]); the last ``pad`` positions zero, as the
    model pads a prompt to a multiple of the chunk."""
    dt = torch.exp(torch.rand((b, s, h), generator=gen, device="cuda")
                   * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    A = torch.rand((h,), generator=gen, device="cuda") * 15 + 1
    x = torch.randn((b, s, h, p), generator=gen, device="cuda") * dt[..., None]
    bm = torch.randn((b, s, h, n), generator=gen, device="cuda") * 0.5
    cm = torch.randn((b, s, h, n), generator=gen, device="cuda") * 0.5
    a = -dt * A
    if pad:
        for t in (x, a, bm, cm):
            t[:, s - pad:] = 0
    return x.to(dtype), a, bm.to(dtype), cm.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk,pad", [
    (1, 137, 24, 64, 128, 137, 0),   # served widths, one ragged chunk
    (1, 512, 24, 64, 128, 256, 0),   # two chunks: the carry
    (1, 512, 24, 64, 128, 256, 212),  # a 300-token prompt, padded
    (2, 96, 8, 32, 16, 32, 0),        # reduced widths
    (3, 64, 4, 64, 16, 1, 0),         # chunk 1
    (1, 250, 3, 32, 128, 250, 0),
    (1, 4096, 24, 64, 128, 256, 0),   # many chunks: the carry pass
    (2, 2048, 24, 64, 128, 64, 0),
    (1, 256, 24, 64, 128, 1, 0),      # 256 one-row chunks
    (1, 8192, 24, 64, 128, 256, 3000),  # a long prompt, padded
])
def test_ssd_scan_kernel_matches_plain_on_card(dtype, b, s, h, p, n, chunk,
                                               pad):
    requires_card()
    gen = torch.Generator(device="cuda").manual_seed(s + chunk)
    x, a, bm, cm = _card_scan_inputs(gen, b, s, h, p, n, dtype, pad)
    launches = ops.ssd_scan.launches
    y, fs = ops.ssd_scan(x, a, bm, cm, chunk=chunk)
    want_y, want_fs = ref.ssd_scan(x, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == launches + 1
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-5
    for got, want in ((y, want_y), (fs, want_fs)):
        assert got.dtype == dtype
        atol = 2e-5 * float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,s,chunk,kernels", [
    (torch.bfloat16, 137, 137, 2),  # one chunk: states, outputs
    (torch.bfloat16, 512, 256, 3),  # two: states, carry, outputs
    (torch.float32, 512, 256, 1),   # the CUDA-core body
])
def test_ssd_scan_call_counts_one_launch_on_card(dtype, s, chunk, kernels):
    """One wrapper call adds exactly 1 to ``launches``, however many
    kernels the library launched for it (as it records them)."""
    requires_card()
    from repro_torch.kernels import build
    gen = torch.Generator(device="cuda").manual_seed(s)
    x, a, bm, cm = _card_scan_inputs(gen, 1, s, 24, 64, 128, dtype)
    launches = ops.ssd_scan.launches
    ops.ssd_scan(x, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == launches + 1
    assert build.load("ssd_scan_last_kernels")() == kernels
    assert build.load("ssd_scan_last_body")() == (
        1 if dtype == torch.bfloat16 else 0)


@pytest.mark.gpu
def test_ssm_kernel_engine_matches_plain_engine_on_card(setup):
    """On the card, the SSD-kernel engine and the plain engine give the
    same greedy tokens (fp32, TF32 off), and every prefill dispatch
    launches the kernel once per layer."""
    requires_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg, _, tp = setup
    params = jax.tree_util.tree_map(lambda t: t.to("cuda"), tp)
    prompts = _prompts(6, [5, 60, 33, 100])
    streams = []
    for impl in ("kernel", "torch"):
        eng = InferenceEngine(cfg, params, EngineConfig(
            max_slots=4, max_len=128, max_output=64, eos_id=-1,
            attn_impl=impl), device="cuda")
        jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
                for i, p in enumerate(prompts)]
        launches = ops.ssd_scan.launches
        out = []
        for _ in range(3):
            toks, _ = eng.run_window(jobs, 8)
            for j, t in zip(jobs, toks):
                j.generated.extend(t)
            out.append(toks)
        streams.append(out)
        want = cfg.n_layers * len(prompts) if impl == "kernel" else 0
        assert ops.ssd_scan.launches - launches == want
    assert streams[0] == streams[1]
