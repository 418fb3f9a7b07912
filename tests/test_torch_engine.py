"""The port's serving engine and executor against the JAX engine on the
reduced qwen2-1.5b (fp32): greedy tokens must be identical, through
batched prefill, compaction, evict/re-admit, EOS freezing, and the whole
``ElisServer`` + ISRTF stack.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
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
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ElisServer, FrontendConfig, Job,  # noqa: E402
                              OraclePredictor, PreemptionConfig, Request,
                              SchedulerConfig)
from repro_torch.engine import (EngineConfig, EngineExecutor,  # noqa: E402
                                InferenceEngine)
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "qwen2-1.5b"


@pytest.fixture(scope="module")
def setup():
    """One parameter tree for both engines: the reference init with the
    layer weights scaled by 3, so that greedy streams do not settle on one
    repeated token (at the plain init the tied embedding makes each token
    predict itself)."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    for group in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for name in group:
            if name.startswith("w"):
                group[name] = group[name] * np.float32(3.0)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    return jcfg, cfg, jp, tp


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(8, 512, size=n)] for n in lengths]


def test_engine_greedy_tokens_match_jax_engine(setup):
    """Batched bucketed prefill, compacted decode, a full-width window with
    a frozen slot, eviction and recompute re-admission: token for token."""
    jcfg, cfg, jp, tp = setup
    kw = dict(max_slots=4, max_len=128, max_output=64, eos_id=-1)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="pallas", **kw))
    teng = InferenceEngine(cfg, tp, EngineConfig(attn_impl="kernel", **kw),
                           device="cpu")
    prompts = _prompts(0, [5, 21, 9])
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
                 "num_prefill_traces", "num_decode_traces",
                 "resume_context_tokens"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr


def _serve(server_cls, cfg_cls, sched_cls, preemption, oracle_cls, req_cls,
           executor, requests):
    server = server_cls(
        cfg_cls(n_nodes=1,
                scheduler=sched_cls(policy="isrtf", window=4, batch_size=2),
                preemption=preemption, observe_in_flight=False),
        oracle_cls(), executor)
    for r in requests:
        server.submit(req_cls(**r))
    return {r.request_id: (r.status.value, r.tokens, r.n_preemptions)
            for r in server.drain()}


def test_server_streams_match_jax_server(setup):
    """ElisServer draining ISRTF over the port's executor yields the JAX
    executor's per-request token streams, with an EOS id that occurs
    mid-stream (EOS freezing inside a decode window)."""
    jcfg, cfg, jp, tp = setup
    rng = np.random.RandomState(4)
    requests = [dict(prompt=f"r{i}", prompt_tokens=p, arrival_time=0.0,
                     request_id=i, true_output_len=int(rng.randint(5, 15)))
                for i, p in enumerate(_prompts(3, [7, 30, 12, 3, 18, 25]))]

    def port(eos_id):
        eng = InferenceEngine(cfg, tp, EngineConfig(
            max_slots=2, max_len=128, max_output=16, eos_id=eos_id,
            respect_job_max=True), device="cpu")
        return _serve(ElisServer, FrontendConfig, SchedulerConfig,
                      PreemptionConfig(enabled=True), OraclePredictor,
                      Request, EngineExecutor({0: eng}), requests)

    # an id the greedy streams emit mid-window becomes the EOS token
    free_run = port(-1)
    eos = free_run[1][1][2]
    got = port(eos)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(
        max_slots=2, max_len=128, max_output=16, eos_id=eos,
        respect_job_max=True, attn_impl="xla"))
    want = _serve(JaxServer, JaxFrontendConfig, JaxSchedulerConfig,
                  JaxPreemptionConfig(enabled=True, policy="recompute"),
                  JaxOracle, JaxRequest, JaxExecutor({0: jeng}), requests)
    assert got == want
    assert all(status == "finished" for status, _, _ in got.values())
    assert any(toks and toks[-1] == eos for _, toks, _ in got.values())


def _serve_with_late_arrivals(server_cls, cfg_cls, sched_cls, preemption,
                              oracle_cls, req_cls, executor, first, late):
    """Submit ``first``, run its first window, then submit ``late`` (dated
    at the current clock) and drain: the late short jobs preempt the long
    one at the next window boundary whatever the windows' wall times."""
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


def test_recompute_preemption_matches_jax_server(setup):
    """ISRTF preempts a long job for two short late arrivals; the victim is
    evicted and resumes by recompute.  Token streams and preemption counts
    match the JAX server's."""
    jcfg, cfg, jp, tp = setup
    prompts = _prompts(7, [11, 6, 9])
    first = dict(prompt="long", prompt_tokens=prompts[0], arrival_time=0.0,
                 request_id=0, true_output_len=30)
    late = [dict(prompt=f"short{i}", prompt_tokens=p, arrival_time=0.0,
                 request_id=i, true_output_len=5)
            for i, p in enumerate(prompts[1:], start=1)]
    kw = dict(max_slots=2, max_len=64, max_output=32, eos_id=-1,
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


def test_dispatch_shapes_stay_within_bucket_bounds(setup):
    _, cfg, _, tp = setup
    eng = InferenceEngine(cfg, tp, EngineConfig(
        max_slots=4, max_len=64, max_output=8, eos_id=-1), device="cpu")
    executor = EngineExecutor({0: eng})
    prompts = _prompts(5, [3, 40, 17, 64, 1, 33, 9, 20])
    jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
            for i, p in enumerate(prompts)]
    for start in range(0, len(jobs), 3):
        batch = jobs[start:start + 3]
        res = executor.execute(0, batch, 2, 0.0)
        assert all(len(t) == 2 for t in res.tokens)
        for j in batch:
            executor.evict(0, j)
    c = executor.counters()
    assert c["prefill_dispatches"] == 3 and c["decode_dispatches"] == 3
    assert 0 < c["prefill_traces"] <= eng.prefill_shape_bound()
    assert 0 < c["decode_traces"] <= eng.decode_batch_buckets()
    assert c["windows_executed"] == 3 and len(executor.window_log) == 3
    assert eng.free_slots() == 4


def test_prompt_longer_than_the_cache_is_refused(setup):
    _, cfg, _, tp = setup
    eng = InferenceEngine(cfg, tp, EngineConfig(max_slots=1, max_len=16),
                          device="cpu")
    job = Job(job_id=0, prompt="", prompt_tokens=list(range(8, 25)),
              arrival_time=0.0)
    with pytest.raises(ValueError, match="max_len"):
        eng.run_window([job], 1)
    assert eng.free_slots() == 1


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
    prompts = _prompts(6, [5, 60, 33])
    streams = []
    for impl in ("kernel", "torch"):
        eng = InferenceEngine(cfg, params, EngineConfig(
            max_slots=4, max_len=128, max_output=64, eos_id=-1,
            attn_impl=impl), device="cuda")
        jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
                for i, p in enumerate(prompts)]
        out = []
        for _ in range(3):
            toks, _ = eng.run_window(jobs, 8)
            for j, t in zip(jobs, toks):
                j.generated.extend(t)
            out.append(toks)
        streams.append(out)
    assert streams[0] == streams[1]
    assert T.init_cache(cfg, 1, 8, "cuda")["kv"].k.is_cuda
