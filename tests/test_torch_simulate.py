"""The port's cluster simulator (``repro_torch.simulate``: ``SimExecutor``,
``run_experiment``, ``compare_policies``, ``requests_to_jobs``) and the
host pieces it needs (``QuantileSketch``, ``StreamingSummary``,
``PriorityBuffer``, ``batch_effective``, ``output_tokens`` on ``Job`` and
``Request``) against the JAX package's, on the CPU.

Tolerances: the simulator is host arithmetic (numpy and Python) in both
packages, so every summary, counter and quantile is compared exactly.
Runs ranked by a BGE predictor (the same tiny encoder's weights in both
packages, converted by ``repro_torch.bridge``) compare each dispatch's
predictions within ``BGE_RTOL`` (fp32 encoders on two frameworks), the
scheduling trace and summary exactly, and the summary's prediction-error
statistics within ``BGE_RTOL``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import simulate as JS  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import metrics as JM  # noqa: E402
from repro.core import predictor as JP  # noqa: E402
from repro.core import scheduler as JSched  # noqa: E402
from repro.core.job import Job as JaxJob  # noqa: E402
from repro.data.workload import WorkloadGenerator as JaxGenerator  # noqa: E402
from repro.models import encoder as JE  # noqa: E402
from repro_torch import simulate as TS  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import (ElisServer, FrontendConfig, Job,  # noqa: E402
                              OraclePredictor, PreemptionConfig,
                              PriorityBuffer, QuantileSketch, Request,
                              SchedulerConfig, StreamingSummary,
                              batch_effective, make_policy)
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import predictor as TP  # noqa: E402
from repro_torch.data.workload import WorkloadGenerator  # noqa: E402
from repro_torch.models import encoder as TE  # noqa: E402


#: fp32 BGE predictions of the two packages on the same weights and inputs
BGE_RTOL = 1e-4

#: the reference tests' tiny predictor shape (tests/test_predictor.py)
TINY = dict(encoder=dict(d_model=16, n_heads=2, n_layers=1, d_ff=32,
                         max_len=32), n_fc_layers=2, fc_hidden=16, max_len=32)


def configs(**kw):
    """The same ``ExperimentConfig`` in both packages (each with its own
    ``PreemptionConfig`` when ``preemption`` is given as a dict)."""
    pre = kw.pop("preemption", None)
    jkw, tkw = dict(kw), dict(kw)
    if pre is not None:
        jkw["preemption"] = JSched.PreemptionConfig(**pre)
        tkw["preemption"] = PreemptionConfig(**pre)
    return JS.ExperimentConfig(**jkw), TS.ExperimentConfig(**tkw)


# --------------------------------------------------------------------------- #
# run_experiment, compare_policies
# --------------------------------------------------------------------------- #


EXPERIMENTS = {
    **{f"{pol}-{pred}": dict(policy=pol, predictor=pred, n_requests=60,
                             seed=3)
       for pol in ("fcfs", "sjf", "isrtf", "mlfq")
       for pred in ("oracle", "noisy_oracle")},
    "scenario-tenants": dict(scenario="multi_tenant_slo", n_requests=80,
                             n_nodes=2, placement="least_predicted_work",
                             seed=5),
    "hetero-2-nodes": dict(model="vic", n_nodes=2, node_profiles={1: "lam13"},
                           placement="least_eta", hw_speedup=2.0,
                           n_requests=60, seed=7),
    "swap": dict(preemption=dict(policy="swap"), rps_multiple=2.0,
                 n_requests=60, seed=11),
    "auto": dict(preemption=dict(policy="auto"), rps_multiple=2.0,
                 batch_size=2, n_requests=60, seed=12),
    "prefill-chunk": dict(prefill_chunk=64, rps_multiple=1.5, n_requests=50,
                          seed=13),
    "bursty-calibrated": dict(arrivals="bursty", calibrate="ema+conformal",
                              risk_quantile=0.9, predictor_bias=0.7,
                              repredict_every=3, aging_rate=0.05,
                              n_requests=60, seed=14),
    "rebalance": dict(n_nodes=3, rebalance=True, rebalance_threshold=50.0,
                      placement="least_jobs", rps_multiple=1.5,
                      n_requests=60, seed=15),
}


@pytest.mark.parametrize("kw", EXPERIMENTS.values(), ids=EXPERIMENTS.keys())
def test_run_experiment_matches_reference(kw):
    jcfg, tcfg = configs(**kw)
    want = JS.run_experiment(jcfg)
    got = TS.run_experiment(tcfg)
    assert got == want
    assert got["n_finished"] == jcfg.n_requests and got["n_unfinished"] == 0


@pytest.mark.parametrize("kw", [dict(n_requests=60, seed=2),
                                dict(scenario="multi_tenant_slo",
                                     n_requests=80, n_nodes=2, seed=4)],
                         ids=["plain", "scenario"])
def test_stream_metrics_match_reference(kw):
    """``stream_metrics=True``: the constant-memory summary (sketch
    quantiles), per tenant too, exactly as the reference streams it."""
    jcfg, tcfg = configs(**kw)
    want = JS.run_experiment(jcfg, stream_metrics=True)
    got = TS.run_experiment(tcfg, stream_metrics=True)
    assert got == want


def test_compare_policies_matches_reference():
    jcfg, tcfg = configs(n_requests=40, predictor="noisy_oracle", seed=9)
    want = JS.compare_policies(jcfg, n_trials=2)
    got = TS.compare_policies(tcfg, n_trials=2)
    assert got == want
    assert set(got) == {"fcfs", "isrtf", "sjf"}


def test_requests_to_jobs_matches_reference():
    jobs = TS.requests_to_jobs(WorkloadGenerator(seed=1).sample_requests(20))
    want = JS.requests_to_jobs(JaxGenerator(seed=1).sample_requests(20))
    fields = ("job_id", "prompt", "prompt_tokens", "arrival_time",
              "true_output_len", "output_tokens")
    assert [tuple(getattr(j, f) for f in fields) for j in jobs] == \
        [tuple(getattr(j, f) for f in fields) for j in want]
    assert all(len(j.output_tokens) == j.true_output_len for j in jobs)


# --------------------------------------------------------------------------- #
# Request.output_tokens, the refusals
# --------------------------------------------------------------------------- #


def test_output_tokens_pass_from_workload_into_the_job():
    """``Request.from_workload`` carries the stream, and the server hands it
    to the ``Job``, as the reference does."""
    w = WorkloadGenerator(seed=2).sample_requests(3)
    jw = JaxGenerator(seed=2).sample_requests(3)
    for r, jr in zip(w, jw):
        req, jreq = (tapi.Request.from_workload(r),
                     japi.Request.from_workload(jr))
        assert list(req.output_tokens) == list(jreq.output_tokens)
        assert len(req.output_tokens) == r.true_output_len
    server = ElisServer(FrontendConfig(), OraclePredictor(),
                        TS.SimExecutor(TS.PROFILES["vic"]))
    for r in w:
        server.submit(tapi.Request.from_workload(r))
    assert [server._jobs[r.request_id].output_tokens for r in w] == \
        [list(r.output_tokens) for r in w]
    assert [len(r.tokens) for r in server.drain()] == \
        [r.true_output_len for r in w]
    # a request without a stream keeps the default, an empty one
    assert Request(prompt="", prompt_tokens=[1]).output_tokens == ()


def _message(exc_info):
    return str(exc_info.value).replace("repro_torch.", "repro.")


def test_a_short_stream_is_refused_with_the_reference_message():
    errs = []
    for ex_mod, job_cls in ((TS, Job), (JS, JaxJob)):
        job = job_cls(job_id=4, prompt="", prompt_tokens=[1, 2],
                      arrival_time=0.0, true_output_len=5,
                      output_tokens=[7, 7, 7])
        with pytest.raises(ValueError) as e:
            ex_mod.SimExecutor(ex_mod.PROFILES["vic"]).execute(0, [job], 50,
                                                               0.0)
        errs.append(_message(e))
    assert errs[0] == errs[1]
    assert "output_tokens has 3 tokens but true_output_len=5" in errs[0]


@pytest.mark.parametrize("kw", [dict(model="gpt-9"), dict(arrivals="lumpy"),
                                dict(scenario="no-such-scenario")],
                         ids=["model", "arrivals", "scenario"])
def test_unknown_names_are_refused_with_the_reference_message(kw):
    jcfg, tcfg = configs(n_requests=4, **kw)
    errs = []
    for mod, cfg in ((TS, tcfg), (JS, jcfg)):
        with pytest.raises((ValueError, KeyError)) as e:
            mod.run_experiment(cfg)
        errs.append((e.type, _message(e)))
    assert errs[0] == errs[1]


def test_scenario_and_requests_are_refused_together():
    reqs = WorkloadGenerator(seed=0).sample_requests(2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TS.run_experiment(TS.ExperimentConfig(scenario="diurnal"),
                          requests=reqs)


# --------------------------------------------------------------------------- #
# SimExecutor
# --------------------------------------------------------------------------- #


def _drive_executor(mod, job_cls):
    """The same calls on one executor: cold prefills, a chunked window, an
    offload and explicit restore, a lazy swap-in, an evict and recompute
    resume, memory pressure on a small capacity, and the cost hooks.
    Returns every observable result."""
    ex = mod.SimExecutor(mod.PROFILES["lam13"], kv_capacity_tokens=400,
                         node_profiles={1: mod.PROFILES["vic"]})
    rng = np.random.RandomState(0)
    jobs = []
    for i in range(6):
        n = int(rng.randint(20, 160))
        jobs.append(job_cls(job_id=i, prompt="", arrival_time=0.0,
                            prompt_tokens=[3] * int(rng.randint(8, 90)),
                            true_output_len=n,
                            output_tokens=[int(t) for t in
                                           rng.randint(5, 99, size=n)]))
    out = []

    def run(node, batch, window, chunk=None):
        r = ex.execute(node, batch, window, 0.0, prefill_chunk=chunk)
        for j, toks in zip(batch, r.tokens):
            j.generated.extend(toks)
        out.append((r.duration, r.tokens, r.finished,
                    [j.prefilled_tokens for j in batch]))

    run(0, jobs[:3], 50)
    run(0, jobs[:3], 50)
    out.append((ex.preempt_costs(0, jobs[1]), ex.preempt_costs(0, jobs[5])))
    out.append(ex.offload(0, jobs[1]))
    out.append(ex.offload(0, jobs[1]))     # nothing resident any more
    run(0, [jobs[0], jobs[2], jobs[3]], 50)
    out.append(ex.restore(0, jobs[1]))
    out.append(ex.offload(0, jobs[2]))
    run(0, [jobs[1], jobs[2], jobs[4]], 20)  # lazy swap-in of job 2
    ex.evict(0, jobs[0])
    run(0, [jobs[0]], 30)                    # recompute resume
    run(1, [jobs[5], jobs[3]], 16, chunk=32)  # chunked, other node
    run(1, [jobs[5], jobs[3]], 16, chunk=32)
    run(1, [jobs[5], jobs[3]], 16, chunk=32)
    out.append(ex.node_token_cost(2))
    out.append([ex.resident_token_count(n) for n in (0, 1)])
    out.append((ex.capacity(0), ex.free_capacity(0), ex.kv_capacity_tokens,
                ex._capacity_of(1)))
    return out, ex.counters()


def test_sim_executor_matches_reference():
    got, counters = _drive_executor(TS, Job)
    want, jcounters = _drive_executor(JS, JaxJob)
    assert got == want
    assert counters == jcounters
    assert counters["swapouts"] == 2 and counters["swapins"] == 2
    assert counters["recompute_prefill_tokens"] > 0
    assert counters["mem_preemptions"] > 0


def test_sim_executor_homogeneous_capacity_is_the_profiles():
    for name in ("opt6.7", "lam13", "vic"):
        assert TS.SimExecutor(TS.PROFILES[name]).kv_capacity_tokens == \
            JS.SimExecutor(JS.PROFILES[name]).kv_capacity_tokens


# --------------------------------------------------------------------------- #
# QuantileSketch, StreamingSummary, PriorityBuffer, batch_effective
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1])
def test_quantile_sketch_matches_reference(seed):
    rng = np.random.RandomState(seed)
    parts = [rng.lognormal(2.0, 1.5, size=n) for n in (500, 1, 300)]
    parts.append(np.array([1e-7, 5e7]))   # under- and overflow bins
    ts, js = QuantileSketch(), JM.QuantileSketch()
    for p in parts:
        ts.add(p)
        js.add(p)
    qs = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0]
    assert [ts.quantile(q) for q in qs] == [js.quantile(q) for q in qs]
    assert (ts.mean, ts.n, ts.min, ts.max, ts.rel_error) == \
        (js.mean, js.n, js.min, js.max, js.rel_error)
    np.testing.assert_array_equal(ts.counts, js.counts)
    # the relative-error contract: each quantile lies within rel_error of
    # a true q-quantile point of the sample
    x = np.concatenate(parts)
    tol = 1.0 + ts.rel_error
    for q in qs[1:-1]:
        v, rank = ts.quantile(q), q * (x.size - 1)
        assert np.sum(x <= v * tol) >= rank
        assert np.sum(x < v / tol) <= rank + 1
    # merge: two halves equal the whole
    a, b, ja, jb = (QuantileSketch(), QuantileSketch(), JM.QuantileSketch(),
                    JM.QuantileSketch())
    a.add(parts[0]), b.add(parts[2]), ja.add(parts[0]), jb.add(parts[2])
    a.merge(b)
    ja.merge(jb)
    np.testing.assert_array_equal(a.counts, ja.counts)
    assert [a.quantile(q) for q in qs] == [ja.quantile(q) for q in qs]


class _Record:
    """A finished Response's timing surface."""

    def __init__(self, rng, i):
        self.arrival_time = float(i) * 0.5
        self._jct = float(rng.lognormal(1.0, 0.8))
        self.queuing_delay = float(rng.uniform(0, 1))
        self.first_token_time = (None if i % 5 == 0
                                 else self.arrival_time + 0.1 * (i % 7))
        self.n_preemptions = int(i % 3)
        self.pred_mae = None if i % 4 == 0 else float(rng.uniform(1, 9))
        self.pred_bias = None if i % 6 == 0 else float(rng.uniform(0.5, 2))

    def jct(self):
        return self._jct


def test_streaming_summary_merge_matches_reference():
    rng = np.random.RandomState(3)
    recs = [_Record(rng, i) for i in range(90)]
    sums = {}
    for name, mod in (("torch", None), ("jax", JM)):
        cls = StreamingSummary if mod is None else mod.StreamingSummary
        a, b, whole = cls(slo_target=4.0), cls(slo_target=4.0), cls(4.0)
        for k, r in enumerate(recs):
            (a if k % 3 else b).add_response(r)
            whole.add_response(r)
        jct = np.array([r.jct() for r in recs[:10]])
        c = cls()
        c.add_batch(jct, np.ones(10), np.arange(10.0),
                    np.where(np.arange(10) % 2, 0.3, np.nan), np.ones(10))
        a.merge(b)
        sums[name] = (a.summarize(), whole.summarize(), c.summarize(),
                      cls().summarize(), cls(slo_target=1.0).summarize())
    assert sums["torch"] == sums["jax"]
    merged, whole = sums["torch"][:2]
    assert merged["n"] == whole["n"] == 90
    assert merged["jct_p99"] == whole["jct_p99"]


def test_priority_buffer_matches_reference():
    rng = np.random.RandomState(4)
    bufs = PriorityBuffer(), JSched.PriorityBuffer()
    popped = [[], []]
    for step in range(60):
        node = int(rng.randint(0, 3))
        if rng.rand() < 0.6:
            prio = float(rng.randint(0, 5))   # ties pop in push order
            for b in bufs:
                b.push(node, prio, step)
        else:
            k = int(rng.randint(1, 4))
            for out, b in zip(popped, bufs):
                out.append((node, b.pop_batch(node, k),
                            [b.depth(n) for n in range(3)]))
    assert popped[0] == popped[1]


def test_batch_effective_matches_reference():
    sides = ((SchedulerConfig, Job, TP.OraclePredictor, make_policy,
              batch_effective),
             (JSched.SchedulerConfig, JaxJob, JP.OraclePredictor,
              JSched.make_policy, JSched.batch_effective))
    for pol in ("fcfs", "isrtf", "mlfq"):
        for aging in (0.0, 0.1):
            effs = []
            for sched, job_cls, oracle, make, batch_eff in sides:
                policy = make(sched(policy=pol, aging_rate=aging), oracle())
                jobs = []
                for i in range(5):
                    j = job_cls(job_id=i, prompt="", prompt_tokens=[1] * 4,
                                arrival_time=0.1 * i,
                                true_output_len=40 + 7 * i,
                                priority_class=i % 2)
                    j.generated = [1] * (3 * i)
                    j.last_enqueue_time = 0.2 * i
                    jobs.append(j)
                effs.append(batch_eff(policy, jobs, 2.0))
            assert effs[0] == effs[1], (pol, aging)


# --------------------------------------------------------------------------- #
# predictor="bge": the port's BGE predictor ranks the pool
# --------------------------------------------------------------------------- #


def _bge_pair(seed=0):
    shape = TINY
    jcfg = JP.PredictorConfig(
        encoder=JE.EncoderArchConfig(**shape["encoder"]),
        **{k: v for k, v in shape.items() if k != "encoder"})
    tcfg = TP.PredictorConfig(
        encoder=TE.EncoderArchConfig(**shape["encoder"]),
        **{k: v for k, v in shape.items() if k != "encoder"})
    jpred = JP.BGEPredictor(jcfg, seed=seed)
    tpred = TP.BGEPredictor(tcfg, seed=seed, device="cpu")
    tpred.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpred.params), "cpu")
    return jpred, tpred


def _record(pred):
    """Log each dispatch (pool ids, predictions) and every ``observe`` call
    (the scheduling trace: finishes observe 0) on ``pred``."""
    dispatches, trace = [], []
    predict_jobs = pred.predict_jobs

    def recorded_predict(jobs):
        out = np.asarray(predict_jobs(jobs), np.float64)
        dispatches.append(([j.job_id for j in jobs], out))
        return out

    def recorded_observe(job, remaining):
        trace.append((job.job_id, remaining))

    pred.predict_jobs = recorded_predict
    pred.observe = recorded_observe
    return dispatches, trace


def test_bge_ranked_run_matches_reference():
    """ISRTF ranked by the same tiny BGE predictor in both packages (seed
    0, fixed before the run): every dispatch scores the same pool within
    ``BGE_RTOL``, the scheduling trace (each window's observed remaining,
    finishes included) is identical, and so is the summary."""
    jpred, tpred = _bge_pair(seed=0)
    jlog, tlog = _record(jpred), _record(tpred)
    jcfg, tcfg = configs(predictor="bge", n_requests=24, batch_size=4,
                         rps_multiple=1.5, seed=7)
    want = JS.run_experiment(jcfg, bge=jpred)
    got = TS.run_experiment(tcfg, bge=tpred)
    (jd, jtrace), (td, ttrace) = jlog, tlog
    assert len(td) == len(jd) > 10
    for (ids, p), (jids, jp) in zip(td, jd):
        assert ids == jids
        np.testing.assert_allclose(p, jp, rtol=BGE_RTOL)
    assert ttrace == jtrace
    # the clock replays the same trace exactly; only the prediction-error
    # statistics carry the predictions' own difference
    approx = ("pred_mae_mean", "pred_bias_gmean")
    for k in approx:
        assert got.pop(k) == pytest.approx(want.pop(k), rel=BGE_RTOL)
    assert got == want
    assert got["n_finished"] == 24


def test_bge_runner_keeps_the_callers_predictor():
    """The runner ranks with the very object it was given: no copy, no
    move, no CPU stand-in built in its place."""
    from repro_torch.training.tree import leaves

    _, tpred = _bge_pair(seed=1)
    seen = []
    predict_jobs = tpred.predict_jobs

    def spy(jobs):
        seen.append(len(jobs))
        return predict_jobs(jobs)

    tpred.predict_jobs = spy
    params = tpred.params
    where = [(t.device, t.data_ptr()) for t in leaves(params)]
    TS.run_experiment(TS.ExperimentConfig(predictor="bge", n_requests=8,
                                          seed=2), bge=tpred)
    assert seen
    assert tpred.params is params
    assert [(t.device, t.data_ptr()) for t in leaves(params)] == where
    with pytest.raises(ValueError, match="pass a trained BGEPredictor"):
        TS.run_experiment(TS.ExperimentConfig(predictor="bge",
                                              n_requests=2))


def test_experiment_config_defaults_match_reference():
    t = dataclasses.asdict(TS.ExperimentConfig())
    j = dataclasses.asdict(JS.ExperimentConfig())
    t.pop("preemption"), j.pop("preemption")
    assert t == j
    assert TS.ARRIVAL_PROCESSES == JS.ARRIVAL_PROCESSES
    assert sorted(TS.__all__) == sorted(JS.__all__ + ["CALIBRATION_MEAN_TOKENS"])
