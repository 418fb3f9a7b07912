"""The port's BGE length predictor against the JAX package, on the CPU.

Same parameters (the JAX init, converted by ``repro_torch.bridge``) and the
same inputs: ``encode`` (CLS and mean pooling, with padded rows and ids
past the vocabulary), ``predict`` (one head and two), the shape-bucketed
dispatch and trace counts, the calibration wrappers, ``RankedPredictor``'s
online updates, and one ``ElisServer`` run of the reduced qwen2-1.5b
ranked by the converted predictor.

Tolerances: both sides compute in fp32 from the same parameters, so they
differ only by summation order.  Encoder outputs are O(1) after the final
LayerNorm: ``ENC_TOL`` (atol 2e-5, rtol 2e-5) is ~100 fp32 ulps.
Predictions are exp of a head output: ``PRED_RTOL`` 2e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import predictor as JP  # noqa: E402
from repro.core import ElisServer as JaxServer  # noqa: E402
from repro.core import FrontendConfig as JaxFrontendConfig  # noqa: E402
from repro.core import Job as JaxJob  # noqa: E402
from repro.core import JobState as JaxJobState  # noqa: E402
from repro.core import PreemptionConfig as JaxPreemptionConfig  # noqa: E402
from repro.core import Request as JaxRequest  # noqa: E402
from repro.core import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.data import make_predictor_dataset as jax_dataset  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import EngineExecutor as JaxExecutor  # noqa: E402
from repro.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.models import encoder as JE  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.objective import RankingConfig as JaxRankingConfig  # noqa: E402,E501
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import predictor as TP  # noqa: E402
from repro_torch.core import (ElisServer, FrontendConfig, Job,  # noqa: E402
                              JobState, PreemptionConfig, Request,
                              SchedulerConfig)
from repro_torch.data import make_predictor_dataset  # noqa: E402
from repro_torch.engine import (EngineConfig, EngineExecutor,  # noqa: E402
                                InferenceEngine)
from repro_torch.models import encoder as TE  # noqa: E402
from repro_torch.models.objective import RankingConfig  # noqa: E402
from repro_torch.training.tree import leaves  # noqa: E402

ENC_TOL = dict(atol=2e-5, rtol=2e-5)
PRED_RTOL = 2e-5

#: the reference tests' tiny shapes (tests/test_ranking.py,
#: tests/test_predictor.py)
TINY = dict(encoder=dict(d_model=16, n_heads=2, n_layers=1, d_ff=32,
                         max_len=32), n_fc_layers=2, fc_hidden=16, max_len=32)
SMALL = dict(encoder=dict(d_model=64, n_heads=2, n_layers=2, d_ff=128,
                          max_len=128), n_fc_layers=8, fc_hidden=128,
             max_len=128)


def pair(shape=TINY, ranking=False, seed=0, **kw):
    """A JAX BGEPredictor and the port's, holding the same parameters."""
    jcfg = JP.PredictorConfig(
        encoder=JE.EncoderArchConfig(**shape["encoder"]),
        **{k: v for k, v in shape.items() if k != "encoder"},
        ranking=JaxRankingConfig(**kw) if ranking else None)
    tcfg = TP.PredictorConfig(
        encoder=TE.EncoderArchConfig(**shape["encoder"]),
        **{k: v for k, v in shape.items() if k != "encoder"},
        ranking=RankingConfig(**kw) if ranking else None)
    jpred = JP.BGEPredictor(jcfg, seed=seed)
    tpred = TP.BGEPredictor(tcfg, seed=seed, device="cpu")
    tpred.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpred.params), "cpu")
    return jpred, tpred


def jobs_for(job_cls, specs):
    """Jobs from (job_id, prompt_tokens, generated, true_len) specs."""
    out = []
    for jid, prompt, gen, true_len in specs:
        j = job_cls(job_id=jid, prompt=f"p{jid}", prompt_tokens=list(prompt),
                    arrival_time=0.0, true_output_len=true_len)
        j.generated = list(gen)
        out.append(j)
    return out


def random_specs(seed, n, vocab=9000):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(8, vocab, size=rng.randint(1, 40)).tolist(),
             rng.randint(8, vocab, size=rng.randint(0, 30)).tolist(),
             int(rng.randint(5, 120))) for i in range(n)]


# --------------------------------------------------------------------------- #
# encode, predict
# --------------------------------------------------------------------------- #


def test_encoder_init_layout_matches_reference():
    """The port's encoder tree has the reference's leaves, in JAX's
    flattening order, with the reference's shapes; ``BGE_BASE`` is the
    reference's (bge-base-en-v1.5: ~108.8 M encoder parameters)."""
    small = dict(vocab_size=64, d_model=24, n_heads=2, n_layers=3, d_ff=40,
                 max_len=16)
    tp = TE.init_encoder(torch.Generator().manual_seed(0),
                         TE.EncoderArchConfig(**small))
    jsmall = JE.init_encoder(jax.random.PRNGKey(0),
                             JE.EncoderArchConfig(**small))
    assert [tuple(x.shape) for x in leaves(tp)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jsmall)]
    assert TE.BGE_BASE == TE.EncoderArchConfig(**vars(JE.BGE_BASE))
    full = jax.eval_shape(
        lambda: JE.init_encoder(jax.random.PRNGKey(0), JE.BGE_BASE))
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(full))
    assert 108e6 < n < 110e6


@pytest.mark.parametrize("shape", [TINY, SMALL], ids=["tiny", "small"])
def test_encode_matches_reference(shape):
    """CLS and mean pooling over a batch with ragged masks, a padded row
    (mask all False) and ids past the vocabulary (clamped to its last
    row, as JAX's gather does)."""
    jpred, tpred = pair(shape)
    cfg = shape["encoder"]
    rng = np.random.RandomState(1)
    b, s = 5, cfg["max_len"]
    tokens = rng.randint(0, 8192, size=(b, s)).astype(np.int32)
    tokens[1, :4] = [8191, 8192, 20000, 151935]  # at and past the vocab
    lens = [s, 4, 1, s // 2, 0]                  # the last row is padding
    mask = np.arange(s)[None, :] < np.array(lens)[:, None]
    jcls, jmean = JE.encode(jpred.params["encoder"], jpred.cfg.encoder,
                            jnp.asarray(tokens), jnp.asarray(mask))
    tcls, tmean = TE.encode(tpred.params["encoder"], tpred.cfg.encoder,
                            torch.from_numpy(tokens), torch.from_numpy(mask))
    assert torch.isfinite(tcls).all() and torch.isfinite(tmean).all()
    np.testing.assert_allclose(tcls.numpy(), np.asarray(jcls), **ENC_TOL)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), **ENC_TOL)


@pytest.mark.parametrize("ranking", [False, True], ids=["one-head",
                                                         "two-head"])
def test_predict_matches_reference(ranking):
    """``predict`` over a pool of jobs (ragged prompts, generated ids past
    the vocabulary): means and rank scores."""
    jpred, tpred = pair(SMALL, ranking=ranking)
    specs = random_specs(2, 6, vocab=151936)
    want = jpred.predict(jobs_for(JaxJob, specs))
    got = tpred.predict(jobs_for(Job, specs))
    np.testing.assert_allclose([p.mean for p in got],
                               [p.mean for p in want], rtol=PRED_RTOL)
    if ranking:
        np.testing.assert_allclose([p.rank_score for p in got],
                                   [p.rank_score for p in want],
                                   rtol=PRED_RTOL)
    else:
        assert all(p.rank_score is None for p in got)


def test_padding_is_inert():
    """Each job predicted alone gives its value in the pool: the batch
    bucket's padded rows and the sequence bucket's padding change
    nothing."""
    _, tpred = pair(SMALL, ranking=True)
    jobs = jobs_for(Job, random_specs(3, 5))
    pool = tpred.predict(jobs)
    for j, p in zip(jobs, pool):
        [alone] = tpred.predict([j])
        np.testing.assert_allclose([alone.mean, alone.rank_score],
                                   [p.mean, p.rank_score], rtol=PRED_RTOL)


def test_dispatch_and_trace_counts_match_reference():
    """``num_dispatches`` and ``num_traces`` through growing pools,
    ``evaluate``, ``fit`` (which resets the trace count) and predictions
    after it."""
    jpred, tpred = pair()
    counts = lambda p: (p.num_traces, p.num_dispatches)
    tr, _, te = make_predictor_dataset(40, seed=0, max_len=32, max_steps=2)
    jtr, _, jte = jax_dataset(40, seed=0, max_len=32, max_steps=2)
    for n in (1, 2, 3, 5, 2, 9, 1):
        specs = random_specs(n, n)
        jpred.predict(jobs_for(JaxJob, specs))
        tpred.predict(jobs_for(Job, specs))
        assert counts(tpred) == counts(jpred)
    jpred.evaluate(jte)
    tpred.evaluate(te)
    assert counts(tpred) == counts(jpred)
    jpred.fit(jtr, num_steps=2, batch_size=8)
    tpred.fit(tr, num_steps=2, batch_size=8)
    assert counts(tpred) == counts(jpred)
    for n in (4, 7):
        specs = random_specs(n, n)
        jpred.predict(jobs_for(JaxJob, specs))
        tpred.predict(jobs_for(Job, specs))
        assert counts(tpred) == counts(jpred)
    from repro.data.dataset import n_shape_buckets
    assert tpred.num_traces <= n_shape_buckets(9, 32)


def test_predictor_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would serve")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TP.BGEPredictor(TP.PredictorConfig(
            encoder=TE.EncoderArchConfig(d_model=16, n_heads=2, n_layers=1,
                                         d_ff=32, max_len=32)))


# --------------------------------------------------------------------------- #
# calibration wrappers and RankedPredictor
# --------------------------------------------------------------------------- #


def _drive(pred, job_cls, state_cls, specs, windows=3):
    """Predict the whole pool each window while every job generates 10
    tokens, then finish the even jobs and cancel the odd ones; returns the
    predictions (mean, std, quantiles, rank_score) of every window."""
    jobs = jobs_for(job_cls, specs)
    out = []
    for w in range(windows):
        preds = pred.predict(jobs)
        out.append([(p.mean, p.std, p.quantiles, p.rank_score)
                    for p in preds])
        for j in jobs:
            j.generated = j.generated + [9] * 10
    for j in jobs:
        j.state = (state_cls.FINISHED if j.job_id % 2 == 0
                   else state_cls.CANCELLED)
        pred.observe(j, 0.0)
    out.append([(p.mean, p.std, p.quantiles, p.rank_score)
                for p in pred.predict(jobs)])
    return out


def _flat(windows):
    vals = []
    for w in windows:
        for mean, std, lad, rank in w:
            vals += [mean, std] + [v for _, v in lad]
            vals += [] if rank is None else [rank]
    return np.array(vals)


@pytest.mark.parametrize("calibration", ["ema", "conformal",
                                         "ema+conformal"])
def test_calibration_wrappers_are_identical_over_the_noisy_oracle(
        calibration):
    """Host-side wrappers over the same seeded noisy oracle: every
    prediction identical, bit for bit."""
    cal = TP.CalibrationConfig.from_name(calibration, min_samples=4)
    jcal = JP.CalibrationConfig.from_name(calibration, min_samples=4)
    specs = random_specs(5, 12)
    got = _drive(TP.make_predictor("noisy_oracle", seed=3, calibration=cal),
                 Job, JobState, specs)
    want = _drive(JP.make_predictor("noisy_oracle", seed=3,
                                    calibration=jcal),
                  JaxJob, JaxJobState, specs)
    assert got == want


@pytest.mark.parametrize("kind", ["bge", "ranked"])
def test_calibrated_bge_matches_reference(kind):
    """``ema+conformal`` over the converted BGE predictor (and over its
    ranked adapter): every window's means, spreads, ladders and rank
    scores allclose."""
    jpred, tpred = pair(ranking=kind == "ranked")
    cal = TP.CalibrationConfig.from_name("ema+conformal", min_samples=4)
    jcal = JP.CalibrationConfig.from_name("ema+conformal", min_samples=4)
    specs = random_specs(6, 10)
    got = _drive(TP.make_predictor(kind, bge=tpred, calibration=cal),
                 Job, JobState, specs)
    want = _drive(JP.make_predictor(kind, bge=jpred, calibration=jcal),
                  JaxJob, JaxJobState, specs)
    np.testing.assert_allclose(_flat(got), _flat(want), rtol=PRED_RTOL)


def test_ranked_predictor_online_updates_match_reference():
    """Pairs harvested from finished jobs (cancelled ones censored): the
    same ``pair_log`` and counters, and the heads after the online SGD
    steps allclose (the steps move the heads by ``online_lr`` times an
    fp32 gradient: atol 1e-6)."""
    jpred, tpred = pair(ranking=True, pair_sampling="same_step")
    kw = dict(seed=4, window=32, pairs_per_update=3, update_every=5)
    jr = JP.RankedPredictor(jpred, online_lr=1e-2, **kw)
    tr = TP.RankedPredictor(tpred, online_lr=1e-2, **kw)
    before = [p.numpy().copy() for p in leaves(tpred.params)]
    for rp, job_cls, state_cls in ((jr, JaxJob, JaxJobState),
                                   (tr, Job, JobState)):
        _drive(rp, job_cls, state_cls, random_specs(7, 16))
    assert tr.pair_log == jr.pair_log and tr.pair_log
    assert (tr.n_observed, tr.n_pairs, tr.n_updates) == (
        jr.n_observed, jr.n_pairs, jr.n_updates)
    assert tr.n_updates > 0
    assert tpred.num_traces == jpred.num_traces
    after = leaves(tpred.params)
    want = jax.tree_util.tree_leaves(jpred.params)
    moved = 0
    for a, b, w in zip(after, before, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5)
        moved += int(not np.array_equal(a.numpy(), b))
    assert moved > 0  # the heads did move


def test_registry_matches_reference():
    _, tpred = pair()
    with pytest.raises(ValueError, match="two-head"):
        TP.make_predictor("ranked")
    with pytest.raises(ValueError, match="two-head"):
        TP.RankedPredictor(tpred)
    with pytest.raises(ValueError, match="bge="):
        TP.make_predictor("bge")
    with pytest.raises(ValueError, match="ranked"):
        TP.make_predictor("bogus")
    assert TP.make_predictor("none") is None
    assert sorted(TP.BASE_PREDICTORS) == sorted(JP.BASE_PREDICTORS)
    rp = TP.make_predictor("ranked", bge=pair(ranking=True)[1])
    assert TP.make_predictor("ranked", bge=rp) is rp
    w = TP.wrap_calibration(rp, "ema+conformal")
    assert isinstance(w, TP.ConformalPredictor)
    assert isinstance(w.base, TP.EMADebiasedPredictor)
    assert w.base.base is rp


# --------------------------------------------------------------------------- #
# ElisServer ranked by the converted predictor
# --------------------------------------------------------------------------- #


class Recorder:
    """Delegates to a predictor and records every window's predictions and
    every observation (the completion order)."""

    def __init__(self, inner):
        self.inner = inner
        self.windows = []
        self.observed = []

    def predict(self, jobs):
        preds = self.inner.predict(jobs)
        self.windows.append([(j.job_id, p.mean, p.rank_score)
                             for j, p in zip(jobs, preds)])
        return preds

    def observe(self, job, actual_remaining):
        self.observed.append((job.job_id, job.state.value))
        self.inner.observe(job, actual_remaining)


def _serve(server_cls, cfg_cls, sched_cls, preemption, req_cls, executor,
           predictor, requests):
    server = server_cls(
        cfg_cls(n_nodes=1,
                scheduler=sched_cls(policy="isrtf", window=4, batch_size=2,
                                    rank_by="rank_score"),
                preemption=preemption, observe_in_flight=False),
        predictor, executor)
    for r in requests:
        server.submit(req_cls(**r))
    return {r.request_id: (r.status.value, r.tokens, r.n_preemptions)
            for r in server.drain()}


def test_bge_ranked_server_matches_reference():
    """ISRTF ordered by the ranking head of a converted two-head predictor
    (ranked adapter under ``ema+conformal``, online updates on) over the
    reduced qwen2-1.5b (fp32): the JAX server's completion order and
    token streams, and every window's predictions allclose."""
    jcfg = jax_get_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    for group in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for name in group:
            if name.startswith("w"):
                group[name] = group[name] * np.float32(3.0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    rng = np.random.RandomState(5)
    requests = [dict(prompt=f"r{i}",
                     prompt_tokens=rng.randint(8, 512, size=n).tolist(),
                     arrival_time=0.0, request_id=i,
                     true_output_len=int(rng.randint(4, 14)))
                for i, n in enumerate([7, 30, 12, 3, 18, 25])]
    kw = dict(max_slots=2, max_len=128, max_output=16, eos_id=-1,
              respect_job_max=True)
    jpred, tpred = pair(ranking=True)
    ranked = dict(seed=0, pairs_per_update=2, update_every=2)
    cal = lambda m: m.CalibrationConfig.from_name("ema+conformal",
                                                   min_samples=2)
    trec = Recorder(TP.wrap_calibration(TP.RankedPredictor(tpred, **ranked),
                                        cal(TP)))
    jrec = Recorder(JP.wrap_calibration(JP.RankedPredictor(jpred, **ranked),
                                        cal(JP)))
    got = _serve(ElisServer, FrontendConfig, SchedulerConfig,
                 PreemptionConfig(enabled=True, margin=8.0), Request,
                 EngineExecutor({0: InferenceEngine(cfg, tp, EngineConfig(
                     **kw), device="cpu")}), trec, requests)
    want = _serve(JaxServer, JaxFrontendConfig, JaxSchedulerConfig,
                  JaxPreemptionConfig(enabled=True, margin=8.0,
                                      policy="recompute"), JaxRequest,
                  JaxExecutor({0: JaxEngine(jcfg, jp, JaxEngineConfig(
                      attn_impl="xla", **kw))}), jrec, requests)
    assert got == want
    assert trec.observed == jrec.observed
    assert all(s == "finished" for s, _, _ in got.values())
    assert trec.inner.base.base.n_updates > 0
    assert [[w[0] for w in win] for win in trec.windows] == [
        [w[0] for w in win] for win in jrec.windows]
    np.testing.assert_allclose(
        [v for win in trec.windows for w in win for v in w[1:]],
        [v for win in jrec.windows for w in win for v in w[1:]],
        rtol=PRED_RTOL)
