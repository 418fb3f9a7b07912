"""The port's learning-to-rank pieces against the JAX package, on the CPU:
``kendall_tau`` and ``improvement``, the ranking losses (property tests
over random pools), ``RankingConfig``'s checks, the scheduler's
``rank_by`` ordering and its errors, the calibration wrappers' pass-through
of ``rank_score``, and ``RankedPredictor``'s censoring and seeded pair
harvest.

Tolerances: host arithmetic (``kendall_tau``, ``score_jobs``, the
wrappers, the pair log) is the reference's, so it is compared exactly.
The losses are fp32 on both sides over the same inputs: rtol 1e-5 with an
atol of 1e-6 for losses near 0.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import Job as JaxJob  # noqa: E402
from repro.core import LengthPrediction as JaxLengthPrediction  # noqa: E402
from repro.core import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.core import kendall_tau as jax_kendall_tau  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.core.metrics import improvement as jax_improvement  # noqa: E402
from repro.core.scheduler import RANK_BY as JAX_RANK_BY  # noqa: E402
from repro.core.scheduler import score_jobs as jax_score_jobs  # noqa: E402
from repro.models import objective as JO  # noqa: E402
from repro_torch.core import (RANK_BY, CalibrationConfig,  # noqa: E402
                              ConformalPredictor, EMADebiasedPredictor, Job,
                              JobState, LengthPrediction, LengthPredictor,
                              OraclePredictor, PredictorConfig,
                              RankedPredictor, RankingConfig, SchedulerConfig,
                              BGEPredictor, improvement, kendall_tau,
                              make_policy)
from repro_torch.core.scheduler import score_jobs  # noqa: E402
from repro_torch.models import objective as TO  # noqa: E402
from repro_torch.models.encoder import EncoderArchConfig  # noqa: E402
from repro_torch.training.tree import leaves  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def mk_job(job_cls, jid, true_len=100, generated=0):
    j = job_cls(job_id=jid, prompt=f"p{jid}", prompt_tokens=[1, 2, 3],
                arrival_time=0.0, true_output_len=true_len)
    j.generated = [7] * generated
    return j


# --------------------------------------------------------------------------- #
# kendall_tau, improvement
# --------------------------------------------------------------------------- #


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 6), st.floats(-1e3, 1e3)),
                min_size=0, max_size=30))
def test_kendall_tau_matches_reference(pairs):
    """Ties on either side (small integers) and continuous values."""
    x = [a for a, _ in pairs]
    y = [b for _, b in pairs]
    assert kendall_tau(x, y) == jax_kendall_tau(x, y)
    assert kendall_tau(y, x) == jax_kendall_tau(y, x)


def test_kendall_tau_edges_match_reference():
    assert kendall_tau([1, 1, 2, 2], [1, 2, 3, 4]) == pytest.approx(
        4 / math.sqrt(24))
    for x, y in (([], []), ([5], [3]), ([2, 2, 2], [1, 2, 3])):
        assert kendall_tau(x, y) == jax_kendall_tau(x, y) == 0.0
    with pytest.raises(ValueError, match="length"):
        kendall_tau([1, 2], [1, 2, 3])


def test_improvement_matches_reference():
    base, new = {"jct_mean": 8.0, "p99": 20.0}, {"jct_mean": 6.0, "p99": 25.0}
    for key in ("jct_mean", "p99"):
        assert improvement(base, new, key) == jax_improvement(base, new, key)


# --------------------------------------------------------------------------- #
# ranking losses
# --------------------------------------------------------------------------- #


pools = st.lists(st.tuples(st.floats(-3.0, 3.0), st.integers(1, 2000),
                           st.booleans(), st.integers(0, 3)),
                 min_size=1, max_size=12)


@settings(max_examples=30, deadline=None)
@given(pools, st.sampled_from([0.0, 0.1, 0.5]))
def test_pairwise_loss_matches_reference(pool, margin):
    scores = np.array([p[0] for p in pool], np.float32)
    log_labels = np.log(np.array([p[1] for p in pool], np.float32))
    valid = np.array([p[2] for p in pool])
    steps = np.array([p[3] for p in pool], np.int32)
    pair_mask = steps[:, None] == steps[None, :]
    for pm in (None, pair_mask):
        want = JO.pairwise_margin_loss(
            jnp.asarray(scores), jnp.asarray(log_labels), jnp.asarray(valid),
            margin=margin, pair_mask=None if pm is None else jnp.asarray(pm))
        got = TO.pairwise_margin_loss(
            torch.from_numpy(scores), torch.from_numpy(log_labels),
            torch.from_numpy(valid), margin=margin,
            pair_mask=None if pm is None else torch.from_numpy(pm))
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


@settings(max_examples=30, deadline=None)
@given(pools, st.sampled_from([0.5, 1.0, 2.0]))
def test_listwise_loss_matches_reference(pool, temperature):
    scores = np.array([p[0] for p in pool], np.float32)
    log_labels = np.log(np.array([p[1] for p in pool], np.float32))
    valid = np.array([p[2] for p in pool])
    want = JO.listwise_softmax_loss(jnp.asarray(scores),
                                    jnp.asarray(log_labels),
                                    jnp.asarray(valid),
                                    temperature=temperature)
    got = TO.listwise_softmax_loss(torch.from_numpy(scores),
                                   torch.from_numpy(log_labels),
                                   torch.from_numpy(valid),
                                   temperature=temperature)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


@pytest.mark.parametrize("cfg", [dict(), dict(margin=0.3),
                                 dict(pair_sampling="same_step"),
                                 dict(loss="listwise",
                                      listwise_temperature=2.0)])
def test_ranking_loss_dispatch_matches_reference(cfg):
    rng = np.random.RandomState(0)
    scores = rng.randn(9).astype(np.float32)
    labels = rng.randint(0, 300, size=9).astype(np.float32)  # some < 1
    valid = rng.rand(9) > 0.2
    steps = rng.randint(0, 3, size=9).astype(np.int32)
    for st_ in (None, steps):
        want = JO.ranking_loss(JO.RankingConfig(**cfg), jnp.asarray(scores),
                               jnp.asarray(labels), jnp.asarray(valid),
                               steps=None if st_ is None
                               else jnp.asarray(st_))
        got = TO.ranking_loss(RankingConfig(**cfg), torch.from_numpy(scores),
                              torch.from_numpy(labels),
                              torch.from_numpy(valid),
                              steps=None if st_ is None
                              else torch.from_numpy(st_))
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


@pytest.mark.parametrize("kw", [dict(loss="hinge^2"),
                                dict(pair_sampling="adjacent")])
def test_ranking_config_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        JO.RankingConfig(**kw)
    with pytest.raises(ValueError) as got:
        RankingConfig(**kw)
    assert str(got.value) == str(want.value)
    assert TO.RANKING_LOSSES == JO.RANKING_LOSSES
    assert TO.PAIR_SAMPLING == JO.PAIR_SAMPLING


# --------------------------------------------------------------------------- #
# rank_by
# --------------------------------------------------------------------------- #


class FakeRank(LengthPredictor):
    """Deterministic two-head stand-in: a mean and a rank score per job id
    (``cls`` is the LengthPrediction class of the package under test)."""

    def __init__(self, means, ranks, cls=LengthPrediction):
        self.means, self.ranks, self.cls = means, ranks, cls

    def predict(self, jobs):
        return [self.cls(mean=float(self.means[j.job_id]),
                         rank_score=(None if self.ranks is None
                                     else float(self.ranks[j.job_id])))
                for j in jobs]


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.floats(1.0, 1e4), st.floats(0.2, 2e3)),
                min_size=1, max_size=12),
       st.sampled_from(RANK_BY))
def test_rank_by_scores_match_reference(pool, rank_by):
    """Whatever orders the pool, the raw priorities, ``priority`` and
    ``expected_remaining`` (always the mean) equal the reference's."""
    assert RANK_BY == JAX_RANK_BY
    means = {i: m for i, (m, _) in enumerate(pool)}
    ranks = {i: r for i, (_, r) in enumerate(pool)}
    out = []
    for job_cls, cfg_cls, policy, lp, score in (
            (Job, SchedulerConfig, make_policy, LengthPrediction, score_jobs),
            (JaxJob, JaxSchedulerConfig, jax_make_policy,
             JaxLengthPrediction, jax_score_jobs)):
        jobs = [mk_job(job_cls, i) for i in range(len(pool))]
        pol = policy(cfg_cls(policy="isrtf", rank_by=rank_by),
                     FakeRank(means, ranks, lp))
        raw = score(pol, jobs, now=0.0)
        out.append((raw, [j.priority for j in jobs],
                    [j.expected_remaining for j in jobs],
                    [j.pred_trace for j in jobs]))
    assert out[0] == out[1]
    assert out[0][0] == [ranks[i] if rank_by == "rank_score" else means[i]
                         for i in range(len(pool))]


@pytest.mark.parametrize("kw,pred", [
    (dict(rank_by="nope"), "oracle"),
    (dict(rank_by="rank_score", risk_quantile=0.9), "oracle"),
    (dict(rank_by="rank_score"), "none"),
])
def test_rank_by_errors_match_reference(kw, pred):
    def outcome(cfg_cls, policy, oracle):
        try:
            policy(cfg_cls(policy="isrtf", **kw),
                   None if pred == "none" else oracle)
        except ValueError as e:
            return str(e)
        return "accepted"

    from repro.core import OraclePredictor as JaxOracle
    got = outcome(SchedulerConfig, make_policy, OraclePredictor())
    assert got == outcome(JaxSchedulerConfig, jax_make_policy, JaxOracle())
    assert got != "accepted"


def test_rank_score_without_a_ranked_predictor_is_loud():
    pol = make_policy(SchedulerConfig(policy="isrtf", rank_by="rank_score"),
                      OraclePredictor())
    with pytest.raises(ValueError, match="two-head ranked"):
        score_jobs(pol, [mk_job(Job, 0)], now=0.0)


@pytest.mark.parametrize("wrapper", [EMADebiasedPredictor,
                                     ConformalPredictor])
def test_calibration_wrappers_pass_rank_scores_through(wrapper):
    w = wrapper(FakeRank({0: 10.0, 1: 20.0}, {0: 7.5, 1: 2.5}),
                CalibrationConfig(debias=True, conformal=True,
                                  min_samples=1, by_step=False))
    for _ in range(3):  # warm the wrapper with biased finishes
        jobs = [mk_job(Job, i, true_len=40) for i in range(2)]
        w.predict(jobs)
        for j in jobs:
            j.generated = [7] * 40
            j.state = JobState.FINISHED
            w.observe(j, 0.0)
    preds = w.predict([mk_job(Job, 0), mk_job(Job, 1)])
    assert [p.rank_score for p in preds] == [7.5, 2.5]
    assert preds[0].mean != 10.0 or preds[0].quantiles


# --------------------------------------------------------------------------- #
# RankedPredictor: censoring and the seeded harvest
# --------------------------------------------------------------------------- #


def two_head(seed=0):
    return BGEPredictor(PredictorConfig(
        encoder=EncoderArchConfig(d_model=16, n_heads=2, n_layers=1,
                                  d_ff=32, max_len=32),
        n_fc_layers=2, fc_hidden=16, max_len=32,
        ranking=RankingConfig()), seed=seed, device="cpu")


@pytest.mark.parametrize("state", [JobState.CANCELLED, JobState.EXPIRED])
def test_censored_jobs_never_form_pairs(state):
    rp = RankedPredictor(two_head(), pairs_per_update=1, update_every=1)
    for i in range(6):
        j = mk_job(Job, i, true_len=40)
        rp.predict([j])
        j.generated = [7] * (10 + i)
        j.state = state
        rp.observe(j, 0.0)
    assert (rp.n_observed, rp.pair_log, rp.n_updates) == (0, [], 0)
    assert not rp._pending and not rp._records


@settings(max_examples=4, deadline=None)
@given(st.lists(st.integers(5, 60), min_size=10, max_size=14),
       st.integers(0, 100))
def test_pair_harvest_is_a_function_of_order_and_seed(lens, seed):
    """Two identically seeded instances fed the same jobs agree bit for
    bit; the encoder never moves, the heads are reassigned, not
    mutated."""
    def run_one():
        base = two_head(seed=1)
        snap = base.params
        snap_head = [p.clone() for p in leaves(snap["head"])]
        rp = RankedPredictor(base, seed=seed, window=32,
                             pairs_per_update=2, update_every=4)
        for i, n in enumerate(lens):
            j = mk_job(Job, i, true_len=n)
            rp.predict([j])
            j.generated = [7] * n
            j.state = JobState.FINISHED
            rp.observe(j, 0.0)
        assert base.params["encoder"] is snap["encoder"]
        assert all(torch.equal(a, b)
                   for a, b in zip(leaves(snap["head"]), snap_head))
        return rp

    a, b = run_one(), run_one()
    assert a.pair_log == b.pair_log and a.n_updates > 0
    assert all(torch.equal(x, y) for x, y in zip(leaves(a.base.params),
                                                 leaves(b.base.params)))
