"""Response-length predictors (paper §3.2–3.3, §4.2): the port of
``repro.core.predictor``.

Every predictor returns typed :class:`LengthPrediction` results (point
estimate, spread, quantile ladder) from ONE batched entry point::

    predictions = predictor.predict(pool)      # list[LengthPrediction]

and accepts online feedback from the serving loop::

    predictor.observe(job, actual_remaining)   # every window / finish

Base predictors:

* :class:`BGEPredictor` — the paper's model: a BGE-style encoder + 8 fully
  connected layers (hidden 1024, ReLU) regressing the *remaining* output
  length from ``[CLS] prompt [SEP] partial-output``, in PyTorch on the card
  (or on the CPU when asked).  ``fit`` trains it with the port's AdamW and
  estimates the log-space residual spread, so quantiles are available out
  of the box.
* :class:`OraclePredictor` — ground-truth remaining length.
* :class:`NoisyOraclePredictor` — truth corrupted by step-dependent
  lognormal noise (paper Fig. 2(b)), with the analytic posterior ladder.

Calibration wrappers (compose over any base via :func:`make_predictor`):
:class:`EMADebiasedPredictor` (EMA multiplicative debiasing, per step
bucket) and :class:`ConformalPredictor` (split-conformal quantiles from a
rolling residual window).  Both are host-side copies of the reference.

Learning-to-rank: ``PredictorConfig(ranking=RankingConfig(...))`` grows a
sibling ranking head on the shared trunk, trained jointly; its score lands
on :attr:`LengthPrediction.rank_score`.  :class:`RankedPredictor` is the
serving adapter: one fused dispatch fills both heads, and ``observe()``
turns completed jobs into seeded online SGD steps of the heads.

The scheduler's hot path stays a single *shape-bucketed* dispatch per
scheduling window (batch padded to power-of-two buckets, sequence to the
``seq_bucket`` ladder); ``BGEPredictor.num_traces`` counts the shapes and
``num_dispatches`` the dispatches.
"""
from __future__ import annotations

import math
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace
from typing import (
    Deque,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from repro_torch.core.job import TERMINAL_STATES, Job, JobState
from repro_torch.core.metrics import kendall_tau
from repro_torch.data.dataset import (
    WINDOW,
    StepSample,
    batch_bucket,
    batch_iterator,
    clip_step_input,
    seq_bucket,
)
from repro_torch.data.tokenizer import PAD_ID
from repro_torch.device import resolve_device
from repro_torch.models import encoder as E
from repro_torch.models.layers import dense_init
from repro_torch.models.objective import RankingConfig, ranking_loss
from repro_torch.training import AdamWConfig, train
from repro_torch.training.loop import to_device
from repro_torch.training.tree import leaves, tree_map, unflatten


class Predictor(Protocol):
    """Deprecated scalar protocol (pre-LengthPredictor).  New code should
    type against :class:`LengthPredictor` and call ``predict``/``observe``;
    these two methods remain only so old annotations keep resolving."""

    def init(self, job: Job) -> float: ...
    def iter(self, job: Job) -> float: ...


# --------------------------------------------------------------------------- #
# LengthPrediction — the typed result
# --------------------------------------------------------------------------- #


#: quantile ladder every distribution-aware predictor materialises; the
#: scheduler interpolates between rungs for other risk levels
QUANTILE_GRID: Tuple[float, ...] = (0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99)


def _norm_ppf(q: float) -> float:
    """Standard-normal inverse CDF (Acklam's rational approximation,
    |rel err| < 1.2e-9 — plenty for risk quantiles; avoids a scipy dep)."""
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow = 0.02425
    if q < plow:
        u = math.sqrt(-2.0 * math.log(q))
        return (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u
                + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    if q > 1 - plow:
        u = math.sqrt(-2.0 * math.log(1 - q))
        return -(((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u
                 + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    u = q - 0.5
    r = u * u
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
            + a[5]) * u / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                            + b[4]) * r + 1)


#: z-values for the grid, computed once — ladder construction sits on the
#: scheduling hot path (every scored job, every window)
_Z_GRID: Tuple[float, ...] = tuple(_norm_ppf(q) for q in QUANTILE_GRID)


def _lognormal_ladder(mean: float, mu: float,
                      s: float) -> Tuple[Tuple[float, float], ...]:
    """Quantile ladder of ``mean * LogNormal(mu, s)`` on the grid."""
    return tuple((q, mean * math.exp(mu + s * z))
                 for q, z in zip(QUANTILE_GRID, _Z_GRID))


@dataclass(frozen=True)
class LengthPrediction:
    """One job's predicted remaining length, as a distribution.

    ``mean`` is the point estimate every legacy consumer ranked on (for a
    stochastic predictor it is the *draw*, not the posterior mean — trace
    compatibility with the scalar API is exact).  ``quantiles`` is a sorted
    ``(q, value)`` ladder; :meth:`quantile` interpolates between rungs and
    falls back to a normal approximation from ``std`` (degenerate at the
    mean when ``std == 0``).
    """

    mean: float
    std: float = 0.0
    quantiles: Tuple[Tuple[float, float], ...] = ()
    #: ranking-head score: a token-scale pseudo-length whose ORDER across a
    #: pool is meaningful but whose magnitude is uncalibrated.  The
    #: scheduler orders on it under ``SchedulerConfig.rank_by =
    #: "rank_score"``; ``expected_remaining`` / predicted-work accounting
    #: never read it.  None for single-head predictors.
    rank_score: Optional[float] = None

    def quantile(self, q: float) -> float:
        """The q-th quantile of the predicted remaining length."""
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        lad = self.quantiles
        if lad:
            if q <= lad[0][0]:
                return lad[0][1]
            for (q0, v0), (q1, v1) in zip(lad, lad[1:]):
                if q <= q1:
                    w = (q - q0) / (q1 - q0)
                    return v0 + w * (v1 - v0)
            return lad[-1][1]
        if self.std > 0.0:
            return max(self.mean + _norm_ppf(q) * self.std, 0.0)
        return self.mean


# --------------------------------------------------------------------------- #
# LengthPredictor — the base class
# --------------------------------------------------------------------------- #


class LengthPredictor:
    """Distribution-aware predictor base.

    Subclasses implement EITHER ``predict_jobs(jobs) -> array`` (one batched
    dispatch of point estimates — the BGE path) OR ``_point(job) -> float``
    (per-job point estimate, e.g. the oracles), plus optionally
    ``_prediction(job, mean)`` to attach spread/quantiles.  ``observe`` is a
    no-op here; calibration wrappers override it to consume feedback.

    ``init``/``iter`` are the deprecated scalar shims (Algorithm 1's
    surface): both return ``predict([job])[0].mean``.
    """

    def predict(self, jobs: Sequence[Job]) -> List[LengthPrediction]:
        """Batched prediction for a scheduling pool — ONE dispatch when the
        underlying model supports it.  For stochastic predictors the draw
        order is the pool order (scoring order), which keeps drain-once
        traces bit-identical to the legacy per-job ``init``/``iter`` path."""
        jobs = list(jobs)
        if not jobs:
            return []
        pj = getattr(self, "predict_jobs", None)
        if pj is not None:
            means = [float(m) for m in pj(jobs)]
        else:
            means = [float(self._point(j)) for j in jobs]
        return [self._prediction(j, m) for j, m in zip(jobs, means)]

    def observe(self, job: Job, actual_remaining: float) -> None:
        """Online feedback: ``job`` has ``actual_remaining`` ground-truth
        tokens left *now*.  The serving loop calls this on every window where
        truth is known (trace replay / simulation), on every FINISH
        (``actual_remaining == 0``), and on CANCELLED/EXPIRED terminations
        (whose censored lengths calibrators must discard).  No-op for raw
        predictors."""

    # -- helpers subclasses provide ------------------------------------- #
    def _point(self, job: Job) -> float:  # pragma: no cover - abstract-ish
        raise NotImplementedError(
            f"{type(self).__name__} must implement _point or predict_jobs")

    def _prediction(self, job: Job, mean: float) -> LengthPrediction:
        return LengthPrediction(mean=mean)

    # -- deprecated scalar shims ---------------------------------------- #
    def init(self, job: Job) -> float:
        """Deprecated: use ``predict([job])[0]``."""
        return self.predict([job])[0].mean

    def iter(self, job: Job) -> float:
        """Deprecated: use ``predict([job])[0]``."""
        return self.predict([job])[0].mean


def predict_lengths(pred, jobs: Sequence[Job]) -> List[LengthPrediction]:
    """Adapt any predictor — new or legacy — to ``list[LengthPrediction]``.

    The scheduler's single entry point: a :class:`LengthPredictor` answers
    through its batched ``predict``; a legacy object with only
    ``predict_jobs`` or ``init``/``iter`` is wrapped into degenerate
    point-mass predictions (same call order as the old scoring loop)."""
    jobs = list(jobs)
    if not jobs:
        return []
    p = getattr(pred, "predict", None)
    if p is not None:
        return list(p(jobs))
    pj = getattr(pred, "predict_jobs", None)
    if pj is not None:
        return [LengthPrediction(mean=float(m)) for m in pj(jobs)]
    out = []
    for j in jobs:
        v = pred.init(j) if j.priority is None else pred.iter(j)
        out.append(LengthPrediction(mean=float(v)))
    return out


# --------------------------------------------------------------------------- #
# Oracle predictors
# --------------------------------------------------------------------------- #


class OraclePredictor(LengthPredictor):
    """Ground-truth remaining length (the SJF 'ideal' bound)."""

    def _point(self, job: Job) -> float:
        return float(job.true_remaining)


@dataclass
class NoisyOraclePredictor(LengthPredictor):
    """truth * lognormal(0, sigma_k) * bias;  sigma_k = sigma0 * decay^k.

    Defaults calibrated against our trained BGE predictor's per-step relative
    error (see benchmarks/fig2_iterative_mae.py): step-0 MAE/mean ≈ 0.45
    falling toward ≈ 0.25 by step 4 — matching the paper's Fig. 2(b) shape.

    ``bias`` injects a systematic multiplicative mis-calibration (< 1 =
    underestimates, the head-of-line-blocking direction) for the calibration
    benchmarks; the default 1.0 is bit-exact with the unbiased predictor.
    The quantile ladder is the analytic posterior of the truth given the
    draw (lognormal), so risk-aware consumers cost no extra RNG draws and
    the draw sequence — one per job, in scoring order — is untouched.
    """

    # calibrated to the trained BGE predictor's relative error per step
    # (benchmarks/fig2_iterative_mae.py): ~0.5 at step 0 -> ~0.3 floor
    sigma0: float = 0.50
    decay: float = 0.90
    sigma_floor: float = 0.30
    seed: int = 0
    #: systematic multiplicative bias applied to every prediction
    bias: float = 1.0
    _rng: np.random.RandomState = field(default=None, repr=False)

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)

    def _sigma(self, step: int) -> float:
        return max(self.sigma0 * self.decay ** step, self.sigma_floor)

    def _point(self, job: Job) -> float:
        step = job.tokens_generated // WINDOW
        s = self._sigma(step)
        noise = self._rng.lognormal(mean=-0.5 * s * s, sigma=s)
        return max(float(job.true_remaining) * noise * self.bias, 1.0)

    def _prediction(self, job: Job, mean: float) -> LengthPrediction:
        # posterior of truth given the draw m = truth * noise:
        # truth = m / noise ~ m * LogNormal(s^2/2, s), so the q-quantile is
        # m * exp(s^2/2 + s * z_q) and the std carries the full
        # exp(mu + s^2/2) = exp(s^2) factor
        s = self._sigma(job.tokens_generated // WINDOW)
        ladder = _lognormal_ladder(mean, 0.5 * s * s, s)
        std = mean * math.exp(s * s) * math.sqrt(max(math.expm1(s * s), 0.0))
        return LengthPrediction(mean=mean, std=std, quantiles=ladder)


# --------------------------------------------------------------------------- #
# BGE predictor (the paper's model)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class PredictorConfig:
    # default_factory, not a shared class-level instance: every
    # PredictorConfig() would otherwise alias one encoder config object
    encoder: E.EncoderArchConfig = field(default_factory=E.EncoderArchConfig)
    n_fc_layers: int = 8           # paper: eight FC layers
    fc_hidden: int = 1024          # paper: hidden dim 1024
    max_len: int = 256
    freeze_encoder: bool = False   # paper freezes pretrained BGE; ours trains
    lr: float = 1e-4               # paper: 1e-4
    predict_log: bool = True       # regress log(remaining) (skew-friendly)
    #: presence enables the sibling learning-to-rank head on the shared
    #: trunk (trained jointly; see repro_torch.models.objective
    #: .RankingConfig).  None keeps the parameter tree identical to the
    #: single-head predictor.
    ranking: Optional[RankingConfig] = None


def init_head(gen: torch.Generator, in_dim: int, hidden: int, n_layers: int,
              init_log_len: float = 4.8) -> Dict:
    """8-FC regression head, drawn from ``gen`` on its device.  The final
    bias starts at log(median length) (~e^4.8 ≈ 120 tokens) so the
    log-space prediction begins at a sane prior and gradients flow from
    step 0 (a zero-init bias puts every prediction at the clip boundary,
    where the gradient dies)."""
    layers = []
    d = in_dim
    for _ in range(n_layers - 1):
        layers.append({"w": dense_init(gen, d, hidden),
                       "b": torch.zeros((hidden,), device=gen.device)})
        d = hidden
    layers.append({"w": dense_init(gen, d, 1),
                   "b": torch.full((1,), init_log_len, device=gen.device)})
    return {"layers": layers}


def apply_head(head: Dict, x: torch.Tensor) -> torch.Tensor:
    for lp in head["layers"][:-1]:
        x = torch.relu(x @ lp["w"] + lp["b"])
    last = head["layers"][-1]
    return (x @ last["w"] + last["b"])[..., 0]


def _host(t: torch.Tensor) -> np.ndarray:
    """A device result as a float32 numpy array."""
    return t.float().cpu().numpy()


class BGEPredictor(LengthPredictor):
    """Encoder + FC-head length regressor with iterative refinement.

    Runs on ``device`` (the card unless ``device="cpu"``; it raises
    without a card).  ``fit`` additionally estimates the model's log-space
    residual distribution (mean + spread of ``log(actual / predicted)``)
    on the training samples, which :meth:`_prediction` turns into a
    lognormal quantile ladder — so a freshly trained predictor supports
    risk-aware scoring without any serving-time feedback.  The ``mean``
    stays the raw point estimate (quantiles are only consumed when a risk
    level is set).

    Nothing is compiled: a "trace" (:attr:`num_traces`) is a dispatch shape
    first seen, which is what the reference's jit cache counts.
    """

    def __init__(self, cfg: Optional[PredictorConfig] = None, seed: int = 0,
                 device="cuda"):
        # None-default: a shared PredictorConfig() instance as the default
        # argument would alias one config object across every predictor
        self.cfg = cfg = cfg if cfg is not None else PredictorConfig()
        self.device = resolve_device(device)
        gen = torch.Generator(self.device).manual_seed(seed)
        self.params = {
            "encoder": E.init_encoder(gen, cfg.encoder),
            # paper §4.2: mean-pooled token embeddings feed the FC stack;
            # we concat [CLS; mean] (CLS is what §3.2 probes)
            "head": init_head(gen, 2 * cfg.encoder.d_model, cfg.fc_hidden,
                              cfg.n_fc_layers),
        }
        if cfg.ranking is not None:
            # sibling ranking head on the shared trunk, drawn after the
            # others so the encoder and head stay those of the single-head
            # model at the same seed
            self.params["rank_head"] = init_head(
                gen, 2 * cfg.encoder.d_model, cfg.fc_hidden, cfg.n_fc_layers)
        self._n_traces = 0
        #: (batch, seq) shapes the serving apply has run since ``fit``
        self._apply_shapes: set = set()
        self.num_dispatches = 0
        #: log-space residual stats from ``fit`` (0, 0 = unknown spread)
        self.resid_mu = 0.0
        self.resid_sigma = 0.0
        #: per-iteration-step residual stats (Fig. 2(b): the error profile
        #: is step-dependent — fresh predictions are much noisier than deep
        #: ones, so upper quantiles hedge them harder): step -> (mu, sigma)
        self.resid_by_step: Dict[int, Tuple[float, float]] = {}

    @property
    def num_traces(self) -> int:
        """Dispatch shapes first seen — the reference's compile count.
        The serving apply adds one per new (batch, seq) shape, each direct
        :meth:`loss_fn` call one (as an eager call of the reference's
        does), and :class:`RankedPredictor` one per new online-update
        shape.  ``fit`` resets it, so for a predictor doing serving-path
        inference it stays <= the number of shape buckets no matter how
        the scheduling pool grows.  ``evaluate`` drives its own
        chunked-but-bucketed shapes and adds their traces."""
        return self._n_traces

    # -------------------------------------------------------------- #
    def _apply_fn(self, params, tokens: torch.Tensor, mask: torch.Tensor):
        cls, mean = E.encode(params["encoder"], self.cfg.encoder, tokens,
                             mask)
        feats = torch.cat([cls, mean], dim=-1)
        raw = apply_head(params["head"], feats)
        if self.cfg.predict_log:
            # wide clip: the gradient must not die at init (raw ≈ prior)
            out = torch.exp(torch.clamp(raw, -2.0, 8.0))  # e^8 ≈ 3k tokens
        else:
            out = torch.maximum(raw, torch.ones_like(raw))
        if self.cfg.ranking is None:
            return out
        # ranking head shares the trunk — same dispatch, no extra encoder
        # pass.  exp keeps the score a token-scale pseudo-length, so it
        # composes with the scheduler's banding/aging/debt arithmetic; only
        # its ORDER is trained (magnitudes stay the regression head's job)
        rank_raw = apply_head(params["rank_head"], feats)
        return out, torch.exp(torch.clamp(rank_raw, -2.0, 8.0))

    def _apply(self, params, tokens: np.ndarray, mask: np.ndarray):
        """One inference dispatch of padded numpy inputs on the device,
        with no autograd graph kept; a shape not seen since ``fit`` counts
        as a trace."""
        if tokens.shape not in self._apply_shapes:
            self._apply_shapes.add(tokens.shape)
            self._n_traces += 1
        with torch.inference_mode():
            return self._apply_fn(
                params, torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _run_tokens(self, token_lists: Sequence[Sequence[int]]):
        """Pad to the (batch, seq) bucket and run ONE dispatch.

        Returns ``(raw_output, b)`` where ``raw_output`` is the apply's
        result — a ``(means, rank_scores)`` tuple when the ranking head is
        enabled — and ``b`` the true batch size for slicing padding off."""
        ml = self.cfg.max_len
        b = len(token_lists)
        self.num_dispatches += 1
        longest = max(min(len(t), ml) for t in token_lists)
        bb = batch_bucket(b)
        sl = seq_bucket(longest, ml)
        toks = np.zeros((bb, sl), np.int32)
        mask = np.zeros((bb, sl), bool)
        for i, t in enumerate(token_lists):
            t = list(t)[:sl]
            toks[i, : len(t)] = t
            mask[i, : len(t)] = True
        return self._apply(self.params, toks, mask), b

    def predict_tokens(self, token_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """One batched inference dispatch, shape-bucketed.

        The batch dimension is padded to the next power of two and the
        sequence dimension to the ``seq_bucket`` ladder (capped at
        ``max_len``), so the dispatch runs one shape per (batch, seq)
        bucket instead of one per raw pool shape.  Padding rows are fully
        masked (the encoder's masked attention/pooling make them inert) and
        sliced off before returning."""
        if len(token_lists) == 0:
            return np.zeros((0,))
        out, b = self._run_tokens(token_lists)
        if self.cfg.ranking is not None:
            out = out[0]
        return _host(out)[:b]

    def predict_tokens_ranked(
            self, token_lists: Sequence[Sequence[int]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Both heads from the SAME single dispatch: (means, rank_scores)."""
        if self.cfg.ranking is None:
            raise ValueError(
                "ranking head disabled — construct the predictor with "
                "PredictorConfig(ranking=RankingConfig(...))")
        if len(token_lists) == 0:
            return np.zeros((0,)), np.zeros((0,))
        (m, r), b = self._run_tokens(token_lists)
        return _host(m)[:b], _host(r)[:b]

    # -------------------------------------------------------------- #
    def _job_input(self, job: Job) -> List[int]:
        return clip_step_input(job.prompt_tokens, job.generated,
                               self.cfg.max_len)

    def predict_jobs(self, jobs: Sequence[Job]) -> np.ndarray:
        """Batched point prediction for a whole pool (one encoder call)."""
        if not jobs:
            return np.zeros((0,))
        return self.predict_tokens([self._job_input(j) for j in jobs])

    def predict(self, jobs: Sequence[Job]) -> List[LengthPrediction]:
        jobs = list(jobs)
        if not jobs:
            return []
        if self.cfg.ranking is None:
            return super().predict(jobs)
        # two-head path: one fused dispatch fills both heads, and the
        # ranking score rides on the prediction next to the calibrated mean
        means, ranks = self.predict_tokens_ranked(
            [self._job_input(j) for j in jobs])
        return [replace(self._prediction(j, float(m)), rank_score=float(r))
                for j, m, r in zip(jobs, means, ranks)]

    def _prediction(self, job: Job, mean: float) -> LengthPrediction:
        if self.resid_sigma <= 0.0:
            return LengthPrediction(mean=mean)
        step = job.tokens_generated // WINDOW
        key = min(step, max(self.resid_by_step, default=0))
        mu, s = self.resid_by_step.get(key, (self.resid_mu, self.resid_sigma))
        ladder = _lognormal_ladder(mean, mu, s)
        std = mean * math.exp(mu + 0.5 * s * s) * math.sqrt(
            max(math.expm1(s * s), 0.0))
        return LengthPrediction(mean=mean, std=std, quantiles=ladder)

    # -------------------------------------------------------------- #
    def loss_fn(self, params, batch):
        """(loss, metrics) of ``params`` on a batch of ``tokens``,
        ``mask``, ``labels`` and optionally ``steps`` (numpy arrays or
        tensors).  Each call counts as one trace."""
        self._n_traces += 1
        return self._loss(params, batch)

    def _loss(self, params, batch):
        batch = to_device(batch, self.device)
        out = self._apply_fn(params, batch["tokens"], batch["mask"])
        rank_pred = None
        if self.cfg.ranking is not None:
            pred, rank_pred = out
        else:
            pred = out
        target = batch["labels"]
        if self.cfg.predict_log:
            err = torch.log(pred) - torch.log(torch.clamp(target, min=1.0))
        else:
            err = (pred - target) / 100.0
        # Huber for robustness against the long tail
        huber = torch.where(torch.abs(err) < 1.0, 0.5 * err * err,
                            torch.abs(err) - 0.5)
        mae = torch.mean(torch.abs(pred - target))
        total = torch.mean(huber)
        metrics = {"mae": mae}
        if rank_pred is not None:
            # joint training: rank scores compared in log space (the exact
            # inverse of the head's exp within the clip window), pairs
            # restricted to valid (unpadded) rows
            valid = batch["mask"].any(dim=-1)
            rloss = ranking_loss(self.cfg.ranking, torch.log(rank_pred),
                                 target, valid, steps=batch.get("steps"))
            total = total + self.cfg.ranking.weight * rloss
            metrics["rank_loss"] = rloss
        return total, metrics

    def fit(self, train_samples: List[StepSample], *, num_steps: int = 600,
            batch_size: int = 32, log_fn=None) -> Dict:
        mask = None
        if self.cfg.freeze_encoder:
            mask = {k: tree_map(lambda _: k != "encoder", v)
                    for k, v in self.params.items()}
        it = batch_iterator(train_samples, batch_size, self.cfg.max_len)
        opt = AdamWConfig(lr=self.cfg.lr, warmup_steps=max(num_steps // 20, 1),
                          total_steps=num_steps, weight_decay=0.01)
        self.params, history = train(
            self.params, self.loss_fn, it, opt, num_steps=num_steps,
            trainable_mask=mask, log_every=max(num_steps // 10, 1),
            log_fn=log_fn,
        )
        # fresh shape set and trace count: the residual-estimation chunks
        # below run their own shapes, which then count as seen
        self._apply_shapes = set()
        self._fit_residuals(train_samples)
        self._n_traces = 0
        return history

    def _fit_residuals(self, samples: Sequence[StepSample],
                       cap: int = 512, min_per_step: int = 16) -> None:
        """Estimate the log-space residual distribution log(actual/pred) on
        (a slice of) the training samples — the quantile-ladder prior.

        Both pooled (``resid_mu``/``resid_sigma``) and per iteration step
        (``resid_by_step``, Fig. 2(b)): early-step predictions carry much
        wider residuals than deep ones, so a risk quantile built from the
        per-step spread hedges fresh, uncertain jobs harder than confident
        deep ones — which is what actually re-orders a pool."""
        sub = list(samples[:cap])
        if len(sub) < 8:
            return
        pred = self._predict_samples(sub)
        y = np.array([max(s.remaining, 1) for s in sub], np.float64)
        logr = np.log(y) - np.log(np.maximum(pred, 1e-6))
        self.resid_mu = float(np.mean(logr))
        self.resid_sigma = float(np.std(logr))
        self.resid_by_step = {}
        steps = np.array([s.step for s in sub])
        for k in sorted(set(int(s) for s in steps)):
            r = logr[steps == k]
            if len(r) >= min_per_step:
                self.resid_by_step[k] = (float(np.mean(r)),
                                         float(np.std(r)))

    def _predict_samples(self, samples: Sequence[StepSample],
                         chunk: int = 256, *,
                         want_rank: bool = False) -> np.ndarray:
        """Chunked, bucket-padded inference over pre-built StepSamples.

        Pads PER CHUNK (batch dimension to the power-of-two bucket, sequence
        to the configured ``max_len``) instead of materialising one giant
        padded array for the whole sample list — evaluating a large trace
        set stays O(chunk) memory and runs at most one shape per batch
        bucket.  ``want_rank`` selects the ranking head's scores instead of
        the regression means (two-head predictors only)."""
        if want_rank and self.cfg.ranking is None:
            raise ValueError(
                "ranking head disabled — construct the predictor with "
                "PredictorConfig(ranking=RankingConfig(...))")
        ml = self.cfg.max_len
        preds = []
        for i in range(0, len(samples), chunk):
            part = samples[i: i + chunk]
            bb = batch_bucket(len(part))
            # same pad convention as training's pad_batch (PAD_ID, masked)
            toks = np.full((bb, ml), PAD_ID, np.int32)
            msk = np.zeros((bb, ml), bool)
            for r, s in enumerate(part):
                t = s.tokens[:ml]
                toks[r, : len(t)] = t
                msk[r, : len(t)] = True
            out = self._apply(self.params, toks, msk)
            if self.cfg.ranking is not None:
                out = out[1] if want_rank else out[0]
            preds.append(_host(out)[: len(part)])
        return np.concatenate(preds) if preds else np.zeros((0,))

    # -------------------------------------------------------------- #
    def evaluate(self, samples: List[StepSample]) -> Dict[str, float]:
        """MAE / RMSE / R² — the paper's Table 2 metrics — and Kendall-τ.

        Pads per 256-row chunk (see :meth:`_predict_samples`) rather than
        one ``pad_batch`` over the whole list, so a large sample list never
        materialises one (n, max_len) array, and the chunked shapes stay
        on the batch-bucket ladder so traces are bounded."""
        if not samples:
            return {"mae": float("nan"), "rmse": float("nan"),
                    "r2": float("nan"), "kendall_tau": float("nan")}
        pred = self._predict_samples(samples)
        y = np.array([s.remaining for s in samples], np.float32)
        mae = float(np.mean(np.abs(pred - y)))
        rmse = float(np.sqrt(np.mean((pred - y) ** 2)))
        ss_res = float(np.sum((pred - y) ** 2))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        r2 = 1.0 - ss_res / max(ss_tot, 1e-9)
        return {"mae": mae, "rmse": rmse, "r2": r2,
                "kendall_tau": kendall_tau(pred, y)}

    def evaluate_rank(self, samples: List[StepSample]) -> Dict[str, float]:
        """Kendall-τ of the pool ordering — the metric ISRTF actually needs.

        Scores come from the ranking head when enabled and from the
        regression mean otherwise, so single-head and two-head predictors
        are directly comparable at equal encoder budget."""
        if not samples:
            return {"kendall_tau": float("nan")}
        scores = self._predict_samples(
            samples, want_rank=self.cfg.ranking is not None)
        y = np.array([s.remaining for s in samples], np.float32)
        return {"kendall_tau": kendall_tau(scores, y)}

    def evaluate_per_step(self, samples: List[StepSample],
                          max_step: int = 6) -> Dict[int, float]:
        """MAE bucketed by iteration index — the paper's Fig. 2(b)."""
        out = {}
        for k in range(max_step):
            sub = [s for s in samples if s.step == k]
            if len(sub) >= 5:
                out[k] = self.evaluate(sub)["mae"]
        return out


# --------------------------------------------------------------------------- #
# Calibration wrappers (online feedback consumers)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class CalibrationConfig:
    """How a base predictor is wrapped for serving-time calibration."""

    #: EMA multiplicative debiasing (EMADebiasedPredictor)
    debias: bool = False
    #: EMA weight for the log-bias estimate
    ema_alpha: float = 0.1
    #: distribution-free quantiles from rolling residuals (ConformalPredictor)
    conformal: bool = False
    #: rolling residual-window size (per step bucket when ``by_step``)
    window: int = 256
    #: residuals required before a wrapper's estimate is trusted
    min_samples: int = 16
    #: Mondrian bucketing: estimate per iteration step (Fig. 2(b): the error
    #: profile is step-dependent), falling back to the pooled estimate while
    #: a step's bucket is cold
    by_step: bool = True
    #: steps >= this share one bucket
    max_step_bucket: int = 6

    @classmethod
    def from_name(cls, name: str, **kw) -> "CalibrationConfig":
        """``none | ema | conformal | ema+conformal`` -> config."""
        parts = {p for p in name.replace(" ", "").split("+") if p}
        known = {"none", "ema", "conformal"}
        if not parts or not parts <= known:
            raise ValueError(
                f"unknown calibration {name!r} (combine {sorted(known)})")
        return cls(debias="ema" in parts, conformal="conformal" in parts, **kw)


class CalibratedPredictor(LengthPredictor):
    """Base for calibration wrappers: composes over any base predictor,
    logs every prediction it hands out, and resolves those logs into
    residuals when :meth:`observe` reveals the ground truth.

    A logged entry is ``(tokens_generated_at_prediction, reference_mean)``;
    on an observation with ``actual_remaining`` known *now*, the actual
    remaining length at each logged point is
    ``(tokens_generated_now + actual_remaining) - tokens_at_prediction`` —
    exact both for mid-flight oracle feedback (simulation/replay) and for
    the finish-only feedback a live engine can provide.  CANCELLED/EXPIRED
    jobs are censored (they would have generated more); their logs are
    dropped without touching the estimate, so aborted requests never poison
    the residual window."""

    #: logged-but-unresolved predictions kept per job (oldest dropped)
    MAX_PENDING_PER_JOB = 64
    #: jobs tracked at once (serving cleans up via terminal observes; this
    #: bounds standalone/benchmark usage that never calls observe)
    MAX_PENDING_JOBS = 4096

    def __init__(self, base):
        self.base = base
        self._pending: "OrderedDict[int, List[Tuple[int, float]]]" = \
            OrderedDict()
        #: resolved residuals consumed so far
        self.n_observed = 0

    # -- step bucketing ------------------------------------------------- #
    def _bucket(self, tokens_generated: int) -> int:
        cfg = self.cfg
        if not cfg.by_step:
            return 0
        return min(tokens_generated // WINDOW, cfg.max_step_bucket)

    # -- prediction path ------------------------------------------------ #
    def predict(self, jobs: Sequence[Job]) -> List[LengthPrediction]:
        jobs = list(jobs)
        if not jobs:
            return []
        base_preds = self.base.predict(jobs)
        out = [self._adjust(j, p) for j, p in zip(jobs, base_preds)]
        for j, bp, ap in zip(jobs, base_preds, out):
            self._log(j, self._reference_mean(bp, ap))
        return out

    def _log(self, job: Job, ref_mean: float) -> None:
        entries = self._pending.setdefault(job.job_id, [])
        self._pending.move_to_end(job.job_id)
        entries.append((job.tokens_generated, ref_mean))
        if len(entries) > self.MAX_PENDING_PER_JOB:
            del entries[0]
        while len(self._pending) > self.MAX_PENDING_JOBS:
            self._pending.popitem(last=False)

    # -- feedback path --------------------------------------------------- #
    def observe(self, job: Job, actual_remaining: float) -> None:
        self.base.observe(job, actual_remaining)
        jid = job.job_id
        if job.state in (JobState.CANCELLED, JobState.EXPIRED):
            # censored: the request was aborted, its realised length says
            # nothing about what the model would have generated
            self._pending.pop(jid, None)
            return
        entries = self._pending.get(jid)
        if entries:
            total = job.tokens_generated + max(float(actual_remaining), 0.0)
            for g, ref in entries:
                actual = total - g
                if actual > 0.0 and ref > 0.0:
                    self._update(self._bucket(g), ref, actual)
                    self.n_observed += 1
            entries.clear()
        if job.state in TERMINAL_STATES:
            self._pending.pop(jid, None)

    # -- wrapper-specific hooks ------------------------------------------ #
    def _adjust(self, job: Job,
                pred: LengthPrediction) -> LengthPrediction:
        raise NotImplementedError

    def _reference_mean(self, base_pred: LengthPrediction,
                        adjusted: LengthPrediction) -> float:
        """Which mean the residual is measured against."""
        raise NotImplementedError

    def _update(self, bucket: int, predicted: float, actual: float) -> None:
        raise NotImplementedError


class EMADebiasedPredictor(CalibratedPredictor):
    """Multiplicative-bias correction from online feedback.

    Tracks ``log(predicted / actual)`` of the BASE predictor as an EMA —
    per iteration-step bucket when ``cfg.by_step`` (an undertrained
    regressor's bias is strongly step-dependent: early-step predictions
    regress to the corpus mean) — and divides the estimated bias back out
    of every prediction (mean, std, and quantile ladder all scale).  Under
    a constantly biased base (pred = b * truth) the correction converges to
    1/b, driving the served multiplicative bias to 1."""

    def __init__(self, base, cfg: Optional[CalibrationConfig] = None):
        super().__init__(base)
        self.cfg = cfg if cfg is not None else CalibrationConfig(debias=True)
        n = (self.cfg.max_step_bucket + 1) if self.cfg.by_step else 1
        self._log_bias = [0.0] * n
        self._counts = [0] * n

    def bias(self, bucket: int = 0) -> float:
        """Current multiplicative bias estimate (predicted/actual)."""
        return math.exp(self._log_bias[bucket])

    def _correction(self, bucket: int) -> float:
        if self._counts[bucket] >= self.cfg.min_samples:
            return math.exp(-self._log_bias[bucket])
        # cold bucket: fall back to the pooled estimate across warm buckets
        warm = [(c, lb) for c, lb in zip(self._counts, self._log_bias)
                if c >= self.cfg.min_samples]
        if warm:
            tot = sum(c for c, _ in warm)
            return math.exp(-sum(c * lb for c, lb in warm) / tot)
        return 1.0

    def _adjust(self, job: Job,
                pred: LengthPrediction) -> LengthPrediction:
        f = self._correction(self._bucket(job.tokens_generated))
        if f == 1.0:
            return pred
        # rank_score passes through untouched: it is a pool-relative
        # ordering, not a magnitude, so debiasing must not rescale it
        return LengthPrediction(
            mean=pred.mean * f, std=pred.std * f,
            quantiles=tuple((q, v * f) for q, v in pred.quantiles),
            rank_score=pred.rank_score,
        )

    def _reference_mean(self, base_pred: LengthPrediction,
                        adjusted: LengthPrediction) -> float:
        return base_pred.mean  # the bias being estimated is the base's

    def _update(self, bucket: int, predicted: float, actual: float) -> None:
        x = math.log(max(predicted, 1e-6) / max(actual, 1e-6))
        a = self.cfg.ema_alpha
        if self._counts[bucket] == 0:
            self._log_bias[bucket] = x
        else:
            self._log_bias[bucket] += a * (x - self._log_bias[bucket])
        self._counts[bucket] += 1


class ConformalPredictor(CalibratedPredictor):
    """Distribution-free quantiles from a rolling residual window.

    Keeps the last ``cfg.window`` multiplicative residuals
    ``actual / predicted`` (per step bucket when ``cfg.by_step`` — Mondrian
    conformal, better conditional coverage when the error profile is
    step-dependent) and replaces the base's quantile ladder with

        quantile(q) = mean * Q_q({actual_i / predicted_i})

    using the split-conformal finite-sample correction
    ``ceil((n+1) q) / n``: on exchangeable residuals the q-quantile upper
    bound covers the realised length with probability >= q.  The point
    estimate (``mean``) passes through untouched, so conformal wrapping
    changes nothing until a risk level is actually consumed."""

    def __init__(self, base, cfg: Optional[CalibrationConfig] = None):
        super().__init__(base)
        self.cfg = cfg if cfg is not None else CalibrationConfig(conformal=True)
        n = (self.cfg.max_step_bucket + 1) if self.cfg.by_step else 1
        self._scores: List[Deque[float]] = [deque(maxlen=self.cfg.window)
                                            for _ in range(n)]
        #: sorted-window memo: bucket -> (version-at-sort, sorted scores);
        #: sorting sits on the scheduling hot path (every scored job) and
        #: the window only changes when a residual lands, not per quantile
        self._version = 0
        self._sorted: Dict[int, Tuple[int, Optional[np.ndarray]]] = {}

    def _window(self, bucket: int) -> Optional[np.ndarray]:
        hit = self._sorted.get(bucket)
        if hit is not None and hit[0] == self._version:
            return hit[1]
        s = self._scores[bucket]
        if len(s) < self.cfg.min_samples:
            # cold bucket: pool every bucket's residuals
            pooled = [x for d in self._scores for x in d]
            out = (np.sort(np.asarray(pooled))
                   if len(pooled) >= self.cfg.min_samples else None)
        else:
            out = np.sort(np.asarray(s))
        self._sorted[bucket] = (self._version, out)
        return out

    @staticmethod
    def _rung(s: np.ndarray, q: float) -> float:
        n = len(s)
        k = min(int(math.ceil((n + 1) * q)), n)
        return float(s[k - 1])

    def ratio_quantile(self, q: float, bucket: int = 0) -> Optional[float]:
        """Finite-sample-corrected empirical quantile of the residual
        ratios, or None while the window is cold."""
        s = self._window(bucket)
        if s is None:
            return None
        return self._rung(s, q)

    def _adjust(self, job: Job,
                pred: LengthPrediction) -> LengthPrediction:
        bucket = self._bucket(job.tokens_generated)
        s = self._window(bucket)
        if s is None:
            return pred
        ladder = tuple((q, pred.mean * self._rung(s, q))
                       for q in QUANTILE_GRID)
        return LengthPrediction(mean=pred.mean, std=pred.std,
                                quantiles=ladder,
                                rank_score=pred.rank_score)

    def _reference_mean(self, base_pred: LengthPrediction,
                        adjusted: LengthPrediction) -> float:
        return adjusted.mean  # score the mean actually served (post-debias)

    def _update(self, bucket: int, predicted: float, actual: float) -> None:
        self._scores[bucket].append(actual / max(predicted, 1e-6))
        self._version += 1  # invalidate every memoised sorted window


# --------------------------------------------------------------------------- #
# RankedPredictor — serving adapter for the two-head model
# --------------------------------------------------------------------------- #


class RankedPredictor(LengthPredictor):
    """Serving-time learning-to-rank predictor over a two-head BGE model.

    ``predict(pool)`` delegates to the two-head :class:`BGEPredictor` (one
    fused dispatch fills both heads; every :class:`LengthPrediction`
    carries ``rank_score`` next to the calibrated ``mean``) and logs the
    inputs it scored.  ``observe()`` resolves those logs into ground-truth
    remaining lengths, keeps them in a rolling window, and every
    ``update_every`` resolved observations harvests ``pairs_per_update``
    record pairs — drawn WITHOUT replacement by a seeded RNG, so the pair
    sequence is a pure function of the observation order and the seed —
    into one fixed-shape SGD step on BOTH heads (encoder frozen online;
    the joint :meth:`BGEPredictor.loss_fn` supplies the regression Huber
    term and the pairwise/listwise ranking term).

    Censoring matches :class:`CalibratedPredictor`: CANCELLED/EXPIRED jobs
    have their logs dropped before any pair can form — an aborted
    request's realised length says nothing about what the model would have
    generated.  ``pair_log`` records the (job_id, job_id) pairs that
    entered training batches; the censoring/determinism tests read it.

    Composes under the calibration wrappers (``make_predictor("ranked",
    bge=..., calibration="ema+conformal")``): they adjust magnitudes, pass
    ``rank_score`` through untouched, and forward ``observe`` here first.
    """

    #: logged-but-unresolved prediction inputs kept per job (oldest dropped)
    MAX_PENDING_PER_JOB = 8
    #: jobs tracked at once (serving cleans up via terminal observes)
    MAX_PENDING_JOBS = 4096

    def __init__(self, base: "BGEPredictor", *, seed: int = 0,
                 window: int = 256, pairs_per_update: int = 8,
                 update_every: int = 32, online_lr: float = 1e-4):
        if not isinstance(base, BGEPredictor) or base.cfg.ranking is None:
            raise ValueError(
                "RankedPredictor needs a two-head BGEPredictor — construct "
                "it with PredictorConfig(ranking=RankingConfig(...))")
        self.base = base
        self._rng = np.random.RandomState(seed)
        self._pending: "OrderedDict[int, List[Tuple[int, Tuple[int, ...]]]]" \
            = OrderedDict()
        #: rolling window of resolved ground truth:
        #: (job_id, input_tokens, actual_remaining, step_at_prediction)
        self._records: Deque[Tuple[int, Tuple[int, ...], float, int]] = \
            deque(maxlen=window)
        self.pairs_per_update = pairs_per_update
        self.update_every = update_every
        self.online_lr = online_lr
        #: resolved ground-truth records consumed so far
        self.n_observed = 0
        #: harvested training pairs so far
        self.n_pairs = 0
        #: online SGD steps taken so far
        self.n_updates = 0
        #: (job_id_a, job_id_b) pairs that entered online training batches
        self.pair_log: List[Tuple[int, int]] = []
        self._since_update = 0
        #: online-update batch shapes seen (each new one counts as a trace
        #: of the base predictor, as the reference's jitted grad does)
        self._grad_shapes: set = set()

    # -- prediction path ------------------------------------------------- #
    def predict(self, jobs: Sequence[Job]) -> List[LengthPrediction]:
        jobs = list(jobs)
        if not jobs:
            return []
        preds = self.base.predict(jobs)
        for j in jobs:
            entries = self._pending.setdefault(j.job_id, [])
            self._pending.move_to_end(j.job_id)
            entries.append((j.tokens_generated,
                            tuple(self.base._job_input(j))))
            if len(entries) > self.MAX_PENDING_PER_JOB:
                del entries[0]
            while len(self._pending) > self.MAX_PENDING_JOBS:
                self._pending.popitem(last=False)
        return preds

    # -- feedback path --------------------------------------------------- #
    def observe(self, job: Job, actual_remaining: float) -> None:
        jid = job.job_id
        if job.state in (JobState.CANCELLED, JobState.EXPIRED):
            # censored: drop the logs BEFORE any pair can form
            self._pending.pop(jid, None)
            return
        entries = self._pending.get(jid)
        if entries:
            total = job.tokens_generated + max(float(actual_remaining), 0.0)
            for g, toks in entries:
                actual = total - g
                if actual > 0.0:
                    self._records.append((jid, toks, actual, g // WINDOW))
                    self.n_observed += 1
                    self._since_update += 1
            entries.clear()
        if job.state in TERMINAL_STATES:
            self._pending.pop(jid, None)
        if self._since_update >= self.update_every:
            self._since_update = 0
            self._update_heads()

    # -- online head training -------------------------------------------- #
    def _heads_grad(self, heads, encoder, batch):
        """Gradients of the joint loss with respect to ``heads`` only (the
        encoder is frozen online and carries no graph)."""
        if batch["tokens"].shape not in self._grad_shapes:
            self._grad_shapes.add(batch["tokens"].shape)
            self.base._n_traces += 1
        flat = [p.detach().requires_grad_(True) for p in leaves(heads)]
        loss, _ = self.base._loss({"encoder": encoder,
                                   **unflatten(heads, flat)}, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return unflatten(heads, [torch.zeros_like(p) if g is None else g
                                 for p, g in zip(flat, grads)])

    def _update_heads(self) -> None:
        recs = list(self._records)
        n = 2 * self.pairs_per_update
        if len(recs) < n:
            return
        idx = self._rng.choice(len(recs), size=n, replace=False)
        rows = [recs[int(i)] for i in idx]
        self.pair_log.extend((rows[2 * t][0], rows[2 * t + 1][0])
                             for t in range(self.pairs_per_update))
        self.n_pairs += self.pairs_per_update
        # fixed (n, max_len) batch shape -> one trace for every update
        ml = self.base.cfg.max_len
        toks = np.full((n, ml), PAD_ID, np.int32)
        msk = np.zeros((n, ml), bool)
        labels = np.zeros((n,), np.float32)
        steps = np.zeros((n,), np.int32)
        for r, (jid, t, actual, step) in enumerate(rows):
            t = list(t)[:ml]
            toks[r, : len(t)] = t
            msk[r, : len(t)] = True
            labels[r] = actual
            steps[r] = step
        batch = {"tokens": toks, "mask": msk, "labels": labels,
                 "steps": steps}
        heads = {k: v for k, v in self.base.params.items() if k != "encoder"}
        grads = self._heads_grad(heads, self.base.params["encoder"], batch)
        lr = self.online_lr
        with torch.no_grad():
            new = tree_map(lambda p, g: p - lr * g, heads, grads)
        # fresh dict (no in-place mutation): callers may hold the previous
        # params tree as a snapshot for benchmark isolation
        self.base.params = {"encoder": self.base.params["encoder"], **new}
        self.n_updates += 1


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #


def _make_oracle(seed: int, bias: float, bge):
    return OraclePredictor()


def _make_noisy(seed: int, bias: float, bge):
    return NoisyOraclePredictor(seed=seed, bias=bias)


def _make_bge(seed: int, bias: float, bge):
    if bge is None:
        raise ValueError("pass a trained BGEPredictor via bge=")
    return bge


def _make_ranked(seed: int, bias: float, bge):
    if bge is None:
        raise ValueError(
            "pass a trained two-head BGEPredictor via bge= "
            "(PredictorConfig(ranking=RankingConfig(...)))")
    if isinstance(bge, RankedPredictor):
        return bge
    return RankedPredictor(bge, seed=seed)


#: base-predictor registry: name -> factory(seed, bias, bge)
BASE_PREDICTORS = {
    "oracle": _make_oracle,
    "noisy_oracle": _make_noisy,
    "bge": _make_bge,
    "ranked": _make_ranked,
}


def wrap_calibration(base, calibration: Union[None, str, CalibrationConfig]):
    """Compose calibration wrappers over ``base``: EMA debias innermost
    (fixes the point estimate), conformal outermost (its residual window
    then scores the debiased mean it actually serves)."""
    if calibration is None:
        return base
    if isinstance(calibration, str):
        calibration = CalibrationConfig.from_name(calibration)
    pred = base
    if calibration.debias:
        pred = EMADebiasedPredictor(pred, calibration)
    if calibration.conformal:
        pred = ConformalPredictor(pred, calibration)
    return pred


def make_predictor(kind: str = "noisy_oracle", *, seed: int = 0, bge=None,
                   calibration: Union[None, str, CalibrationConfig] = None,
                   bias: float = 1.0):
    """Build a (possibly calibrated) predictor from the registry.

    ``kind`` selects the base (``oracle | noisy_oracle | bge | none``);
    ``calibration`` is a :class:`CalibrationConfig`, a name like
    ``"ema+conformal"``, or None; ``bias`` injects a synthetic
    multiplicative mis-calibration into the noisy oracle (benchmarks)."""
    if kind == "none":
        return None
    try:
        factory = BASE_PREDICTORS[kind]
    except KeyError:
        raise ValueError(
            f"unknown predictor {kind!r} "
            f"(have {sorted(BASE_PREDICTORS)} + 'none')") from None
    return wrap_calibration(factory(seed, bias, bge), calibration)
