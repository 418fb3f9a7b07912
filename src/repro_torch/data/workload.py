"""Synthetic LMSYS-Chat-1M-like workload with a *learnable* length signal.

The real paper trains its predictor on LMSYS-Chat-1M responses generated by
13 LLMs.  Offline we synthesise an equivalent: each request is built from a
latent (task, topic, verbosity) triple; the *text of the prompt* carries the
signal (task phrase, topic words, verbosity modifiers), and the response
length is a noisy deterministic function of the latents.  A capable encoder
can therefore genuinely learn length-from-context — and an incapable one
cannot, which is exactly the property the paper's §3 experiments probe.

Length model (tokens):
    len = clip( base[task] * topic_scale * verbosity_mult * lognormal(σ_task), 1, 1024 )

Tasks mirror the observable LMSYS mix: short factual answers dominate, long
generative tails exist (the paper's MAE ~20 at mean length ~200 reflects the
same skew).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.tokenizer import EOS_ID, HashTokenizer, N_SPECIAL

# --------------------------------------------------------------------------- #
# Latent space
# --------------------------------------------------------------------------- #

TASKS: Dict[str, Dict] = {
    # task -> base length, noise sigma, phrase templates
    "yesno": dict(base=8, sigma=0.35, phrases=[
        "is it true that", "can you confirm whether", "yes or no :",
    ]),
    "factual": dict(base=42, sigma=0.40, phrases=[
        "what is", "who invented", "when did", "where can i find",
    ]),
    "summarize": dict(base=90, sigma=0.40, phrases=[
        "summarize the following text about", "give me a short summary of",
        "tl;dr of",
    ]),
    "explain": dict(base=220, sigma=0.45, phrases=[
        "explain how", "describe the process of", "why does",
    ]),
    "code": dict(base=320, sigma=0.50, phrases=[
        "write a python function that", "implement an algorithm for",
        "debug this code about",
    ]),
    "story": dict(base=540, sigma=0.55, phrases=[
        "write a story about", "compose a long essay on",
        "write a detailed article about",
    ]),
}

TOPICS: Dict[str, Dict] = {
    # topic -> length scale, topic vocabulary (disjoint word stems)
    "weather":   dict(scale=0.8, words="rain cloud storm sunny forecast humidity wind temperature climate snow".split()),
    "cooking":   dict(scale=0.9, words="recipe bake flour oven simmer sauce garlic roast knead season".split()),
    "space":     dict(scale=1.1, words="orbit planet rocket galaxy telescope asteroid lunar cosmic nebula gravity".split()),
    "history":   dict(scale=1.2, words="empire revolution treaty dynasty medieval ancient archive monarch war colony".split()),
    "software":  dict(scale=1.0, words="compiler database thread kernel deploy container latency cache protocol queue".split()),
    "biology":   dict(scale=1.0, words="enzyme neuron protein genome cell membrane bacteria evolution organism dna".split()),
    "finance":   dict(scale=0.7, words="equity dividend portfolio inflation hedge liquidity asset bond margin yield".split()),
    "music":     dict(scale=0.9, words="melody chord rhythm tempo orchestra harmony verse acoustic synth octave".split()),
}

VERBOSITY: Dict[str, Tuple[float, List[str]]] = {
    "terse":   (0.45, ["briefly", "in one sentence", "very short answer :"]),
    "normal":  (1.00, [""]),
    "verbose": (1.90, ["in great detail", "thoroughly and at length",
                       "step by step with examples"]),
}

FILLER = (
    "please could you the a for me about regarding with respect to i want "
    "to know tell me more information on this topic thanks"
).split()

#: response phase vocabularies — real LLM answers are structured (openers,
#: sectioned body, closers), so the partial answer reveals *fractional
#: progress*; that structure is what makes iterative prediction increasingly
#: accurate (paper Fig. 2b).  Our synthetic responses mirror it: each
#: progress quintile interleaves its own marker vocabulary into the body.
OPENING_WORDS = "sure certainly here overview introduction begin firstly".split()
CLOSING_WORDS = ("finally conclusion summary therefore overall closing "
                 "lastly ultimately wrapping final").split()
PHASE_WORDS = [
    "opening initial premise background".split(),
    "second expanding detail elaborate".split(),
    "midpoint meanwhile further continuing".split(),
    "penultimate approaching nearing consolidating".split(),
    "finally conclusion summary closing".split(),
]
OPENING_LEN = 10
#: every PHASE_EVERY body tokens, one progress-marker word is emitted
PHASE_EVERY = 8

MAX_OUTPUT = 1024


@dataclass
class Request:
    """One serving request with ground truth known to the generator only."""

    request_id: int
    prompt: str
    prompt_tokens: List[int]
    output_tokens: List[int]  # the synthetic "response" token stream
    true_output_len: int
    arrival_time: float = 0.0
    # latents, retained for analysis only (never shown to the predictor)
    task: str = ""
    topic: str = ""
    verbosity: str = ""
    # serving attributes set by the scenario library (forwarded into
    # RequestOptions by api.Request.from_workload); plain generator output
    # leaves them at the defaults
    tenant: str = "default"
    priority_class: int = 0
    deadline: Optional[float] = None


class WorkloadGenerator:
    """Samples LMSYS-like requests.  Deterministic given the seed."""

    def __init__(self, tokenizer: Optional[HashTokenizer] = None,
                 seed: int = 0):
        self.tok = tokenizer or HashTokenizer()
        self.rng = np.random.RandomState(seed)
        self._task_names = list(TASKS)
        # LMSYS-ish mix: factual/short dominates
        self._task_probs = np.array([0.15, 0.30, 0.15, 0.20, 0.12, 0.08])
        self._topic_names = list(TOPICS)
        self._verb_names = list(VERBOSITY)
        self._verb_probs = np.array([0.25, 0.55, 0.20])
        self._next_id = 0

    # ------------------------------------------------------------------ #
    def true_length(self, task: str, topic: str, verbosity: str) -> float:
        """Noise-free expected length for the latent triple."""
        return float(
            np.clip(
                TASKS[task]["base"]
                * TOPICS[topic]["scale"]
                * VERBOSITY[verbosity][0],
                1,
                MAX_OUTPUT,
            )
        )

    def sample_request(self) -> Request:
        rng = self.rng
        task = self._task_names[rng.choice(len(self._task_names),
                                           p=self._task_probs)]
        topic = self._topic_names[rng.randint(len(self._topic_names))]
        verb = self._verb_names[rng.choice(len(self._verb_names),
                                           p=self._verb_probs)]

        t = TASKS[task]
        phrase = t["phrases"][rng.randint(len(t["phrases"]))]
        vmult, vwords = VERBOSITY[verb]
        vphrase = vwords[rng.randint(len(vwords))]
        topic_words = TOPICS[topic]["words"]
        chosen = [topic_words[rng.randint(len(topic_words))]
                  for _ in range(rng.randint(2, 5))]
        filler = [FILLER[rng.randint(len(FILLER))]
                  for _ in range(rng.randint(0, 6))]
        parts = [vphrase, phrase] + chosen + filler
        prompt = " ".join(w for w in parts if w)

        mean_len = t["base"] * TOPICS[topic]["scale"] * vmult
        length = int(np.clip(
            mean_len * rng.lognormal(mean=0.0, sigma=t["sigma"]), 1, MAX_OUTPUT
        ))

        # synthetic response: opener -> phase-marked topic body -> closer,
        # mirroring the sectioned structure of real LLM answers (the
        # iterative predictor learns progress-fraction from phase vocabulary)
        out_words = []
        body = length - 1
        for i in range(body):
            frac = i / max(body, 1)
            if i < OPENING_LEN:
                pool = OPENING_WORDS
            elif body - i <= 20:
                pool = CLOSING_WORDS
            elif i % PHASE_EVERY == 0:
                pool = PHASE_WORDS[min(int(frac * len(PHASE_WORDS)),
                                       len(PHASE_WORDS) - 1)]
            else:
                pool = topic_words
            out_words.append(pool[rng.randint(len(pool))])
        out_tokens = [self.tok.token_id(w) for w in out_words] + [EOS_ID]

        req = Request(
            request_id=self._next_id,
            prompt=prompt,
            prompt_tokens=self.tok.encode(prompt),
            output_tokens=out_tokens,
            true_output_len=length,
            task=task,
            topic=topic,
            verbosity=verb,
        )
        self._next_id += 1
        return req

    def sample_requests(self, n: int) -> List[Request]:
        return [self.sample_request() for _ in range(n)]


# --------------------------------------------------------------------------- #
# Arrival scenarios for the cluster-scheduling sweep
# --------------------------------------------------------------------------- #


def bursty_arrival_times(n: int, rate: float,
                         rng: np.random.RandomState,
                         burst_size: int = 8,
                         burst_spread: float = 0.5) -> np.ndarray:
    """Flash-crowd arrivals: requests land in bursts of ``burst_size``
    within ``burst_spread`` seconds, bursts themselves Poisson-spaced so the
    long-run rate is still ``rate`` req/s.

    This is the skewed-load regime where count-based placement breaks down
    (Fu et al., "Efficient LLM Scheduling by Learning to Rank"): a burst
    dumped across nodes by job count alone leaves some nodes with all the
    long responses, and only length-aware placement / rebalancing recovers.
    Sorted, so times pair with requests in generation order.
    """
    assert n > 0 and rate > 0
    n_bursts = (n + burst_size - 1) // burst_size
    starts = np.cumsum(rng.exponential(burst_size / rate, size=n_bursts))
    times: List[float] = []
    for s in starts:
        k = min(burst_size, n - len(times))
        times.extend(s + rng.uniform(0.0, burst_spread, size=k))
        if len(times) >= n:
            break
    return np.sort(np.asarray(times[:n]))


# --------------------------------------------------------------------------- #
# Scale workloads: struct-of-arrays traces + the typed Scenario registry
# --------------------------------------------------------------------------- #

#: length-model tables in array form, aligned with dict insertion order —
#: the vectorized sampler draws the same latent space as sample_request
_TASK_NAMES = list(TASKS)
_TASK_BASE = np.array([TASKS[t]["base"] for t in _TASK_NAMES], np.float64)
_TASK_SIGMA = np.array([TASKS[t]["sigma"] for t in _TASK_NAMES], np.float64)
_TOPIC_SCALE = np.array([TOPICS[t]["scale"] for t in TOPICS], np.float64)
_VERB_MULT = np.array([VERBOSITY[v][0] for v in VERBOSITY], np.float64)
#: the LMSYS-ish default mixes (WorkloadGenerator's)
DEFAULT_TASK_PROBS = (0.15, 0.30, 0.15, 0.20, 0.12, 0.08)
DEFAULT_VERB_PROBS = (0.25, 0.55, 0.20)


def sample_length_arrays(n: int, rng: np.random.RandomState, *,
                         task_probs: Optional[Sequence[float]] = None,
                         verb_probs: Optional[Sequence[float]] = None
                         ) -> np.ndarray:
    """Vectorized response lengths from the WorkloadGenerator length model
    (same latent triples and lognormal noise, no prompt/response text) —
    millions of draws in milliseconds.  ``task_probs`` reweights the task
    mix (scenario tenants skew short vs long)."""
    tp = np.asarray(task_probs if task_probs is not None
                    else DEFAULT_TASK_PROBS, np.float64)
    vp = np.asarray(verb_probs if verb_probs is not None
                    else DEFAULT_VERB_PROBS, np.float64)
    task = rng.choice(len(_TASK_BASE), size=n, p=tp / tp.sum())
    topic = rng.randint(len(_TOPIC_SCALE), size=n)
    verb = rng.choice(len(_VERB_MULT), size=n, p=vp / vp.sum())
    mean = _TASK_BASE[task] * _TOPIC_SCALE[topic] * _VERB_MULT[verb]
    noise = rng.lognormal(mean=0.0, sigma=_TASK_SIGMA[task])
    return np.clip(mean * noise, 1, MAX_OUTPUT).astype(np.int64)


@dataclass
class ScaleWorkload:
    """A trace-compressed workload: one numpy row per request, no Job
    objects, prompts, or token streams — the form a vectorized scale
    simulator consumes directly (and :func:`scale_workload_requests` can
    materialise into full Requests for the exact event loop on validation
    slices)."""

    arrival: np.ndarray        # float64, sorted ascending
    length: np.ndarray         # int64 true response lengths (>= 1)
    prompt_len: np.ndarray     # int64 prompt token counts
    tenant_id: np.ndarray      # int32 index into ``tenants``
    priority_class: np.ndarray  # int16 band (0 = default)
    deadline: np.ndarray       # float64 absolute deadlines; +inf = none
    tenants: Tuple[str, ...] = ("default",)
    #: soft per-tenant JCT targets (seconds) for SLO-attainment reporting
    slo_targets: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        n = len(self.arrival)
        for name in ("length", "prompt_len", "tenant_id",
                     "priority_class", "deadline"):
            assert len(getattr(self, name)) == n, f"{name} length mismatch"
        assert n == 0 or self.length.min() >= 1
        assert np.all(np.diff(self.arrival) >= 0), "arrivals must be sorted"

    @property
    def n(self) -> int:
        return len(self.arrival)

    def head(self, k: int) -> "ScaleWorkload":
        """The first ``k`` requests (fidelity-validation slices)."""
        return ScaleWorkload(
            self.arrival[:k], self.length[:k], self.prompt_len[:k],
            self.tenant_id[:k], self.priority_class[:k], self.deadline[:k],
            tenants=self.tenants, slo_targets=dict(self.slo_targets))


def _assemble(parts: List[Dict], tenants: Tuple[str, ...],
              slo_targets: Dict[str, float]) -> ScaleWorkload:
    """Merge per-tenant arrays into one time-sorted ScaleWorkload."""
    arrival = np.concatenate([p["arrival"] for p in parts])
    order = np.argsort(arrival, kind="stable")
    cat = {k: np.concatenate([np.asarray(p[k]) for p in parts])[order]
           for k in ("arrival", "length", "tenant_id", "priority_class",
                     "deadline")}
    n = len(arrival)
    return ScaleWorkload(
        arrival=cat["arrival"].astype(np.float64),
        length=cat["length"].astype(np.int64),
        prompt_len=np.full(n, 12, np.int64),
        tenant_id=cat["tenant_id"].astype(np.int32),
        priority_class=cat["priority_class"].astype(np.int16),
        deadline=cat["deadline"].astype(np.float64),
        tenants=tenants, slo_targets=slo_targets)


def _tenant_part(times: np.ndarray, lengths: np.ndarray, tid: int,
                 klass: int, deadline=np.inf) -> Dict:
    """``deadline``: scalar (same absolute deadline everywhere, +inf =
    none) or a per-request array aligned with the *sorted* arrivals —
    deadline-heavy scenarios set each request's deadline relative to its
    own arrival."""
    n = len(times)
    times = np.sort(times)
    deadline = (np.asarray(deadline, np.float64)
                if np.ndim(deadline) else np.full(n, deadline))
    return dict(arrival=times, length=lengths,
                tenant_id=np.full(n, tid), priority_class=np.full(n, klass),
                deadline=deadline)


def _build_diurnal(n: int, rate: float,
                   rng: np.random.RandomState) -> ScaleWorkload:
    from repro_torch.data.arrivals import diurnal_arrival_times

    # period scaled so any run spans ~3 full cycles (clamped to real hours)
    period = float(np.clip(n / rate / 3.0, 600.0, 86400.0))
    times = diurnal_arrival_times(n, rate, rng, amplitude=0.7,
                                  period_s=period, noise_sigma=0.15)
    lengths = sample_length_arrays(n, rng)
    return _assemble([_tenant_part(times, lengths, 0, 0)],
                     ("default",), {})


#: the multi-tenant SLO mix: (share, priority class, soft JCT target [s],
#: task-mix skew, arrival process) per tenant
_SLO_TENANTS: Dict[str, Dict] = {
    "interactive": dict(
        share=0.55, klass=0, slo=60.0,
        task_probs=(0.35, 0.40, 0.15, 0.07, 0.02, 0.01), process="gamma"),
    "agent": dict(
        share=0.15, klass=1, slo=240.0,
        task_probs=(0.05, 0.15, 0.15, 0.25, 0.30, 0.10), process="bursty"),
    "batch": dict(
        share=0.30, klass=2, slo=1200.0,
        task_probs=(0.02, 0.08, 0.15, 0.30, 0.20, 0.25), process="poisson"),
}


def _build_multi_tenant_slo(n: int, rate: float,
                            rng: np.random.RandomState) -> ScaleWorkload:
    from repro_torch.data.arrivals import GammaArrivals, PoissonArrivals

    tenants = tuple(_SLO_TENANTS)
    counts = [int(round(_SLO_TENANTS[t]["share"] * n)) for t in tenants]
    counts[0] += n - sum(counts)  # rounding residue to the largest tenant
    parts = []
    for tid, (tenant, spec) in enumerate(_SLO_TENANTS.items()):
        n_t, rate_t = counts[tid], spec["share"] * rate
        if n_t <= 0:  # tiny validation slices can round a tenant away
            continue
        if spec["process"] == "bursty":
            times = bursty_arrival_times(n_t, rate_t, rng, burst_size=16,
                                         burst_spread=1.0)
        elif spec["process"] == "poisson":
            times = PoissonArrivals(rate_t).sample_arrival_times(n_t, rng)
        else:
            times = GammaArrivals().rate_scaled(rate_t).sample_arrival_times(
                n_t, rng)
        lengths = sample_length_arrays(n_t, rng,
                                       task_probs=spec["task_probs"])
        parts.append(_tenant_part(times, lengths, tid, spec["klass"]))
    slo = {t: _SLO_TENANTS[t]["slo"] for t in tenants}
    return _assemble(parts, tenants, slo)


def _build_flash_crowd(n: int, rate: float,
                       rng: np.random.RandomState) -> ScaleWorkload:
    from repro_torch.data.arrivals import GammaArrivals

    n_bg = int(round(0.7 * n))
    n_crowd = n - n_bg
    bg_times = GammaArrivals().rate_scaled(0.7 * rate).sample_arrival_times(
        n_bg, rng)
    parts = [_tenant_part(bg_times, sample_length_arrays(n_bg, rng), 0, 0)]
    if n_crowd > 0:
        # correlated cross-node spikes: whole crowds land within a few
        # seconds, crowd onsets Poisson-spaced for a long-run 0.3*rate
        crowd_size = max(32, n_crowd // 64)
        crowd_times = bursty_arrival_times(n_crowd, 0.3 * rate, rng,
                                           burst_size=crowd_size,
                                           burst_spread=3.0)
        parts.append(_tenant_part(
            crowd_times, sample_length_arrays(n_crowd, rng), 1, 0))
    return _assemble(parts, ("background", "crowd"), {})


#: the deadline-heavy agent mix: orchestrated tool-call steps are worthless
#: past their step timeout (tight per-request deadlines, bursty chains),
#: planning turns run long under a looser turn budget, and a background
#: interactive tenant carries no deadline at all — (share, priority class,
#: soft SLO target [s], deadline budget range [s] drawn uniform per
#: request, task-mix skew, arrival process)
_AGENT_TENANTS: Dict[str, Dict] = {
    "tool": dict(
        share=0.50, klass=0, slo=20.0, budget=(8.0, 30.0),
        task_probs=(0.50, 0.32, 0.12, 0.04, 0.01, 0.01), process="bursty"),
    "plan": dict(
        share=0.20, klass=1, slo=240.0, budget=(90.0, 300.0),
        task_probs=(0.02, 0.08, 0.15, 0.30, 0.30, 0.15), process="gamma"),
    "interactive": dict(
        share=0.30, klass=1, slo=120.0, budget=None,
        task_probs=None, process="gamma"),
}


def _build_agent(n: int, rate: float,
                 rng: np.random.RandomState) -> ScaleWorkload:
    from repro_torch.data.arrivals import GammaArrivals

    tenants = tuple(_AGENT_TENANTS)
    counts = [int(round(_AGENT_TENANTS[t]["share"] * n)) for t in tenants]
    counts[0] += n - sum(counts)
    parts = []
    for tid, (tenant, spec) in enumerate(_AGENT_TENANTS.items()):
        n_t, rate_t = counts[tid], spec["share"] * rate
        if n_t <= 0:
            continue
        if spec["process"] == "bursty":
            # one burst ≈ one agent chain fanning out tool calls
            times = bursty_arrival_times(n_t, rate_t, rng, burst_size=8,
                                         burst_spread=0.5)
        else:
            times = GammaArrivals().rate_scaled(rate_t).sample_arrival_times(
                n_t, rng)
        times = np.sort(times)
        lengths = sample_length_arrays(n_t, rng,
                                       task_probs=spec["task_probs"])
        if spec["budget"] is not None:
            lo, hi = spec["budget"]
            deadline = times + rng.uniform(lo, hi, n_t)
        else:
            deadline = np.inf
        parts.append(_tenant_part(times, lengths, tid, spec["klass"],
                                  deadline=deadline))
    slo = {t: _AGENT_TENANTS[t]["slo"] for t in tenants}
    return _assemble(parts, tenants, slo)


@dataclass(frozen=True)
class Scenario:
    """One registered at-scale traffic scenario."""

    name: str
    description: str
    #: build(n_requests, aggregate_rate_rps, rng) -> ScaleWorkload
    build: "callable"


SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in (
        Scenario("diurnal",
                 "sinusoidal day/night load curve (amplitude 0.7, lognormal "
                 "jitter) over ~3 simulated cycles", _build_diurnal),
        Scenario("multi_tenant_slo",
                 "interactive/agent/batch tenants with distinct arrival "
                 "processes, length mixes, priority classes and soft JCT "
                 "SLO targets", _build_multi_tenant_slo),
        Scenario("flash_crowd",
                 "steady background traffic plus correlated cross-node "
                 "crowd spikes (bursts of hundreds within seconds)",
                 _build_flash_crowd),
        Scenario("agent",
                 "deadline-heavy agent orchestration: bursty tool-call "
                 "chains with tight per-request deadlines (8-30s), "
                 "long-form planning turns under looser budgets, and "
                 "deadline-free interactive background — report expiry "
                 "rate per tenant", _build_agent),
    )
}


def build_scale_workload(name: str, n: int, rate: float,
                         rng: np.random.RandomState) -> ScaleWorkload:
    """Look up and build a registered scenario; unknown names fail loudly
    with the valid choices."""
    try:
        scenario = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; choose from {sorted(SCENARIOS)}"
        ) from None
    return scenario.build(n, rate, rng)


def scale_workload_requests(w: ScaleWorkload) -> List[Request]:
    """Materialise a ScaleWorkload into full Requests for the *exact*
    event loop (validation slices / ``serve --scenario``).

    Prompts and response streams are synthetic placeholders — scenario
    traces carry lengths, not text, so they pair with the oracle-family
    predictors (content-reading predictors like ``bge`` would see no
    signal).  Token values are irrelevant to the simulators; only
    ``len(output_tokens) == true_output_len`` matters."""
    reqs: List[Request] = []
    body_tok = N_SPECIAL + 1
    for i in range(w.n):
        length = int(w.length[i])
        deadline = float(w.deadline[i])
        reqs.append(Request(
            request_id=i,
            prompt=f"scale request {i}",
            prompt_tokens=[body_tok] * int(w.prompt_len[i]),
            output_tokens=[body_tok] * (length - 1) + [EOS_ID],
            true_output_len=length,
            arrival_time=float(w.arrival[i]),
            tenant=w.tenants[int(w.tenant_id[i])],
            priority_class=int(w.priority_class[i]),
            deadline=None if np.isinf(deadline) else deadline,
        ))
    return reqs


# --------------------------------------------------------------------------- #
# Fig-1 style similar/dissimilar sentence sets
# --------------------------------------------------------------------------- #


def similarity_probe_sets(n: int = 100, seed: int = 0):
    """Two sentence sets and the tokenizer: one set on a single topic
    (weather), one scattered across all other topics, as in the paper's
    Fig. 1 experiment.  The draws are the reference's, in its order, so
    the same seed gives the same sentences."""
    rng = np.random.RandomState(seed)
    tok = HashTokenizer()
    weather = TOPICS["weather"]["words"]
    others = [t for t in TOPICS if t != "weather"]

    def sentence(words):
        k = rng.randint(4, 9)
        return " ".join(words[rng.randint(len(words))] for _ in range(k))

    similar = [sentence(weather) for _ in range(n)]
    dissimilar = [
        sentence(TOPICS[others[rng.randint(len(others))]]["words"])
        for _ in range(n)
    ]
    return similar, dissimilar, tok
