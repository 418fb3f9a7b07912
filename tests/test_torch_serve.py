"""The port's serve CLI (``repro_torch.launch.serve``) and the host pieces
it needs against the JAX package: ``parse_mesh``, ``load_requests`` for
each kind of traffic, ``decide_preempt``, ``prefill_debt``,
``fairness_ratio`` and ``summarize_by_tenant``; an ``ElisServer`` that
preempts by swap under chunked prefill; and ``main`` itself on the CPU,
request by request against the JAX CLI (its weights differ, so the
per-request status and token counts are compared, not the tokens), with
the oracle and with the BGE predictor, calibrated or not, and restored
from a checkpoint the JAX package wrote.
Everything is exact: no tolerance.
"""
import argparse
import json
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import Job as JaxJob  # noqa: E402
from repro.core import PreemptionConfig as JaxPreemptionConfig  # noqa: E402
from repro.core import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.core.metrics import fairness_ratio as jax_fairness  # noqa: E402
from repro.core.metrics import \
    summarize_by_tenant as jax_by_tenant  # noqa: E402
from repro.core.scheduler import decide_preempt as jax_decide  # noqa: E402
from repro.core.scheduler import prefill_debt as jax_debt  # noqa: E402
from repro.data.workload import SCENARIOS  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ElisServer, FrontendConfig, Job,  # noqa: E402
                              OraclePredictor, PreemptionConfig, Request,
                              SchedulerConfig, decide_preempt,
                              fairness_ratio, prefill_debt,
                              summarize_by_tenant)
from repro_torch.engine import (EngineConfig, EngineExecutor,  # noqa: E402
                                InferenceEngine)
from repro_torch.launch import serve  # noqa: E402

ARCH = "qwen2-1.5b"


# --------------------------------------------------------------------------- #
# parse_mesh, load_requests
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("spec", ["2x4", "1X1", "1x2", " 3x 2", "2x", "x4",
                                  "2x3x4", "ax4", "2x4.5", "0x4", "2x-1",
                                  ""])
def test_parse_mesh_matches_reference(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return str(e)

    assert outcome(serve.parse_mesh) == outcome(jax_serve.parse_mesh)


def _args(**kw):
    base = dict(scenario=None, trace=None, n=12, rate=2.0, seed=3,
                max_output=32)
    base.update(kw)
    return argparse.Namespace(**base)


def _request_fields(r):
    o = r.options
    return (r.request_id, r.prompt, list(r.prompt_tokens), r.arrival_time,
            r.true_output_len, o.max_tokens, o.deadline, o.tenant,
            o.priority_class)


def _same_requests(args):
    got, got_slo = serve.load_requests(args)
    want, want_slo = jax_serve.load_requests(args)
    assert got_slo == want_slo
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _request_fields(g) == _request_fields(w)


@pytest.mark.parametrize("scenario", [None] + sorted(SCENARIOS))
def test_load_requests_matches_reference(scenario):
    _same_requests(_args(scenario=scenario, n=40))


def test_load_requests_from_a_trace_matches_reference(tmp_path):
    path = tmp_path / "trace.jsonl"
    with open(path, "w") as f:
        for i in range(5):
            rec = {"request_id": 10 + i, "prompt": f"q{i}",
                   "prompt_tokens": list(range(8, 8 + 3 * i + 1)),
                   "arrival_time": 0.25 * i}
            if i % 2:
                rec["max_tokens"] = 5 + i
            if i == 3:
                rec["deadline"] = 9.5
            f.write(json.dumps(rec) + "\n")
    _same_requests(_args(trace=str(path)))


# --------------------------------------------------------------------------- #
# Scheduler and metrics pieces
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", ["recompute", "swap", "auto"])
@pytest.mark.parametrize("costs", [None, (0.01, 0.5), (0.5, 0.01),
                                   (0.1, 0.2)])
@pytest.mark.parametrize("remaining", [None, 0.0, 30.0, 500.0])
def test_decide_preempt_matches_reference(policy, costs, remaining):
    assert (decide_preempt(PreemptionConfig(policy=policy), costs, remaining)
            == jax_decide(JaxPreemptionConfig(policy=policy), costs,
                          remaining))


def test_decide_preempt_refuses_unknown_policy():
    with pytest.raises(ValueError, match="unknown preempt policy"):
        decide_preempt(PreemptionConfig(policy="drop"), None, None)


@pytest.mark.parametrize("chunk", [None, 8])
def test_prefill_debt_matches_reference(chunk):
    for plen, gen, pre in [(10, 0, 0), (10, 0, 8), (10, 5, 16), (10, 5, 0),
                           (3, 2, 9)]:
        jobs = []
        for cls in (Job, JaxJob):
            j = cls(job_id=0, prompt="", prompt_tokens=list(range(plen)),
                    arrival_time=0.0)
            j.generated = [1] * gen
            j.prefilled_tokens = pre
            jobs.append(j)
        assert (prefill_debt(SchedulerConfig(prefill_chunk=chunk), jobs[0])
                == jax_debt(JaxSchedulerConfig(prefill_chunk=chunk),
                            jobs[1]))


@pytest.mark.parametrize("values", [{}, {"a": 1.0}, {"a": 2.0, "b": 1.0},
                                    {"a": 2.0, "b": 0.0},
                                    {"a": 0.0, "b": 0.0},
                                    {"a": 3.0, "b": -1.0, "c": 1.5}])
def test_fairness_ratio_matches_reference(values):
    assert fairness_ratio(values) == jax_fairness(values)


class _Record:
    """A finished request's timing surface, as ``summarize`` reads it."""

    def __init__(self, tenant, arrival, jct, rng):
        self.tenant = tenant
        self.arrival_time = arrival
        self.finish_time = arrival + jct
        self.queuing_delay = jct * rng.uniform(0, 0.5)
        self.first_token_time = arrival + self.queuing_delay
        self.n_preemptions = int(rng.randint(0, 3))

    def jct(self):
        return self.finish_time - self.arrival_time


def test_summarize_by_tenant_matches_reference():
    rng = np.random.RandomState(0)
    recs = [_Record(t, float(a), float(j), rng)
            for t, a, j in zip(rng.choice(["x", "y", "z"], 30),
                               rng.uniform(0, 10, 30),
                               rng.uniform(0.1, 4, 30))]
    targets = {"x": 2.0, "z": 1.0}
    assert summarize_by_tenant(recs, targets) == jax_by_tenant(recs, targets)
    assert summarize_by_tenant(recs) == jax_by_tenant(recs)


# --------------------------------------------------------------------------- #
# ElisServer: swap preemption under chunked prefill
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def params():
    """The reference init, the dense layers' weights scaled by 3 so that
    greedy streams do not settle on one repeated token."""
    tree = jax.tree_util.tree_map(
        np.asarray,
        jax_init_params(jax.random.PRNGKey(0), jax_get_config(ARCH).reduced()))
    for group in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for name in group:
            if name.startswith("w"):
                group[name] = group[name] * np.float32(3.0)
    return params_from_numpy(tree, "cpu")


def _engine(params, slots=2):
    return InferenceEngine(get_config(ARCH).reduced(), params, EngineConfig(
        max_slots=slots, max_len=128, max_output=128, eos_id=-1,
        respect_job_max=True), device="cpu")


def _solo_stream(params, prompt, n):
    """The request's greedy stream run alone, one-shot, uninterrupted."""
    eng = _engine(params, slots=1)
    job = Job(job_id=0, prompt="", prompt_tokens=prompt, arrival_time=0.0,
              true_output_len=n)
    while True:
        toks, fin = eng.run_window([job], 8)
        job.generated.extend(toks[0])
        if fin[0]:
            return job.generated


@pytest.mark.parametrize("policy", ["swap", "auto"])
def test_server_swaps_under_chunked_prefill(params, policy):
    """Two long requests run; short ones arrive and preempt them.  Under
    ``swap`` the victims' caches go to host memory and come back (under
    ``auto`` the break-even decides); every request finishes with its
    uninterrupted greedy stream."""
    rng = np.random.RandomState(5)
    specs = [(0.0, 20, 100), (0.0, 17, 100), (1e-4, 6, 4), (2e-4, 9, 6),
             (3e-4, 5, 5)]
    prompts = [[int(t) for t in rng.randint(8, 512, size=p)]
               for _, p, _ in specs]
    executor = EngineExecutor({0: _engine(params)})
    server = ElisServer(
        FrontendConfig(
            n_nodes=1,
            scheduler=SchedulerConfig(policy="isrtf", window=4, batch_size=2,
                                      prefill_chunk=8),
            preemption=PreemptionConfig(policy=policy),
            observe_in_flight=False),
        OraclePredictor(), executor)
    for i, ((t, _, n), p) in enumerate(zip(specs, prompts)):
        server.submit(Request(prompt=f"r{i}", prompt_tokens=p,
                              arrival_time=t, request_id=i,
                              true_output_len=n))
    responses = {r.request_id: r for r in server.drain()}
    c = executor.counters()
    assert sum(r.n_preemptions for r in responses.values()) > 0
    assert c["chunk_dispatches"] > 0
    if policy == "swap":
        assert c["swapouts"] > 0 and c["swapins"] == c["swapouts"]
        assert c["resume_context_tokens"] == 0  # nothing was recomputed
    for i, ((_, _, n), p) in enumerate(zip(specs, prompts)):
        r = responses[i]
        assert r.ok and r.n_tokens == n
        assert list(r.tokens) == _solo_stream(params, p, n), f"request {i}"


# --------------------------------------------------------------------------- #
# main(): the CLI on the CPU against the JAX CLI
# --------------------------------------------------------------------------- #


def _run(main, argv, capsys, monkeypatch=None):
    """(per-request (request_id, status, n_tokens), stderr) of one CLI run;
    the JAX ``main`` reads ``sys.argv``."""
    capsys.readouterr()
    if monkeypatch is None:
        main(argv)
    else:
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        main()
    cap = capsys.readouterr()
    recs = [json.loads(line) for line in cap.out.splitlines()
            if line.startswith("{")]
    return [(r["request_id"], r["status"], r["n_tokens"]) for r in recs], \
        cap.err


@pytest.mark.parametrize("argv", [
    ["--n", "6", "--max-output", "12"],
    ["--n", "8", "--max-output", "40", "--rate", "20", "--prefill-chunk",
     "8", "--preempt-policy", "swap", "--policy", "isrtf"],
    ["--n", "8", "--max-output", "16", "--scenario", "multi_tenant_slo",
     "--policy", "sjf", "--workers", "2", "--placement",
     "least_predicted_work", "--rebalance"],
    ["--n", "8", "--max-output", "24", "--policy", "mlfq"],
    ["--n", "6", "--max-output", "24", "--policy", "fcfs", "--slots", "1"],
    ["--n", "10", "--max-output", "40", "--rate", "20", "--preempt-policy",
     "auto", "--probe-nodes", "1", "--placement", "least_eta"],
    ["--n", "10", "--max-output", "40", "--rate", "20", "--preempt-policy",
     "swap", "--swap-pool", "30"],
    ["--n", "6", "--max-output", "24", "--rate", "20", "--predictor", "bge"],
    ["--n", "6", "--max-output", "24", "--rate", "20", "--calibrate",
     "ema+conformal"],
    ["--n", "6", "--max-output", "24", "--rate", "20", "--predictor", "bge",
     "--calibrate", "ema+conformal", "--policy", "isrtf"],
], ids=["default", "chunk-swap", "scenario-2-workers", "mlfq", "fcfs",
        "auto-probe", "swap-pool", "bge", "calibrated-oracle",
        "calibrated-bge"])
def test_main_matches_jax_cli(argv, capsys, monkeypatch):
    got, err = _run(serve.main, argv + ["--device", "cpu"], capsys)
    want, _ = _run(jax_serve.main, argv, capsys, monkeypatch)
    assert got == want
    assert len(got) == int(argv[1])
    assert f"({len(got)}/{len(got)} finished)" in err


def test_main_serves_a_trace_as_the_jax_cli(tmp_path, capsys, monkeypatch):
    path = tmp_path / "trace.jsonl"
    with open(path, "w") as f:
        for i in range(4):
            f.write(json.dumps({
                "request_id": i, "prompt": f"q{i}",
                "prompt_tokens": list(range(8, 20 + 5 * i)),
                "arrival_time": 0.01 * i, "max_tokens": 6 + 3 * i}) + "\n")
    argv = ["--trace", str(path), "--max-output", "12"]
    got, _ = _run(serve.main, argv + ["--device", "cpu"], capsys)
    want, _ = _run(jax_serve.main, argv, capsys, monkeypatch)
    assert got == want == [(i, "finished", min(6 + 3 * i, 12))
                           for i in range(4)]


def test_main_serves_a_tp_pod_on_cpu_ranks(capsys):
    """``--mesh 1x2`` with recompute preemption: one TP=2 pod of CPU ranks;
    every request finishes with its expected token count."""
    argv = ["--n", "5", "--max-output", "10", "--mesh", "1x2"]
    got, err = _run(serve.main, argv + ["--device", "cpu"], capsys)
    reqs, _ = serve.load_requests(_args(n=5, rate=1.5, seed=0,
                                        max_output=10))
    assert got == [(r.request_id, "finished", min(r.true_output_len, 10))
                   for r in reqs]
    assert "1 TP=2 pod(s)" in err


def test_main_restores_a_jax_checkpoint_as_the_jax_cli(tmp_path, capsys,
                                                      monkeypatch):
    """``--predictor bge --predictor-ckpt DIR`` on a checkpoint the JAX
    package wrote: the port restores the same weights into its predictor
    and serves every request as the JAX CLI does."""
    from repro import training as jax_training
    from repro.core import BGEPredictor as JaxBGE
    from repro_torch.training.tree import leaves

    ns = argparse.Namespace(predictor="bge", predictor_ckpt=None,
                            calibrate="none")
    cfg = jax_serve.build_predictor(ns).cfg
    trained = JaxBGE(cfg, seed=1)  # not the CLI's seed-0 weights
    jax_training.save_checkpoint(str(tmp_path), 12, trained.params)
    ns.predictor_ckpt = str(tmp_path)
    restored = serve.build_predictor(ns, "cpu")
    for a, b in zip(leaves(restored.params),
                    jax.tree_util.tree_leaves(trained.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    argv = ["--n", "6", "--max-output", "24", "--rate", "20", "--predictor",
            "bge", "--predictor-ckpt", str(tmp_path)]
    got, err = _run(serve.main, argv + ["--device", "cpu"], capsys)
    want, _ = _run(jax_serve.main, argv, capsys, monkeypatch)
    assert got == want
    assert "(6/6 finished)" in err


@pytest.mark.parametrize("argv,match", [
    (["--predictor", "bge", "--predictor-ckpt", "{empty}"], "no checkpoint in"),
    (["--prefill-chunk", "0"], "must be >= 1"),
    (["--mesh", "2x"], "DxM"),
])
def test_main_refuses_at_launch(argv, match, tmp_path):
    """A checkpoint directory that holds no checkpoint and a malformed flag
    exit non-zero (never a fallback to the oracle or to recompute)."""
    argv = [a.replace("{empty}", str(tmp_path)) for a in argv]
    with pytest.raises(SystemExit) as e:
        serve.main(argv + ["--device", "cpu"])
    assert match in str(e.value.code)


def test_main_needs_a_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would serve")
    with pytest.raises(SystemExit) as e:
        serve.main(["--n", "1"])
    assert "torch.cuda.is_available() is False" in str(e.value.code)
