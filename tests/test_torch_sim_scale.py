"""The port's scale fast path (``repro_torch.simulate.scale``:
``ScaleSimConfig``, ``ScaleSimulator``, ``ScaleResult``,
``run_exact_reference``) against the JAX package's, on the CPU.

Both packages' simulators are host arithmetic (numpy and Python) over the
same struct-of-arrays workload, so every result array, counter and
streamed summary is compared bit for bit: with and without window
coalescing, and for the exact event loop.  The port's fast path is also
held trace-identical to its own exact loop where the reference's
exactness contract promises it, and it reproduces the reference's one
known exception (seed 2712: multi-node FCFS with deadlines) field by
field.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

from repro.core import scheduler as JSched  # noqa: E402
from repro.data import workload as JW  # noqa: E402
from repro.simulate import scale as JScale  # noqa: E402
from repro_torch.core import PreemptionConfig  # noqa: E402
from repro_torch.data import workload as TW  # noqa: E402
from repro_torch.simulate import PROFILES, ModelProfile  # noqa: E402
from repro_torch.simulate import scale as TScale  # noqa: E402


RESULT_ARRAYS = ("state", "finish", "first_token", "queuing_delay",
                 "n_preemptions", "n_iterations", "finished_order")
COUNTERS = ("n_swapouts", "n_swapins", "recompute_prefill_tokens")


def workloads(seed: int, n: int = 36, *, rate: float = 1.2,
              with_deadlines: bool = False):
    """The reference sweep's small adversarial workload
    (``tests/test_sim_scale.py::_random_workload``), built once as arrays
    and wrapped in each package's ``ScaleWorkload``."""
    rng = np.random.RandomState(seed)
    arrival = np.sort(np.round(rng.uniform(0.0, n / rate, size=n), 2))
    if n >= 4:
        arrival[1] = arrival[0]
        arrival[n // 2] = arrival[n // 2 - 1]
    length = rng.randint(1, 130, size=n).astype(np.int64)
    tenant_id = rng.randint(0, 2, size=n).astype(np.int32)
    klass = rng.randint(0, 2, size=n).astype(np.int16)
    deadline = np.full(n, np.inf)
    if with_deadlines:
        tight = rng.rand(n) < 0.35
        deadline[tight] = arrival[tight] + rng.uniform(2.0, 60.0,
                                                       size=int(tight.sum()))
    kw = dict(arrival=arrival, length=length,
              prompt_len=np.full(n, 12, np.int64), tenant_id=tenant_id,
              priority_class=klass, deadline=deadline,
              tenants=("alpha", "beta"), slo_targets={"alpha": 30.0})
    return (JW.ScaleWorkload(**{k: np.copy(v) if isinstance(v, np.ndarray)
                                else v for k, v in kw.items()}),
            TW.ScaleWorkload(**kw))


def configs(**kw):
    """The same ``ScaleSimConfig`` in both packages."""
    pre = kw.pop("preemption", None)
    jkw, tkw = dict(kw), dict(kw)
    if pre is not None:
        jkw["preemption"] = JSched.PreemptionConfig(**pre)
        tkw["preemption"] = PreemptionConfig(**pre)
    return JScale.ScaleSimConfig(**jkw), TScale.ScaleSimConfig(**tkw)


def assert_same_arrays(got, want, ctx, names=RESULT_ARRAYS + COUNTERS):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(g, np.ndarray):
            assert g.dtype == w.dtype, f"{ctx}: {name} dtype"
            assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), \
                f"{ctx}: {name} differs"
        else:
            assert g == w, f"{ctx}: {name} {g} != {w}"


def metrics(result):
    m = result.metrics()
    m.pop("wall_s"), m.pop("requests_per_s")
    return m


# --------------------------------------------------------------------------- #
# ScaleSimulator against the reference's, bit for bit
# --------------------------------------------------------------------------- #


FAST = {
    "isrtf-oracle": dict(policy="isrtf", seed=1),
    "isrtf-noisy": dict(policy="isrtf", predictor="noisy_oracle", seed=2,
                        preemption=dict(enabled=True)),
    "sjf-noisy-2-nodes": dict(policy="sjf", predictor="noisy_oracle",
                              n_nodes=2, placement="least_predicted_work",
                              seed=3),
    "fcfs-deadlines": dict(policy="fcfs", batch_size=2, seed=4,
                           deadlines=True),
    "isrtf-aging-stride": dict(policy="isrtf", predictor="noisy_oracle",
                               aging_rate=0.05, repredict_every=3,
                               n_nodes=2, seed=5),
    "swap": dict(policy="isrtf", preemption=dict(policy="swap"),
                 batch_size=2, seed=6),
    "auto": dict(policy="isrtf", predictor="noisy_oracle",
                 preemption=dict(policy="auto"), batch_size=2, seed=7),
    "prefill-chunk": dict(policy="isrtf", prefill_chunk=5, batch_size=3,
                          seed=8),
    "hetero-least-eta": dict(policy="isrtf", n_nodes=3, batch_size=2,
                             hw_speedup=2.0, node_profiles={1: "lam13"},
                             placement="least_eta", seed=9),
    "bias-sparse": dict(policy="isrtf", predictor="noisy_oracle",
                        predictor_bias=0.6, seed=10, rate=0.08),
}


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesce", "off"])
@pytest.mark.parametrize("kw", FAST.values(), ids=FAST.keys())
def test_fast_path_matches_reference(kw, coalesce):
    kw = dict(kw)
    w_kw = dict(with_deadlines=kw.pop("deadlines", False),
                rate=kw.pop("rate", 1.2))
    jcfg, tcfg = configs(model="vic", batch_size=kw.pop("batch_size", 3),
                         coalesce=coalesce, **kw)
    jw, tw = workloads(tcfg.seed, n=48, **w_kw)
    want = JScale.ScaleSimulator(jcfg).run(jw)
    got = TScale.ScaleSimulator(tcfg).run(tw)
    assert_same_arrays(got, want, repr(tcfg))
    assert (got.n_windows, got.n_coalesced) == (want.n_windows,
                                                want.n_coalesced)
    assert metrics(got) == metrics(want)


def test_coalescing_fires_on_a_sparse_trickle():
    """The sparse case coalesces in both packages, identically, and the
    port's result stays trace-identical to its own exact loop."""
    jcfg, tcfg = configs(model="vic", policy="isrtf", batch_size=4, seed=11)
    jw, tw = workloads(11, n=24, rate=0.08)
    got = TScale.ScaleSimulator(tcfg).run(tw)
    want = JScale.ScaleSimulator(jcfg).run(jw)
    assert got.n_coalesced == want.n_coalesced > 0
    assert_same_arrays(got, want, "coalesce")
    assert_same_arrays(got, TScale.run_exact_reference(tcfg, tw), "exact",
                       RESULT_ARRAYS)


def test_scenario_workload_and_a_fitted_profile_match_reference():
    """A scenario built by each package's ``build_scale_workload`` from one
    seed, under a ``ModelProfile`` instance (a live fit plugs in so) and a
    fitted overhead."""
    fit = dict(name="fit", params_b=1.5, avg_latency_ms=2400.0, n_layers=28,
               n_kv_heads=2, head_dim=128, preempt_batch=64,
               mem_limit_frac=0.4, batch_slowdown=0.07)
    from repro.simulate import ModelProfile as JaxModelProfile

    jcfg, tcfg = configs(policy="isrtf", predictor="noisy_oracle",
                         n_nodes=2, seed=3, sched_overhead_s=0.004)
    jcfg.model, tcfg.model = JaxModelProfile(**fit), ModelProfile(**fit)
    jw = JW.build_scale_workload("flash_crowd", 3000, 6.0,
                                 np.random.RandomState(3))
    tw = TW.build_scale_workload("flash_crowd", 3000, 6.0,
                                 np.random.RandomState(3))
    want = JScale.ScaleSimulator(jcfg).run(jw)
    got = TScale.ScaleSimulator(tcfg).run(tw)
    assert_same_arrays(got, want, "flash_crowd")
    assert metrics(got) == metrics(want)
    assert got.metrics()["n_finished"] == 3000


# --------------------------------------------------------------------------- #
# run_exact_reference, and the exactness contract on the port itself
# --------------------------------------------------------------------------- #


EXACT = {
    "isrtf-oracle-preempt": dict(policy="isrtf", seed=21,
                                 preemption=dict(enabled=True)),
    "sjf-noisy-2-nodes": dict(policy="sjf", predictor="noisy_oracle",
                              n_nodes=2, placement="least_predicted_work",
                              seed=22, coalesce=False),
    "fcfs-deadlines": dict(policy="fcfs", batch_size=2, seed=23,
                           deadlines=True),
    "swap-chunk": dict(policy="isrtf", preemption=dict(policy="swap"),
                       prefill_chunk=7, batch_size=2, seed=24),
    "hetero": dict(policy="isrtf", n_nodes=3, batch_size=2, hw_speedup=2.0,
                   node_profiles={1: "lam13"}, placement="least_eta",
                   seed=25),
}


@pytest.mark.parametrize("kw", EXACT.values(), ids=EXACT.keys())
def test_exact_reference_matches_reference_and_the_fast_path(kw):
    kw = dict(kw)
    deadlines = kw.pop("deadlines", False)
    jcfg, tcfg = configs(model="vic", batch_size=kw.pop("batch_size", 3),
                         **kw)
    jw, tw = workloads(tcfg.seed, with_deadlines=deadlines)
    want = JScale.run_exact_reference(jcfg, jw)
    got = TScale.run_exact_reference(tcfg, tw)
    assert_same_arrays(got, want, repr(tcfg))
    # the contract: oracle runs and noisy runs without coalescing are
    # trace-identical to the exact loop
    fast = TScale.ScaleSimulator(tcfg).run(tw)
    assert_same_arrays(fast, got, "fast vs exact")


def test_reproduces_the_reference_multi_node_fcfs_caveat():
    """The reference's falsifying case of its fidelity sweep (``vic``,
    FCFS, oracle, 3 nodes, batch 3, no preemption, deadlines, seed 2712):
    its fast path finishes jobs 17 and 18 in the other order than its
    exact loop.  The port's fast and exact results equal the reference's
    fast and exact results field by field, the caveat included."""
    jcfg, tcfg = configs(model="vic", policy="fcfs", predictor="oracle",
                         n_nodes=3, batch_size=3, window=50,
                         preemption=dict(enabled=False),
                         placement="least_jobs", seed=2712, coalesce=True)
    jw, tw = workloads(2712, with_deadlines=True)
    jfast = JScale.ScaleSimulator(jcfg).run(jw)
    jexact = JScale.run_exact_reference(jcfg, jw)
    tfast = TScale.ScaleSimulator(tcfg).run(tw)
    texact = TScale.run_exact_reference(tcfg, tw)
    assert_same_arrays(tfast, jfast, "fast")
    assert_same_arrays(texact, jexact, "exact")
    assert not np.array_equal(tfast.finished_order, texact.finished_order)
    differ = np.nonzero(tfast.finished_order != texact.finished_order)[0]
    assert sorted(tfast.finished_order[differ].tolist()) == [17, 18]


# --------------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kw", [
    dict(predictor="bge"), dict(predictor="calibrated"),
    dict(policy="mlfq"), dict(rank_by="rank_score"), dict(rank_by="vibes"),
    dict(model="gpt-9"), dict(node_profiles={1: "gpt-9"}),
    dict(placement="random"), dict(prefill_chunk=0),
    dict(preemption=dict(policy="teleport")), dict(window=0),
], ids=["bge", "calibrated", "mlfq", "rank_score", "rank_by", "model",
        "node-profile", "placement", "chunk", "preempt", "window"])
def test_refusals_carry_the_reference_message(kw):
    jcfg, tcfg = configs(**kw)
    msgs = []
    for mod, cfg in ((TScale, tcfg), (JScale, jcfg)):
        with pytest.raises(ValueError) as e:
            mod.ScaleSimulator(cfg)
        msgs.append(str(e.value).replace("repro_torch.", "repro."))
    assert msgs[0] == msgs[1]
    if kw.get("predictor") == "bge" or kw.get("policy") == "mlfq" \
            or kw.get("rank_by") == "rank_score":
        assert "run_experiment" in msgs[0]


def test_config_defaults_and_profiles_match_reference():
    t = dataclasses.asdict(TScale.ScaleSimConfig())
    j = dataclasses.asdict(JScale.ScaleSimConfig())
    t.pop("preemption"), j.pop("preemption")
    assert t == j
    assert TScale._VECTOR_CUTOVER == JScale._VECTOR_CUTOVER
    cfg = TScale.ScaleSimConfig(model="vic", n_nodes=2, hw_speedup=2.0,
                                node_profiles={1: PROFILES["lam13"]})
    jcfg = JScale.ScaleSimConfig(model="vic", n_nodes=2, hw_speedup=2.0,
                                 node_profiles={1: "lam13"})
    assert [p.decode_ms(3) for p in cfg.profiles()] == \
        [p.decode_ms(3) for p in jcfg.profiles()]
