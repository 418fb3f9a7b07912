"""Tensor-parallel pods of the MoE family, and chunked prefill and KV swap
under a mesh, in the port against the JAX package on the CPU: the MoE
partition rules, ``local_config``'s MoE widths, the MoE block's rank
partials (routed once), prefill logits of TP pods, and TP engines, servers
and the serve CLI against the JAX *single-device* engine, server and CLI,
on the reduced qwen2-moe-a2.7b (4 experts top-2 and a shared MLP),
mixtral-8x7b (4 experts top-2, normalised weights, SWA) and qwen2-1.5b,
fp32.  Ranks are CPU devices listed once per rank.

The JAX TP engine is not the oracle: its own TP tests fail under the
installed JAX (ROADMAP.md, reference caveats), and the reference's
contract makes its TP and single-device engines token-identical
(``tests/test_sharded_engine.py``).

Tolerance: 2e-5 abs + rel on fp32 outputs and logits (each rank's partial
rounds once before the ranks add, in rank order); routing indices,
lengths, stashed cache rows and tokens are compared exactly.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

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
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch.partition import param_pspecs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ElisServer, FrontendConfig, Job,  # noqa: E402
                              OraclePredictor, PreemptionConfig, Request,
                              SchedulerConfig)
from repro_torch.engine import (EngineConfig, EngineExecutor,  # noqa: E402
                                InferenceEngine, make_tp_pods)
from repro_torch.engine.engine import _gather_slots, _leaves  # noqa: E402
from repro_torch.launch import make_mesh, shard_params  # noqa: E402
from repro_torch.launch import partition as P  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-5
MOE = "qwen2-moe-a2.7b"
MOE_ARCHS = [MOE, "mixtral-8x7b"]
DENSE = "qwen2-1.5b"
ECFG = dict(max_slots=2, max_len=128, max_output=64, eos_id=-1)
#: mixtral's published window: with ``max_len`` 128 its caches stay
#: linear, so chunks and the decode kernel run with ``window`` set (the
#: reduced window, 64, would make them rings, which chunks refuse)
WINDOW = 4096


def cpu_mesh(tp):
    return make_mesh((tp,), ("model",), devices=["cpu"] * tp)


_SETUPS = {}


def _setup(arch, window=None):
    """(JAX config, port config, JAX params, port params) of the reduced
    ``arch`` (its window set to ``window`` when given): one parameter
    tree for both packages, the reference init with the layer weights
    scaled by 3, so that greedy streams do not settle on one repeated
    token."""
    key = (arch, window)
    if key not in _SETUPS:
        jcfg = jax_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        if window is not None:
            jcfg = dataclasses.replace(jcfg, swa_window=window)
            cfg = dataclasses.replace(cfg, swa_window=window)
        tree = jax.tree_util.tree_map(
            np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
        layers = tree["layers"]
        groups = [layers["attn"]]
        if "moe" in layers:
            groups += [layers["moe"], layers["moe"].get("shared", {})]
        else:
            groups.append(layers["mlp"])
        for group in groups:
            for name in group:
                if name.startswith("w"):
                    group[name] = group[name] * np.float32(3.0)
        _SETUPS[key] = (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                        params_from_numpy(tree, "cpu"))
    return _SETUPS[key]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _prompt(i, n):
    rng = np.random.RandomState(100 + i)
    return [int(t) for t in rng.randint(8, 512, size=n)]


def _job(job_cls, i, prompt):
    return job_cls(job_id=i, prompt=f"p{i}", prompt_tokens=list(prompt),
                   arrival_time=0.0)


def _drive(eng, job, n_out, chunk=None, window=4):
    """Run one job until it has ``n_out`` tokens; returns the stream."""
    out = []
    for _ in range(64):
        toks, _ = eng.run_window([job], window, prefill_chunk=chunk)
        job.generated.extend(toks[0])
        out.extend(toks[0])
        if len(out) >= n_out:
            break
    return out[:n_out]


def _leaf_paths(tree, names=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, names + (k,))
    else:
        yield names, tree


def _get(tree, names):
    for k in names:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------- #
# Partition rules
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_shard_concat_round_trip_every_moe_leaf(arch, tp):
    """Every leaf comes back from its shards: split leaves by concatenation
    along the axis the reference's ``param_pspecs`` (its baseline
    "tensor" scheme) puts on "model", replicated leaves (the router, the
    shared gate, the norms) on every rank."""
    jcfg, cfg, _, params = _setup(arch)
    shards = shard_params(params, cfg, cpu_mesh(tp))
    specs = param_pspecs(jcfg)
    per_kv = max(tp // cfg.n_kv_heads, 1)  # ranks reading one KV head
    split = set()
    for names, leaf in _leaf_paths(params):
        pieces = [_get(s, names) for s in shards]
        spec = tuple(_get(specs, names))
        spec = (None,) * (leaf.ndim - len(spec)) + spec
        if "model" not in spec:
            assert all(torch.equal(p, leaf) for p in pieces), names
            continue
        axis = spec.index("model")
        split.add(names[1:] if names[0] == "layers" else names)
        if names[-1] in ("wk", "wv", "bk", "bv"):
            pieces = pieces[::per_kv]
        assert all(p.shape[axis] * len(pieces) == leaf.shape[axis]
                   and p.is_contiguous() for p in pieces), names
        assert torch.equal(torch.cat(pieces, dim=axis), leaf), names
    moe = {("moe", "w_gate"), ("moe", "w_up"), ("moe", "w_down")}
    if cfg.moe.num_shared_experts:
        moe |= {("moe", "shared", w) for w in ("w_gate", "w_up", "w_down")}
    assert moe <= split
    assert not {("moe", "router"), ("moe", "shared", "gate")} & split


def test_moe_leaf_with_no_rule_raises():
    """A leaf under ``moe`` with no rule raises ``KeyError`` naming its
    path, as the reference's ``param_pspecs`` does."""
    _, cfg, _, params = _setup(MOE)
    layers = dict(params["layers"],
                  moe=dict(params["layers"]["moe"], mystery=torch.zeros(4)))
    with pytest.raises(KeyError, match="mystery"):
        shard_params(dict(params, layers=layers), cfg, cpu_mesh(2))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_local_config_divides_the_moe_widths(arch):
    """Each rank computes with 1/tp of the experts' and the shared path's
    hidden axes (mixtral's shared width 0 stays 0); a width that does not
    divide raises ``ValueError`` and builds no shards."""
    _, cfg, _, params = _setup(arch)
    m = cfg.moe
    for tp in (2, 4):
        lm = P.local_config(cfg, tp).moe
        assert (lm.expert_d_ff, lm.shared_d_ff) == (m.expert_d_ff // tp,
                                                     m.shared_d_ff // tp)
        assert (lm.num_experts, lm.top_k, lm.norm_topk_prob) == (
            m.num_experts, m.top_k, m.norm_topk_prob)
    bad = [("expert_d_ff", 6)] + ([("shared_d_ff", 10)]
                                  if m.num_shared_experts else [])
    for field, width in bad:
        odd = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, **{field: width}))
        with pytest.raises(ValueError, match=f"moe.{field}={width}"):
            P.local_config(odd, 4)
        with pytest.raises(ValueError, match=field):
            InferenceEngine(odd, params, EngineConfig(**ECFG),
                            mesh=cpu_mesh(4))


# --------------------------------------------------------------------------- #
# The MoE block's rank partials
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("impl", ["dense", "grouped"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_partials_sum_to_the_jax_block(arch, impl, tp, monkeypatch):
    """Layer 0's MoE block over ``tp`` ranks: the partials, summed in rank
    order, equal the JAX block within 2e-5; the router ran once, and every
    rank computed with the same expert indices (on integer-valued tokens,
    whose router logits tie often, and on random ones)."""
    jcfg, cfg, jp, params = _setup(arch)
    lcfg = P.local_config(cfg, tp)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    ranks = [T._unstack(s["layers"]["moe"], cfg.n_layers)[0]
             for s in shard_params(params, cfg, cpu_mesh(tp))]
    routed, calls = [], []
    router, per_rank = M.router_probs, M._routed

    def counted(*a):
        calls.append(1)
        return router(*a)

    def logged(p, x, routing):
        routed.append(routing)
        return per_rank(p, x, routing)

    monkeypatch.setattr(M, "router_probs", counted)
    monkeypatch.setattr(M, "_routed", logged)
    rng = np.random.RandomState(7)
    for x in (rng.randint(-2, 3, size=(3, 8, cfg.d_model)) / 4.0,
              rng.randn(2, 5, cfg.d_model)):
        x = x.astype(np.float32)
        calls.clear()
        routed.clear()
        parts = M.moe_partials(ranks, lcfg, [torch.as_tensor(x)] * tp,
                               impl=impl)
        assert len(calls) == 1 and len(parts) == len(routed) == tp
        for r in routed[1:]:
            assert torch.equal(r.topk_i, routed[0].topk_i)
            assert torch.equal(r.topk_w, routed[0].topk_w)
        assert (routed[0].combine is None) == (impl == "grouped")
        want, _ = JM.moe_block(jl, jcfg, jnp.asarray(x), impl=impl)
        _close(T._all_reduce(parts)[0], want)


# --------------------------------------------------------------------------- #
# The TP model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_tp_prefill_logits_match_jax(arch, tp):
    """Prefill logits of an MoE TP pod (right-padded batch, per-row last
    index) against the JAX single-device prefill within 2e-5; two runs
    agree bit for bit, and each rank's cache holds its own KV heads."""
    jcfg, cfg, jp, params = _setup(arch)
    rng = np.random.RandomState(tp)
    toks = rng.randint(0, cfg.vocab_size, size=(3, 24)).astype(np.int32)
    last = np.asarray([23, 4, 11], np.int32)
    mesh = cpu_mesh(tp)
    shards = shard_params(params, cfg, mesh)
    runs = []
    for _ in range(2):
        caches = T.init_cache(cfg, 3, 64, mesh=mesh)
        logits, caches = T.prefill(
            shards, cfg, {"tokens": torch.as_tensor(toks)}, caches,
            attn_impl="torch", last_index=torch.as_tensor(last), mesh=mesh)
        runs.append(logits)
    assert torch.equal(runs[0], runs[1])
    jlogits, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                             JT.init_cache(jcfg, 3, 64),
                             last_index=jnp.asarray(last))
    _close(runs[0], jlogits)
    jk = np.asarray(jc["kv"].k)
    for r, c in enumerate(caches):
        lo, hi = P.kv_head_range(cfg, tp, r)
        _close(c["kv"].k, jk[:, :, :, lo:hi])


# --------------------------------------------------------------------------- #
# TP engines against the JAX single-device engine
# --------------------------------------------------------------------------- #


def _two_windows(eng, job_cls):
    """A compacted window of two jobs, then a batched admission of the
    third and a full-width window (``test_sharded_engine._run_identity``);
    returns the tokens."""
    jobs = [_job(job_cls, i, p) for i, p in
            enumerate([[11, 22, 33, 44], [9, 8, 7], [301, 302, 303, 304,
                                                    305]])]
    t1, _ = eng.run_window(jobs[:2], 6)
    for j, t in zip(jobs, t1):
        j.generated.extend(t)
    t2, _ = eng.run_window(jobs, 5)
    return t1, t2


@pytest.mark.parametrize("impl", [("torch", "xla"), ("kernel", "pallas")])
def test_moe_tp2_token_identity_with_jax_single_device(impl):
    """``test_sharded_token_identity_tp2`` and ``test_pallas_token_identity_
    tp2`` for qwen2-moe-a2.7b: a compacted window, then a batched
    admission at full width; tokens identical to the JAX single-device
    engine's, both ranks' ``len`` equal to its ``len``."""
    jcfg, cfg, jp, params = _setup(MOE)
    timpl, jimpl = impl
    kw = dict(max_slots=4, max_len=128, max_output=64, eos_id=-1)
    eng = InferenceEngine(cfg, params, EngineConfig(attn_impl=timpl, **kw),
                          mesh=cpu_mesh(2))
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl=jimpl, **kw))
    got, want = _two_windows(eng, Job), _two_windows(jeng, JaxJob)
    assert got == want
    assert [c["len"].tolist() for c in eng.cache] == [
        np.asarray(jeng.cache["len"]).tolist()] * 2
    assert len(set(got[1][1])) > 1  # not a degenerate stream


def test_moe_preempt_resume_identical_under_tp2():
    """Evict and recompute-resume on an MoE TP=2 engine (one slot): tokens
    and resume cost as the JAX single-device engine's."""
    jcfg, cfg, jp, params = _setup(MOE)
    kw = dict(ECFG, max_slots=1)
    out = {}
    for name, eng, job_cls in (
            ("jax", JaxEngine(jcfg, jp, JaxEngineConfig(**kw)), JaxJob),
            ("tp2", InferenceEngine(cfg, params, EngineConfig(**kw),
                                    mesh=cpu_mesh(2)), Job)):
        job = _job(job_cls, 0, [5, 6, 7])
        t1, _ = eng.run_window([job], 5)
        job.generated.extend(t1[0])
        eng.evict_job(job.job_id)
        t2, _ = eng.run_window([job], 5)
        out[name] = (t1[0] + t2[0], eng.resume_context_tokens)
    assert out["tp2"] == out["jax"]


#: (arch, window, port attn_impl, ranks): the dense and MoE families with
#: the plain decode, with the kernels' plain versions between the chunks
#: (``test_chunked_prefill_identity_under_tp2_pallas``), mixtral with its
#: window set, and 4 ranks over 2 KV heads (each rank writes the one it
#: reads)
CHUNK_CASES = [(DENSE, None, "torch", 2), (MOE, None, "torch", 2),
               (DENSE, None, "kernel", 2), (MOE, None, "kernel", 2),
               ("mixtral-8x7b", WINDOW, "kernel", 2), (MOE, None, "kernel", 4)]


@pytest.mark.parametrize("arch,window,impl,tp", CHUNK_CASES)
def test_chunked_prefill_under_tp_matches_jax_oneshot(arch, window, impl,
                                                      tp):
    """``test_chunked_prefill_identity_under_tp2``: chunks of 6 on a TP
    pod give the JAX single-device one-shot engine's greedy tokens, with
    at least 4 chunk dispatches and no fallback; every rank's ``len``
    follows."""
    jcfg, cfg, jp, params = _setup(arch, window)
    prompt = [11 + k % 60 for k in range(23)]
    want = _drive(JaxEngine(jcfg, jp, JaxEngineConfig(**ECFG)),
                  _job(JaxJob, 0, prompt), 8)
    eng = InferenceEngine(cfg, params, EngineConfig(attn_impl=impl, **ECFG),
                          mesh=cpu_mesh(tp))
    assert eng.chunk_supported()
    got = _drive(eng, _job(Job, 0, prompt), 8, chunk=6)
    assert got == want
    assert eng.num_chunk_dispatches >= 4
    assert [c["len"][eng.slot_of[0]].item() for c in eng.cache] == [
        len(prompt) + 8 - 1] * tp


def _slot_rows(eng, job_id):
    """Every rank's copy of the job's slot rows: [rank][leaf]."""
    slot = torch.tensor([eng.slot_of[job_id]])
    return [[t.clone() for t in _leaves(_gather_slots(c, slot))]
            for c in eng.cache]


def _same_rows(a, b):
    return len(a) == len(b) and all(
        len(x) == len(y) and all(torch.equal(s, t) for s, t in zip(x, y))
        for x, y in zip(a, b))


@pytest.mark.parametrize("arch,tp", [(DENSE, 2), (MOE, 2), (MOE, 4)])
def test_swap_roundtrip_bit_exact_under_tp(arch, tp):
    """``test_swap_roundtrip_bit_exact_under_tp2``: offload a decoding job,
    run another in its freed slot, restore: every rank's slot rows come
    back bit for bit (at TP=4, ranks 0-1 and 2-3 each hold their one KV
    head), and the streams equal the JAX single-device engine's over the
    same schedule, with nothing recomputed."""
    jcfg, cfg, jp, params = _setup(arch)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ECFG))
    eng = InferenceEngine(cfg, params, EngineConfig(**ECFG),
                          mesh=cpu_mesh(tp))
    pairs = [(_job(JaxJob, i, _prompt(i, n)), _job(Job, i, _prompt(i, n)))
             for i, n in ((4, 9), (5, 7))]

    def both(batch, window=5):
        jt, _ = jeng.run_window([j for j, _ in batch], window)
        tt, _ = eng.run_window([t for _, t in batch], window)
        assert tt == jt
        for (jj, tj), t in zip(batch, tt):
            jj.generated.extend(t)
            tj.generated.extend(t)

    both(pairs)
    (j0, t0), (j1, t1) = pairs
    before = _slot_rows(eng, 4)
    assert len(before) == tp
    if tp == 4:
        k = [rows[1] for rows in before]  # each rank's K rows
        assert all(x.shape[3] == 1 for x in k)
        assert not torch.equal(k[0], k[2])
    assert eng.offload_job(4) and jeng.offload_job(4)
    assert eng.has_stash(4) and not eng.has_job(4)
    assert len(eng._host_stash[4]["cache"]) == tp
    both([(j1, t1)])  # overwrites the freed slot: the stash is a copy
    eng.restore_job(t0)
    jeng.restore_job(j0)
    assert _same_rows(_slot_rows(eng, 4), before)
    both(pairs)
    assert eng.resume_context_tokens == jeng.resume_context_tokens == 0


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_swap_midprefill_roundtrip_under_tp2(arch):
    """A job offloaded between two chunks keeps its chunk cursor and every
    rank's rows: restored, it finishes prefill and decodes the JAX
    single-device one-shot stream."""
    jcfg, cfg, jp, params = _setup(arch)
    prompt = _prompt(0, 21)
    want = _drive(JaxEngine(jcfg, jp, JaxEngineConfig(**ECFG)),
                  _job(JaxJob, 0, prompt), 12)
    eng = InferenceEngine(cfg, params, EngineConfig(**ECFG),
                          mesh=cpu_mesh(2))
    job = _job(Job, 0, prompt)
    eng.run_window([job], 3, prefill_chunk=6)
    assert eng.prefill_incomplete(0) and eng._prefill_cursor[0] == 6
    before = _slot_rows(eng, 0)
    assert eng.offload_job(0)
    other = _job(Job, 1, _prompt(1, 30))
    eng.run_window([other], 3, prefill_chunk=6)  # writes the freed slot
    eng.evict_job(1)
    eng.restore_job(job)
    assert eng._prefill_cursor[0] == 6
    assert _same_rows(_slot_rows(eng, 0), before)
    assert _drive(eng, job, 12, chunk=6, window=3) == want


# --------------------------------------------------------------------------- #
# Servers and the CLI
# --------------------------------------------------------------------------- #


def _serve(server_cls, cfg_cls, sched_cls, preemption, oracle_cls, req_cls,
           executor, requests):
    server = server_cls(
        cfg_cls(n_nodes=2,
                scheduler=sched_cls(policy="isrtf", window=4, batch_size=2,
                                    prefill_chunk=8),
                preemption=preemption, observe_in_flight=False),
        oracle_cls(), executor)
    for r in requests:
        server.submit(req_cls(**r))
    return {r.request_id: (r.status.value, r.tokens, r.n_preemptions)
            for r in server.drain()}


def test_server_over_moe_tp_pods_matches_jax_server():
    """``ElisServer`` with ISRTF, chunked prefill and swap preemption over
    two MoE TP=2 pods: two long requests a pod run, short ones arrive and
    preempt them (``test_torch_serve``'s traffic, twice, with outputs and
    the preemption margin cut to keep the test short).  Request by
    request, the streams of the JAX server over two single-device
    engines; the pods swap out and in and recompute nothing."""
    jcfg, cfg, jp, params = _setup(MOE)
    rng = np.random.RandomState(5)
    specs = [(0.0, 20, 24), (0.0, 17, 24), (0.0, 9, 24), (0.0, 12, 24),
             (1e-4, 6, 4), (2e-4, 9, 6), (3e-4, 5, 5), (4e-4, 7, 4)]
    requests = [dict(prompt=f"r{i}", request_id=i, arrival_time=t,
                     prompt_tokens=[int(x) for x in rng.randint(8, 512, p)],
                     true_output_len=n)
                for i, (t, p, n) in enumerate(specs)]
    kw = dict(max_slots=2, max_len=128, max_output=32, eos_id=-1,
              respect_job_max=True)
    executor = EngineExecutor(make_tp_pods(cfg, params, EngineConfig(**kw),
                                           n_pods=2, tp=2,
                                           devices=["cpu"] * 4))
    got = _serve(ElisServer, FrontendConfig, SchedulerConfig,
                 PreemptionConfig(enabled=True, policy="swap", margin=8.0),
                 OraclePredictor, Request, executor, requests)
    want = _serve(JaxServer, JaxFrontendConfig, JaxSchedulerConfig,
                  JaxPreemptionConfig(enabled=True, policy="swap",
                                      margin=8.0),
                  JaxOracle, JaxRequest,
                  JaxExecutor({n: JaxEngine(jcfg, jp, JaxEngineConfig(**kw))
                               for n in range(2)}), requests)
    assert got == want
    assert all(status == "finished" for status, _, _ in got.values())
    c = executor.counters()
    assert c["swapouts"] > 0 and c["swapins"] == c["swapouts"]
    assert c["chunk_dispatches"] > 0 and c["resume_context_tokens"] == 0


def _cli(main, argv, capsys, monkeypatch=None):
    """(per-request (request_id, status, n_tokens), stderr) of one CLI
    run; the JAX ``main`` reads ``sys.argv``."""
    import json
    import sys

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
    ["--n", "5", "--max-output", "16", "--rate", "20", "--arch", MOE,
     "--prefill-chunk", "8"],
    ["--n", "5", "--max-output", "16", "--rate", "20", "--preempt-policy",
     "swap"],
], ids=["moe-chunk", "swap"])
def test_main_mesh_matches_jax_cli(argv, capsys, monkeypatch):
    """``--mesh 1x2`` (one TP=2 pod of CPU ranks) with chunked prefill or
    swap preemption: request by request the status and token count of
    the JAX CLI on one device (its TP path fails under the installed
    JAX); the chunks ran.  (Whether the traffic preempts depends on the
    host clock; the engine and server tests above drive the swaps.)"""
    got, err = _cli(serve.main, argv + ["--mesh", "1x2", "--device", "cpu"],
                    capsys)
    want, _ = _cli(jax_serve.main, argv, capsys, monkeypatch)
    assert got == want
    assert "1 TP=2 pod(s)" in err and "(5/5 finished)" in err
    if "--prefill-chunk" in argv:
        assert "chunk_dispatches=" in err
        assert "chunk_dispatches=0 " not in err
