"""Tensor-parallel pods of the SSM and hybrid families in the port against
the JAX package on the CPU: the per-rank split of the Mamba2 leaves (the
packed ``in_proj`` and conv columns included), the Mamba2 block's rank
partials against the JAX block, prefill logits of SSM and hybrid pods,
and pod engines, servers and the serve CLI against the JAX
*single-device* engine, server and CLI, on the reduced mamba2-130m (8 SSM
heads of 32, (P, N) = (32, 16)) and zamba2-7b (the same SSD widths, 4/2
attention heads), fp32, at TP = 2 and 4.  Ranks are CPU devices listed
once per rank.

The JAX TP engine is not the oracle: its own TP tests fail under the
installed JAX (ROADMAP.md, reference caveats), and the reference's
contract makes its TP and single-device engines token-identical.

Tolerance: 2e-5 abs + rel on fp32 outputs, states and logits (each
rank's sum of squares and its ``out_proj`` partial round once before the
ranks add, in rank order); split leaves, lengths, stashed cache rows and
tokens are compared exactly.
"""
import dataclasses
import importlib.util
import json
import re
import sys
from contextlib import nullcontext
from pathlib import Path

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
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ElisServer, FrontendConfig, Job,  # noqa: E402
                              OraclePredictor, PreemptionConfig, Request,
                              SchedulerConfig)
from repro_torch.engine import (EngineConfig, EngineExecutor,  # noqa: E402
                                InferenceEngine, make_tp_pods)
from repro_torch.engine.engine import _gather_slots, _leaves  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import make_mesh, shard_params  # noqa: E402
from repro_torch.launch import partition as P  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-5
SSM, HYBRID = "mamba2-130m", "zamba2-7b"
ARCHS = [SSM, HYBRID]
ECFG = dict(max_slots=2, max_len=64, max_output=64, eos_id=-1)
#: (JAX impl, port impl): the Pallas scan in interpret mode against the
#: port's kernel wrapper (its plain version on CPU tensors), and the plain
#: paths
IMPLS = [("pallas", "kernel"), ("xla", "torch")]
#: packed leaves and the axis (from the end) their columns lie on
PACKED = {"in_proj": -1, "conv_w": -2, "conv_b": -1}


def cpu_mesh(tp):
    return make_mesh((tp,), ("model",), devices=["cpu"] * tp)


_SETUPS = {}


def _setup(arch, **ssm):
    """(JAX config, port config, JAX params, port params) of the reduced
    ``arch``, its SSM config replaced by ``ssm``: one parameter tree for
    both packages (the reference init)."""
    key = (arch, tuple(sorted(ssm.items())))
    if key not in _SETUPS:
        jcfg = jax_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        if ssm:
            jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
                jcfg.ssm, **ssm))
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, **ssm))
        tree = jax.tree_util.tree_map(
            np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
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


def _blocks(cfg, name):
    """The packed blocks of ``name`` in order, (label, width, split by
    head?): ``in_proj`` is [z | x | B | C | dt], the conv leaves [x | B |
    C]; B and C are whole on every rank with one group."""
    di, gn = cfg.ssm_d_inner, cfg.ssm.n_groups * cfg.ssm.d_state
    split_groups = cfg.ssm.n_groups > 1
    conv = [("x", di, True), ("B", gn, split_groups),
            ("C", gn, split_groups)]
    if name == "in_proj":
        return [("z", di, True)] + conv + [("dt", cfg.ssm_n_heads, True)]
    return conv


def _unpack(t, axis, blocks, tp=1):
    """Split ``t`` (a whole leaf, or with ``tp`` a rank's piece) along
    ``axis`` into its named blocks."""
    widths = [w // tp if split else w for _, w, split in blocks]
    return dict(zip([b[0] for b in blocks], t.split(widths, dim=axis)))


# --------------------------------------------------------------------------- #
# Partition rules
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_concat_round_trip_every_ssm_and_hybrid_leaf(arch, tp):
    """Every leaf comes back from its shards.  The packed ``in_proj`` and
    conv leaves: rank r's piece is [z_r | x_r | B | C | dt_r] ([x_r | B |
    C] for the conv), each head block the concatenation of the ranks'
    pieces in rank order and B / C whole on every rank.  The other split
    leaves concatenate along the axis the reference's ``param_pspecs``
    puts on "model"; replicated leaves (the layers' pre-norm ``scale``
    among them) are whole on every rank."""
    jcfg, cfg, _, params = _setup(arch)
    shards = shard_params(params, cfg, cpu_mesh(tp))
    specs = param_pspecs(jcfg)
    per_kv = max(tp // max(cfg.n_kv_heads, 1), 1)
    packed, split = set(), set()
    for names, leaf in _leaf_paths(params):
        pieces = [_get(s, names) for s in shards]
        if names[-1] in PACKED:
            axis = leaf.ndim + PACKED[names[-1]]
            blocks = _blocks(cfg, names[-1])
            whole = _unpack(leaf, axis, blocks)
            parts = [_unpack(p, axis, blocks, tp) for p in pieces]
            for label, _, by_head in blocks:
                if by_head:
                    got = torch.cat([p[label] for p in parts], dim=axis)
                    assert torch.equal(got, whole[label]), (names, label)
                else:
                    assert all(torch.equal(p[label], whole[label])
                               for p in parts), (names, label)
            packed.add(names[-1])
            continue
        spec = tuple(_get(specs, names))
        spec = (None,) * (leaf.ndim - len(spec)) + spec
        if "model" not in spec:
            assert all(torch.equal(p, leaf) for p in pieces), names
            continue
        axis = spec.index("model")
        split.add(names[-1])
        if names[-1] in ("wk", "wv", "bk", "bv"):
            pieces = pieces[::per_kv]
        assert all(p.shape[axis] * len(pieces) == leaf.shape[axis]
                   and p.is_contiguous() for p in pieces), names
        assert torch.equal(torch.cat(pieces, dim=axis), leaf), names
    assert packed == set(PACKED)
    assert {"A_log", "dt_bias", "D", "norm", "out_proj"} <= split
    assert "scale" not in split
    if arch == HYBRID:
        assert {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"} <= split


def test_ssm_columns_pin_the_packed_order():
    """On a leaf whose entries are their own column numbers, rank 1 of 2
    holds exactly z's, x's and dt's second halves around B and C whole,
    in that order (a contiguous split would give it half of x and all of
    B, C and dt with no error, since the shapes still fit)."""
    _, cfg, _, _ = _setup(SSM)
    di, gn, nh = cfg.ssm_d_inner, cfg.ssm.d_state, cfg.ssm_n_heads
    h = di // 2
    want = list(range(h, di)) + list(range(di + h, 2 * di)) + list(
        range(2 * di, 2 * di + 2 * gn)) + list(
        range(2 * di + 2 * gn + nh // 2, 2 * di + 2 * gn + nh))
    assert P.ssm_columns(cfg, 2, 1).tolist() == want
    conv = list(range(h, di)) + list(range(di, di + 2 * gn))
    assert P.ssm_columns(cfg, 2, 1, conv=True).tolist() == conv
    assert P.ssm_columns(cfg, 1, 0).tolist() == list(
        range(2 * di + 2 * gn + nh))


def test_ssm_widths_and_the_layouts_the_port_refuses():
    """A rank's widths: its share of the heads, B and C whole with one
    group and split with groups that divide; heads or groups that do not
    divide raise ``ValueError`` naming the layout, from ``local_config``
    and the engine too, before any shard is built."""
    _, cfg, _, params = _setup(SSM)
    assert P.ssm_widths(cfg, 4) == P.SSMWidths(2, 64, 1)
    assert S.conv_channels(cfg, 4) == 64 + 2 * cfg.ssm.d_state
    two = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           n_groups=2))
    assert P.ssm_widths(two, 2) == P.SSMWidths(4, 128, 1)
    with pytest.raises(ValueError, match="layout: 2 SSM groups"):
        P.local_config(two, 4)
    with pytest.raises(ValueError, match="layout: 8 SSM heads"):
        P.local_config(cfg, 3)
    with pytest.raises(ValueError, match="layout: 8 SSM heads"):
        InferenceEngine(cfg, params, EngineConfig(**ECFG),
                        mesh=make_mesh((3,), ("model",),
                                       devices=["cpu"] * 3))


def test_tp_serves_the_ssm_and_hybrid_families_only_vlm_audio_refused():
    """``check_family`` passes the SSM and hybrid families, and the vlm and
    audio families too now (ROADMAP.md queue 1, item 8.2, landed;
    ``tests/test_torch_tp_vlm_audio.py``): it refuses only a family with
    no TP design.  The sharded decode kernel serves the hybrid's shared
    block (32/32 heads) and keeps its ``family:`` reason for the SSM."""
    for arch in ARCHS + ["qwen2-vl-7b", "whisper-large-v3"]:
        P.check_family(get_config(arch))
    with pytest.raises(NotImplementedError, match="no TP design"):
        P.check_family(dataclasses.replace(get_config(SSM), family="other"))
    for tp in (2, 4):
        mesh = cpu_mesh(tp)
        assert P.kernel_decode_support(get_config(HYBRID), mesh) is None
        assert P.kernel_decode_support(get_config(SSM), mesh).startswith(
            "family: ssm")


# --------------------------------------------------------------------------- #
# The Mamba2 block's rank partials
# --------------------------------------------------------------------------- #


def _rank_layers(params, cfg, tp, i):
    return [T._unstack(s["layers"], cfg.n_layers)[i]["ssm"]
            for s in shard_params(params, cfg, cpu_mesh(tp))]


@pytest.mark.parametrize("jimpl,timpl,tp", [IMPLS[0] + (2,),
                                            IMPLS[1] + (4,)])
def test_ssm_partials_sum_to_the_jax_block(jimpl, timpl, tp):
    """Layer 0's Mamba2 block over ``tp`` ranks, S = 45 (one chunk of 32
    and a padded second): the partials, summed in rank order, equal the
    JAX block within 2e-5, and each rank's decode state equals the JAX
    state's columns of its conv channels and its heads."""
    jcfg, cfg, jp, params = _setup(SSM)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["ssm"])
    x = np.random.RandomState(tp).randn(2, 45, cfg.d_model).astype(
        np.float32)
    parts, states = S.ssm_partials(_rank_layers(params, cfg, tp, 0), cfg,
                                   [torch.as_tensor(x)] * tp, impl=timpl)
    jout, jst = JS.ssm_forward(jl, jcfg, jnp.asarray(x), impl=jimpl,
                               return_state=True)
    _close(T._all_reduce(parts)[0], jout)
    h = cfg.ssm_n_heads // tp
    for r, st in enumerate(states):
        cols = P.ssm_columns(cfg, tp, r, conv=True).numpy()
        _close(st["conv"], np.asarray(jst["conv"])[:, cols])
        _close(st["ssm"], np.asarray(jst["ssm"])[:, r * h:(r + 1) * h])


@pytest.mark.parametrize("arch,groups,tp", [(SSM, 1, 2), (SSM, 1, 4),
                                            (SSM, 2, 2), (HYBRID, 1, 4)])
def test_ssm_decode_partials_sum_to_the_jax_step(arch, groups, tp):
    """Layer 1's recurrent step over ``tp`` ranks from a random state: the
    partials sum to the JAX step within 2e-5, each rank's new state is
    the JAX state's slice, and the states given are left as they were;
    with two groups each rank of two holds its own B and C."""
    jcfg, cfg, jp, params = _setup(arch, n_groups=groups)
    shards = shard_params(params, cfg, cpu_mesh(tp))
    if arch == HYBRID:  # group 0's second layer
        jl = jax.tree_util.tree_map(lambda a: a[0, 1], jp["groups"]["ssm"])
        ranks = [T._hybrid_layers(s, cfg)[0][0][1]["ssm"] for s in shards]
    else:
        jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["ssm"])
        ranks = [T._unstack(s["layers"], cfg.n_layers)[1]["ssm"]
                 for s in shards]
    rng = np.random.RandomState(5)
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    conv = rng.randn(3, S.conv_channels(cfg), 3).astype(np.float32)
    ssm = rng.randn(3, cfg.ssm_n_heads, 32, 16).astype(np.float32)
    h = cfg.ssm_n_heads // tp
    states = [{"conv": torch.as_tensor(
        conv[:, P.ssm_columns(cfg, tp, r, conv=True).numpy()]),
        "ssm": torch.as_tensor(ssm[:, r * h:(r + 1) * h].copy())}
        for r in range(tp)]
    before = [{k: v.clone() for k, v in st.items()} for st in states]
    parts, news = S.ssm_decode_partials(ranks, cfg,
                                        [torch.as_tensor(x)] * tp, states)
    jout, jst = JS.ssm_decode_step(jl, jcfg, jnp.asarray(x),
                                   {"conv": jnp.asarray(conv),
                                    "ssm": jnp.asarray(ssm)})
    _close(T._all_reduce(parts)[0], jout)
    for r, (new, st, old) in enumerate(zip(news, states, before)):
        cols = P.ssm_columns(cfg, tp, r, conv=True).numpy()
        _close(new["conv"], np.asarray(jst["conv"])[:, cols])
        _close(new["ssm"], np.asarray(jst["ssm"])[:, r * h:(r + 1) * h])
        assert all(torch.equal(st[k], old[k]) for k in st)


def test_a_rank_local_norm_is_caught():
    """``chip_smoke.py``'s ``rank_local_norm`` fault (each rank normalises
    over its own slice of ``d_inner``) moves the block's output far past
    the tolerance, so the partials check above catches it; the correct
    partials pass."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    jcfg, cfg, jp, params = _setup(SSM)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["ssm"])
    x = np.random.RandomState(2).randn(1, 20, cfg.d_model).astype(
        np.float32)
    want = np.asarray(JS.ssm_forward(jl, jcfg, jnp.asarray(x),
                                     impl="xla")[0])
    ranks = _rank_layers(params, cfg, 2, 0)
    args = (ranks, cfg, [torch.as_tensor(x)] * 2)
    _close(T._all_reduce(S.ssm_partials(*args, impl="torch")[0])[0], want)
    with chip_smoke.rank_local_norm():
        got = T._all_reduce(S.ssm_partials(*args, impl="torch")[0])[0]
    assert float(np.abs(got.numpy() - want).max()) > 100 * TOL


# --------------------------------------------------------------------------- #
# The TP model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_logits_and_states_match_jax(arch, tp, monkeypatch):
    """Prefill logits of a pod (two 40-token prompts, per-row last index)
    against the JAX single-device prefill within 2e-5; two runs agree bit
    for bit; ``ssd_scan`` ran on each rank's heads once a layer (and the
    hybrid's ``flash_attention`` once a site a rank); each rank's states
    are the JAX states' slices and its K/V the KV heads it reads."""
    jcfg, cfg, jp, params = _setup(arch)
    toks = np.random.RandomState(tp).randint(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    last = np.asarray([39, 17], np.int32)
    mesh = cpu_mesh(tp)
    shards = shard_params(params, cfg, mesh)
    calls = {"ssd_scan": [], "flash_attention": []}
    for name in calls:
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls[_n].append(a[0].shape[2]), _fn(*a, **kw))[1])
    runs = []
    for _ in range(2):
        caches = T.init_cache(cfg, 2, 64, mesh=mesh)
        logits, caches = T.prefill(
            shards, cfg, {"tokens": torch.as_tensor(toks)}, caches,
            last_index=torch.as_tensor(last), mesh=mesh)
        runs.append(logits)
    assert torch.equal(runs[0], runs[1])
    h = cfg.ssm_n_heads // tp
    assert calls["ssd_scan"] == [h] * (2 * cfg.n_layers * tp)
    sites = T.hybrid_layout(cfg)[0] if arch == HYBRID else 0
    assert calls["flash_attention"] == [cfg.n_heads // tp] * (2 * sites * tp)
    jlogits, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                             JT.init_cache(jcfg, 2, 64), attn_impl="xla",
                             last_index=jnp.asarray(last))
    _close(runs[0], jlogits)
    key = "groups_ssm" if arch == HYBRID else "ssm"
    for r, c in enumerate(caches):
        cols = P.ssm_columns(cfg, tp, r, conv=True).numpy()
        _close(c[key]["conv"], np.asarray(jc[key]["conv"])[..., cols, :])
        _close(c[key]["ssm"], np.asarray(jc[key]["ssm"])[
            ..., r * h:(r + 1) * h, :, :])
        if arch == HYBRID:
            lo, hi = P.kv_head_range(cfg, tp, r)
            _close(c["kv"].k, np.asarray(jc["kv"].k)[:, :, :, lo:hi])


# --------------------------------------------------------------------------- #
# Pod engines against the JAX single-device engine
# --------------------------------------------------------------------------- #


def _slot_rows(eng, job_id):
    """Every rank's copy of the job's slot rows: [rank][leaf]."""
    slot = torch.tensor([eng.slot_of[job_id]])
    return [[t.clone() for t in _leaves(_gather_slots(c, slot))]
            for c in eng.cache]


@pytest.mark.parametrize("arch,tp", [(SSM, 2), (SSM, 4), (HYBRID, 2)])
def test_pod_engine_matches_jax_engine(arch, tp):
    """Serial exact-length admissions, a compacted window, a recompute
    eviction, and a swap round trip whose every rank's slot rows (len,
    states, the hybrid's K/V) come back bit for bit: token for token the
    JAX single-device engine's, with its ``len`` on every rank and its
    dispatch counts.  Then the rollback caveat: a fresh job's stream over
    two windows is the JAX engine's (the pending-first rollback absorbs a
    token twice in both).  Prompt lengths repeat (job 0's recompute is 8
    tokens, as are jobs 2 and 3) to keep the JAX engine's compiles few."""
    jcfg, cfg, jp, params = _setup(arch)
    kw = dict(ECFG, max_slots=3)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="xla", **kw))
    eng = InferenceEngine(cfg, params, EngineConfig(**kw), mesh=cpu_mesh(tp))
    prompts = [_prompt(0, 5), _prompt(1, 21), _prompt(2, 8)]
    pairs = [(_job(JaxJob, i, p), _job(Job, i, p))
             for i, p in enumerate(prompts)]
    for w, ids in enumerate([[0, 1], [0, 1, 2], [0, 2], [0, 1, 2]]):
        if w == 1:  # preempt job 0: its slot is freed, resume recomputes
            jeng.evict_job(0)
            eng.evict_job(0)
        if w == 2:  # swap job 1 out to the host
            before = _slot_rows(eng, 1)
            assert jeng.offload_job(1) and eng.offload_job(1)
            assert len(eng._host_stash[1]["cache"]) == tp
        if w == 3:  # and back in, bit for bit on every rank
            assert jeng.restore_job(pairs[1][0]) == eng.restore_job(
                pairs[1][1])
            after = _slot_rows(eng, 1)
            assert len(after) == tp and all(
                len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
                for a, b in zip(after, before))
        jt, jf = jeng.run_window([pairs[i][0] for i in ids], 4)
        tt, tf = eng.run_window([pairs[i][1] for i in ids], 4)
        assert tt == jt and tf == jf, f"window {w}"
        for i, t in zip(ids, tt):
            pairs[i][0].generated.extend(t)
            pairs[i][1].generated.extend(t)
        assert [c["len"].tolist() for c in eng.cache] == [
            np.asarray(jeng.cache["len"]).tolist()] * tp
    assert len(set(pairs[1][1].generated)) > 1  # not a degenerate stream
    for attr in ("num_prefill_dispatches", "num_decode_dispatches",
                 "resume_context_tokens"):
        assert getattr(eng, attr) == getattr(jeng, attr), attr
    assert eng.num_prefill_dispatches == 4  # 3 admissions + 1 recompute
    # the pending-first rollback, on a fresh job in a free slot
    for e in (jeng, eng):
        for i in range(3):
            e.evict_job(i)
    streams = []
    for e, cls in ((jeng, JaxJob), (eng, Job)):
        job = _job(cls, 9, _prompt(3, 8))
        for _ in range(2):
            toks, _ = e.run_window([job], 4)
            job.generated.extend(toks[0])
        streams.append(job.generated)
    assert streams[0] == streams[1]


# --------------------------------------------------------------------------- #
# Servers and the CLI
# --------------------------------------------------------------------------- #


def _serve(server_cls, cfg_cls, sched_cls, preemption, oracle_cls, req_cls,
           executor, requests):
    server = server_cls(
        cfg_cls(n_nodes=2,
                scheduler=sched_cls(policy="isrtf", window=4, batch_size=2),
                preemption=preemption, observe_in_flight=False),
        oracle_cls(), executor)
    for r in requests:
        server.submit(req_cls(**r))
    return {r.request_id: (r.status.value, r.tokens, r.n_preemptions)
            for r in server.drain()}


def test_server_over_ssm_pods_matches_jax_server():
    """``ElisServer`` with ISRTF and swap preemption over two mamba2-130m
    TP=2 pods: long requests start, short ones arrive and preempt them.
    Request by request, the streams of the JAX server over two
    single-device engines; the pods swap out and in and recompute
    nothing."""
    jcfg, cfg, jp, params = _setup(SSM)
    rng = np.random.RandomState(5)
    specs = [(0.0, 20, 20), (0.0, 17, 20), (0.0, 9, 20), (0.0, 12, 20),
             (1e-4, 6, 4), (2e-4, 9, 6), (3e-4, 5, 5)]
    requests = [dict(prompt=f"r{i}", request_id=i, arrival_time=t,
                     prompt_tokens=[int(x) for x in rng.randint(8, 512, p)],
                     true_output_len=n)
                for i, (t, p, n) in enumerate(specs)]
    kw = dict(max_slots=2, max_len=64, max_output=32, eos_id=-1,
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
                  JaxExecutor({n: JaxEngine(jcfg, jp, JaxEngineConfig(
                      attn_impl="xla", **kw)) for n in range(2)}),
                  requests)
    assert got == want
    assert all(status == "finished" for status, _, _ in got.values())
    c = executor.counters()
    assert c["swapouts"] > 0 and c["swapins"] == c["swapouts"]
    assert c["resume_context_tokens"] == 0


def _cli(main, argv, capsys, monkeypatch=None):
    """(per-request (request_id, status, n_tokens), stderr) of one CLI
    run; the JAX ``main`` reads ``sys.argv``."""
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
    ["--arch", SSM, "--preempt-policy", "swap"],
    ["--arch", HYBRID, "--prefill-chunk", "8", "--preempt-policy", "auto"],
], ids=["ssm-swap", "hybrid-chunk-auto"])
def test_main_mesh_matches_jax_cli(argv, capsys, monkeypatch):
    """``--mesh 1x2`` (one TP=2 pod of CPU ranks) of mamba2-130m and
    zamba2-7b: request by request the status and token count of the JAX
    CLI on one device; ``--prefill-chunk`` falls back to one-shot prefill
    (no chunk dispatched), as on one device."""
    argv = ["--n", "3", "--max-output", "8", "--rate", "20"] + argv
    chunked = "--prefill-chunk" in argv
    with (pytest.warns(UserWarning, match="falling back") if chunked
          else nullcontext()):
        got, err = _cli(serve.main, argv + ["--mesh", "1x2", "--device",
                                            "cpu"], capsys)
    want, _ = _cli(jax_serve.main, argv, capsys, monkeypatch)
    assert got == want
    assert "1 TP=2 pod(s)" in err and "(3/3 finished)" in err
    assert not re.search(r"chunk_dispatches=[1-9]", err)
