"""Tensor-parallel serving in the port against the JAX package, on the
CPU: meshes and pods, the partition rules, the sharded decode read
(``flash_decode_sharded``), and TP engines and servers against the JAX
single-device engine on the reduced qwen2-1.5b (4/2 heads, head dim 32,
fp32).  Ranks are CPU devices listed once per rank.

The JAX TP engine is not the oracle here: its own TP tests fail under the
installed JAX (ROADMAP.md, reference caveats), and the reference's
contract makes its TP and single-device engines token-identical
(``tests/test_sharded_engine.py``), so the port's TP engine is held
against the JAX single-device engine.

Tolerances, as |got - want| <= atol + rtol * |want|: kernel outputs 2e-5
(fp32 sums in another order); prefill logits 1e-4 (the row-parallel
partial sums round once per rank before they are added, and 2 layers of
such sums reach the logits).
"""
import dataclasses
import warnings
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

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
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.launch.partition import pallas_decode_support  # noqa: E402
from repro.launch.partition import param_pspecs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ElisServer, FrontendConfig, Job,  # noqa: E402
                              OraclePredictor, PreemptionConfig, Request,
                              SchedulerConfig)
from repro_torch.engine import (EngineConfig, EngineExecutor,  # noqa: E402
                                InferenceEngine, make_tp_pods)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import (kernel_decode_support,  # noqa: E402
                                make_mesh, pod_meshes, shard_params)
from repro_torch.launch import partition as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "qwen2-1.5b"
PROMPTS = [[11, 22, 33, 44], [9, 8, 7], [301, 302, 303, 304, 305]]


def cpu_mesh(tp):
    return make_mesh((tp,), ("model",), devices=["cpu"] * tp)


def fake_mesh(shape, names):
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def requires_card(n=1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA card(s) (torch.cuda.device_count() "
                    f"is {torch.cuda.device_count()})")


@pytest.fixture(scope="module")
def setup():
    """One parameter tree for both packages: the reference init with the
    layer weights scaled by 3, so that greedy streams do not settle on one
    repeated token."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    for group in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for name in group:
            if name.startswith("w"):
                group[name] = group[name] * np.float32(3.0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, cfg, jp, params_from_numpy(tree, "cpu")


def _jobs(job_cls, prompts=PROMPTS):
    return [job_cls(job_id=i, prompt="", prompt_tokens=list(p),
                    arrival_time=0.0) for i, p in enumerate(prompts)]


def _two_windows(eng, job_cls):
    """A compacted window of two jobs, then a batched admission of the
    third and a full-width window (``test_sharded_engine._run_identity``);
    returns the tokens and every window's ``len`` vector(s)."""
    jobs = _jobs(job_cls)
    t1, _ = eng.run_window(jobs[:2], 6)
    for j, t in zip(jobs, t1):
        j.generated.extend(t)
    lens1 = _lens(eng)
    t2, _ = eng.run_window(jobs, 5)
    return (t1, t2), (lens1, _lens(eng))


def _lens(eng):
    """Every rank's ``len`` vector; a JAX engine's one vector."""
    cache = eng.cache
    if isinstance(cache, list):
        return [c["len"].tolist() for c in cache]
    lens = cache["len"]
    return [lens.tolist() if isinstance(lens, torch.Tensor)
            else np.asarray(lens).tolist()]


# --------------------------------------------------------------------------- #
# Meshes
# --------------------------------------------------------------------------- #


def test_make_mesh_validates_shape_axes():
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("model",), devices=["cpu"] * 8)


def test_make_mesh_fails_loudly_without_devices():
    with pytest.raises(RuntimeError, match="device"):
        make_mesh((4096,), ("model",), devices=["cpu"] * 8)


def test_make_mesh_and_pod_meshes_disjoint():
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = make_mesh((2, 4), ("data", "model"), devices=devs)
    assert dict(zip(mesh.axis_names, mesh.shape)) == {"data": 2, "model": 4}
    assert mesh.ranks == devs
    pods = pod_meshes(mesh)
    assert len(pods) == 2
    seen = set()
    for pod in pods:
        ids = {d.index for d in pod.ranks}
        assert len(ids) == 4
        assert not ids & seen, "pods must own disjoint devices"
        seen |= ids
        assert pod.axis_names == ("model",)


def test_pod_meshes_requires_model_axis():
    with pytest.raises(ValueError, match="model"):
        pod_meshes(fake_mesh((2,), ("data",)))


def test_mesh_repeats_a_device():
    """Two ranks on one device: the only way to run TP on one card."""
    mesh = cpu_mesh(2)
    assert mesh.ranks == [torch.device("cpu")] * 2
    assert mesh.shape == (2,)


# --------------------------------------------------------------------------- #
# Partition rules
# --------------------------------------------------------------------------- #


def _leaves(tree, names=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, names + (k,))
    else:
        yield names, tree


def _get(tree, names):
    for k in names:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_concat_round_trip_every_leaf(setup, tp):
    """Every leaf comes back from its shards: split leaves by concatenation
    along the axis the reference's ``param_pspecs`` puts on "model",
    replicated leaves on every rank.  At TP=4 over 2 KV heads, ranks 2r
    and 2r + 1 both hold KV head r, so every second K/V piece
    concatenates to the leaf."""
    jcfg, cfg, _, tp_params = setup
    shards = shard_params(tp_params, cfg, cpu_mesh(tp))
    assert len(shards) == tp
    specs = param_pspecs(jcfg)
    kv_leaves = {"wk", "wv", "bk", "bv"}
    n_split = 0
    for names, leaf in _leaves(tp_params):
        pieces = [_get(s, names) for s in shards]
        spec = tuple(_get(specs, names))
        spec = (None,) * (leaf.ndim - len(spec)) + spec
        axis = spec.index("model") if "model" in spec else None
        if axis is None:
            assert all(torch.equal(p, leaf) for p in pieces), names
            continue
        n_split += 1
        if names[-1] in kv_leaves:
            per = max(tp // cfg.n_kv_heads, 1)  # ranks per KV head range
            assert all(torch.equal(pieces[r], pieces[r - r % per])
                       for r in range(tp)), names
            pieces = pieces[::per]
        assert all(p.shape[axis] * len(pieces) == leaf.shape[axis]
                   and p.is_contiguous() for p in pieces), names
        assert torch.equal(torch.cat(pieces, dim=axis), leaf), names
    assert n_split == 11


def test_unknown_leaf_has_no_rule(setup):
    _, cfg, _, tp_params = setup
    bad = dict(tp_params, extra={"mystery": torch.zeros(4)})
    with pytest.raises(KeyError, match="mystery"):
        shard_params(bad, cfg, cpu_mesh(2))


def test_tp4_layout_gives_each_rank_its_kv_head(setup):
    """TP=4 over 2 KV heads: each rank has 1 query head, the one KV head
    that query head reads on one device (ranks 0-1 KV head 0, ranks 2-3 KV
    head 1) and a quarter of the FFN; at TP=2 each rank has its share."""
    _, cfg, _, _ = setup
    lcfg = P.local_config(cfg, 4)
    assert (lcfg.n_heads, lcfg.n_kv_heads, lcfg.d_ff, lcfg.head_dim) == (
        1, 1, cfg.d_ff // 4, cfg.head_dim)
    rep = cfg.n_heads // cfg.n_kv_heads
    for tp in (2, 4):
        hl = cfg.n_heads // tp
        for r in range(tp):
            lo, hi = P.kv_head_range(cfg, tp, r)
            assert list(range(lo, hi)) == sorted(
                {j // rep for j in range(r * hl, (r + 1) * hl)})
    caches = T.init_cache(cfg, 2, 16, mesh=cpu_mesh(4))
    assert [c["kv"].k.shape[3] for c in caches] == [1] * 4


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("axes", [("model",), ("data",), ("data", "model")])
@pytest.mark.parametrize("arch", [ARCH, "mamba2-130m"])
def test_kernel_decode_support_matches_reference(arch, axes, tp):
    """The same reason-or-None as ``pallas_decode_support``, with the same
    category prefix and the same facts before the dash (the tails name
    each package's own handling), but where the rank count is a multiple
    of the KV heads: the port serves that layout through the kernels (each
    rank holds the KV head its query heads read), the reference falls
    back to XLA."""
    shape = (tp,) if len(axes) == 1 else (2, tp)
    cfg = get_config(arch).reduced()
    got = kernel_decode_support(cfg, fake_mesh(shape, axes))
    want = pallas_decode_support(jax_get_config(arch).reduced(),
                                 fake_mesh(shape, axes))
    if (want is not None and want.startswith("layout:")
            and tp % cfg.n_kv_heads == 0):
        assert got is None
        return
    assert (got is None) == (want is None)
    if want is not None:
        assert got.split(" — ")[0] == want.split(" — ")[0]


@pytest.mark.parametrize("heads,tp", [((6, 3), 2), ((4, 2), 3)])
def test_kernel_decode_support_refuses_uneven_layouts(heads, tp):
    """Where neither head count divides the other's share of the axis, the
    port gives the reference's ``layout:`` reason and builds no shards."""
    h, kh = heads
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_heads=h,
                              n_kv_heads=kh)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), n_heads=h,
                               n_kv_heads=kh)
    got = kernel_decode_support(cfg, fake_mesh((tp,), ("model",)))
    want = pallas_decode_support(jcfg, fake_mesh((tp,), ("model",)))
    assert got.startswith("layout:")
    assert got.split(" — ")[0] == want.split(" — ")[0]
    with pytest.raises(ValueError, match="layout:"):
        P.local_config(cfg, tp)


# --------------------------------------------------------------------------- #
# The sharded decode read
# --------------------------------------------------------------------------- #

#: per-slot kv_len vectors of ``test_sharded_engine``'s kernel property test
LEN_VECTORS = [[1, 1, 1, 1], [1, 37, 77, 128], [128, 128, 128, 128],
               [5, 5, 64, 3]]


@pytest.mark.parametrize("case", range(len(LEN_VECTORS)))
def test_flash_decode_sharded_plain_matches_single_device(case):
    """The plain path of ``flash_decode_sharded`` at TP=2: its shards side
    by side equal the single-device plain decode bit for bit, and agree
    with the reference's single-device kernel (Pallas, interpret mode)."""
    b, h, kh, d, L = 4, 4, 2, 16, 128
    rng = np.random.default_rng(case)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, 1, h, d), (b, L, kh, d), (b, L, kh, d)))
    lens = np.asarray(LEN_VECTORS[case], np.int32)
    kv_len = torch.as_tensor(lens)
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    shards = [list(x.chunk(2, dim=2)) for x in (tq, tk, tv)]
    shards = [[s.contiguous() for s in xs] for xs in shards]
    before = ops.flash_decode_sharded.launches
    got = torch.cat(ops.flash_decode_sharded(
        *shards, kv_len=kv_len, q_offset=kv_len - 1), dim=2)
    assert ops.flash_decode_sharded.launches == before  # CPU: no launch
    single = ops.flash_decode(tq, tk, tv, kv_len=kv_len, q_offset=kv_len - 1)
    assert torch.equal(got, single)
    want = jax_ops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), kv_len=jnp.asarray(lens),
                                q_offset=jnp.asarray(lens - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_decode_sharded_refuses_indivisible_heads():
    b, L, d = 4, 128, 16
    q = torch.zeros((b, 1, 4, d))
    k3 = torch.zeros((b, L, 3, d))
    with pytest.raises(ValueError, match="divide"):
        ops.flash_decode_sharded(list(q.chunk(2, dim=2)),
                                 list(k3.tensor_split(2, dim=2)),
                                 list(k3.tensor_split(2, dim=2)),
                                 kv_len=torch.ones(b, dtype=torch.int32),
                                 q_offset=torch.zeros(b, dtype=torch.int32))


def test_ref_flash_decode_sharded_is_per_shard():
    rng = np.random.default_rng(7)
    qs = [torch.as_tensor(rng.standard_normal((2, 1, 2, 32)),
                          dtype=torch.float32) for _ in range(2)]
    ks = [torch.as_tensor(rng.standard_normal((2, 64, 1, 32)),
                          dtype=torch.float32) for _ in range(2)]
    kv_len = torch.tensor([3, 64], dtype=torch.int32)
    outs = ref.flash_decode_sharded(qs, ks, ks, kv_len=kv_len,
                                    q_offset=kv_len - 1, window=16)
    for q, k, o in zip(qs, ks, outs):
        assert torch.equal(o, ref.flash_decode(q, k, k, kv_len=kv_len,
                                               q_offset=kv_len - 1,
                                               window=16))


# --------------------------------------------------------------------------- #
# The TP model
# --------------------------------------------------------------------------- #


def test_vocab_parallel_embedding_at_the_shard_boundaries(setup):
    """Ids at both ends of each vocab shard, and out-of-range ids (clamped
    as the reference's gather clamps them), embed exactly as on one
    device."""
    _, cfg, _, tp_params = setup
    V = cfg.vocab_size
    for tp in (2, 4):
        mesh = cpu_mesh(tp)
        shards = shard_params(tp_params, cfg, mesh)
        vl = V // tp
        ids = sorted({0, V - 1, V, V + 77, -5}
                     | {r * vl + e for r in range(tp) for e in (-1, 0, vl - 1)
                        if 0 <= r * vl + e < V})
        tokens = torch.tensor([ids], dtype=torch.int32)
        got = T._embed(shards, cfg, tokens, mesh.ranks)
        want = T.embed_tokens(tp_params, cfg, tokens)
        for g in got:
            assert torch.equal(g, want), tp


def _jax_prefill_logits(jcfg, jp, toks, last):
    cache = JT.init_cache(jcfg, toks.shape[0], 64)
    logits, _ = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, cache,
                           last_index=jnp.asarray(last))
    return np.asarray(logits)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_prefill_logits_match_jax(setup, tp):
    """Prefill logits of the TP model (right-padded batch, per-row last
    index) against the JAX single-device model, within 1e-4; two TP runs
    agree bit for bit (the reduction order is fixed)."""
    jcfg, cfg, jp, tp_params = setup
    rng = np.random.RandomState(tp)
    toks = rng.randint(0, cfg.vocab_size, size=(3, 24)).astype(np.int32)
    last = np.asarray([23, 4, 11], np.int32)
    mesh = cpu_mesh(tp)
    shards = shard_params(tp_params, cfg, mesh)
    runs = []
    for _ in range(2):
        caches = T.init_cache(cfg, 3, 64, mesh=mesh)
        logits, caches = T.prefill(
            shards, cfg, {"tokens": torch.as_tensor(toks)}, caches,
            attn_impl="torch", last_index=torch.as_tensor(last), mesh=mesh)
        runs.append(logits)
    assert torch.equal(runs[0], runs[1])
    assert [c["len"].tolist() for c in caches] == [[24] * 3] * tp
    np.testing.assert_allclose(runs[0].numpy(),
                               _jax_prefill_logits(jcfg, jp, toks, last),
                               atol=1e-4, rtol=1e-4)


def test_tp_refuses_an_uneven_layout(setup):
    """6 query / 3 KV heads over 2 ranks: the shards, the caches and the
    engine all refuse the layout, with its ``layout:`` reason; no path
    serves it on the plain version instead."""
    _, cfg, _, tp_params = setup
    cfg6 = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3)
    mesh = cpu_mesh(2)
    with pytest.raises(ValueError, match="layout:"):
        T.init_cache(cfg6, 1, 16, mesh=mesh)
    with pytest.raises(ValueError, match="layout:"):
        shard_params(tp_params, cfg6, mesh)
    for impl in ("kernel", "torch"):
        with pytest.raises(ValueError, match="layout:"):
            InferenceEngine(cfg6, tp_params,
                            EngineConfig(max_slots=1, max_len=32,
                                         attn_impl=impl), mesh=mesh)


def test_ssm_family_under_a_mesh_is_not_ported():
    cfg = get_config("mamba2-130m").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine(cfg, params, EngineConfig(max_slots=1, max_len=32),
                        mesh=cpu_mesh(2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_cache(cfg, 1, 32, mesh=cpu_mesh(2))


# --------------------------------------------------------------------------- #
# TP engines against the JAX single-device engine
# --------------------------------------------------------------------------- #


def _jax_engine(jcfg, jp, impl="xla", **kw):
    return JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl=impl, **kw))


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_tp2_token_identity_with_jax_single_device(setup, impl):
    """TP=2 (``test_sharded_token_identity_tp2`` /
    ``test_pallas_token_identity_tp2``): a compacted window, then a batched
    admission at full width; no fallback and no warning, tokens identical
    to the JAX single-device Pallas engine, and both ranks' ``len`` equal
    to its ``len``."""
    jcfg, cfg, jp, tp_params = setup
    kw = dict(max_slots=4, max_len=128, max_output=64, eos_id=-1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = InferenceEngine(cfg, tp_params,
                              EngineConfig(attn_impl=impl, **kw),
                              mesh=cpu_mesh(2))
    assert eng.cfg.attn_impl == impl
    got, got_lens = _two_windows(eng, Job)
    want, want_lens = _two_windows(_jax_engine(jcfg, jp, "pallas", **kw),
                                   JaxJob)
    assert got == want
    for g, w in zip(got_lens, want_lens):
        assert g == w * 2
    assert len(set(got[1][1])) > 1  # not a degenerate stream


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_tp4_two_kv_heads_token_identity_with_jax_single_device(setup, impl):
    """TP=4 over 2 KV heads (the layout of
    ``test_pallas_falls_back_with_reason_tp4_indivisible_kv``, where the
    reference falls back to XLA): no warning and no fallback, each rank
    caches the one KV head it reads, and the tokens and every rank's
    ``len`` are those of the JAX single-device engine."""
    jcfg, cfg, jp, tp_params = setup
    kw = dict(max_slots=4, max_len=128, max_output=64, eos_id=-1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = InferenceEngine(cfg, tp_params,
                              EngineConfig(attn_impl=impl, **kw),
                              mesh=cpu_mesh(4))
        got, got_lens = _two_windows(eng, Job)
    assert eng.cfg.attn_impl == impl
    assert [c["kv"].k.shape[3] for c in eng.cache] == [1] * 4
    want, want_lens = _two_windows(_jax_engine(jcfg, jp, **kw), JaxJob)
    assert got == want
    for g, w in zip(got_lens, want_lens):
        assert g == w * 4


def test_preempt_resume_identical_under_tp2(setup):
    """Evict and recompute-resume on a TP=2 engine (one slot): tokens as
    the JAX single-device engine's (``test_preempt_resume_identical_under_
    sharding``)."""
    jcfg, cfg, jp, tp_params = setup
    kw = dict(max_slots=1, max_len=128, max_output=64, eos_id=-1)
    out = {}
    for name, eng, job_cls in (
            ("jax", _jax_engine(jcfg, jp, **kw), JaxJob),
            ("tp2", InferenceEngine(cfg, tp_params, EngineConfig(**kw),
                                    mesh=cpu_mesh(2)), Job)):
        job = _jobs(job_cls, [[5, 6, 7]])[0]
        t1, _ = eng.run_window([job], 5)
        job.generated.extend(t1[0])
        eng.evict_job(job.job_id)
        t2, _ = eng.run_window([job], 5)
        out[name] = (t1[0] + t2[0], _lens(eng))
    assert out["tp2"][0] == out["jax"][0]
    assert out["tp2"][1] == out["jax"][1] * 2


def test_eos_freeze_keeps_rank_lengths_equal(setup):
    """An EOS mid-window freezes a slot on every rank: the ranks' ``len``
    vectors stay equal to each other and to the JAX engine's, window after
    window, through a compacted window and an eviction."""
    jcfg, cfg, jp, tp_params = setup
    kw = dict(max_slots=4, max_len=128, max_output=64)
    free, _ = _two_windows(InferenceEngine(
        cfg, tp_params, EngineConfig(eos_id=-1, **kw), mesh=cpu_mesh(2)),
        Job)
    eos = free[0][1][2]  # job 1's third token, mid-window
    engines = {"tp2": (InferenceEngine(cfg, tp_params,
                                       EngineConfig(eos_id=eos, **kw),
                                       mesh=cpu_mesh(2)), Job),
               "jax": (_jax_engine(jcfg, jp, eos_id=eos, **kw), JaxJob)}
    out = {}
    for name, (eng, job_cls) in engines.items():
        jobs = _jobs(job_cls)
        trace = []
        for ids in ([0, 1], [0, 1, 2], [0, 2]):
            if ids == [0, 2]:
                eng.evict_job(1)
            toks, fin = eng.run_window([jobs[i] for i in ids], 4)
            for i, t in zip(ids, toks):
                jobs[i].generated.extend(t)
            trace.append((toks, fin, _lens(eng)))
        out[name] = trace
    for (gt, gf, gl), (wt, wf, wl) in zip(out["tp2"], out["jax"]):
        assert (gt, gf) == (wt, wf)
        assert gl == wl * 2
    assert out["tp2"][0][1][1]  # job 1 finished on its EOS


def test_make_tp_pods(setup):
    """Two TP=2 pods on four CPU ranks serve identical tokens; TP=1 pods
    are single-device engines; too few devices raise."""
    jcfg, cfg, _, tp_params = setup
    ecfg = EngineConfig(max_slots=2, max_len=64, max_output=16, eos_id=-1)
    pods = make_tp_pods(cfg, tp_params, ecfg, n_pods=2, tp=2,
                        devices=[torch.device("cpu", i) for i in range(4)])
    assert sorted(pods) == [0, 1]
    assert [d.index for d in pods[0].mesh.ranks] == [0, 1]
    assert [d.index for d in pods[1].mesh.ranks] == [2, 3]
    t0, _ = pods[0].run_window(_jobs(Job, [[11, 22, 33]]), 6)
    t1, _ = pods[1].run_window(_jobs(Job, [[11, 22, 33]]), 6)
    assert t0 == t1
    single = make_tp_pods(cfg, tp_params, ecfg, n_pods=2, tp=1,
                          devices=["cpu", "cpu"])
    assert all(e.mesh is None for e in single.values())
    assert single[0].run_window(_jobs(Job, [[11, 22, 33]]), 6)[0] == t0
    with pytest.raises(RuntimeError, match="devices"):
        make_tp_pods(cfg, tp_params, ecfg, n_pods=3, tp=2,
                     devices=["cpu"] * 4)


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


def test_server_over_tp_pods_matches_jax_server(setup):
    """``ElisServer`` with ISRTF over two TP=2 pods gives, request by
    request, the streams of the JAX server over two single-device
    engines."""
    jcfg, cfg, jp, tp_params = setup
    rng = np.random.RandomState(11)
    requests = [dict(prompt=f"r{i}", request_id=i, arrival_time=0.0,
                     prompt_tokens=[int(t) for t in rng.randint(8, 512, n)],
                     true_output_len=int(rng.randint(5, 15)))
                for i, n in enumerate([7, 30, 12, 3, 18, 25])]
    kw = dict(max_slots=2, max_len=128, max_output=16, eos_id=-1,
              respect_job_max=True)
    got = _serve(ElisServer, FrontendConfig, SchedulerConfig,
                 PreemptionConfig(enabled=True), OraclePredictor, Request,
                 EngineExecutor(make_tp_pods(cfg, tp_params,
                                             EngineConfig(**kw), n_pods=2,
                                             tp=2, devices=["cpu"] * 4)),
                 requests)
    want = _serve(JaxServer, JaxFrontendConfig, JaxSchedulerConfig,
                  JaxPreemptionConfig(enabled=True, policy="recompute"),
                  JaxOracle, JaxRequest,
                  JaxExecutor({n: _jax_engine(jcfg, jp, **kw)
                               for n in range(2)}), requests)
    assert got == want
    assert all(status == "finished" for status, _, _ in got.values())


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #


@pytest.mark.gpu
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_sharded_on_card_is_bitwise_single_device(dtype, tp):
    """At the served shard shapes (12/2 heads, D=128; over 2 ranks 6/1
    heads each, over 4 ranks 3 query heads and the one KV head they
    read), all ranks on one card: the shards' outputs side by side equal
    the single-device kernel's bit for bit, one counted launch per shard
    and none counted as ``flash_decode``."""
    requires_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, L, h, kh, d = 4, 512, 12, 2, 128
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, L, kh, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, L, kh, d), generator=gen, device="cuda").to(dt)
    kv_len = torch.tensor([1, 200, 377, 512], dtype=torch.int32,
                          device="cuda")
    cfg = SimpleNamespace(n_heads=h, n_kv_heads=kh)
    ranges = [P.kv_head_range(cfg, tp, r) for r in range(tp)]
    shards = [[c.contiguous() for c in q.chunk(tp, dim=2)]] + [
        [x[:, :, lo:hi].contiguous() for lo, hi in ranges] for x in (k, v)]
    before = (ops.flash_decode_sharded.launches, ops.flash_decode.launches)
    got = torch.cat(ops.flash_decode_sharded(
        *shards, kv_len=kv_len, q_offset=kv_len - 1), dim=2)
    assert (ops.flash_decode_sharded.launches,
            ops.flash_decode.launches) == (before[0] + tp, before[1])
    want = ops.flash_decode(q, k, v, kv_len=kv_len, q_offset=kv_len - 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [("cuda:0", "cuda:0"), ("cuda:0", "cuda:1"),
                                   ("cuda:0",) * 4])
def test_tp2_kernel_engine_matches_single_device_kernel_engine_on_card(
        setup, ranks):
    """fp32, TF32 off, both ranks on ``cuda:0`` or one rank on each of two
    cards, and TP=4 over the 2 KV heads on ``cuda:0``: the TP kernel
    engine and the single-device kernel engine give the same greedy
    tokens, and every decode step launched the sharded decode kernel once
    per rank and layer."""
    requires_card(len(set(ranks)))
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg, _, tp_params = setup
    params = jax.tree_util.tree_map(lambda t: t.to("cuda"), tp_params)
    kw = dict(max_slots=4, max_len=128, max_output=64, eos_id=-1,
              attn_impl="kernel")
    single = InferenceEngine(cfg, params, EngineConfig(**kw), device="cuda")
    tp = len(ranks)
    pod = InferenceEngine(cfg, params, EngineConfig(**kw),
                          mesh=make_mesh((tp,), ("model",), devices=ranks))
    want, _ = _two_windows(single, Job)
    before = (ops.flash_decode_sharded.launches, ops.flash_decode.launches)
    got, _ = _two_windows(pod, Job)
    assert got == want
    assert (ops.flash_decode_sharded.launches - before[0],
            ops.flash_decode.launches - before[1]) == (
        cfg.n_layers * tp * (6 + 5), 0)


@pytest.mark.gpu
def test_shard_on_a_second_card_launches_there():
    """With a shard on ``cuda:1`` while ``cuda:0`` is current, every kernel
    launches on its tensors' card and agrees with the single-card
    result."""
    requires_card(2)
    gen = torch.Generator(device="cuda:0").manual_seed(1)
    b, L, h, kh, d = 2, 256, 4, 2, 64
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda:0")
    k = torch.randn((b, L, kh, d), generator=gen, device="cuda:0")
    kv_len = torch.tensor([9, 256], dtype=torch.int32, device="cuda:0")
    shards = [[x[:, :, :n // 2].contiguous(),
               x[:, :, n // 2:].contiguous().to("cuda:1")]
              for x, n in ((q, h), (k, kh), (k, kh))]
    torch.cuda.set_device(0)
    got = ops.flash_decode_sharded(*shards, kv_len=kv_len,
                                   q_offset=kv_len - 1)
    want = ops.flash_decode(q, k, k, kv_len=kv_len, q_offset=kv_len - 1)
    torch.cuda.synchronize("cuda:0")
    torch.cuda.synchronize("cuda:1")
    assert got[1].device == torch.device("cuda:1")
    assert torch.equal(torch.cat([got[0], got[1].to("cuda:0")], dim=2), want)
    qa = torch.randn((1, 64, h, d), generator=gen, device="cuda:0")
    ka = torch.randn((1, 64, kh, d), generator=gen, device="cuda:0")
    fa = ops.flash_attention(qa.to("cuda:1"), ka.to("cuda:1"),
                             ka.to("cuda:1"))
    assert torch.equal(fa.to("cuda:0"), ops.flash_attention(qa, ka, ka))
    x = torch.randn((1, 64, 4, 32), generator=gen, device="cuda:0")
    a = -torch.rand((1, 64, 4), generator=gen, device="cuda:0")
    bm = torch.randn((1, 64, 4, 16), generator=gen, device="cuda:0")
    y1, s1 = ops.ssd_scan(*(t.to("cuda:1") for t in (x, a, bm, bm)),
                          chunk=32)
    y0, s0 = ops.ssd_scan(x, a, bm, bm, chunk=32)
    assert torch.equal(y1.to("cuda:0"), y0) and torch.equal(s1.to("cuda:0"),
                                                            s0)
