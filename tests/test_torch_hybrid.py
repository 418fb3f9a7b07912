"""The port's hybrid family (zamba2-7b) against the JAX package on the CPU.

Two reduced configs, fp32, parameters made by the reference's init and
converted by ``repro_torch.bridge``:
  * ``reduced()``: 4 layers in 2 groups of 2, no tail, head dim 32, SSD
    (P, N) = (32, 16);
  * ``TAIL``: 5 layers (2 groups of 2 and one tail layer), 2/2 heads of
    the published head dim 112, SSD (P, N) = (64, 64) as published, a
    ``swa_window`` of 16 so that prompts of 30 ids are masked by the
    window and a cache of ``max_len`` 64 is a ring (read plain, as in the
    reference); ``max_len`` 16 keeps it linear.

Checked: the config, ``param_count`` and ``reduced()`` field for field;
``init_params`` and ``init_cache`` layouts; prefill logits and every
cache leaf, then masked decode steps, on both paths (the reference's
Pallas kernels in interpret mode against the port's kernel wrappers,
which run their plain versions on CPU tensors; XLA against plain
PyTorch); the plain kernels at D = 112 and (P, N) = (64, 64) against the
Pallas kernels; the engine's greedy tokens against the JAX engine through
recompute evictions and a swap round trip (the swapped slot bit for bit),
compacted decode windows, the ``groups_ssm`` slot axis in gather and
scatter, and the chunked-prefill fallback; the step functions; a hybrid
cache through the bridge; the CLI.  Hybrid pods under a mesh:
``tests/test_torch_tp_ssm.py``.

Tolerances: logits and cache leaves 2e-5 abs + rel (as
``tests/test_torch_ssm.py``: the same fp32 arithmetic summed in another
order); the plain kernels against the Pallas kernels 1e-4 abs (as the
SSM tests hold the scan; attention 2e-5); greedy tokens identical;
frozen rows and swapped slots bit for bit.
"""
import dataclasses
import functools
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import Job as JaxJob  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.engine.engine import _gather_slots as jax_gather  # noqa: E402
from repro.engine.engine import _scatter_slots as jax_scatter  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import (cache_to_numpy,  # noqa: E402
                                hybrid_cache_from_numpy, params_from_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.engine.engine import (_gather_slots, _leaves,  # noqa: E402
                                       _scatter_slots)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "zamba2-7b"
TOL = 2e-5
#: (JAX impl, port impl): the kernels, and the plain paths
IMPLS = [("pallas", "kernel"), ("xla", "torch")]
#: a reduced config with a tail layer at the published head dim and SSD
#: widths, and a small window
TAIL = dict(arch_id="zamba2-7b-tail", n_layers=5, n_heads=2, n_kv_heads=2,
            head_dim=112, swa_window=16)


def _configs(name):
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if name == "tail":
        jcfg = dataclasses.replace(jcfg, **TAIL, ssm=dataclasses.replace(
            jcfg.ssm, head_dim=64, d_state=64))
        cfg = dataclasses.replace(cfg, **TAIL, ssm=dataclasses.replace(
            cfg.ssm, head_dim=64, d_state=64))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(name, JAX config, port config, JAX params, converted params)."""
    jcfg, cfg = _configs(name)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return name, jcfg, cfg, jp, tp


@pytest.fixture(params=["reduced", "tail"])
def setup(request):
    return _setup(request.param)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _prompts(seed, lengths, vocab=512):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(8, vocab, size=n)] for n in lengths]


def _raw_leaves(cache):
    """Every leaf of a cache of either package (or of its specs), by
    name."""
    out = {"len": cache["len"], "k": cache["kv"].k, "v": cache["kv"].v}
    for name in ("groups_ssm", "tail_ssm"):
        for k, v in cache.get(name, {}).items():
            out[f"{name}/{k}"] = v
    return out


def _cache_leaves(cache):
    """Every leaf of a cache of either package, by name, as numpy."""
    return {k: np.asarray(v) for k, v in _raw_leaves(cache).items()}


def _same_cache(tc, jc):
    got, want = _cache_leaves(tc), _cache_leaves(jc)
    assert got.keys() == want.keys()
    assert tc["kv"].ring == jc["kv"].ring
    for k in got:
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k])


# --------------------------------------------------------------------------- #
# Config, layout
# --------------------------------------------------------------------------- #


def test_config_param_count_and_reduced_match_reference():
    for reduce in (False, True):
        want, got = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            want, got = want.reduced(), got.reduced()
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(g):
                g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            assert g == w, f.name
        assert got.param_count() == want.param_count()
    assert get_config(ARCH).param_count() == 6_750_821_088
    assert T.hybrid_layout(get_config(ARCH)) == JT.hybrid_layout(
        jax_get_config(ARCH)) == (13, 6, 3)


def test_init_params_and_cache_have_reference_layout(setup):
    """Keys, shapes and dtypes of the port's own init (bf16 too, where the
    SSM's ``A_log``, ``dt_bias`` and ``D`` stay fp32 at any depth of the
    tree) and of ``init_cache`` (int8 too), against the reference's."""
    _, jcfg, cfg, _, _ = setup
    for dtype in ("float32", "bfloat16"):
        jc = dataclasses.replace(jcfg, dtype=dtype)
        tc = dataclasses.replace(cfg, dtype=dtype)
        want = {jax.tree_util.keystr(p): (a.shape, str(a.dtype)) for p, a in
                jax.tree_util.tree_leaves_with_path(
                    jax.eval_shape(lambda k: jax_init_params(k, jc),
                                   jax.random.PRNGKey(0)))}
        tp = T.init_params(tc, torch.Generator().manual_seed(0))
        got = {jax.tree_util.keystr(p): (tuple(t.shape),
                                         str(t.dtype).split(".")[1])
               for p, t in jax.tree_util.tree_leaves_with_path(tp)}
        assert got == want
    for kv_dtype in (None, "int8"):
        jc = JT.init_cache(jcfg, 3, 32, kv_dtype=kv_dtype)
        tc = T.init_cache(cfg, 3, 32, "cpu", kv_dtype=kv_dtype)
        assert tc.keys() == jc.keys()
        got, want = _cache_leaves(tc), _cache_leaves(jc)
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert tc["kv"].quantized == (kv_dtype == "int8")
        if kv_dtype:
            assert tuple(tc["kv"].k_scale.shape) == jc["kv"].k_scale.shape


# --------------------------------------------------------------------------- #
# Model: prefill and decode
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
@pytest.mark.parametrize("name,max_len", [("reduced", 64), ("tail", 16),
                                          ("tail", 64)])
def test_prefill_and_decode_match_reference(name, max_len, jimpl, timpl):
    """Prefill of two prompts, then four decode steps with an ``active``
    mask: logits and every cache leaf; frozen rows bit for bit.  In the
    tail config a 64-row cache is a ring over the 16-token window and
    the 30-token prompts see the window mask."""
    name, jcfg, cfg, jp, tp = _setup(name)
    s = 30 if max_len == 64 else 12
    toks = np.asarray(_prompts(s, [s, s]), np.int32)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        JT.init_cache(jcfg, 2, max_len), attn_impl=jimpl)
    tl, tc = T.prefill(tp, cfg, {"tokens": _t(toks)},
                       T.init_cache(cfg, 2, max_len, "cpu"), attn_impl=timpl)
    assert tc["kv"].ring == (name == "tail" and max_len == 64)
    _close(tl, jl)
    _same_cache(tc, jc)
    rng = np.random.RandomState(max_len)
    for i in range(4):
        step = rng.randint(8, 512, size=(2, 1)).astype(np.int32)
        active = np.array([True, i % 2 == 0])
        frozen = {k: v.copy() for k, v in _cache_leaves(tc).items()}
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(step), jc,
                                attn_impl=jimpl, active=jnp.asarray(active))
        tl, tc = T.decode_step(tp, cfg, _t(step), tc, attn_impl=timpl,
                               active=_t(active))
        _close(tl.numpy()[active], np.asarray(jl)[active])
        _same_cache(tc, jc)
        if not active[1]:
            for k, v in _cache_leaves(tc).items():
                axis = 2 if k.startswith("groups_ssm") else (
                    0 if k == "len" else 1)
                np.testing.assert_array_equal(np.take(v, 1, axis),
                                              np.take(frozen[k], 1, axis))


# --------------------------------------------------------------------------- #
# The plain kernels at the hybrid's shapes
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("window", [None, 24])
def test_plain_attention_at_head_dim_112_matches_pallas(window):
    rng = np.random.RandomState(3)
    q = rng.randn(1, 40, 4, 112).astype(np.float32)
    k, v = (rng.randn(1, 40, 4, 112).astype(np.float32) for _ in range(2))
    got = ref.flash_attention(_t(q), _t(k), _t(v), window=window)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=window)
    _close(got, want)
    kv_len = np.array([1, 33, 64, 50], np.int32)
    qd = rng.randn(4, 1, 4, 112).astype(np.float32)
    kc, vc = (rng.randn(4, 64, 4, 112).astype(np.float32) for _ in range(2))
    got = ref.flash_decode(_t(qd), _t(kc), _t(vc), kv_len=_t(kv_len),
                           q_offset=_t(kv_len - 1), window=window)
    want = jax_ops.flash_decode(jnp.asarray(qd), jnp.asarray(kc),
                                jnp.asarray(vc), kv_len=jnp.asarray(kv_len),
                                q_offset=jnp.asarray(kv_len - 1),
                                window=window)
    _close(got, want)


def test_plain_ssd_scan_at_64_64_matches_pallas():
    rng = np.random.RandomState(4)
    b, s, h, p, n = 1, 96, 3, 64, 64
    x = rng.randn(b, s, h, p).astype(np.float32)
    a = (-np.abs(rng.randn(b, s, h)) * 0.1).astype(np.float32)
    bm, cm = (rng.randn(b, s, h, n).astype(np.float32) for _ in range(2))
    y, fs = ref.ssd_scan(*map(_t, (x, a, bm, cm)), chunk=32)
    jy, jfs = jax_ops.ssd_scan(*map(jnp.asarray, (x, a, bm, cm)), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(fs.numpy(), np.asarray(jfs), atol=1e-4)


# --------------------------------------------------------------------------- #
# Engine
# --------------------------------------------------------------------------- #


def _jobs(cls, prompts):
    return [cls(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
            for i, p in enumerate(prompts)]


def _slot_leaves(eng, job_id):
    """Copies of every leaf of a job's slot (``len``, K/V, the states)."""
    idx = torch.tensor([eng.slot_of[job_id]])
    return [t.clone() for t in _leaves(_gather_slots(eng.cache, idx))]


def test_engine_greedy_tokens_match_jax_engine(setup):
    """Serial exact-length admissions, compacted and full-width windows, a
    recompute eviction and a swap round trip (the restored slot's every
    leaf bit for bit): token for token with the JAX engine, with the same
    dispatch counts."""
    name, jcfg, cfg, jp, tp = setup
    kw = dict(max_slots=4, max_len=64, max_output=64, eos_id=-1)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="xla", **kw))
    teng = InferenceEngine(cfg, tp, EngineConfig(attn_impl="kernel", **kw),
                           device="cpu")
    prompts = _prompts(0, [5, 21, 9])
    jjobs, tjobs = _jobs(JaxJob, prompts), _jobs(Job, prompts)
    schedule = [[0, 1], [0, 1, 2], [1, 2], [0, 1, 2], [0, 2], [0, 1, 2]]
    for w, ids in enumerate(schedule):
        if w == 2:  # preempt job 0: its slot is freed, resume recomputes
            jeng.evict_job(0)
            teng.evict_job(0)
        if w == 4:  # swap job 1 out to the host
            before = _slot_leaves(teng, 1)
            assert jeng.offload_job(1) and teng.offload_job(1)
            assert not teng.has_job(1)
        if w == 5:  # and back in, bit for bit
            assert jeng.restore_job(jjobs[1]) == teng.restore_job(tjobs[1])
            after = _slot_leaves(teng, 1)
            # len, k, v and the groups' two states (and the tail's two)
            assert len(after) == len(before) == (7 if name == "tail" else 5)
            assert all(torch.equal(a, b) for a, b in zip(after, before))
        jt, jf = jeng.run_window([jjobs[i] for i in ids], 4)
        tt, tf = teng.run_window([tjobs[i] for i in ids], 4)
        assert tt == jt and tf == jf, f"window {w}"
        for i, t in zip(ids, tt):
            jjobs[i].generated.extend(t)
            tjobs[i].generated.extend(t)
        assert teng.cache["len"].tolist() == np.asarray(
            jeng.cache["len"]).tolist()
        assert teng.slot_job == jeng.slot_job
    assert len(set(tjobs[1].generated)) > 1  # not a degenerate stream
    for attr in ("num_prefill_dispatches", "num_decode_dispatches",
                 "resume_context_tokens"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    assert teng.num_prefill_dispatches == 4  # 3 admissions + 1 recompute


def test_gather_and_scatter_take_groups_ssm_on_its_slot_axis():
    """``groups_ssm`` has its slot axis at 2, every other leaf at 1 (``len``
    at 0): a gather of slots (with a repeated pad row, as a compacted
    window makes) and a scatter back agree with the reference's, leaf for
    leaf, on a cache filled with distinct numbers."""
    _, jcfg, cfg, _, _ = _setup("tail")
    jc = JT.init_cache(jcfg, 4, 16)
    rng = np.random.RandomState(9)
    leaves, treedef = jax.tree_util.tree_flatten(jc)
    leaves = [rng.randn(*np.shape(x)).astype(np.asarray(x).dtype)
              if np.asarray(x).dtype == np.float32
              else rng.randint(0, 9, np.shape(x)).astype(np.asarray(x).dtype)
              for x in leaves]
    jc = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x)
                                                for x in leaves])
    tc = hybrid_cache_from_numpy(**{k: jax.tree_util.tree_map(
        np.asarray, v) for k, v in _as_kwargs(jc).items()}, device="cpu")
    idx = [3, 1, 3]
    jsub = jax_gather(jc, jnp.asarray(idx, jnp.int32))
    tsub = _gather_slots(tc, torch.tensor(idx))
    _same_cache(tsub, jsub)
    np.testing.assert_array_equal(
        tsub["groups_ssm"]["ssm"].numpy(),
        np.asarray(jc["groups_ssm"]["ssm"])[:, :, idx])
    jbig = jax_scatter(jc, jsub, [0, 2], 2)
    tbig = _scatter_slots(tc, tsub, [0, 2], 2)
    got, want = _cache_leaves(tbig), _cache_leaves(jbig)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _as_kwargs(jc):
    """A JAX hybrid cache as the keyword arguments of
    ``hybrid_cache_from_numpy``."""
    kw = {"length": jc["len"], "groups_ssm": dict(jc["groups_ssm"]),
          "k": jc["kv"].k, "v": jc["kv"].v, "ring": bool(jc["kv"].ring)}
    if "tail_ssm" in jc:
        kw["tail_ssm"] = dict(jc["tail_ssm"])
    if jc["kv"].k_scale is not None:
        kw.update(k_scale=jc["kv"].k_scale, v_scale=jc["kv"].v_scale)
    return kw


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_bridge_round_trips_a_hybrid_cache(kv_dtype):
    """A JAX hybrid cache (after a prefill; int8 codes and scales filled
    by hand, since the reference does not prefill an int8 hybrid cache)
    into the port and back, bit for bit."""
    _, jcfg, cfg, jp, _ = _setup("tail")
    toks = np.asarray(_prompts(2, [10, 10]), np.int32)
    _, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       JT.init_cache(jcfg, 2, 64))
    kw = jax.tree_util.tree_map(np.asarray, _as_kwargs(jc))
    if kv_dtype:
        rng = np.random.RandomState(1)
        kw["k"], kw["v"] = (rng.randint(-127, 128, kw["k"].shape).astype(
            np.int8) for _ in range(2))
        kw["k_scale"], kw["v_scale"] = (rng.rand(*kw["k"].shape[:3]).astype(
            np.float32) for _ in range(2))
    tc = hybrid_cache_from_numpy(**kw, device="cpu")
    assert tc["kv"].ring and tc["kv"].quantized == bool(kv_dtype)
    back = cache_to_numpy(tc)
    assert back.keys() == kw.keys() - {"ring"}
    for k, v in back.items():
        for got, want in zip(jax.tree_util.tree_leaves(v),
                             jax.tree_util.tree_leaves(kw[k])):
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want)


def test_chunked_prefill_falls_back_to_one_shot_with_a_warning():
    """The hybrid's recurrent state absorbs every position it sees, so
    ``run_window(prefill_chunk=...)`` prefills one-shot, with the
    reference's warning, once: the same tokens as without chunking."""
    _, _, cfg, _, tp = _setup("reduced")
    prompts = _prompts(4, [13, 6])
    streams = []
    for chunk in (None, 4):
        eng = InferenceEngine(cfg, tp, EngineConfig(
            max_slots=2, max_len=32, max_output=16, eos_id=-1), device="cpu")
        jobs = _jobs(Job, prompts)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                toks, _ = eng.run_window(jobs, 3, prefill_chunk=chunk)
                for j, t in zip(jobs, toks):
                    j.generated.extend(t)
        msgs = [str(w.message) for w in caught]
        if chunk is None:
            assert not msgs
        else:
            assert len(msgs) == 1 and "falling back to one-shot" in msgs[0]
            assert "family='hybrid'" in msgs[0]
            assert eng.num_chunk_dispatches == 0
        streams.append([list(j.generated) for j in jobs])
    assert streams[0] == streams[1]


#: the step functions' run: 3 prompts of 24 ids, a cache of 48 rows (a
#: ring over the tail config's 16-token window), 5 serve steps
STEP_PROMPTS = np.random.RandomState(7).randint(8, 512, (3, 24)).astype(
    np.int32)
STEP_ROWS, N_STEPS = 48, 5


@functools.lru_cache(maxsize=None)
def _reference_steps():
    """The reference's step functions on the tail config: the prefill's
    logits, then each serve step's greedy tokens, and the last cache."""
    _, jcfg, _, jp, _ = _setup("tail")
    jl, jc = JSTEPS.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(STEP_PROMPTS),
             "cache": JT.init_cache(jcfg, 3, STEP_ROWS)})
    jstep = JSTEPS.make_serve_step(jcfg)
    jtok, toks = jnp.argmax(jl[:, -1], -1).astype(jnp.int32), []
    for _ in range(N_STEPS):
        jtok, jc = jstep(jp, jtok[:, None], jc)
        toks.append(np.asarray(jtok))
    return np.asarray(jl), toks, jc


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_step_functions_match_reference(impl):
    """``make_prefill_step`` over an ``input_specs`` cache, then
    ``make_serve_step`` fed its own greedy tokens, against the
    reference's step functions."""
    _, _, cfg, _, tp = _setup("tail")
    jl, jtoks, jc = _reference_steps()
    specs = S.input_specs(cfg, S.InputShape("small", STEP_ROWS, 3, "decode"),
                          device="cpu")
    assert specs["cache"]["kv"].ring
    tl, tc = steps.make_prefill_step(cfg, attn_impl=impl)(
        tp, {"tokens": torch.from_numpy(STEP_PROMPTS),
             "cache": specs["cache"]})
    _close(tl, jl)
    tstep = steps.make_serve_step(cfg, attn_impl=impl)
    ttok = tl[:, -1].argmax(-1).to(torch.int32)
    for want in jtoks:
        ttok, tc = tstep(tp, ttok[:, None], tc)
        np.testing.assert_array_equal(ttok.numpy(), want)
    _same_cache(tc, jc)


@pytest.mark.parametrize("shape", sorted(JS.SHAPES))
def test_input_specs_match_reference_on_meta(shape):
    """Full width: ``input_specs`` of zamba2-7b at every shape, leaf for
    leaf (shapes and dtypes; its caches are rings past 4096 rows)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    want = JS.input_specs(jcfg, JS.SHAPES[shape])
    got = S.input_specs(cfg, S.SHAPES[shape])
    assert S.supported(cfg, S.SHAPES[shape]) == JS.supported(
        jcfg, JS.SHAPES[shape])
    assert got.keys() == want.keys()
    if "cache" in want:
        def specs(cache):
            return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in _raw_leaves(cache).items()}

        assert specs(got["cache"]) == specs(want["cache"])
        assert got["cache"]["kv"].ring == want["cache"]["kv"].ring


def test_cli_serves_zamba2_on_cpu(capsys):
    """``--arch zamba2-7b`` serves the reduced config on the CPU."""
    responses, _ = serve.main(["--arch", ARCH, "--n", "3", "--max-output",
                               "6", "--device", "cpu"])
    assert len(responses) == 3 and all(r.ok for r in responses)
    assert "(3/3 finished)" in capsys.readouterr().err
