"""The port's other archs against the JAX package on the CPU: every ported
config field for field (full and reduced), ``d_head_total``,
``param_count`` and ``active_param_count``; ``input_specs`` of the new
archs on the meta device; the engine's greedy tokens against the JAX
single-device engine on the reduced llama3.2-3b, yi-6b and qwen1.5-32b
(fp32); ``InferenceEngine.add_job``; vlm and audio pods and the TP
refusals left (int8 under a mesh, a vocab the ranks do not divide), the
CLI serving a vlm pod and exiting at launch on an audio arch; and
``dense_init``'s fp32 transient.  Everything is exact: no tolerance.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.core import Job as JaxJob  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.launch import partition as P  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

NEW_ARCHS = ["llama3.2-3b", "yi-6b", "qwen1.5-32b", "qwen2-moe-a2.7b",
             "mixtral-8x7b"]
DENSE_ARCHS = NEW_ARCHS[:3]


def _value(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_config_matches_reference(arch, reduced):
    want, got = jax_get_config(arch), get_config(arch)
    if reduced:
        want, got = want.reduced(), got.reduced()
    for f in dataclasses.fields(got):
        assert _value(getattr(got, f.name)) == _value(getattr(want, f.name)), f
    for prop in ("d_head_total", "attn_free", "ssm_d_inner", "ssm_n_heads"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_port_registers_the_new_archs():
    assert set(NEW_ARCHS) <= set(list_archs())
    assert set(list_archs()) <= set(jax_list_archs())


def test_param_count_keeps_the_reference_quirk():
    """qwen2-moe-a2.7b: ``param_count`` counts the shared path as 4 MLPs of
    width ``shared_d_ff`` (16.807 B), while ``init_moe`` builds one (the
    reference's tree holds 14.316 B).  The port counts as the reference
    does."""
    cfg = get_config("qwen2-moe-a2.7b")
    assert cfg.param_count() == 16_807_151_616
    assert cfg.active_param_count() == 5_180_540_928
    built = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda k: jax_init_params(k, jax_get_config(
            "qwen2-moe-a2.7b")), jax.random.PRNGKey(0))))
    m = cfg.moe
    # three shared MLPs counted and not built, and the shared path's
    # (d, 1) sigmoid gate built and not counted
    extra = (m.num_shared_experts - 1) * 3 * cfg.d_model * m.shared_d_ff
    assert cfg.param_count() - built == cfg.n_layers * (extra - cfg.d_model)
    assert built == 14_315_784_192


def test_port_tree_has_the_reference_shapes():
    """``init_params`` of each reduced new arch builds the reference's
    leaves with the reference's shapes."""
    for arch in NEW_ARCHS:
        want = jax.tree_util.tree_map(
            lambda a: tuple(a.shape), jax.eval_shape(
                lambda k: jax_init_params(k, jax_get_config(arch).reduced()),
                jax.random.PRNGKey(0)))
        got = jax.tree_util.tree_map(
            lambda t: tuple(t.shape), T.init_params(
                get_config(arch).reduced(), torch.Generator().manual_seed(0)))
        assert got == want, arch


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    elif hasattr(tree, "k_scale"):
        yield f"{prefix}/ring", tree.ring
        for name in ("k", "v", "k_scale", "v_scale"):
            if getattr(tree, name) is not None:
                yield from _walk(getattr(tree, name), f"{prefix}/{name}")
    else:
        yield prefix, tree


def _leaves(tree):
    return {path: leaf if isinstance(leaf, bool) else
            (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
            for path, leaf in _walk(tree)}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("shape", sorted(JS.SHAPES))
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_input_specs_match_reference_on_meta(arch, shape, kv_dtype):
    """Full width: the MoE family goes through ``input_specs`` as the dense
    family does, with the reference's shapes and dtypes (mixtral's caches
    are SWA rings past 4096 rows)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert S.supported(cfg, S.SHAPES[shape]) == JS.supported(
        jcfg, JS.SHAPES[shape])
    want = JS.input_specs(jcfg, JS.SHAPES[shape], kv_dtype=kv_dtype)
    got = S.input_specs(cfg, S.SHAPES[shape], kv_dtype=kv_dtype)
    assert _leaves(got) == _leaves(want)


# --------------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------------- #


def _params(arch):
    """One tree for both packages: the reference init with the layer
    weights scaled by 3, so that greedy streams do not settle on one
    repeated token."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    for group in tree["layers"].values():
        for name in group:
            if name.startswith("w"):
                group[name] = group[name] * np.float32(3.0)
    return (jcfg, cfg, jax.tree_util.tree_map(jax.numpy.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(8, 512, size=n)] for n in lengths]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_engine_greedy_tokens_match_jax_engine(arch):
    """Batched bucketed prefill, compacted decode, eviction and recompute
    re-admission through the kernels' path: token for token."""
    jcfg, cfg, jp, tp = _params(arch)
    kw = dict(max_slots=4, max_len=64, max_output=48, eos_id=-1)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl="pallas", **kw))
    teng = InferenceEngine(cfg, tp, EngineConfig(attn_impl="kernel", **kw),
                           device="cpu")
    prompts = _prompts(1, [7, 19, 11])
    jjobs = [JaxJob(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
             for i, p in enumerate(prompts)]
    tjobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
             for i, p in enumerate(prompts)]
    for w, ids in enumerate([[0, 1], [0, 1, 2], [1, 2], [0, 1, 2]]):
        if w == 2:
            jeng.evict_job(0)
            teng.evict_job(0)
        jt, jf = jeng.run_window([jjobs[i] for i in ids], 4)
        tt, tf = teng.run_window([tjobs[i] for i in ids], 4)
        assert tt == jt and tf == jf, f"window {w}"
        for i, t in zip(ids, tt):
            jjobs[i].generated.extend(t)
            tjobs[i].generated.extend(t)
    assert len(set(tjobs[1].generated)) > 1
    assert teng.cache["len"].tolist() == np.asarray(jeng.cache["len"]).tolist()


def _add_job_trace(engine_cls, cfg_cls, job_cls, cfg, params, **kw):
    """The three behaviours of ``add_job``, as observed values: the slot of
    a first admission, the slot of a re-admission, the error of a full
    engine, and the prefill dispatches before and after it."""
    eng = engine_cls(cfg, params, cfg_cls(max_slots=1, max_len=64,
                                          max_output=64, eos_id=-1), **kw)
    slot = eng.add_job(job_cls(job_id=0, prompt="", prompt_tokens=[1, 2, 3],
                               arrival_time=0.0))
    again = eng.add_job(job_cls(job_id=0, prompt="", prompt_tokens=[1, 2, 3],
                                arrival_time=0.0))
    before = eng.num_prefill_dispatches
    with pytest.raises(RuntimeError, match="free slots") as e:
        eng.add_job(job_cls(job_id=1, prompt="", prompt_tokens=[4, 5, 6],
                            arrival_time=0.0))
    return slot, again, str(e.value), before, eng.num_prefill_dispatches


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b",
                                  "mamba2-130m"])
def test_add_job_matches_reference(arch):
    """``add_job`` admits one job, re-admits it idempotently into the slot
    it holds, and on a full engine raises ``RuntimeError`` with no wasted
    prefill, as the reference's does."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    got = _add_job_trace(InferenceEngine, EngineConfig, Job, cfg, tp,
                         device="cpu")
    want = _add_job_trace(JaxEngine, JaxEngineConfig, JaxJob, jcfg, jp)
    assert got == want
    slot, again, _, before, after = got
    assert slot == again == 0 and before == after == 1


# --------------------------------------------------------------------------- #
# Refusals and the initialiser
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-large-v3"])
def test_tp_refusal_names_queue_item_8(arch):
    """The vlm and audio families build TP=2 pods (ROADMAP.md queue 1,
    item 8.2, landed), over int8 caches too (item 8.3, landed: each rank
    its KV heads' codes and a copy of the per-token scales); the refusal
    once named item 8.4, a vocab the ranks do not divide, and is served
    now (item 8.4, landed): full whisper's 51866 rows over 4 ranks split
    12967 / 12967 / 12966 / 12966, and qwen2-vl-7b's 28 query heads 7
    a rank.  (``tests/test_torch_tp_vlm_audio.py``,
    ``tests/test_torch_uneven_tp.py`` and ``tests/test_torch_dryrun.py``
    hold the pods against the JAX package.)"""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    eng = InferenceEngine(cfg, params, EngineConfig(max_slots=1, max_len=32),
                          mesh=mesh)
    assert [c["kv"].k.shape[3] for c in eng.cache] == [1, 1]
    caches = T.init_cache(cfg, 1, 32, mesh=mesh, kv_dtype="int8")
    for c in caches:
        assert c["kv"].k.dtype == torch.int8 and c["kv"].k.shape[3] == 1
        assert c["kv"].k_scale.shape == c["kv"].k.shape[:3]
    full = get_config(arch)
    assert P.layout_reason(full, 4) is None
    assert [P.local_config(full, 4, r).n_heads for r in range(4)] == [
        full.n_heads // 4] * 4
    rows = [hi - lo for lo, hi in (P.vocab_range(full, 4, r)
                                   for r in range(4))]
    assert sum(rows) == full.vocab_size and max(rows) - min(rows) <= 1
    if full.vocab_size % 4:
        assert rows == [12967, 12967, 12966, 12966]


@pytest.mark.parametrize("arch", ["qwen2-vl-7b"])
def test_cli_exits_at_launch_on_mesh_with_an_unported_family(arch, capsys):
    """``--mesh`` with a vlm ``--arch`` serves (queue 1, item 8.2,
    landed); the family the CLI does not serve, audio, still exits at
    launch with ``--mesh``, before any weight is made: it never serves
    something else in its place."""
    responses, _ = serve.main(["--arch", arch, "--mesh", "1x2", "--n", "2",
                               "--max-output", "4", "--device", "cpu"])
    assert len(responses) == 2 and all(r.ok for r in responses)
    assert "1 TP=2 pod(s)" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "whisper-large-v3", "--mesh", "1x2", "--n",
                    "2", "--device", "cpu"])
    assert "no frames" in str(e.value.code)
    assert "whisper-large-v3" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_cli_serves_a_new_arch_on_cpu(capsys):
    """``--arch`` takes the new archs (the reduced config on the CPU)."""
    responses, _ = serve.main(["--arch", "qwen2-moe-a2.7b", "--n", "3",
                               "--max-output", "6", "--device", "cpu"])
    assert len(responses) == 3 and all(r.ok for r in responses)
    assert "(3/3 finished)" in capsys.readouterr().err


def test_dense_init_holds_one_matrix_in_fp32(monkeypatch):
    """A stacked leaf is drawn one (in, out) matrix at a time, never the
    whole leaf in fp32, with the reference's bounds; so are the MoE
    experts through ``init_moe``."""
    draws = []
    rand = torch.rand

    def counting_rand(*args, **kw):
        out = rand(*args, **kw)
        draws.append((out.numel(), out.dtype))
        return out

    monkeypatch.setattr(torch, "rand", counting_rand)
    gen = torch.Generator().manual_seed(0)
    w = L.dense_init(gen, 64, 48, torch.bfloat16, lead=(3, 5))
    assert w.shape == (3, 5, 64, 48) and w.dtype == torch.bfloat16
    assert draws == [(64 * 48, torch.float32)] * 15
    assert float(w.float().abs().max()) <= 1 / 8
    assert len(set(w.float().flatten().tolist())) > 1000
    draws.clear()
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    p = M.init_moe(gen, cfg, cfg.n_layers, torch.bfloat16)
    m, d = cfg.moe, cfg.d_model
    assert max(n for n, _ in draws) == d * max(m.expert_d_ff, m.shared_d_ff)
    assert all(n < p["w_gate"][0].numel() for n, _ in draws)
    assert float(p["w_down"].float().abs().max()) <= 1 / m.expert_d_ff ** 0.5
