"""Tensor-parallel pods of the vlm and audio families in the port against
the JAX package on the CPU: the per-rank split of every qwen2-vl-7b and
whisper-large-v3 leaf (the cross-attention's K/V projections by query
head), the whisper encoder and cross-attention over ranks, pod prefill
with stub patches and 3-D M-RoPE positions or with frames through the
step functions, a vlm pod engine through a chunked prefill and swaps, and
the serve CLI, each against the JAX *single-device* path, on the reduced
configs (d_model 128, 4/2 heads of dim 32; whisper with 2 + 2 layers over
16 frames), fp32, at TP = 2 and 4.  Ranks are CPU devices listed once per
rank.  The planted faults of ``chip_smoke.py`` for these pods
(``mrope_rank0_only``, ``cross_rank_local``) are caught here too.

The JAX TP engine is not the oracle: its own TP tests fail under the
installed JAX (ROADMAP.md, reference caveats), and the reference's
contract makes its TP and single-device paths compute the same function.

Tolerance: 2e-5 abs + rel on fp32 activations, cache rows and logits
(each rank's row-parallel partial rounds once before the ranks add, in
rank order); split leaves, lengths, stashed cache rows and tokens are
compared exactly.
"""
import functools
import importlib.util
import json
import sys
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
from repro.core import Job as JaxJob  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.launch.partition import param_pspecs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.engine.engine import _gather_slots, _leaves  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import make_mesh, serve, shard_params  # noqa: E402
from repro_torch.launch import partition as P  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-5
VLM, AUDIO = "qwen2-vl-7b", "whisper-large-v3"
ECFG = dict(max_slots=2, max_len=64, max_output=64, eos_id=-1)


def cpu_mesh(tp):
    return make_mesh((tp,), ("model",), devices=["cpu"] * tp)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(JAX config, port config, JAX params, port params) of the reduced
    ``arch`` from the reference init: the vlm's layer weights scaled by 3
    (so greedy streams do not settle on one token), whisper's norm scales
    and biases drawn at random (so a dropped or misplaced bias shows)."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(2)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif arch == VLM and k.startswith("w"):
                node[k] = v * np.float32(3.0)
            elif arch == AUDIO and k in ("scale", "bias"):
                node[k] = (v + rng.uniform(-0.2, 0.2, v.shape)).astype(
                    np.float32)

    perturb(tree["layers"] if arch == VLM else tree)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _batch(cfg, b: int, text: int, seed: int):
    """The vlm's stub patches on a grid at temporal 0 and ``text`` ids at
    the next position on all three axes; whisper's ``text`` ids and its
    frames.  As numpy."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(8, 512, (b, text)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.randn(b, cfg.encoder.n_frames,
                                    cfg.d_model).astype(np.float32)
        return batch
    n = cfg.frontend_tokens
    side = int(round(n ** 0.5))
    grid = np.arange(n)
    img = np.stack([np.zeros(n), grid // side, grid % side]).astype(np.int32)
    txt = np.broadcast_to(np.arange(img.max() + 1, img.max() + 1 + text,
                                    dtype=np.int32), (3, text))
    batch["embeds"] = rng.randn(b, n, cfg.d_model).astype(np.float32)
    batch["positions"] = np.broadcast_to(
        np.concatenate([img, txt], 1)[:, None], (3, b, n + text)).copy()
    return batch


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


def _job(job_cls, i, prompt):
    return job_cls(job_id=i, prompt=f"p{i}", prompt_tokens=list(prompt),
                   arrival_time=0.0)


def _prompt(i, n):
    rng = np.random.RandomState(100 + i)
    return [int(t) for t in rng.randint(8, 512, size=n)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --------------------------------------------------------------------------- #
# Partition rules
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_shard_round_trip_every_vlm_and_audio_leaf(arch, tp):
    """Every leaf comes back from its shards along the axis the
    reference's ``param_pspecs`` puts on "model"; replicated leaves
    (learned positions, LayerNorm scales and biases) are whole on every
    rank.  The self-attention's ``wk`` / ``wv`` split by KV head (2 KV
    heads: at TP=4 ranks 0-1 and 2-3 share one), the cross-attention's by
    query head: each rank holds H / tp heads' columns of all three."""
    jcfg, cfg, _, params = _setup(arch)
    shards = shard_params(params, cfg, cpu_mesh(tp))
    specs = param_pspecs(jcfg)
    per_kv = max(tp // cfg.n_kv_heads, 1)
    split, whole = set(), set()
    for names, leaf in _leaf_paths(params):
        pieces = [_get(s, names) for s in shards]
        spec = tuple(_get(specs, names))
        spec = (None,) * (leaf.ndim - len(spec)) + spec
        if "model" not in spec:
            assert all(torch.equal(p, leaf) for p in pieces), names
            whole.add(names[-1])
            continue
        axis = spec.index("model")
        split.add(names[-1])
        if names[-1] in ("wk", "wv", "bk", "bv") and "cross" not in names:
            pieces = pieces[::per_kv]
        if "cross" in names:
            assert pieces[0].shape[axis] == cfg.n_heads // tp * cfg.head_dim
        assert all(p.shape[axis] * len(pieces) == leaf.shape[axis]
                   and p.is_contiguous() for p in pieces), names
        assert torch.equal(torch.cat(pieces, dim=axis), leaf), names
    assert {"wq", "wk", "wv", "wo", "w_up", "w_down", "embed"} <= split
    if arch == AUDIO:
        assert {"pos_embed", "enc_pos", "scale", "bias"} <= whole
    else:
        assert {"bq", "bk", "bv", "lm_head"} <= split


# --------------------------------------------------------------------------- #
# The whisper encoder and cross-attention over ranks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tp", [2, 4])
def test_encoder_over_ranks_matches_jax_encode_audio(tp):
    """``encode_audio`` over ``tp`` ranks, each rank its heads and FFN
    columns and the ranks' ``wo`` and ``w_down`` partials summed: every
    rank's copy of the output equals the JAX encoder's."""
    jcfg, cfg, jp, params = _setup(AUDIO)
    mesh = cpu_mesh(tp)
    frames = _batch(cfg, 2, 4, 6)["frames"]
    outs = T.encode_audio(shard_params(params, cfg, mesh), cfg,
                          torch.from_numpy(frames), mesh=mesh)
    want = JT.encode_audio(jp, jcfg, jnp.asarray(frames))
    assert len(outs) == tp
    for out in outs:
        _close(out, want)


@pytest.mark.parametrize("tp", [2, 4])
def test_cross_attention_partials_sum_to_the_jax_block(tp):
    """Layer 0's cross-attention over ``tp`` ranks, each with its rank
    config: its ``encode_cross_kv`` is the JAX cross K/V's slice of its
    query heads, and the ``cross_attention_block`` partials summed in
    rank order equal the JAX block."""
    jcfg, cfg, jp, params = _setup(AUDIO)
    lcfg = P.local_config(cfg, tp)
    rng = np.random.RandomState(7)
    enc = rng.randn(2, cfg.encoder.n_frames, cfg.d_model).astype(np.float32)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    jc = {k: v[0] for k, v in jp["layers"]["cross"].items()}
    jkv = JL.encode_cross_kv(jc, jcfg, jnp.asarray(enc))
    h = cfg.n_heads // tp
    parts = []
    for r, shard in enumerate(shard_params(params, cfg, cpu_mesh(tp))):
        cross = {k: v[0] for k, v in shard["layers"]["cross"].items()}
        kv = L.encode_cross_kv(cross, lcfg, torch.from_numpy(enc))
        for got, want in zip(kv, jkv):
            assert tuple(got.shape) == (2, cfg.encoder.n_frames, h,
                                        cfg.head_dim)
            _close(got, np.asarray(want)[:, :, r * h:(r + 1) * h])
        parts.append(L.cross_attention_block(cross, lcfg,
                                             torch.from_numpy(x), kv))
    _close(T._all_reduce(parts)[0],
           JL.cross_attention_block(jc, jcfg, jnp.asarray(x), jkv))


# --------------------------------------------------------------------------- #
# Pods through the step functions
# --------------------------------------------------------------------------- #


def _count_kernels(monkeypatch):
    """Record the heads of each ``flash_attention`` call and the ranks of
    each ``flash_decode_sharded`` call (the wrappers run their plain
    versions on CPU tensors)."""
    calls = {"flash_attention": [], "flash_decode_sharded": []}
    for name in calls:
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls[_n].append(a[0].shape[2] if _n == "flash_attention"
                             else len(a[0])), _fn(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_pod_steps_match_jax_single_device(arch, tp, monkeypatch):
    """``make_prefill_step(mesh=)`` over the vlm's stub patches and (3, B,
    S) positions, or whisper's frames, then 3 ``make_serve_step(mesh=)``
    steps on a pod: prefill logits within 2e-5 of the JAX single-device
    step, greedy tokens identical, and every rank's K/V (its KV heads)
    and cross K/V (its query heads) the JAX cache's slices.
    ``flash_attention`` ran on each rank's heads once a layer and
    ``flash_decode_sharded`` once a layer and step over all ranks."""
    jcfg, cfg, jp, params = _setup(arch)
    mesh = cpu_mesh(tp)
    calls = _count_kernels(monkeypatch)
    batch = _batch(cfg, 2, 9, 11)
    jl, jc = JSTEPS.make_prefill_step(jcfg)(
        jp, {**{k: jnp.asarray(v) for k, v in batch.items()},
             "cache": JT.init_cache(jcfg, 2, 32)})
    shards = shard_params(params, cfg, mesh)
    caches = T.init_cache(cfg, 2, 32, mesh=mesh)
    tl, caches = steps.make_prefill_step(cfg, mesh=mesh)(
        shards, {**{k: torch.from_numpy(v) for k, v in batch.items()},
                 "cache": caches})
    _close(tl, jl)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = tl[:, -1].argmax(-1).to(torch.int32)
    jserve = JSTEPS.make_serve_step(jcfg)
    tserve = steps.make_serve_step(cfg, mesh=mesh)
    for _ in range(3):
        jtok, jc = jserve(jp, jtok[:, None], jc)
        ttok, caches = tserve(shards, ttok[:, None], caches)
        assert ttok.tolist() == np.asarray(jtok).tolist()
    n = cfg.n_layers
    assert calls["flash_attention"] == [cfg.n_heads // tp] * (n * tp)
    assert calls["flash_decode_sharded"] == [tp] * (3 * n)
    h = cfg.n_heads // tp
    for r, c in enumerate(caches):
        lo, hi = P.kv_head_range(cfg, tp, r)
        assert c["len"].tolist() == np.asarray(jc["len"]).tolist()
        _close(c["kv"].k, np.asarray(jc["kv"].k)[:, :, :, lo:hi])
        _close(c["kv"].v, np.asarray(jc["kv"].v)[:, :, :, lo:hi])
        if arch == AUDIO:
            for got, want in ((c["cross_kv"].k, jc["cross_kv"].k),
                              (c["cross_kv"].v, jc["cross_kv"].v)):
                _close(got, np.asarray(want)[:, :, :, r * h:(r + 1) * h])


def test_planted_pod_faults_are_caught():
    """``chip_smoke.py``'s in-memory faults move a TP=2 pod's prefill
    logits far past the tolerance, so the fp32 checks catch them:
    ``mrope_rank0_only`` (rank 1 rotates by the 2-D text positions, not
    the (3, B, S) ones) on the vlm pod, ``cross_rank_local`` (each rank
    adds only its own heads' cross-attention output) on the whisper pod;
    without them the pods agree with the JAX single-device prefill."""
    chip_smoke = _chip_smoke()
    mesh = cpu_mesh(2)
    for arch, fault in ((VLM, chip_smoke.mrope_rank0_only),
                        (AUDIO, chip_smoke.cross_rank_local)):
        jcfg, cfg, jp, params = _setup(arch)
        batch = _batch(cfg, 2, 9, 12)
        want, _ = JT.prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                        batch.items()},
                             JT.init_cache(jcfg, 2, 32))
        shards = shard_params(params, cfg, mesh)

        def pod():
            return T.prefill(shards, cfg, {k: torch.from_numpy(v) for k, v
                                           in batch.items()},
                             T.init_cache(cfg, 2, 32, mesh=mesh),
                             mesh=mesh)[0]

        _close(pod(), want)
        with fault():
            got = pod()
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) > \
            100 * TOL, arch
        assert set(chip_smoke.POD_FAULTS) >= {"mrope_rank0_only",
                                              "cross_rank_local"}


# --------------------------------------------------------------------------- #
# A vlm pod engine and the CLI
# --------------------------------------------------------------------------- #


def _slot_rows(eng, job_id):
    slot = torch.tensor([eng.slot_of[job_id]])
    return [[t.clone() for t in _leaves(_gather_slots(c, slot))]
            for c in eng.cache]


def _same_rows(a, b):
    return len(a) == len(b) and all(
        len(x) == len(y) and all(torch.equal(s, t) for s, t in zip(x, y))
        for x, y in zip(a, b))


@pytest.mark.parametrize("tp", [2, 4])
def test_vlm_pod_engine_chunks_and_swaps_match_jax_engine(tp):
    """A vlm pod engine (text, as the reference's engine serves it) with
    chunks of 6: a 21-token job swapped to the host between its first two
    chunks while another job writes its freed slot, then swapped again
    mid-decode; every rank's slot rows come back bit for bit, and its
    stream is the JAX single-device one-shot engine's, token for
    token."""
    jcfg, cfg, jp, params = _setup(VLM)
    prompt = _prompt(0, 21)
    jeng, jjob = JaxEngine(jcfg, jp, JaxEngineConfig(**ECFG)), _job(
        JaxJob, 0, prompt)
    want = []
    while len(want) < 12:
        toks, _ = jeng.run_window([jjob], 3)
        jjob.generated.extend(toks[0])
        want.extend(toks[0])
    eng = InferenceEngine(cfg, params, EngineConfig(**ECFG),
                          mesh=cpu_mesh(tp))
    job, other = _job(Job, 0, prompt), _job(Job, 1, _prompt(1, 30))
    got = []

    def window(chunk=6):
        toks, _ = eng.run_window([job], 3, prefill_chunk=chunk)
        job.generated.extend(toks[0])
        got.extend(toks[0])

    def swap():
        before = _slot_rows(eng, 0)
        assert eng.offload_job(0)
        assert len(eng._host_stash[0]["cache"]) == tp
        eng.run_window([other], 3, prefill_chunk=6)  # writes the freed slot
        eng.evict_job(1)
        eng.restore_job(job)
        assert _same_rows(_slot_rows(eng, 0), before)

    window()
    assert eng.prefill_incomplete(0) and eng._prefill_cursor[0] == 6
    swap()
    while len(got) < 6:
        window()
    swap()
    while len(got) < 12:
        window()
    assert got[:12] == want[:12]
    assert len(set(got)) > 1
    assert eng.num_chunk_dispatches >= 4
    assert eng.resume_context_tokens == 0


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


def test_main_mesh_vlm_matches_jax_cli(capsys, monkeypatch):
    """``--mesh 1x2 --arch qwen2-vl-7b`` (one TP=2 pod of CPU ranks) with
    chunked prefill: request by request the status and token count of the
    JAX CLI on one device; the chunks ran."""
    argv = ["--n", "3", "--max-output", "8", "--rate", "20", "--arch", VLM,
            "--prefill-chunk", "8"]
    got, err = _cli(serve.main, argv + ["--mesh", "1x2", "--device", "cpu"],
                    capsys)
    want, _ = _cli(jax_serve.main, argv, capsys, monkeypatch)
    assert got == want
    assert "1 TP=2 pod(s)" in err and "(3/3 finished)" in err
    assert "chunk_dispatches=0 " not in err


def test_refusals_left_name_their_queue_items():
    """Full whisper over 4 ranks: its vocab (51866) does not divide, which
    the reference replicates; the port splits it as whole rows, the first
    ranks one more (ROADMAP.md queue 1, item 8.4, landed), and the dry
    run names no item for the layout.  An int8 cache under a mesh is
    built now (item 8.3, landed): each rank's self-attention codes of
    its heads with its copy of the scales, and the cross K/V in the
    model's dtype, as the reference's ``init_cache`` leaves them."""
    full = get_config(AUDIO)
    assert P.layout_reason(full, 4) is None
    assert [P.vocab_range(full, 4, r)[1] - P.vocab_range(full, 4, r)[0]
            for r in range(4)] == [12967, 12967, 12966, 12966]
    cfg = _setup(AUDIO)[1]
    caches = T.init_cache(cfg, 1, 32, mesh=cpu_mesh(2), kv_dtype="int8")
    for c in caches:
        assert c["kv"].quantized and c["kv"].k.dtype == torch.int8
        assert c["cross_kv"].k.dtype == T.DTYPES[cfg.dtype]
