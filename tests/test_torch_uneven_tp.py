"""Tensor-parallel pods whose ranks do not divide the heads, the GQA groups,
the FFN width or the vocab, in the port against the JAX package's single
device on the CPU.  The layout (``launch.partition.split_range``): each
rank holds a contiguous range of whole units, the first ``n % tp`` ranks
one more; a rank's query heads read the KV heads ``[q0 // G, (q1 - 1) //
G + 1)``, so ranks share a KV head where a group crosses their boundary,
and the attention kernels launch a rank that cuts a group as uniform
segments (``kernels.ops.head_segments``).  The JAX package lays these
layouts out through GSPMD (``sanitize_specs`` replicates what does not
divide); its single device computes the same function, and is the
oracle, as in ``tests/test_torch_tp.py``.

The cases, on reduced configs in fp32 at TP=4:

* (i) dense, 6 query / 2 KV heads: ranks hold 2, 2, 1, 1 heads, and
  rank 1's heads [2, 4) cut KV head 0's group [0, 3); ``d_ff`` 250 and a
  vocab of 509 that 4 does not divide;
* (ii) 2 / 2 heads: ranks 2 and 3 hold no heads, read nothing and add a
  zero partial;
* (iii) Mamba2 with 6 SSM heads (2, 2, 1, 1) and a vocab of 509;
* (iv) whisper with 6 / 6 heads (its cross-attention split by query head
  as unevenly) and a vocab of 509, through the step functions;
* (v) the shards and their inverse;
* (vi) the sharded decode wrappers over cut and empty shards (their
  plain versions, which the card's kernels are held against bit for bit
  in ``chip_smoke.py``);
* (vii) the dry run.

Tolerance: fp32 logits within 1e-3 of the JAX single device (each rank's
row-parallel partial rounds once before the ranks add; the readings are
about 1e-6); tokens, split leaves and the plain decode's outputs are
compared exactly, as are a shard's plain decode and its segments' calls.
"""
import dataclasses
import functools

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
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.engine.engine import _gather_slots, _leaves  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun, make_mesh, shard_params  # noqa: E402
from repro_torch.launch import partition as P  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.layers import quantize_kv  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 1e-3
TP = 4
ECFG = dict(max_slots=2, max_len=64, max_output=64, eos_id=-1)
#: (arch, the fields that make its layout uneven at TP=4)
CASES = {
    "dense": ("qwen2-1.5b", dict(n_heads=6, n_kv_heads=2, d_ff=250,
                                 vocab_size=509)),
    "zero-heads": ("qwen2-1.5b", dict(n_heads=2, n_kv_heads=2,
                                      head_dim=64, vocab_size=509)),
    "ssm": ("mamba2-130m", dict(d_model=96, vocab_size=509)),
    "audio": ("whisper-large-v3", dict(d_model=192, n_heads=6,
                                       n_kv_heads=6, head_dim=32, d_ff=250,
                                       vocab_size=509)),
}


def cpu_mesh(tp=TP):
    return make_mesh((tp,), ("model",), devices=["cpu"] * tp)


@functools.lru_cache(maxsize=None)
def _setup(case):
    """(JAX config, port config, JAX params, port params) of a case from
    the reference init, the layer weights scaled by 3 so that greedy
    streams do not settle on one token."""
    arch, kw = CASES[case]
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    for name in ("layers", "enc_layers"):
        for group in tree.get(name, {}).values():
            for k, v in group.items():
                if k.startswith("w") or k in ("in_proj", "out_proj"):
                    group[k] = v * np.float32(3.0)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _prompt(i, n, vocab=509):
    rng = np.random.RandomState(100 + i)
    return [int(t) for t in rng.randint(8, vocab, size=n)]


def _job(job_cls, i, prompt):
    return job_cls(job_id=i, prompt=f"p{i}", prompt_tokens=list(prompt),
                   arrival_time=0.0)


def _prefill_logits(case, b=2, s=11):
    """The pod's prefill logits and the JAX single device's, over one
    batch of ``b`` prompts of ``s`` tokens."""
    jcfg, cfg, jp, params = _setup(case)
    tokens = np.random.RandomState(5).randint(8, 509, (b, s)).astype(
        np.int32)
    want, _ = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                         JT.init_cache(jcfg, b, 32))
    mesh = cpu_mesh()
    got, caches = T.prefill(shard_params(params, cfg, mesh), cfg,
                            {"tokens": torch.from_numpy(tokens)},
                            T.init_cache(cfg, b, 32, mesh=mesh), mesh=mesh)
    return got, want, caches


def _slot_rows(eng, job_id):
    slot = torch.tensor([eng.slot_of[job_id]])
    return [[t.clone() for t in _leaves(_gather_slots(c, slot))]
            for c in eng.cache]


def _jax_stream(case, prompt, n):
    """``n`` greedy tokens of the JAX single-device engine, one-shot."""
    jcfg, _, jp, _ = _setup(case)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ECFG))
    job, out = _job(JaxJob, 0, prompt), []
    while len(out) < n:
        toks, _ = jeng.run_window([job], 4)
        job.generated.extend(toks[0])
        out.extend(toks[0])
    return out[:n]


def _pod_stream(case, prompt, n, chunk=None):
    """``n`` greedy tokens of a TP=4 pod engine, with chunks of ``chunk``
    where the family takes them, the job swapped to the host after its
    first window (mid-prefill when chunked) while another job writes its
    freed slot; every rank's slot rows come back bit for bit."""
    _, cfg, _, params = _setup(case)
    eng = InferenceEngine(cfg, params, EngineConfig(**ECFG),
                          mesh=cpu_mesh())
    job, other = _job(Job, 0, prompt), _job(Job, 1, _prompt(1, 19))
    out, swapped = [], False
    while len(out) < n:
        toks, _ = eng.run_window([job], 4, prefill_chunk=chunk)
        job.generated.extend(toks[0])
        out.extend(toks[0])
        if not swapped:
            swapped = True
            before = _slot_rows(eng, 0)
            assert eng.offload_job(0)
            eng.run_window([other], 4, prefill_chunk=chunk)
            eng.evict_job(1)
            eng.restore_job(job)
            after = _slot_rows(eng, 0)
            assert all(torch.equal(a, b) for x, y in zip(before, after)
                       for a, b in zip(x, y))
    return out[:n], eng


# --------------------------------------------------------------------------- #
# (i)-(iv) pods against the JAX single device
# --------------------------------------------------------------------------- #


def test_cut_group_pod_matches_jax_single_device():
    """(i) 6 / 2 heads at TP=4: heads 2, 2, 1, 1, KV heads [0, 1), [0, 2),
    [1, 2), [1, 2) (rank 1 cuts KV head 0's group, and its decode and
    prefill read as two segments), ``d_ff`` 250 as 63, 63, 62, 62, vocab
    509 as 128, 127, 127, 127.  Prefill logits within 1e-3 of the JAX
    single device; greedy tokens through a chunked prefill (chunks of 5)
    and a swap equal the JAX single-device engine's."""
    _, cfg, _, _ = _setup("dense")
    assert [P.local_config(cfg, TP, r).n_heads for r in range(TP)] == [
        2, 2, 1, 1]
    assert [P.kv_head_range(cfg, TP, r) for r in range(TP)] == [
        (0, 1), (0, 2), (1, 2), (1, 2)]
    assert [P.local_config(cfg, TP, r).d_ff for r in range(TP)] == [
        63, 63, 62, 62]
    assert [ops.head_segments(q0, h, 3) for q0, h in ((0, 2), (2, 2))] == [
        [(0, 2, 0, 1)], [(0, 1, 0, 1), (1, 2, 1, 2)]]
    got, want, caches = _prefill_logits("dense")
    _close(got, want)
    assert [c["kv"].k.shape[3] for c in caches] == [1, 2, 1, 1]
    prompt = _prompt(0, 13)
    stream, _ = _pod_stream("dense", prompt, 12, chunk=5)
    assert stream == _jax_stream("dense", prompt, 12)


def test_pod_with_headless_ranks_matches_jax_single_device():
    """(ii) 2 / 2 heads at TP=4: ranks 2 and 3 hold no query or KV heads
    (empty caches, no attention read) and add a zero ``wo`` partial; the
    FFN and vocab still split over all four.  Prefill logits within 1e-3
    of the JAX single device, and 6 greedy decode steps' tokens equal."""
    jcfg, cfg, jp, params = _setup("zero-heads")
    assert [P.local_config(cfg, TP, r).n_heads for r in range(TP)] == [
        1, 1, 0, 0]
    got, want, caches = _prefill_logits("zero-heads")
    _close(got, want)
    assert [c["kv"].k.shape[3] for c in caches] == [1, 1, 0, 0]
    mesh = cpu_mesh()
    shards = shard_params(params, cfg, mesh)
    jc = JT.init_cache(jcfg, 2, 32)
    tokens = np.random.RandomState(5).randint(8, 509, (2, 11)).astype(
        np.int32)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)}, jc)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = got[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(6):
        jl, jc = JT.decode_step(jp, jcfg, jtok, jc)
        tl, caches = T.decode_step(shards, cfg, ttok, caches, mesh=mesh)
        _close(tl, jl)
        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
        assert ttok.tolist() == np.asarray(jtok).tolist()


def test_ssm_pod_with_uneven_heads_matches_jax_single_device():
    """(iii) Mamba2 with 6 SSM heads at TP=4 (2, 2, 1, 1; the gated norm
    still divides the ranks' summed squares by the whole width) and vocab
    509: prefill logits within 1e-3, greedy tokens through a swap equal
    the JAX single-device engine's."""
    _, cfg, _, _ = _setup("ssm")
    assert cfg.ssm_n_heads == 6
    assert [P.ssm_widths(cfg, TP, r).n_heads for r in range(TP)] == [
        2, 2, 1, 1]
    got, want, caches = _prefill_logits("ssm")
    _close(got, want)
    assert [c["ssm"]["ssm"].shape[2] for c in caches] == [2, 2, 1, 1]
    prompt = _prompt(0, 13)
    stream, _ = _pod_stream("ssm", prompt, 10)
    assert stream == _jax_stream("ssm", prompt, 10)


def test_audio_pod_steps_with_uneven_heads_and_vocab_match_jax():
    """(iv) whisper with 6 / 6 heads (2, 2, 1, 1 a rank, the cross
    attention's K/V by query head as unevenly) and vocab 509 (128, 127,
    127, 127), through ``make_prefill_step(mesh=)`` and 3
    ``make_serve_step(mesh=)`` steps: logits within 1e-3 of the JAX
    single-device steps and the tokens equal."""
    jcfg, cfg, jp, params = _setup("audio")
    rng = np.random.RandomState(11)
    batch = {"tokens": rng.randint(8, 509, (2, 9)).astype(np.int32),
             "frames": rng.randn(2, cfg.encoder.n_frames,
                                 cfg.d_model).astype(np.float32)}
    jl, jc = JSTEPS.make_prefill_step(jcfg)(
        jp, {**{k: jnp.asarray(v) for k, v in batch.items()},
             "cache": JT.init_cache(jcfg, 2, 32)})
    mesh = cpu_mesh()
    shards = shard_params(params, cfg, mesh)
    tl, caches = steps.make_prefill_step(cfg, mesh=mesh)(
        shards, {**{k: torch.from_numpy(v) for k, v in batch.items()},
                 "cache": T.init_cache(cfg, 2, 32, mesh=mesh)})
    _close(tl, jl)
    assert [c["cross_kv"].k.shape[3] for c in caches] == [2, 2, 1, 1]
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = tl[:, -1].argmax(-1).to(torch.int32)
    jserve = JSTEPS.make_serve_step(jcfg)
    tserve = steps.make_serve_step(cfg, mesh=mesh)
    for _ in range(3):
        jtok, jc = jserve(jp, jtok[:, None], jc)
        ttok, caches = tserve(shards, ttok[:, None], caches)
        assert ttok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("arch,mesh", [("llama3.2-3b", "1x3"),
                                       ("qwen2-1.5b", "1x8")])
def test_serve_cli_on_an_uneven_pod(arch, mesh, capsys, monkeypatch):
    """``--mesh 1x3 --arch llama3.2-3b`` (the reduced 4 / 2 heads: 2, 1, 1
    a rank) and ``--mesh 1x8 --arch qwen2-1.5b`` (four ranks with no
    heads), chunked and with the swap preemption policy: request by
    request the status and token count of the JAX CLI on one device."""
    import json
    import sys

    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    def run(main, argv, jax=False):
        capsys.readouterr()
        if jax:
            monkeypatch.setattr(sys, "argv", ["serve"] + argv)
            main()
        else:
            main(argv)
        cap = capsys.readouterr()
        recs = [json.loads(line) for line in cap.out.splitlines()
                if line.startswith("{")]
        return ([(r["request_id"], r["status"], r["n_tokens"])
                 for r in recs], cap.err)

    argv = ["--n", "3", "--max-output", "8", "--rate", "20", "--arch", arch,
            "--prefill-chunk", "8", "--preempt-policy", "swap"]
    got, err = run(serve.main, argv + ["--mesh", mesh, "--device", "cpu"])
    want, _ = run(jax_serve.main, argv, jax=True)
    assert got == want
    assert f"TP={mesh[2:]} pod(s)" in err and "(3/3 finished)" in err


# --------------------------------------------------------------------------- #
# (v) the shards and their inverse
# --------------------------------------------------------------------------- #


def _paths(tree, names=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, names + (k,))
    else:
        yield names, tree


@pytest.mark.parametrize("case", list(CASES))
def test_shard_gather_is_the_identity_for_uneven_splits(case):
    """``gather_shards`` of ``shard_params`` gives back every leaf bit for
    bit at TP = 3, 4 and 8 (pieces of unequal widths, empty pieces, KV
    heads two ranks hold), and each rank's piece along a split axis is
    its ``split_range`` of whole units."""
    _, cfg, _, params = _setup(case)
    for tp in (3, 4, 8):
        mesh = cpu_mesh(tp)
        shards = shard_params(params, cfg, mesh)
        back = P.gather_shards(shards, cfg, mesh)
        for (names, leaf), (_, got) in zip(_paths(params), _paths(back)):
            assert torch.equal(leaf, got), (case, tp, names)
        lo, hi = zip(*(P.vocab_range(cfg, tp, r) for r in range(tp)))
        assert [s["embed"].shape[0] for s in shards] == [
            b - a for a, b in zip(lo, hi)]


@pytest.mark.parametrize("tp", [2, 3, 4, 8, 16])
def test_every_arch_lays_out_per_rank(tp):
    """Every arch of the port at TP = 2, 3, 4, 8 and 16: a config a rank
    whose shares of the query heads, ``d_ff``, the experts' and shared
    widths and the SSM heads cover each axis once, in rank order, and
    whose KV heads are the ones its query heads read."""
    for arch in list_archs():
        cfg = get_config(arch)
        assert P.layout_reason(cfg, tp) is None, arch
        lcs = P.local_configs(cfg, tp)
        m = cfg.moe
        for field, total in (("d_ff", cfg.d_ff),
                             ("expert_d_ff", m.expert_d_ff),
                             ("shared_d_ff", m.shared_d_ff)):
            got = [getattr(lc.moe if field != "d_ff" else lc, field)
                   for lc in lcs]
            assert sum(got) == total and max(got) - min(got) <= 1, arch
        if cfg.ssm.enabled:
            got = [P.ssm_widths(cfg, tp, r).n_heads for r in range(tp)]
            assert sum(got) == cfg.ssm_n_heads, arch
        if cfg.attn_free:
            continue
        assert sum(lc.n_heads for lc in lcs) == cfg.n_heads, arch
        g = cfg.n_heads // cfg.n_kv_heads
        for r, lc in enumerate(lcs):
            q0, q1 = P.head_range(cfg, tp, r)
            lo, hi = P.kv_head_range(cfg, tp, r)
            assert lc.n_kv_heads == hi - lo, arch
            assert set(range(lo, hi)) == {j // g for j in range(q0, q1)}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b",
                                  "mamba2-130m", "whisper-large-v3"])
def test_divisible_splits_give_equal_pieces(arch):
    """Where the ranks divide every split axis, each leaf's pieces are the
    ``tp`` equal contiguous pieces of the layout before uneven splits (a
    KV leaf's at TP=4 over 2 KV heads: each KV head twice), so every
    divisible pod is laid out as before."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tp = 2
    shards = shard_params(params, cfg, cpu_mesh(tp))
    for names, leaf in _paths(params):
        pieces = P._pieces(names, leaf, cfg, tp)
        got = []
        for s in shards:
            for k in names:
                s = s[k]
            got.append(s)
        if pieces is None:
            assert all(torch.equal(g, leaf) for g in got)
        elif names[-1] not in P._PACKED_RULES:
            axis = pieces[0]
            want = leaf.chunk(tp, dim=axis)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), names
    for r in range(tp):
        lc = P.local_config(cfg, tp, r)
        assert (lc.d_ff, lc.moe.expert_d_ff, lc.moe.shared_d_ff) == (
            cfg.d_ff // tp, cfg.moe.expert_d_ff // tp,
            cfg.moe.shared_d_ff // tp)


# --------------------------------------------------------------------------- #
# (vi) the sharded decode wrappers over cut and empty shards
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("heads,tp", [((24, 8), 3), ((6, 2), 4),
                                      ((12, 2), 16), ((2, 2), 4)])
def test_sharded_decode_over_cut_and_empty_shards(heads, tp, int8):
    """The shards of ``kv_head_range`` (llama3.2-3b's 24 / 8 at TP=3: KV
    [0, 3), [2, 6), [5, 8); a group cut at rank 1; qwen2-1.5b's 12 / 2 at
    TP=16: four empty ranks) through ``flash_decode_sharded`` and
    ``flash_decode_int8_sharded`` with each rank's first head and the
    group size: each shard is its ``head_segments``' plain calls bit for
    bit (none when empty), and side by side the unsplit call's (within
    2e-6: the plain version's CPU matmuls may sum in another order at
    another count of heads)."""
    h, kh = heads
    g = h // kh
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), n_heads=h,
                              n_kv_heads=kh, head_dim=16)
    b, L, d = 3, 48, 16
    gen = torch.Generator().manual_seed(h * tp)
    q = torch.randn((b, 1, h, d), generator=gen)
    k, v = (torch.randn((b, L, kh, d), generator=gen) for _ in range(2))
    kv_len = torch.tensor([1, 30, 48], dtype=torch.int32)
    kw = dict(kv_len=kv_len, q_offset=kv_len - 1, window=None)
    qs, ks, vs, segs = [], [], [], []
    for r in range(tp):
        q0, q1 = P.head_range(cfg, tp, r)
        lo, hi = P.kv_head_range(cfg, tp, r)
        qs.append(q[:, :, q0:q1].contiguous())
        ks.append(k[:, :, lo:hi].contiguous())
        vs.append(v[:, :, lo:hi].contiguous())
        segs.append(ops.head_segments(q0, q1 - q0, g))
        assert segs[-1] == ops._segments("t", qs[-1], ks[-1], q0, g)
    starts = [s for s, _ in P.rank_heads(cfg, tp)]
    if int8:
        kq, ksc = quantize_kv(k)
        vq, vsc = quantize_kv(v)
        kqs = [kq[:, :, lo:hi].contiguous() for lo, hi in
               (P.kv_head_range(cfg, tp, r) for r in range(tp))]
        vqs = [vq[:, :, lo:hi].contiguous() for lo, hi in
               (P.kv_head_range(cfg, tp, r) for r in range(tp))]
        outs = ops.flash_decode_int8_sharded(
            qs, kqs, vqs, [ksc] * tp, [vsc] * tp, head_starts=starts,
            group=g, **kw)
        whole = ops.flash_decode_int8(q, kq, vq, ksc, vsc, **kw)
    else:
        outs = ops.flash_decode_sharded(qs, ks, vs, head_starts=starts,
                                        group=g, **kw)
        whole = ops.flash_decode(q, k, v, **kw)
    assert [o.shape[2] for o in outs] == [x.shape[2] for x in qs]
    fn = ref.flash_decode_int8 if int8 else ref.flash_decode
    for r in range(tp):  # each shard is its segments' plain calls, exactly
        sc = ([ksc, vsc] if int8 else [])
        kk, vv = (kqs[r], vqs[r]) if int8 else (ks[r], vs[r])
        assert torch.equal(outs[r], ref.over_segments(fn, qs[r], kk, vv,
                                                      segs[r], *sc, **kw))
    # side by side, the unsplit call's: CPU matmuls may sum in another
    # order at another count of heads, so within 2e-6 here (the card's
    # kernel is held bit for bit, chip_smoke.py phase 3)
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(), whole.numpy(),
                               atol=2e-6, rtol=2e-6)
    if (h, kh, tp) == (24, 8, 3):
        assert [len(s) for s in segs] == [2, 3, 2]


def test_plain_segments_of_one_shard_are_the_unsplit_read():
    """``ref.over_segments`` over a shard's segments, with no segments
    (an empty rank) an empty output."""
    q = torch.randn((2, 1, 4, 16))
    k = torch.randn((2, 8, 2, 16))
    kw = dict(kv_len=8, q_offset=7)
    segs = [(0, 1, 0, 1), (1, 2, 0, 1), (2, 4, 1, 2)]
    assert torch.equal(ref.over_segments(ref.flash_decode, q, k, k, segs,
                                         **kw),
                       ref.flash_decode(q, k, k, **kw))
    assert ref.over_segments(ref.flash_decode, q[:, :, :0], k[:, :, :0],
                             k[:, :, :0], [], **kw).shape == (2, 1, 0, 16)


# --------------------------------------------------------------------------- #
# (vii) the dry run
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dry_run_lays_out_every_production_mesh_and_counts_an_uneven_pod(
        kind):
    """No arch x shape x production mesh is skipped for a layout the ranks
    do not divide (ROADMAP.md queue 1, item 8.4, landed); the skips left
    are long_500k's.  A tiny uneven pod's record (6 / 2 heads, ``d_ff``
    250 and vocab 509 at mesh (1, 4)) counts the pod's flops of the same
    program run on the CPU, exactly, and reports its busiest rank: rank r
    computes what a one-rank trace of ``partition.local_config(cfg, 4,
    r)`` computes, less the logits of the vocab rows it does not hold
    (its config's vocab is whole), and the busiest is rank 1, whose heads
    [2, 4) cut KV head 0's group and so project two KV heads where rank 0
    projects one (the ROADMAP's section 3 fault 1, fixed: the record
    was the pod's mean)."""
    from torch.utils.flop_counter import FlopCounterMode

    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in list_archs():
            for shape in S.SHAPES.values():
                why = dryrun.skip_reason(get_config(arch), shape, mesh)
                assert why is None or why.startswith("long_500k"), (arch,
                                                                     why)
    _, cfg, _, _ = _setup("dense")
    shape = S.InputShape(f"{kind}_32k", 16, 16, kind)
    kw = dict(input_shape=shape, kv_shard="heads")
    rec = dryrun.lower_one("qwen2-1.5b", shape.name, False,
                           cfg_override=cfg, mesh_shape=(1, TP), **kw)
    assert rec["status"] == "ok", rec
    step, inputs, tp = dryrun.rank_program(
        cfg, shape, make_mesh((1, TP), ("data", "model"),
                              devices=["cpu"] * TP), kv_shard="heads")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        step(*inputs)
    assert tp == TP and fc.get_total_flops() == rec["cost_analysis"][
        "pod flops"]
    assert sum(dryrun._storages(inputs).values()) == (
        rec["memory_analysis"]["pod_argument_size_in_bytes"])
    ranks = []
    for r in range(TP):
        one = dryrun.lower_one("qwen2-1.5b", shape.name, False,
                               cfg_override=P.local_config(cfg, TP, r),
                               mesh_shape=(1, 1), **kw)
        lo, hi = P.vocab_range(cfg, TP, r)
        ranks.append(one["flops"] - 2 * shape.global_batch * cfg.d_model
                     * (cfg.vocab_size - (hi - lo)))
    assert sum(ranks) == rec["cost_analysis"]["pod flops"]
    assert rec["flops"] == max(ranks) == ranks[1] > ranks[0]
    assert rec["flops"] * TP > rec["cost_analysis"]["pod flops"]
