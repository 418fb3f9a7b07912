"""The cache layouts a pod splits other than by head
(``repro_torch.models.kv_split``) against the JAX package's single device
on the CPU: the sequence-sharded cache (``kv_shard="seq"``) at TP=2 and
TP=3, the context-parallel cache at (2, 1) and (2, 2), and the head-dim
cache at TP=2, each over the reduced qwen2-1.5b in fp32 (2 layers, d 128,
4 / 2 heads, head dim 32) and the JAX reference on bridged params.  On
the CPU the kernels' wrappers run their plain versions
(``ref.flash_decode_partials``, ``ref.flash_decode_combine``).

Tolerances: fp32 logits within 2e-5 (abs + rel: the ranks' partial
states merge in another order than one softmax sums); over an int8 cache
1e-3 once a code differs from JAX's (its K or V projection sums in
another order, ``tests/test_torch_int8.py``); greedy tokens identical.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun, make_mesh, shard_params  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import pod_meshes  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-5
INT8_TOL = 1e-3
ARCH = "qwen2-1.5b"
B = 3


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def cpu_mesh(shape, names=("model",)):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _prompts(seed, b, s):
    return np.random.RandomState(seed).randint(
        8, 512, size=(b, s)).astype(np.int32)


#: the JAX single device's traces, by their arguments: the cases that
#: read the same prompts through other layouts share one
_JAX = {}


def _jax_trace(setup, b, prompt, max_len, kv_dtype, window, steps):
    """Prefill ``b`` prompts, then ``steps`` greedy decode steps with slot
    1 frozen from step 2 on (when ``b`` > 1), in JAX (one device, plain):
    (the prompts, the prefill logits, [(tokens, active, logits)] a
    step)."""
    key = (b, prompt, max_len, kv_dtype, window, steps)
    if key not in _JAX:
        jcfg, _, jp, _ = setup
        toks = _prompts(prompt, b, prompt)
        jc = JT.init_cache(jcfg, b, max_len, kv_dtype=kv_dtype,
                           sliding_window=window)
        jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
        first, trace = np.asarray(jl), []
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        for step in range(steps):
            act = np.array([True, step < 2, True][:b])
            jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                    active=jnp.asarray(act))
            trace.append((tok, act, np.asarray(jl)))
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(
                np.int32)[:, None]
        _JAX[key] = toks, first, trace
    return _JAX[key]


def _against_reference(setup, run_port, *, b=B, prompt=11, max_len=40,
                       kv_dtype=None, window=None, steps=5, chunk=None):
    """:func:`_jax_trace` against ``run_port`` (prefill, decode) fed the
    same tokens: every step's logits within the module's tolerance and
    its greedy tokens equal."""
    toks, first, trace = _jax_trace(setup, b, prompt, max_len, kv_dtype,
                                    window, steps)
    prefill, decode = run_port
    tol = INT8_TOL if kv_dtype else TOL
    _close(prefill(toks, chunk), first, tol)
    for tok, act, want in trace:
        got = decode(torch.from_numpy(tok.copy()), torch.from_numpy(act))
        _close(got, want, tol)
        np.testing.assert_array_equal(got[:, -1].argmax(-1).numpy(),
                                      want[:, -1].argmax(-1))


def _pod_runner(setup, mesh, max_len, **cache_kw):
    """(prefill, decode) of a pod of ``mesh`` over ``init_cache(mesh=,
    **cache_kw)`` with the kernels' wrappers."""
    _, cfg, _, tp = setup
    shards = shard_params(tp, cfg, mesh)
    state = {}

    def prefill(toks, chunk):
        cache = T.init_cache(cfg, toks.shape[0], max_len, mesh=mesh,
                             **cache_kw)
        state["cache"] = cache
        t = torch.from_numpy(toks)
        if chunk is None:
            lg, _ = T.prefill(shards, cfg, {"tokens": t}, cache, mesh=mesh)
            return lg
        b, s = t.shape
        for st in range(0, s, chunk):
            n = min(chunk, s - st)
            lg, _ = T.prefill_chunk(
                shards, cfg, {"tokens": t[:, st:st + chunk]}, cache,
                start=torch.full((b,), st), valid_len=torch.full((b,), n),
                mesh=mesh)
        return lg

    def decode(tok, act):
        lg, _ = T.decode_step(shards, cfg, tok, state["cache"], mesh=mesh,
                              active=act)
        return lg

    return prefill, decode


@pytest.mark.parametrize("tp", [2, 3])
@pytest.mark.parametrize("kind", ["linear", "int8", "ring"])
def test_seq_pod_matches_reference(setup, tp, kind):
    """40 rows over the ranks (20 / 20, or 14 / 13 / 13: the ranks do not
    divide them) hold 11-token prompts, so every rank but the first holds
    no visible row of any slot at first: their states are empty and weigh
    nothing.  The ring keeps 16 rows: the prompt wraps it."""
    kw = {"int8": dict(kv_dtype="int8"), "ring": dict(window=16)}.get(kind,
                                                                      {})
    max_len = 40
    mesh = cpu_mesh((tp,))
    run = _pod_runner(setup, mesh, max_len, kv_shard="seq",
                      kv_dtype=kw.get("kv_dtype"),
                      sliding_window=kw.get("window"))
    prompt = 20 if kind == "ring" else 11
    _against_reference(setup, run, prompt=prompt, max_len=max_len, **kw)


@pytest.mark.parametrize("kv_shard,tp", [("seq", 3), ("head_dim", 2),
                                         ("head_dim", 3)])
def test_chunked_prefill_over_split_caches_matches_reference(setup, kv_shard,
                                                             tp):
    """Chunks of 4 written to the rows' owners (or each rank's dims), read
    plain across the ranks, as the reference reads a chunk; the JAX
    one-shot prefill is the oracle (its chunks are bit-identical to it)."""
    run = _pod_runner(setup, cpu_mesh((tp,)), 40, kv_shard=kv_shard)
    _against_reference(setup, run, chunk=4)


@pytest.mark.parametrize("kind", ["linear", "int8", "ring"])
def test_head_dim_pod_matches_reference(setup, kind):
    """TP=2: each rank 16 of the 32 dims of every head; the scores summed
    across the ranks before the softmax."""
    kw = {"int8": dict(kv_dtype="int8"), "ring": dict(window=16)}.get(kind,
                                                                      {})
    run = _pod_runner(setup, cpu_mesh((2,)), 40, kv_shard="head_dim",
                      kv_dtype=kw.get("kv_dtype"),
                      sliding_window=kw.get("window"))
    _against_reference(setup, run, prompt=20 if kind == "ring" else 11,
                       **kw)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("kind", ["linear", "ring"])
def test_context_parallel_decode_matches_reference(setup, shape, kind):
    """The data indices hold 20 rows each (or 8 of a 16-row ring) of one
    cache, the batch (3 slots) replicated, and merge their states in
    step: the prefill, then decode steps through ``make_serve_step``
    (greedy tokens; the cache says the layout) and ``decode_step``
    (logits) in turn."""
    _, cfg, _, tp = setup
    window = 16 if kind == "ring" else None
    mesh = cpu_mesh(shape, ("data", "model"))
    pods = ST.shard_pods(tp, cfg, mesh)
    pod = pod_meshes(mesh)[0]
    step = ST.make_serve_step(cfg, mesh=mesh)
    state = {}

    def prefill(toks, chunk):
        state["cache"] = ST.init_pod_caches(cfg, B, 40, mesh,
                                            context_parallel=True,
                                            sliding_window=window)
        return T.prefill(pods[0], cfg, {"tokens": torch.from_numpy(toks)},
                         state["cache"], mesh=pod)[0]

    def decode(tok, act):
        want = step(pods, tok, _copy(state["cache"]))[0]
        lg, _ = T.decode_step(pods[0], cfg, tok, state["cache"], mesh=pod,
                              active=act)
        # the step writes every slot: its tokens of the active slots
        got = lg[:, -1].argmax(-1).to(torch.int32)
        assert torch.equal(want[act], got[act])
        return lg

    _against_reference(setup, (prefill, decode),
                       prompt=20 if window else 11, window=window)


def _copy(tree):
    """A deep copy of a pod's caches (the serve step writes in place)."""
    if isinstance(tree, list):
        return type(tree)(_copy(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return dataclasses.replace(tree, **{
        f: getattr(tree, f).clone() for f in ("k", "v", "k_scale", "v_scale")
        if getattr(tree, f) is not None})


def test_empty_rank_weighs_nothing_and_no_nan():
    """The plain partials and combine over three ranks' rows of one cache:
    slot 0's visible rows all lie on rank 0, slot 1 has ``kv_len`` 0, and
    slot 2 sees every rank.  An empty split's state is (m = -1e30, l = 0);
    planting m = -inf or NaN there changes nothing, and the merge equals
    the one-device decode."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(3, 1, 4, 32).astype(np.float32))
    k = torch.from_numpy(rng.randn(3, 48, 2, 32).astype(np.float32))
    v = torch.from_numpy(rng.randn(3, 48, 2, 32).astype(np.float32))
    kv_len = torch.tensor([10, 0, 48], dtype=torch.int32)
    q_off = kv_len - 1
    want = ref.flash_decode(q, k, v, kv_len=kv_len, q_offset=q_off)
    cuts = [(0, 16), (16, 32), (32, 48)]
    n = [ops.partial_splits(3, b - a, q.device)[0] for a, b in cuts]
    part = ops.Partials(3, 4, sum(n), 32, "cpu")
    off = 0
    for (a, b), m in zip(cuts, n):
        ops.flash_decode_partials(q, k[:, a:b], v[:, a:b], kv_len=kv_len,
                                  q_offset=q_off, out=part, row0=a,
                                  split0=off)
        off += m
    empty = part.ml[..., 1] == 0
    assert bool(empty[0, :, n[0]:].all()) and bool(empty[1].all())
    assert bool((part.ml[..., 0][empty] == ref.NEG_INF).all())
    got = ops.flash_decode_combine(part.acc, part.ml)
    part.ml[..., 0][empty] = float("-inf")
    inf = ops.flash_decode_combine(part.acc, part.ml)
    part.ml[..., 0][empty] = float("nan")
    nan = ops.flash_decode_combine(part.acc, part.ml)
    for out in (got, inf, nan):
        assert not bool(out.isnan().any())
        _close(out, want, TOL)
    assert float(got[1].abs().max()) == 0.0


def test_planted_row_offset_is_caught(setup):
    """A rank whose first row is read one row off (its ``row0`` + 1) moves
    the decode logits far outside the tolerance."""
    _, cfg, _, tp = setup
    mesh = cpu_mesh((2,))
    shards = shard_params(tp, cfg, mesh)
    toks = torch.from_numpy(_prompts(3, B, 30))
    outs = []
    for planted in (False, True):
        cache = T.init_cache(cfg, B, 40, mesh=mesh, kv_shard="seq")
        lg, _ = T.prefill(shards, cfg, {"tokens": toks}, cache, mesh=mesh)
        if planted:
            cache[1]["kv"].row0 += 1
        tok = lg[:, -1].argmax(-1)[:, None]
        outs.append(T.decode_step(shards, cfg, tok, cache, mesh=mesh)[0])
    assert float((outs[0] - outs[1]).abs().max()) > 100 * TOL


@pytest.mark.parametrize("case", ["seq-decode", "seq-prefill", "seq-empty",
                                  "head_dim", "context", "zero3-decode",
                                  "zero3-train"])
def test_dry_run_records_equal_a_cpu_run(setup, case, monkeypatch):
    """Each new layout's record on the meta device against the same rank
    program on CPU tensors (``seq-empty``: a sequence-sharded pod with a
    rank that holds no query head, which merges no state): the pod's
    flops (``FlopCounterMode``) and
    argument bytes exact, and the busiest rank's flops and bytes equal
    the CPU run's busiest rank (``dryrun.measure``)."""
    from contextlib import nullcontext

    from torch.utils.flop_counter import FlopCounterMode

    _, cfg, _, _ = setup
    cfg = dataclasses.replace(cfg, n_layers=2)
    kind = {"seq-prefill": "prefill", "zero3-train": "train"}.get(case,
                                                                  "decode")
    shape = S.InputShape({"train": "train_4k", "prefill": "prefill_32k",
                          "decode": "decode_32k"}[kind], 32,
                         {"context": 2, "decode": 16}.get(
                             case if case == "context" else kind, 4), kind)
    # seq-empty: 4 query heads over 5 ranks, the last holding none
    mesh_shape = ((2, 2) if case.startswith(("context", "zero3")) else
                  (1, 5) if case == "seq-empty" else (1, 3))
    kw = dict(kv_shard="head_dim" if case == "head_dim" else "seq",
              params_data_sharded=case.startswith("zero3"))
    rec = dryrun.lower_one(ARCH, shape.name, False, cfg_override=cfg,
                           mesh_shape=mesh_shape, input_shape=shape, **kw)
    assert rec["status"] == "ok", rec
    want = {"context": "heads", "head_dim": "head_dim"}.get(case, "seq")
    assert rec["kv_shard"] == want
    mesh = cpu_mesh(mesh_shape, ("data", "model"))
    step, inputs, tp = dryrun.rank_program(cfg, shape, mesh, **kw)
    grad = nullcontext() if kind == "train" else torch.no_grad()
    with grad, FlopCounterMode(display=False) as fc:
        step(*inputs)
    assert fc.get_total_flops() == rec["cost_analysis"]["pod flops"] > 0
    assert sum(dryrun._storages(inputs).values()) == (
        rec["memory_analysis"]["pod_argument_size_in_bytes"])
    step, inputs, tp = dryrun.rank_program(cfg, shape, mesh, **kw)
    with grad:
        m = dryrun.measure(step, *inputs,
                           owners=dryrun.rank_owners(inputs, kind))
    assert m["flops"] == rec["flops"] and len(m["ranks"]) == tp
    assert m["argument"] == rec["memory_analysis"]["argument_size_in_bytes"]
    if case == "context":
        assert rec["collectives"]["all-reduce"] > 0
    if case.startswith("seq"):
        assert rec["collectives"]["all-to-all"] > 0
