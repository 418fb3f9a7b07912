"""The audio family's cross-attention cache (``cross_kv``) under the
layouts a pod splits other than by head, against the JAX package on the
CPU: under ``kv_shard="seq"`` each rank holds every query head's encoder
K/V over its frames ``split_range(n_frames, tp, r)``, under
``"head_dim"`` its dims of every head, as the reference's ``cache_pspecs``
lays ``cross_kv`` out by the rule it applies to ``kv``.  The reduced
whisper-large-v3 (4 / 2 heads of 32, 16 frames, 2 + 2 layers) in fp32,
at TP=2 and TP=3 (uneven frames and dims), and the published config's
dry-run records.

Tolerances: fp32 logits within ``TOL`` = 2e-5 abs + rel of the JAX single
device (the ranks' partial states, or partial scores, merge in another
order than one softmax sums); ranges, shapes and bytes exactly."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import partition as JPT  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, make_mesh, shard_params  # noqa: E402
from repro_torch.launch import partition as PT  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch.mesh import (counting_collectives,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-5
ARCH = "whisper-large-v3"
B, TEXT, MAX_LEN, STEPS = 2, 5, 24, 3


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(8, 512, (B, TEXT)).astype(np.int32),
             "frames": rng.randn(B, cfg.encoder.n_frames,
                                 cfg.d_model).astype(np.float32)}
    jc = JT.init_cache(jcfg, B, MAX_LEN)
    jl, jc = JT.prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jc)
    trace = [(None, np.asarray(jl))]
    for _ in range(STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        trace.append((tok, np.asarray(jl)))
    return cfg, tp, batch, trace, np.asarray(jc["cross_kv"].k)


def cpu_mesh(tp):
    return make_mesh((tp,), ("model",), devices=["cpu"] * tp)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _run(setup, tp, kv_shard, plant=None):
    """Prefill and ``STEPS`` decode steps of a pod over a ``kv_shard``
    cache, fed the JAX trace's tokens: (each step's logits, the caches).
    ``plant(caches)`` edits the caches before the prefill."""
    cfg, params, batch, trace, _ = setup
    mesh = cpu_mesh(tp)
    shards = shard_params(params, cfg, mesh)
    caches = T.init_cache(cfg, B, MAX_LEN, mesh=mesh, kv_shard=kv_shard)
    if plant is not None:
        plant(caches)
    lg, _ = T.prefill(shards, cfg, {k: torch.from_numpy(v) for k, v in
                                    batch.items()}, caches, mesh=mesh)
    out = [lg]
    for tok, _ in trace[1:]:
        lg, _ = T.decode_step(shards, cfg, torch.from_numpy(tok.copy()),
                              caches, mesh=mesh)
        out.append(lg)
    return out, caches


@pytest.mark.parametrize("tp", [2, 3])
@pytest.mark.parametrize("kv_shard", ["seq", "head_dim"])
def test_each_rank_holds_its_frames_or_dims(setup, kv_shard, tp):
    """Rank r's ``cross_kv`` holds every query head over its frames
    (``seq``) or its dims (``head_dim``), a ``split_range`` of 16 frames
    or 32 dims, and after the prefill exactly the JAX single device's
    encoder K of that piece."""
    cfg, _, _, _, jk = setup
    _, caches = _run(setup, tp, kv_shard)
    nf, hd = cfg.encoder.n_frames, cfg.head_dim
    for r, c in enumerate(caches):
        x = c["cross_kv"]
        assert x.k.shape[3] == cfg.n_heads
        if kv_shard == "seq":
            f0, f1 = PT.split_range(nf, tp, r)
            assert (x.row0, x.total, x.k.shape[2]) == (f0, nf, f1 - f0)
            want = jk[:, :, f0:f1]
        else:
            d0, d1 = PT.split_range(hd, tp, r)
            assert (x.dim0, x.dims, x.k.shape[-1]) == (d0, hd, d1 - d0)
            assert x.k.shape[2] == nf
            want = jk[..., d0:d1]
        _close(x.k, want)


@pytest.mark.parametrize("tp", [2, 3])
@pytest.mark.parametrize("kv_shard", ["seq", "head_dim", "auto"])
def test_split_cross_decode_matches_jax(setup, kv_shard, tp):
    """Prefill and decode logits over split caches within ``TOL`` of the
    JAX single device ("auto" at TP=3: the sequence, 2 KV heads not
    dividing), greedy tokens equal; the decode records the split read's
    collectives."""
    _, _, _, trace, _ = setup
    got, caches = _run(setup, tp, kv_shard)
    for g, (_, want) in zip(got, trace):
        _close(g, want)
        np.testing.assert_array_equal(g[:, -1].argmax(-1).numpy(),
                                      want[:, -1].argmax(-1))
    cfg, params = setup[0], setup[1]
    mesh = cpu_mesh(tp)
    with counting_collectives() as coll:
        T.decode_step(shard_params(params, cfg, mesh), cfg,
                      torch.from_numpy(trace[1][0].copy()), caches,
                      mesh=mesh)
    if PT.kv_layout(cfg, tp, kv_shard) != "heads":
        assert coll["all-gather"] > 0 and coll["count"] > 0


def test_planted_frame_offset_is_caught(setup):
    """Rank 1's frames shifted back by one (it writes and reads frames
    ``[f0 - 1, f1 - 1)``) lies far outside ``TOL``: the gate of
    ``chip_smoke.py``'s audio-seq phase catches it."""
    _, _, _, trace, _ = setup

    def shift(caches):
        caches[1]["cross_kv"].row0 -= 1

    got, _ = _run(setup, 2, "seq", plant=shift)
    gap = max(float(np.abs(g.numpy() - w).max())
              for g, (_, w) in zip(got[1:], trace[1:]))
    assert gap > 100 * TOL


@pytest.mark.parametrize("kv_shard", ["auto", "head_dim"])
def test_records_hold_the_references_cross_kv_piece(kv_shard):
    """The published whisper's decode_32k rank program at a model axis of
    16: the busiest rank's ``cross_kv`` has the local shape of the
    reference's ``cache_pspecs`` spec (GSPMD's padded shard: 94 of 1500
    frames under "auto", which is the sequence there; 4 of 64 dims under
    "head_dim"), and the record's per-device argument bytes hold it."""
    cfg, shape = get_config(ARCH), S.SHAPES["decode_32k"]
    mesh = make_production_mesh()
    _, inputs, tp = dryrun.rank_program(cfg, shape, mesh, kv_shard=kv_shard)
    caches = [c for _, c in dryrun.rank_owners(inputs, "decode")]
    jcfg = jax_get_config(ARCH)
    jc = jax.eval_shape(lambda: JT.init_cache(jcfg, shape.global_batch,
                                              shape.seq_len))
    spec = JPT.cache_pspecs(jcfg, jc, "data", model_size=16,
                            kv_shard=kv_shard)["cross_kv"].k
    sizes = {"data": 16, "model": 16}
    want = tuple(n if ax is None else math.ceil(n / sizes[ax])
                 for n, ax in zip(jc["cross_kv"].k.shape, spec))
    got = [tuple(c["cross_kv"].k.shape) for c in caches]
    assert max(got) == want
    assert tp == 16 and len(set(got)) == (2 if kv_shard == "auto" else 1)
    rec = dryrun.lower_one(ARCH, "decode_32k", False, kv_shard=kv_shard)
    assert rec["kv_shard"] == ("seq" if kv_shard == "auto" else kv_shard)
    held = max(sum(dryrun._storages(o).values())
               for o in dryrun.rank_owners(inputs, "decode"))
    assert rec["memory_analysis"]["argument_size_in_bytes"] == held + (
        inputs[1].numel() * inputs[1].element_size())
    cross = 2 * math.prod(want) * 2  # K and V, bf16
    assert held > cross
