"""The port's dense model against the JAX reference on the reduced
qwen2-1.5b (2 layers, d 128, 4/2 heads, head dim 32, fp32): layers,
prefill logits and caches, masked decode steps, token clamping, and the
sampler.

Tolerance: fp32 2e-5 abs + rel on logits, caches and layer outputs (the
same arithmetic summed in another order); frozen cache rows and clamped
ids are compared bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.engine.sampler import SamplerConfig, sample  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-5
ARCH = "qwen2-1.5b"


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #


def test_layers_match_reference(setup):
    jcfg, cfg, jp, tp = setup
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, cfg.d_model).astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    lp_t = T._unstack(tp["layers"], cfg.n_layers)[0]
    _close(L.rmsnorm(lp_t["attn_norm"], _t(x), cfg.norm_eps),
           JL.rmsnorm(lp_j["attn_norm"], jnp.asarray(x), jcfg.norm_eps))
    _close(L.mlp_block(lp_t["mlp"], cfg, _t(x)),
           JL.mlp_block(lp_j["mlp"], jcfg, jnp.asarray(x)))
    pos = np.array([[0, 1, 2, 3, 4, 5, 6, 7], [40, 41, 42, 43, 44, 45, 46,
                                               47]], np.int32)
    cos, sin = L.rope_cos_sin(_t(pos), cfg.head_dim, cfg.rope_theta)
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(pos), jcfg.head_dim,
                                 jcfg.rope_theta)
    _close(cos, jcos)
    _close(sin, jsin)
    xh = rng.randn(2, 8, 4, cfg.head_dim).astype(np.float32)
    _close(L.apply_rotary(_t(xh), cos, sin),
           JL.apply_rotary(jnp.asarray(xh), jcos, jsin))
    # rmsnorm keeps bf16 in, bf16 out while computing in fp32
    xb = _t(x).to(torch.bfloat16)
    assert L.rmsnorm(lp_t["attn_norm"], xb).dtype == torch.bfloat16


@pytest.mark.parametrize("last_slot", [7, 8])
def test_masked_row_write_leaves_frozen_rows_bit_identical(last_slot):
    """Inactive rows, and a write past the buffer's end (a slot at
    ``len == max_len``, which the reference's scatter drops), leave the
    buffer bit-identical."""
    rng = np.random.RandomState(1)
    buf = rng.randn(3, 8, 2, 4).astype(np.float32)
    val = rng.randn(3, 2, 4).astype(np.float32)
    slot = np.array([1, 5, last_slot], np.int32)
    active = np.array([True, False, True])
    want = JL.masked_row_write(jnp.asarray(buf), jnp.asarray(slot),
                               jnp.asarray(val), jnp.asarray(active))
    got = L.masked_row_write(_t(buf), _t(slot), _t(val), _t(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[1], buf[1])
    if last_slot == 8:
        np.testing.assert_array_equal(got.numpy()[2], buf[2])


# --------------------------------------------------------------------------- #
# Prefill and decode
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", [("xla", "torch"), ("pallas", "kernel")])
def test_prefill_logits_and_cache_match_reference(setup, impl):
    jcfg, cfg, jp, tp = setup
    jimpl, timpl = impl
    rng = np.random.RandomState(2)
    toks = rng.randint(8, 512, size=(3, 32)).astype(np.int32)
    last = np.array([4, 31, 17], np.int32)  # right-padded rows
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        JT.init_cache(jcfg, 3, 64), attn_impl=jimpl,
                        last_index=jnp.asarray(last))
    tl, tc = T.prefill(tp, cfg, {"tokens": _t(toks)},
                       T.init_cache(cfg, 3, 64, "cpu"), attn_impl=timpl,
                       last_index=_t(last))
    assert tuple(tl.shape) == (3, 1, cfg.vocab_size)
    _close(tl, jl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    _close(tc["kv"].k, jc["kv"].k)
    _close(tc["kv"].v, jc["kv"].v)


def test_one_token_prefill_matches_reference(setup):
    """A prompt bucket of one token (``EngineConfig.prefill_bucket=1``) goes
    through the prefill attention path like any other."""
    jcfg, cfg, jp, tp = setup
    toks = np.array([[17], [300]], np.int32)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        JT.init_cache(jcfg, 2, 16), attn_impl="pallas")
    tl, tc = T.prefill(tp, cfg, {"tokens": _t(toks)},
                       T.init_cache(cfg, 2, 16, "cpu"), attn_impl="kernel")
    _close(tl, jl)
    _close(tc["kv"].k, jc["kv"].k)


@pytest.mark.gpu
def test_one_token_prefill_launches_the_kernel_on_card(setup):
    """On the card a one-token prefill runs the flash-attention kernel in
    every layer (no route to the plain version) and agrees with the plain
    path (fp32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg, _, tp = setup
    params = jax.tree_util.tree_map(lambda t: t.to("cuda"), tp)
    toks = torch.tensor([[17], [300]], dtype=torch.int32, device="cuda")
    out = {}
    for impl in ("kernel", "torch"):
        n = ops.flash_attention.launches
        out[impl], _ = T.prefill(params, cfg, {"tokens": toks},
                                 T.init_cache(cfg, 2, 16, "cuda"),
                                 attn_impl=impl)
        launched = ops.flash_attention.launches - n
        assert launched == (cfg.n_layers if impl == "kernel" else 0)
    _close(out["kernel"].cpu(), out["torch"].cpu())


@pytest.mark.parametrize("timpl", ["torch", "kernel"])
def test_decode_step_with_mixed_active_mask(setup, timpl):
    """Live rows match the reference; frozen rows keep their cache bit for
    bit and do not advance ``len``."""
    jcfg, cfg, jp, tp = setup
    rng = np.random.RandomState(3)
    toks = rng.randint(8, 512, size=(4, 16)).astype(np.int32)
    _, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       JT.init_cache(jcfg, 4, 32))
    lens = np.array([16, 3, 9, 16], np.int32)  # ragged slot depths
    jc["len"] = jnp.asarray(lens)
    tc = cache_from_numpy(lens, np.asarray(jc["kv"].k),
                          np.asarray(jc["kv"].v), device="cpu")
    before = {k: v.clone() for k, v in
              (("k", tc["kv"].k), ("v", tc["kv"].v), ("len", tc["len"]))}
    step = rng.randint(8, 512, size=(4, 1)).astype(np.int32)
    active = np.array([True, False, True, False])
    jl, jc2 = JT.decode_step(jp, jcfg, jnp.asarray(step), jc,
                             active=jnp.asarray(active))
    tl, tc = T.decode_step(tp, cfg, _t(step), tc, attn_impl=timpl,
                           active=_t(active))
    live = np.flatnonzero(active)
    _close(tl.numpy()[live], np.asarray(jl)[live])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc2["len"]))
    np.testing.assert_array_equal(tc["len"].numpy(), lens + active)
    for name, buf, jbuf in (("k", tc["kv"].k, jc2["kv"].k),
                            ("v", tc["kv"].v, jc2["kv"].v)):
        for row in np.flatnonzero(~active):
            assert torch.equal(buf[:, row], before[name][:, row])
        _close(buf.numpy()[:, live], np.asarray(jbuf)[:, live])


def test_out_of_range_ids_clamp_like_the_reference(setup):
    jcfg, cfg, jp, tp = setup
    toks = np.array([[8, 100, 511, 512, 8191, 70000, 9, 10]], np.int32)
    jl, _ = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       JT.init_cache(jcfg, 1, 16))
    tl, _ = T.prefill(tp, cfg, {"tokens": _t(toks)},
                      T.init_cache(cfg, 1, 16, "cpu"), attn_impl="torch")
    _close(tl, jl)
    clamped = np.minimum(toks, cfg.vocab_size - 1)
    tl2, _ = T.prefill(tp, cfg, {"tokens": _t(clamped)},
                       T.init_cache(cfg, 1, 16, "cpu"), attn_impl="torch")
    assert torch.equal(tl, tl2)
    emb = T.embed_tokens(tp, cfg, _t(toks))
    assert torch.equal(emb[0, 3], tp["embed"][cfg.vocab_size - 1])


# --------------------------------------------------------------------------- #
# Sampler
# --------------------------------------------------------------------------- #


def test_greedy_sampler_takes_the_first_maximum_and_pads_inactive_rows():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 1.0, 5.0, 5.0],
                           [0.0, 0.0, 0.0, 9.0]])
    want = np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1))
    got = sample(logits, None, SamplerConfig())
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    got = sample(logits, None, SamplerConfig(),
                 active=torch.tensor([True, False, True]), pad_token=0)
    assert got.tolist() == [1, 0, 3]


def test_temperature_sampler_is_seeded_and_respects_top_k():
    logits = torch.randn((64, 32), generator=torch.Generator().manual_seed(0))
    cfg = SamplerConfig(temperature=0.8, top_k=3)
    a = sample(logits, torch.Generator().manual_seed(7), cfg)
    b = sample(logits, torch.Generator().manual_seed(7), cfg)
    assert torch.equal(a, b)
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert bool((top3 == a[:, None].long()).any(dim=-1).all())
