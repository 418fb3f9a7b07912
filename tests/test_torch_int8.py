"""The port's int8 and ring KV caches against the JAX package on the CPU:
``quantize_kv``, the plain version of ``flash_decode_int8`` against the
Pallas kernel (interpret mode), the wrapper's dispatch, the reduced
qwen2-1.5b (2 layers, d 128, 4/2 heads, head dim 32, fp32) prefilling and
decoding over an int8 cache and over a ring, the bridge, and, on a card
only, the CUDA kernel against its plain version.

Tolerances: fp32 2e-5 abs + rel (the same sums in another order); codes of
one input, frozen cache rows and tokens are compared exactly; bf16 on the
card (2e-5, 2^-7), one bf16 ulp of the result.
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
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import (cache_from_numpy, cache_to_numpy,  # noqa: E402
                                params_from_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import make_mesh, shard_params  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-5
#: decode logits over an int8 cache once a code differs from JAX's (see
#: ``_codes_match``): that code's K or V element is one quantization step
#: (1/127 of its token's amax) away, which moves the logits by ~1e-4
FLIPPED_CODE_TOL = 1e-3
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


def _int8_inputs(seed, B, L_, h, kh, D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, h, D).astype(np.float32)
    kf = rng.randn(B, L_, kh, D).astype(np.float32) * 3.0
    vf = rng.randn(B, L_, kh, D).astype(np.float32) * 3.0
    kq, ks = JL.quantize_kv(jnp.asarray(kf))
    vq, vs = JL.quantize_kv(jnp.asarray(vf))
    return q, (kq, vq, ks, vs)


# --------------------------------------------------------------------------- #
# Quantization and the kernel's plain version
# --------------------------------------------------------------------------- #


def test_quantize_kv_matches_reference():
    """Codes identical, scales within 1e-7: both divide by the scale and
    round half to even.  A token of zeros takes the 1e-8 floor."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 16, 2, 32) * rng.uniform(0.1, 50, (3, 16, 1, 1))
         ).astype(np.float32)
    x[1, 3] = 0.0
    # a token whose scale is exactly 1: its .5 values round half to even
    x[2, 5] = rng.uniform(-1, 1, (2, 32))
    x[2, 5, 0, :4] = [127.0, -63.5, 0.5, 1.5]
    jq, js = JL.quantize_kv(jnp.asarray(x))
    tq, ts = L.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7,
                               atol=0)
    assert float(ts[1, 3]) == pytest.approx(1e-8)
    assert tq[2, 5, 0, :4].tolist() == [127, -64, 0, 2]
    np.testing.assert_array_equal(
        L.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(JL.dequantize_kv(jq, js, jnp.float32)))
    # bf16 input quantizes from its fp32 value
    xb = _t(x).to(torch.bfloat16)
    jqb, _ = JL.quantize_kv(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16))
    np.testing.assert_array_equal(L.quantize_kv(xb)[0].numpy(),
                                  np.asarray(jqb))


# GQA ratios 1, 2 and 6 (H / KH)
HEADS = [(4, 4), (4, 2), (6, 1)]


@pytest.mark.parametrize("h,kh", HEADS)
@pytest.mark.parametrize("window", [None, 16])
def test_plain_flash_decode_int8_matches_pallas(h, kh, window):
    """kv_len 0 (every key masked: 0 out) and kv_len > L (a step at
    ``len == L``) included."""
    B, L_, D = 4, 64, 32
    q, (kq, vq, ks, vs) = _int8_inputs(1, B, L_, h, kh, D)
    kv_len = np.array([0, 17, 40, L_ + 1], np.int32)
    q_off = np.array([0, 16, 39, L_], np.int32)
    want = jax_ops.flash_decode_int8(
        jnp.asarray(q), kq, vq, ks, vs, kv_len=jnp.asarray(kv_len),
        q_offset=jnp.asarray(q_off), window=window, block_k=32)
    got = ref.flash_decode_int8(_t(q), _t(kq), _t(vq), _t(ks), _t(vs),
                                kv_len=_t(kv_len), q_offset=_t(q_off),
                                window=window)
    _close(got, want)
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_wrapper_on_cpu_runs_the_plain_version(dtype):
    q, (kq, vq, ks, vs) = _int8_inputs(2, 2, 16, 4, 2, 32)
    q = _t(q).to(dtype)
    k, v, ksc, vsc = (_t(a) for a in (kq, vq, ks, vs))
    before = ops.flash_decode_int8.launches
    kv_len = torch.tensor([3, 16], dtype=torch.int32)
    got = ops.flash_decode_int8(q, k, v, ksc, vsc, kv_len=kv_len,
                                q_offset=kv_len - 1, window=8)
    want = ref.flash_decode_int8(q, k, v, ksc, vsc, kv_len=kv_len,
                                 q_offset=kv_len - 1, window=8)
    assert torch.equal(got, want) and got.dtype == dtype
    assert ops.flash_decode_int8.launches == before  # only a launch counts
    assert ops.KERNELS["flash_decode_int8"] is ops.flash_decode_int8


def test_int8_wrapper_refuses_other_inputs():
    q, (kq, vq, ks, vs) = _int8_inputs(3, 2, 16, 4, 2, 32)
    q, k, v, ksc, vsc = (_t(a) for a in (q, kq, vq, ks, vs))
    kw = dict(kv_len=4, q_offset=3)
    with pytest.raises(ValueError, match="int8"):
        ops.flash_decode_int8(q, k.float(), v.float(), ksc, vsc, **kw)
    with pytest.raises(ValueError, match="scales"):
        ops.flash_decode_int8(q, k, v, ksc[:, :8], vsc, **kw)
    with pytest.raises(ValueError, match="scales"):
        ops.flash_decode_int8(q, k, v, ksc, vsc.double(), **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_decode_int8(q.to("meta"), k.to("meta"), v.to("meta"),
                              ksc.to("meta"), vsc.to("meta"), **kw)


# --------------------------------------------------------------------------- #
# The model over an int8 cache and over a ring
# --------------------------------------------------------------------------- #


def _codes_match(got, want, limit: int) -> int:
    """Codes of the model's caches: the port's K/V come from matrix
    products summed in another order than JAX's (fp32, differences of
    ~1e-7 relative), so a value within that of a rounding boundary
    (x / scale = n + 0.5) may round to the neighbouring code.  Such codes
    differ by exactly 1, and there are at most ``limit`` of them; every
    other code is identical.  Returns how many differ."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    n = int((diff > 0).sum())
    assert diff.max() <= 1 and n <= limit, (n, got.size)
    return n


def _check_cache(tc, jc, limit=8) -> int:
    """Compare the caches; returns how many codes differ (int8 only)."""
    got, jkv = tc["kv"], jc["kv"]
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert got.ring == jkv.ring and got.quantized == jkv.quantized
    if not got.quantized:
        _close(got.k, jkv.k)
        _close(got.v, jkv.v)
        return 0
    _close(got.k_scale, jkv.k_scale)
    _close(got.v_scale, jkv.v_scale)
    return (_codes_match(got.k.numpy(), jkv.k, limit)
            + _codes_match(got.v.numpy(), jkv.v, limit))


def _rows(cache, slot):
    kv = cache["kv"]
    leaves = [kv.k, kv.v] + ([kv.k_scale, kv.v_scale] if kv.quantized
                             else [])
    return [t[:, slot].clone() for t in leaves]


def _prefill_then_decode(setup, impl, *, kv_dtype, max_len, prompt_len,
                         sliding_window=None, steps=16):
    """Prefill 3 prompts, then ``steps`` greedy decode steps with slot 1
    frozen from step 4 on, in JAX (plain path) and in the port
    (``impl``); every step's logits (within 2e-5 while every code read is
    JAX's, else ``FLIPPED_CODE_TOL``), tokens and caches are compared,
    and the frozen slot's rows bit for bit."""
    jcfg, cfg, jp, tp = setup
    rng = np.random.RandomState(prompt_len)
    toks = rng.randint(8, 512, size=(3, prompt_len)).astype(np.int32)
    jc = JT.init_cache(jcfg, 3, max_len, kv_dtype=kv_dtype,
                       sliding_window=sliding_window)
    tc = T.init_cache(cfg, 3, max_len, "cpu", kv_dtype=kv_dtype,
                      sliding_window=sliding_window)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = T.prefill(tp, cfg, {"tokens": _t(toks)}, tc, attn_impl=impl)
    _close(tl, jl)
    _check_cache(tc, jc)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    frozen = None
    for step in range(steps):
        act = np.array([True, step < 4, True])
        if step == 4:
            frozen = _rows(tc, 1)
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                active=jnp.asarray(act))
        tl, tc = T.decode_step(tp, cfg, _t(tok), tc, attn_impl=impl,
                               active=_t(act))
        # the step reads the row it wrote: compare its codes first
        flipped = _check_cache(tc, jc)
        _close(tl, jl, TOL if flipped == 0 else FLIPPED_CODE_TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0])
    for got, want in zip(_rows(tc, 1), frozen):
        assert torch.equal(got, want)
    return tc


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_int8_cache_prefill_and_decode_match_reference(setup, impl):
    tc = _prefill_then_decode(setup, impl, kv_dtype="int8", max_len=64,
                              prompt_len=32)
    kv = tc["kv"]
    assert kv.k.dtype == torch.int8 and kv.k_scale.dtype == torch.float32
    assert tuple(kv.k_scale.shape) == tuple(kv.k.shape[:3])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("prompt_len,ring", [(40, 24), (20, 32)])
def test_ring_cache_matches_reference(setup, kv_dtype, prompt_len, ring):
    """A ring of ``ring`` rows in a cache of 128: a prompt longer than the
    ring, and one shorter that decodes past the wrap (rows not yet written
    are attended as the reference attends them: qwen2 has no window)."""
    tc = _prefill_then_decode(setup, "kernel", kv_dtype=kv_dtype,
                              max_len=128, prompt_len=prompt_len,
                              sliding_window=ring, steps=20)
    assert tc["kv"].ring and tc["kv"].k.shape[2] == ring


def test_ring_read_launches_no_kernel(setup):
    """The reference reads a ring through XLA whatever attn_impl is, so
    the port's kernel path reads it plain: on the CPU that shows as the
    plain read being called with ring positions, not the decode wrappers."""
    _, cfg, _, tp = setup
    calls = []
    real = ops.flash_decode_int8
    ops.flash_decode_int8 = lambda *a, **k: calls.append(1)
    try:
        cache = T.init_cache(cfg, 2, 64, "cpu", kv_dtype="int8",
                             sliding_window=16)
        T.prefill(tp, cfg, {"tokens": torch.full((2, 20), 9)}, cache)
        T.decode_step(tp, cfg, torch.full((2, 1), 9), cache)
    finally:
        ops.flash_decode_int8 = real
    assert calls == []


def test_int8_under_tensor_parallelism_raises(setup):
    """An int8 cache under a mesh raised until ROADMAP.md queue 1, item
    8.3 landed; now a TP=2 pod's decode step over it writes every rank
    the one-device cache's scales (one cross-rank max; relative 1e-6: the
    ranks' K projections sum in another order) and its KV head's codes,
    and gives one device's logits (``tests/test_torch_mesh_steps.py``
    holds the pods against the JAX package, the scales bit for bit on
    the same K/V)."""
    _, cfg, _, tp = setup
    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    pod = T.init_cache(cfg, 2, 32, "cpu", mesh=mesh, kv_dtype="int8")
    one = T.init_cache(cfg, 2, 32, "cpu", kv_dtype="int8")
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    want, _ = T.decode_step(tp, cfg, tok, one)
    got, _ = T.decode_step(shard_params(tp, cfg, mesh), cfg, tok, pod,
                           mesh=mesh)
    assert float((got - want).abs().max()) <= 1e-4
    for c in pod:
        for got_s, want_s in ((c["kv"].k_scale, one["kv"].k_scale),
                              (c["kv"].v_scale, one["kv"].v_scale)):
            assert torch.allclose(got_s, want_s, rtol=1e-6, atol=0)
        assert c["kv"].k.shape[3] == 1
    with pytest.raises(ValueError, match="kv_dtype"):
        T.init_cache(cfg, 2, 32, "cpu", kv_dtype="fp8")


def test_bridge_round_trips_an_int8_cache(setup):
    """A JAX int8 cache becomes the port's (int8 stays int8, whatever
    dtype is asked for), decodes as JAX's does, and converts back."""
    jcfg, cfg, jp, tp = setup
    toks = np.random.RandomState(5).randint(8, 512, (2, 24)).astype(np.int32)
    _, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       JT.init_cache(jcfg, 2, 48, kv_dtype="int8",
                                     sliding_window=16))
    kv = jc["kv"]
    tc = cache_from_numpy(np.asarray(jc["len"]), np.asarray(kv.k),
                          np.asarray(kv.v), k_scale=np.asarray(kv.k_scale),
                          v_scale=np.asarray(kv.v_scale), ring=kv.ring,
                          device="cpu", dtype=torch.bfloat16)
    assert tc["kv"].k.dtype == torch.int8 and tc["kv"].ring
    assert tc["kv"].k_scale.dtype == torch.float32
    back = cache_to_numpy(tc)
    for name, want in (("length", jc["len"]), ("k", kv.k), ("v", kv.v),
                       ("k_scale", kv.k_scale), ("v_scale", kv.v_scale)):
        assert back[name].dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(back[name], np.asarray(want))
    tok = np.array([[11], [12]], np.int32)
    jl, _ = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc)
    tl, _ = T.decode_step(tp, cfg, _t(tok), tc)
    _close(tl, jl)


# --------------------------------------------------------------------------- #
# On the card: the CUDA kernel against its plain version
# --------------------------------------------------------------------------- #


def requires_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


CARD_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 2.0 ** -7)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,d", [(12, 2, 128), (4, 4, 32), (16, 1, 64)])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_decode_int8_kernel_matches_plain_on_card(dtype, h, kh, d,
                                                        window):
    requires_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, L_ = 4, 512
    q = torch.randn((B, 1, h, d), generator=gen, device="cuda", dtype=dtype)
    k, v = (torch.randint(-127, 128, (B, L_, kh, d), generator=gen,
                          device="cuda", dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((B, L_), generator=gen, device="cuda") * 0.02 + 1e-3
              for _ in range(2))
    kv_len = torch.tensor([0, 77, 300, L_ + 1], dtype=torch.int32,
                          device="cuda")
    q_off = torch.tensor([0, 76, 299, L_], dtype=torch.int32, device="cuda")
    n = ops.flash_decode_int8.launches
    got = ops.flash_decode_int8(q, k, v, ks, vs, kv_len=kv_len,
                                q_offset=q_off, window=window)
    want = ref.flash_decode_int8(q, k, v, ks, vs, kv_len=kv_len,
                                 q_offset=q_off, window=window)
    torch.cuda.synchronize()
    assert ops.flash_decode_int8.launches == n + 1
    atol, rtol = CARD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
