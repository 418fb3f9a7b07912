"""The split-KV decode of the port: the host's split rule, a plain model of
the kernel's arithmetic (per-split partial states merged in the kernel's
order) against the plain decode and the JAX package's Pallas kernels
(interpret mode on the CPU), and — on a card only — the three decode
wrappers against their plain versions at a long, ragged cache.

Tolerances, as (atol, rtol) in |got - want| <= atol + rtol * |want|: fp32
(2e-5, 2e-5), the same sums in another order (split softmax against full
softmax); bf16 (2e-5, 2^-7), one bf16 ulp of the result, since kernel and
plain version each round an fp32 result to bf16.
"""
import inspect
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.partition import kv_head_range  # noqa: E402

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 2.0 ** -7)}
H100_SMS = 132


def requires_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# --------------------------------------------------------------------------- #
# The split rule
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("b,L,n_sm", [
    (1, 32, H100_SMS), (4, 512, H100_SMS), (8, 32768, H100_SMS),
    (128, 32768, H100_SMS), (4, 1000, H100_SMS), (3, 77, H100_SMS),
    (2048, 512, H100_SMS), (1, 524288, 114)])
def test_splits_are_tile_aligned_and_cover_the_keys_once(b, L, n_sm):
    n_split, s_len = ops.decode_splits(b, L, n_sm)
    assert 1 <= n_split <= ops.MAX_SPLITS
    assert s_len > 0 and s_len % ops.DECODE_TILE == 0
    # [s * s_len, (s + 1) * s_len) for s < n_split covers [0, L) once, and
    # no split lies wholly past L
    assert (n_split - 1) * s_len < L <= n_split * s_len
    assert n_split == 1 or s_len >= ops.MIN_SPLIT_TILES * ops.DECODE_TILE


def test_split_rule_values_and_inputs():
    """The served shape and decode_32k on an H100, and a rule of (B, L,
    SMs) alone: no heads and no per-slot lengths enter it."""
    assert ops.decode_splits(4, 512, H100_SMS) == (4, 128)
    assert ops.decode_splits(8, 32768, H100_SMS) == (16, 2048)
    assert ops.decode_splits(128, 32768, H100_SMS) == (9, 3648)
    assert ops.decode_splits(1, 32, H100_SMS) == (1, 32)
    assert list(inspect.signature(ops.decode_splits).parameters) == [
        "b", "L", "n_sm"]


# --------------------------------------------------------------------------- #
# The kernel's arithmetic, modelled plainly
# --------------------------------------------------------------------------- #

# G = H / KH of 1, 6 and 16
GROUPS = [(2, 2), (12, 2), (16, 1)]
# (n_split, s_len) over L = 224: one split; seven of one tile (most empty
# for the short slots); three of 96 keys (the last one partial)
SPLITS = [(1, 224), (7, 32), (3, 96)]
B, L, D = 4, 224, 32
# kv_len 0 (no key: 0 out), 5 (splits past it empty), 130, and L + 1 (a
# step at len == L); a window of 40 puts the lower edge of slot 2 (q_pos
# 129) at 90, inside a split of each partition
KV_LEN = np.array([0, 5, 130, L + 1], np.int32)
Q_OFF = np.array([0, 4, 129, L], np.int32)


def _inputs(seed, h, kh):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, h, D).astype(np.float32),
            rng.randn(B, L, kh, D).astype(np.float32) * 2.0,
            rng.randn(B, L, kh, D).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("h,kh", GROUPS)
@pytest.mark.parametrize("n_split,s_len", SPLITS)
@pytest.mark.parametrize("window", [None, 40])
def test_split_model_matches_plain_and_pallas(h, kh, n_split, s_len,
                                              window):
    q, k, v = _inputs(0, h, kh)
    kw = dict(kv_len=_t(KV_LEN), q_offset=_t(Q_OFF), window=window)
    got = ref.flash_decode_split(_t(q), _t(k), _t(v), n_split=n_split,
                                 s_len=s_len, **kw)
    _close(got, ref.flash_decode(_t(q), _t(k), _t(v), **kw))
    want = jax_ops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), kv_len=jnp.asarray(KV_LEN),
                                q_offset=jnp.asarray(Q_OFF), window=window,
                                block_k=32)
    _close(got, want)
    assert bool((got[0] == 0).all()) and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("h,kh", GROUPS)
@pytest.mark.parametrize("n_split,s_len", SPLITS)
@pytest.mark.parametrize("window", [None, 40])
def test_int8_split_model_matches_plain_and_pallas(h, kh, n_split, s_len,
                                                   window):
    q, kf, vf = _inputs(1, h, kh)
    kq, ksc = JL.quantize_kv(jnp.asarray(kf))
    vq, vsc = JL.quantize_kv(jnp.asarray(vf))
    kw = dict(kv_len=_t(KV_LEN), q_offset=_t(Q_OFF), window=window)
    codes = (_t(kq), _t(vq), _t(ksc), _t(vsc))
    got = ref.flash_decode_split(_t(q), codes[0], codes[1], k_scale=codes[2],
                                 v_scale=codes[3], n_split=n_split,
                                 s_len=s_len, **kw)
    _close(got, ref.flash_decode_int8(_t(q), *codes, **kw))
    want = jax_ops.flash_decode_int8(
        jnp.asarray(q), kq, vq, ksc, vsc, kv_len=jnp.asarray(KV_LEN),
        q_offset=jnp.asarray(Q_OFF), window=window, block_k=32)
    _close(got, want)
    assert bool((got[0] == 0).all()) and bool(torch.isfinite(got).all())


def test_split_model_every_split_empty_gives_zero():
    """All splits empty: each has m = -1e30, l = 0, acc = 0, so every
    e_s = exp(0) = 1 and the result is 0/1e-30 = 0, never NaN."""
    q, k, v = (_t(a) for a in _inputs(2, 4, 2))
    zero = torch.zeros(B, dtype=torch.int32)
    out = ref.flash_decode_split(q, k, v, kv_len=zero, q_offset=zero,
                                 n_split=7, s_len=32)
    assert bool((out == 0).all())


def test_split_model_at_the_rules_partition_of_a_ragged_length():
    """An L that is no multiple of 32, cut as the rule cuts it on an
    H100, against the plain decode."""
    rng = np.random.RandomState(3)
    b, L_, h, kh = 3, 1000, 6, 1
    q = _t(rng.randn(b, 1, h, D).astype(np.float32))
    k, v = (_t(rng.randn(b, L_, kh, D).astype(np.float32)) for _ in "kv")
    kv_len = torch.tensor([1, 517, L_ + 1], dtype=torch.int32)
    q_off = (kv_len - 1).clamp(0, L_)
    n_split, s_len = ops.decode_splits(b, L_, H100_SMS)
    assert n_split > 1
    for window in (None, 300):
        kw = dict(kv_len=kv_len, q_offset=q_off, window=window)
        _close(ref.flash_decode_split(q, k, v, n_split=n_split, s_len=s_len,
                                      **kw), ref.flash_decode(q, k, v, **kw))


# --------------------------------------------------------------------------- #
# On the card: the three decode wrappers at a long, ragged cache
# --------------------------------------------------------------------------- #

LONG_B, LONG_L = 8, 32768
#: 0 (no key), 1, within one tile, just past one, mid-split, just past a
#: split edge of the rule's partition (16 splits of 2048), L - 1, and
#: L + 1 (a step at len == L)
LONG_KV_LEN = [0, 1, 31, 33, 1000, 16385, 32767, 32769]


def _long_case(dtype, gen, kv_dtype=None):
    h, kh, d = 12, 2, 128
    q = torch.randn((LONG_B, 1, h, d), generator=gen, device="cuda",
                    dtype=dtype)
    if kv_dtype == torch.int8:
        k, v = (torch.empty((LONG_B, LONG_L, kh, d), dtype=torch.int8,
                            device="cuda").random_(-127, 128, generator=gen)
                for _ in "kv")
    else:
        k, v = (torch.randn((LONG_B, LONG_L, kh, d), generator=gen,
                            device="cuda", dtype=dtype) for _ in "kv")
    kv_len = torch.tensor(LONG_KV_LEN, dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, (kv_len - 1).clamp(0, LONG_L)


def _assert_within(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 3000])
def test_flash_decode_long_ragged_on_card(dtype, window):
    requires_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, kv_len, q_off = _long_case(dtype, gen)
    kw = dict(kv_len=kv_len, q_offset=q_off, window=window)
    n = ops.flash_decode.launches
    got = ops.flash_decode(q, k, v, **kw)
    want = ref.flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == n + 1
    assert ops.decode_plan(LONG_B, LONG_L, q.device)[0] > 1
    assert bool((got[0] == 0).all())
    _assert_within(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
def test_flash_decode_sharded_long_ragged_on_card(dtype, tp):
    """Each rank one contiguous range of query heads with the KV head it
    reads (TP=4 over 2 KV heads: one each); bit for bit the single-device
    kernel."""
    requires_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, kv_len, q_off = _long_case(dtype, gen)
    heads = SimpleNamespace(n_heads=q.shape[2], n_kv_heads=k.shape[2])
    ranges = [kv_head_range(heads, tp, r) for r in range(tp)]
    qs = [c.contiguous() for c in q.chunk(tp, dim=2)]
    ks, vs = ([x[:, :, a:e].contiguous() for a, e in ranges] for x in (k, v))
    kw = dict(kv_len=kv_len, q_offset=q_off)
    n = ops.flash_decode_sharded.launches
    got = torch.cat(ops.flash_decode_sharded(qs, ks, vs, **kw), dim=2)
    single = ops.flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_decode_sharded.launches == n + tp
    assert torch.equal(got, single)
    _assert_within(got, ref.flash_decode(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 3000])
def test_flash_decode_int8_long_ragged_on_card(dtype, window):
    requires_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, kv_len, q_off = _long_case(dtype, gen, torch.int8)
    ks, vs = (torch.empty((LONG_B, LONG_L), device="cuda").uniform_(
        0.005, 0.025, generator=gen) for _ in "kv")
    kw = dict(kv_len=kv_len, q_offset=q_off, window=window)
    n = ops.flash_decode_int8.launches
    got = ops.flash_decode_int8(q, k, v, ks, vs, **kw)
    want = ref.flash_decode_int8(q, k, v, ks, vs, **kw)
    torch.cuda.synchronize()
    assert ops.flash_decode_int8.launches == n + 1
    assert bool((got[0] == 0).all())
    _assert_within(got, want, dtype)
