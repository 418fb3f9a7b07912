"""Attention kernels of the port: their plain PyTorch versions against the
JAX package's Pallas kernels (interpret mode on the CPU), the dispatch of
the wrappers, and — on a card only — the CUDA kernels against their plain
versions.

Tolerances, as (atol, rtol) in |got - want| <= atol + rtol * |want|: fp32
(2e-5, 2e-5), the same sums in another order (online against full
softmax); bf16 (2e-5, 2^-7), one bf16 ulp of the result, since kernel and
plain version each round an fp32 result to bf16.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 2.0 ** -7)}


def requires_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _inputs(seed, q_shape, kv_shape):
    rng = np.random.RandomState(seed)
    return (rng.randn(*q_shape).astype(np.float32),
            rng.randn(*kv_shape).astype(np.float32),
            rng.randn(*kv_shape).astype(np.float32))


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# GQA ratios 1, 2 and 6 (H / KH)
HEADS = [(4, 4), (4, 2), (6, 1)]


@pytest.mark.parametrize("h,kh", HEADS)
@pytest.mark.parametrize("window", [None, 16])
def test_plain_flash_decode_matches_pallas(h, kh, window):
    B, L, D = 4, 64, 32
    q, k, v = _inputs(0, (B, 1, h, D), (B, L, kh, D))
    kv_len = np.array([1, 17, 40, L], np.int32)  # ragged, 1 and L included
    q_off = kv_len - 1
    want = jax_ops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), kv_len=jnp.asarray(kv_len),
                                q_offset=jnp.asarray(q_off), window=window,
                                block_k=32)
    got = ref.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           kv_len=torch.from_numpy(kv_len),
                           q_offset=torch.from_numpy(q_off), window=window)
    _close(got, want)


@pytest.mark.parametrize("h,kh", HEADS)
@pytest.mark.parametrize("window", [None, 24])
def test_plain_flash_attention_matches_pallas(h, kh, window):
    B, S, D = 2, 64, 32
    q, k, v = _inputs(1, (B, S, h, D), (B, S, kh, D))
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, block_q=32, block_k=32)
    got = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window)
    _close(got, want)


def test_plain_flash_attention_query_offset_matches_pallas():
    q, k, v = _inputs(2, (1, 32, 4, 32), (1, 32, 2, 32))
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, q_offset=5,
                                   block_q=32, block_k=32)
    got = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), q_offset=5)
    _close(got, want)


def test_plain_versions_zero_fully_masked_rows():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, (2, 1, 4, 32),
                                                    (2, 16, 2, 32)))
    out = ref.flash_decode(q, k, v, kv_len=torch.tensor([0, 5]),
                           q_offset=torch.tensor([0, 4]))
    assert bool((out[0] == 0).all()) and bool(out[1].abs().sum() > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_on_cpu_run_the_plain_versions(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs(4, (2, 1, 4, 32), (2, 16, 2, 32)))
    before = (ops.flash_decode.launches, ops.flash_attention.launches)
    kv_len = torch.tensor([3, 16], dtype=torch.int32)
    got = ops.flash_decode(q, k, v, kv_len=kv_len, q_offset=kv_len - 1)
    want = ref.flash_decode(q, k, v, kv_len=kv_len, q_offset=kv_len - 1)
    assert torch.equal(got, want) and got.dtype == dtype
    qs, ks, vs = (torch.from_numpy(a).to(dtype)
                  for a in _inputs(5, (2, 16, 4, 32), (2, 16, 2, 32)))
    assert torch.equal(ops.flash_attention(qs, ks, vs, window=8),
                       ref.flash_attention(qs, ks, vs, window=8))
    # only a kernel launch counts
    assert (ops.flash_decode.launches,
            ops.flash_attention.launches) == before


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor on neither the CPU nor the card is refused."""
    q = torch.empty((1, 1, 4, 32), device="meta")
    k = torch.empty((1, 16, 2, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_decode(q, k, k, kv_len=1, q_offset=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, k, k)


def _library_name_after_edit(tmp_path, monkeypatch, edited):
    """The decode library's path before and after appending a newline to
    ``edited`` (its source or a shared header) in a copy of ``csrc``."""
    for f in ("decode_attention.cu",) + build.HEADERS:
        text = (build.CSRC / f).read_text()
        (tmp_path / f).write_text(text + "\n" if f == edited else text)
    before = build.library_path("decode_attention")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return before, build.library_path("decode_attention")


def test_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    for name in build.SOURCES:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    before, after = _library_name_after_edit(tmp_path, monkeypatch,
                                             "decode_attention.cu")
    assert after != before


def test_build_is_keyed_on_the_shared_header(tmp_path, monkeypatch):
    before, after = _library_name_after_edit(tmp_path, monkeypatch,
                                             "common.cuh")
    assert after != before


def test_missing_nvcc_is_reported(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


# --------------------------------------------------------------------------- #
# On the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------- #


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,d", [(12, 2, 128), (4, 2, 32), (6, 1, 64)])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_decode_kernel_matches_plain_on_card(dtype, h, kh, d, window):
    requires_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, L = 4, 512
    q = torch.randn((B, 1, h, d), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((B, L, kh, d), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((B, L, kh, d), generator=gen, device="cuda", dtype=dtype)
    kv_len = torch.tensor([1, 77, 300, L], dtype=torch.int32, device="cuda")
    n = ops.flash_decode.launches
    got = ops.flash_decode(q, k, v, kv_len=kv_len, q_offset=kv_len - 1,
                           window=window)
    want = ref.flash_decode(q, k, v, kv_len=kv_len, q_offset=kv_len - 1,
                            window=window)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == n + 1
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 16, 100, 512])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_kernel_matches_plain_on_card(dtype, S, window):
    requires_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((2, S, 12, 128), generator=gen, device="cuda",
                    dtype=dtype)
    k = torch.randn((2, S, 2, 128), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((2, S, 2, 128), generator=gen, device="cuda", dtype=dtype)
    n = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window)
    want = ref.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 1
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
