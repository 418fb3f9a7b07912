"""The prefill kernel ``flash_attention``: its plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) at every head dim, a
ragged length, a query offset and a window that starts inside a tile; the
slice identity that ``chip_smoke.py`` uses to check the kernel at long
prompts on slices of its output; the planted faults of ``chip_smoke.py``
against the sources they edit; and — on a card only — the bf16
tensor-core kernel against its plain version.

Tolerances, as (atol, rtol) in |got - want| <= atol + rtol * |want|: fp32
(2e-5, 2e-5), the same sums in another order; bf16 (2e-5, 2^-7), one bf16
ulp of the result, since both sides round an fp32 result to bf16.
"""
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 2.0 ** -7)}


def _inputs(seed, q_shape, kv_shape):
    rng = np.random.RandomState(seed)
    return (rng.randn(*q_shape).astype(np.float32),
            rng.randn(*kv_shape).astype(np.float32),
            rng.randn(*kv_shape).astype(np.float32))


def _chip_smoke():
    """``chip_smoke.py`` imported from the repo root (its imports at module
    level are the standard library's; nothing touches a card)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (Sq, Skv, q_offset, window): a ragged length, a query offset with keys
# before the first query (a later prompt chunk), and windows whose lower
# edge falls inside a tile of the kernel (64 keys) and of the Pallas kernel
CASES = [(137, 137, 0, None), (137, 137, 0, 50), (137, 200, 63, None),
         (137, 200, 63, 50)]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,skv,q_offset,window", CASES)
def test_plain_flash_attention_matches_pallas(d, sq, skv, q_offset, window):
    """The Pallas kernel asserts S % block == 0, so it runs as one block of
    the whole (ragged) length."""
    q, k, v = _inputs(d + sq + skv, (2, sq, 4, d), (2, skv, 2, d))
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=window,
                                   q_offset=q_offset, block_q=sq, block_k=skv)
    got = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window,
                              q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("a,b", [(0, 64), (100, 237), (236, 300)])
def test_plain_flash_attention_slice_identity(dtype, window, a, b):
    """Rows [a, b) of the output over the whole prompt equal the output of
    q[:, a:b] over the keys [0, b) at query offset a: keys at or past b are
    masked for those rows, so the long-prompt check of ``chip_smoke.py``
    may compare the kernel's full output with the plain version on
    slices."""
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _inputs(7, (2, 300, 6, 32), (2, 300, 2, 32)))
    full = ref.flash_attention(q, k, v, window=window)
    part = ref.flash_attention(q[:, a:b], k[:, :b], v[:, :b], window=window,
                               q_offset=a)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(part.float(), full[:, a:b].float(), atol=atol,
                               rtol=rtol)


FAULTS = ["drop_v_scale", "drop_first_tile", "bf16_accumulate",
          "combine_no_rescale", "drop_carried_state", "p_in_bf16",
          "ssd_operands_in_bf16", "carry_no_decay"]


def test_planted_faults_are_all_listed():
    assert sorted(_chip_smoke().PLANTED_FAULTS) == sorted(FAULTS)


@pytest.mark.parametrize("kind", FAULTS)
def test_planted_fault_patterns_match_their_sources(kind):
    """Every pattern of a planted fault edits its source at least once, so
    ``--planted-fault`` never runs against an unchanged kernel."""
    faults = _chip_smoke().PLANTED_FAULTS
    for src, pattern, repl in faults[kind]:
        text = (build.CSRC / src).read_text()
        edited, n = re.subn(pattern, repl, text)
        assert n >= 1, f"{kind}: {pattern!r} matches nothing in {src}"
        assert edited != text


def test_rounding_scan_unpins_one_line_of_the_decode_kernel():
    """``chip_smoke.py --rounding-scan`` builds its second decode kernel by
    one edit: the denominator update, written as an explicit fma, left to
    the compiler again."""
    pattern, repl = _chip_smoke().UNPINNED_L
    text = (build.CSRC / "decode_attention.cu").read_text()
    edited, n = re.subn(pattern, repl, text)
    assert n == 1 and repl not in text and repl in edited


@pytest.mark.parametrize("kind", ["drop_first_tile", "bf16_accumulate"])
def test_prefill_faults_reach_both_bodies(kind):
    """The two prefill faults edit the fp32 CUDA-core body and the bf16
    tensor-core body of ``flash_attention.cu`` alike."""
    text = (build.CSRC / "flash_attention.cu").read_text()
    fp32_at = text.index("\nattn_kernel(")
    tc_at = text.index("\nattn_tc_kernel(")
    assert fp32_at < tc_at
    hits = [m.start() for src, pattern, _ in _chip_smoke().PLANTED_FAULTS[kind]
            if src == "flash_attention.cu"
            for m in re.finditer(pattern, text)]
    assert any(fp32_at < p < tc_at for p in hits), "misses the fp32 body"
    assert any(p > tc_at for p in hits), "misses the tensor-core body"


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("b,s", [(2, 137), (2, 1024), (2, 4096), (8, 4000)])
@pytest.mark.parametrize("q_offset,window", [(0, None), (37, None),
                                             (37, 100)])
def test_tensor_core_kernel_matches_plain_on_card(d, b, s, q_offset, window):
    """B=8, S=4000 (8 heads: 2048 blocks of 128 rows) runs the kernel's
    two-row-tile instance on any card of up to 512 SMs; the others (at most
    512 such blocks) run the one-row-tile instance on a 132-SM H100."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    gen = torch.Generator(device="cuda").manual_seed(d + s + q_offset)
    q = torch.randn((b, s, 8, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, s + q_offset, 2, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    n = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window, q_offset=q_offset)
    want = ref.flash_attention(q, k, v, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 1
    body = build.load("flash_attention_last_body")()
    if (b, s) == (8, 4000):
        assert body == 2
    elif torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert body == 1
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
