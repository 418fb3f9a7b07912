"""The bf16 SSD kernel's three passes (chunk states from zero, the carry,
the outputs), as their plain model ``ref.ssd_scan_passes``, against the
plain scan ``ref.ssd_scan``, the JAX package's Pallas kernel (interpret
mode on the CPU) and its sequential recurrence; the workspace the wrapper
allocates for them; and the planted faults of ``chip_smoke.py`` that edit
``ssd_scan.cu``, against the kernels they are meant to reach.

Tolerance: 1e-4 abs, as ``tests/test_kernels.py`` holds the Pallas kernel
and ``tests/test_torch_ssm.py`` the plain scan (the same sums in another
association, in fp32).
"""
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4


def _inputs(seed, b, s, h, p, n, pad=0, decay=0.1):
    """x, a, B, C from numpy; the last ``pad`` positions zero, as the model
    pads a prompt to a multiple of the chunk."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    a = (-np.abs(rng.randn(b, s, h)) * decay).astype(np.float32)
    bm = rng.randn(b, s, h, n).astype(np.float32)
    cm = rng.randn(b, s, h, n).astype(np.float32)
    if pad:
        for t in (x, a, bm, cm):
            t[:, s - pad:] = 0
    return x, a, bm, cm


# (b, s, h, p, n, chunk, pad): many chunks (chunk 1, 16 and 45), one chunk
# of the exact length (chunk = S), B > 1, and a padded tail
CASES = [
    (2, 24, 2, 16, 8, 1, 0),
    (1, 128, 2, 32, 16, 16, 0),
    (2, 90, 2, 32, 16, 45, 0),
    (2, 137, 2, 32, 16, 137, 0),
    (3, 64, 2, 64, 128, 32, 0),
    (1, 160, 3, 32, 16, 32, 50),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,pad", CASES)
def test_passes_match_plain_pallas_and_sequential(b, s, h, p, n, chunk, pad):
    x, a, bm, cm = _inputs(s + chunk, b, s, h, p, n, pad)
    y, fs = ref.ssd_scan_passes(*map(torch.from_numpy, (x, a, bm, cm)),
                                chunk=chunk)
    assert y.shape == (b, s, h, p) and fs.shape == (b, h, p, n)
    py, pfs = ref.ssd_scan(*map(torch.from_numpy, (x, a, bm, cm)),
                           chunk=chunk)
    jin = tuple(map(jnp.asarray, (x, a, bm, cm)))
    jy, jfs = jax_ops.ssd_scan(*jin, chunk=chunk)
    sy, sfs = JS.ssd_reference_sequential(*jin)
    for want_y, want_fs in ((py, pfs), (jy, jfs), (sy, sfs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL)
        np.testing.assert_allclose(fs.numpy(), np.asarray(want_fs),
                                   atol=ATOL)
    if pad:  # the padded positions add nothing to the state
        _, short_fs = ref.ssd_scan_passes(
            *(torch.from_numpy(t[:, :s - pad]) for t in (x, a, bm, cm)),
            chunk=s - pad)
        np.testing.assert_allclose(fs.numpy(), short_fs.numpy(), atol=ATOL)


def test_passes_keep_the_input_dtype_and_refuse_a_ragged_chunk():
    x, a, bm, cm = (torch.from_numpy(v) for v in _inputs(1, 1, 64, 2, 32, 16))
    y, fs = ref.ssd_scan_passes(x.bfloat16(), a, bm.bfloat16(), cm.bfloat16(),
                                chunk=32)
    assert y.dtype == fs.dtype == torch.bfloat16
    want_y, want_fs = ref.ssd_scan(x.bfloat16(), a, bm.bfloat16(),
                                   cm.bfloat16(), chunk=32)
    # both round an fp32 result to bf16: one bf16 ulp apart at most
    for got, want in ((y, want_y), (fs, want_fs)):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-5,
                                   rtol=2.0 ** -7)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.ssd_scan_passes(x, a, bm, cm, chunk=48)


@pytest.mark.parametrize("b,s,h,p,n,chunk,want", [
    (1, 137, 24, 64, 128, 137, 0),             # one chunk: no workspace
    (1, 512, 24, 64, 128, 256, 2 * 24 * (64 * 128 + 1)),
    (1, 32768, 24, 64, 128, 256, 128 * 24 * (64 * 128 + 1)),
    (3, 64, 4, 64, 16, 1, 3 * 64 * 4 * (64 * 16 + 1)),
])
def test_workspace_holds_each_chunk_state_and_end_decay(b, s, h, p, n, chunk,
                                                        want):
    assert ops.ssd_workspace_floats(b, s, h, p, n, chunk) == want


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the kernels of ``ssd_scan.cu`` each SSD fault is meant to edit
SSD_FAULT_KERNELS = {
    "drop_carried_state": {"ssd_kernel", "output_kernel"},
    "ssd_operands_in_bf16": {"chunk_state_kernel", "output_kernel"},
    "carry_no_decay": {"carry_kernel"},
}


@pytest.mark.parametrize("kind", sorted(SSD_FAULT_KERNELS))
def test_ssd_faults_reach_the_kernels_they_mean(kind):
    """Each SSD fault's patterns edit exactly the kernels of
    ``ssd_scan.cu`` it names: ``drop_carried_state`` both bodies (fp32 and
    the bf16 output pass), ``ssd_operands_in_bf16`` the two bf16 passes
    with products, ``carry_no_decay`` the carry pass."""
    text = (build.CSRC / "ssd_scan.cu").read_text()
    starts = sorted((text.index(f"\n{k}("), k) for k in (
        "ssd_kernel", "chunk_state_kernel", "carry_kernel", "output_kernel"))
    starts.append((text.index("\n// launches"), None))

    def kernel_at(pos):
        return max((s, k) for s, k in starts if s < pos)[1]

    hits = {kernel_at(m.start())
            for src, pattern, _ in _chip_smoke().PLANTED_FAULTS[kind]
            if src == "ssd_scan.cu" for m in re.finditer(pattern, text)}
    assert hits == SSD_FAULT_KERNELS[kind]
