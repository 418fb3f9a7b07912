"""The LM training path's kernels on the card (``gpu`` marker; each test
skips without a card, decided inside the test): ``flash_attention`` and
``ssd_scan`` under ``torch.no_grad()`` against their plain versions and
their refusal under grad, and the evaluation forward through the kernels
against the plain forward.  No JAX here: the card's machine has none.

    python -m pytest -q -m gpu tests/test_torch_train_lm_card.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def requires_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.gpu
def test_kernels_on_card_match_plain_under_no_grad():
    """``flash_attention`` (bf16, within one bf16 ulp of 2^-6 at these
    magnitudes) and ``ssd_scan`` (fp32, 2e-4) under ``torch.no_grad()``
    match their plain versions, and raise under grad before launching."""
    requires_card()
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = (rand(2, 128, h, 64, dtype=torch.bfloat16) for h in (4, 2, 2))
    x, bm, cm = rand(2, 64, 2, 64), rand(2, 64, 2, 128), rand(2, 64, 2, 128)
    a = -rand(2, 64, 2).abs()
    ops.reset_launches()
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
        y, final = ops.ssd_scan(x, a, bm, cm, chunk=32)
    assert ops.flash_attention.launches == 1 and ops.ssd_scan.launches == 1
    want = ref.flash_attention(q.float(), k.float(), v.float())
    assert (out.float() - want).abs().max().item() <= 2.0 ** -6
    y_want, final_want = ref.ssd_scan(x, a, bm, cm, chunk=32)
    assert torch.allclose(y, y_want, atol=2e-4, rtol=2e-4)
    assert torch.allclose(final, final_want, atol=2e-4, rtol=2e-4)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.flash_attention(q.requires_grad_(True), k, v)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd_scan(x.requires_grad_(True), a, bm, cm, chunk=32)
    assert ops.flash_attention.launches == 1 and ops.ssd_scan.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m"])
def test_evaluation_forward_through_kernels_on_card(arch):
    """The reduced config in fp32 (TF32 off): ``loss_fn(attn_impl=
    "kernel")`` under ``torch.no_grad()`` launches one kernel a layer and
    agrees with the plain forward within 1e-5; under grad it raises."""
    requires_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = {k: v.cuda() for k, v in next(train.batches(cfg, 2, 64)).items()}
    name = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    ops.reset_launches()
    with torch.no_grad():
        got, _ = loss_fn(params, cfg, batch, attn_impl="kernel")
        assert getattr(ops, name).launches == cfg.n_layers
        want, _ = loss_fn(params, cfg, batch, attn_impl="torch")
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item())
    params["embed"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match=name):
        loss_fn(params, cfg, batch, attn_impl="kernel")
