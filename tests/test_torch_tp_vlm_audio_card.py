"""Tensor-parallel vlm and audio pods on the card (``gpu`` marker; each
test skips without a card, decided inside the test): ``flash_attention``
on a rank's share of qwen2-vl-7b's (14/2 heads of dim 128) and
whisper-large-v3's (10/10 of dim 64) heads against its plain version,
``flash_decode_sharded`` at their TP=2 shares bit for bit against the
single-device kernel, and the step functions of reduced TP=2 pods (stub
patches with 3-D positions, or frames) against one device.  No JAX here:
the card's machine has none.

    python -m pytest -q -m gpu tests/test_torch_tp_vlm_audio_card.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import make_mesh, shard_params  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import transformer as T  # noqa: E402

#: (arch, heads, KV heads, head dim, slot rows) of the two pods, unsplit
WIDTHS = [("qwen2-vl-7b", 28, 4, 128, 512), ("whisper-large-v3", 20, 20, 64,
                                              448)]


def requires_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,h,kh,d,rows", WIDTHS)
def test_kernels_at_a_ranks_share_of_the_pod(arch, h, kh, d, rows, dtype):
    """A TP=2 rank's heads, both ranks on one card: ``flash_attention``
    (B=4, S=480 or 128) within the plain version's tolerance (2e-5 abs +
    rel in fp32, 2^-7 rel in bf16), one counted launch; and
    ``flash_decode_sharded`` over B=4 slots of ``rows`` rows with ragged
    ``kv_len``, the shards side by side equal to the single-device kernel
    bit for bit, one counted launch per shard."""
    requires_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    s, tp = (480 if kh < h else 128), 2
    q, k, v = (torch.randn((4, s, n // tp, d), generator=gen,
                           device="cuda").to(dt) for n in (h, kh, kh))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v)
    assert ops.flash_attention.launches == before + 1
    rtol = 2e-5 if dtype == "float32" else 2.0 ** -7
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v).float(),
                               atol=2e-5, rtol=rtol)
    q = torch.randn((4, 1, h, d), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((4, rows, kh, d), generator=gen,
                        device="cuda").to(dt) for _ in range(2))
    kv_len = torch.tensor([1, 200, 377, rows], dtype=torch.int32,
                          device="cuda")
    kw = dict(kv_len=kv_len, q_offset=kv_len - 1)
    shards = [[c.contiguous() for c in x.chunk(tp, dim=2)] for x in (q, k, v)]
    before = ops.flash_decode_sharded.launches
    got = torch.cat(ops.flash_decode_sharded(*shards, **kw), dim=2)
    assert ops.flash_decode_sharded.launches == before + tp
    want = ops.flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-large-v3"])
def test_pod_step_functions_match_one_device_on_card(arch):
    """fp32, TF32 off, the reduced config: ``make_prefill_step(mesh=)``
    over stub patches with (3, B, S) positions, or over frames, on a TP=2
    pod (both ranks on ``cuda:0``), then 8 serve steps: the prefill logits
    within 1e-3 of one device's (``chip_smoke.POD_LOGIT_TOL``'s fp32
    limit) and the greedy tokens identical."""
    requires_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(8, cfg.vocab_size, (2, 9), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encoder.n_frames, cfg.d_model),
                                      generator=gen, device="cuda")
    else:
        n = cfg.frontend_tokens
        i = torch.arange(n, device="cuda")
        img = torch.stack([torch.zeros_like(i), i // 3, i % 3])
        txt = torch.arange(3, 12, device="cuda").expand(3, 9)
        batch["embeds"] = torch.randn((2, n, cfg.d_model), generator=gen,
                                      device="cuda") * 0.02
        batch["positions"] = torch.cat([img, txt], 1)[:, None].expand(
            3, 2, n + 9).contiguous()
    mesh = make_mesh((2,), ("model",), devices=["cuda:0", "cuda:0"])
    runs = []
    for p, m in ((params, None), (shard_params(params, cfg, mesh), mesh)):
        logits, cache = make_prefill_step(cfg, mesh=m)(
            p, {**batch, "cache": T.init_cache(cfg, 2, 64, "cuda", mesh=m)})
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        toks = [tok]
        serve = make_serve_step(cfg, mesh=m)
        for _ in range(8):
            tok, cache = serve(p, tok[:, None], cache)
            toks.append(tok)
        runs.append((logits.float(), torch.stack(toks, 1)))
    (one, one_toks), (pod, pod_toks) = runs
    assert float((pod - one).abs().max()) <= 1e-3
    assert torch.equal(pod_toks, one_toks)
