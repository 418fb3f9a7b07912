"""Tensor-parallel MoE pods on the card (``gpu`` marker; each test skips
without a card, decided inside the test): ``flash_decode_sharded`` at the
per-rank shapes of qwen2-moe-a2.7b and mixtral-8x7b pods, bit for bit
against the single-device kernel, and a TP=2 MoE kernel engine against
the single-device kernel engine through chunked prefill and a swap round
trip.  No JAX here: the card's machine has none.

    python -m pytest -q -m gpu tests/test_torch_tp_moe_card.py
"""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.engine.engine import (_gather_slots, _leaves,  # noqa: E402
                                       _ranks)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.launch import partition as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def requires_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


#: (arch, heads, KV heads, window) of the published configs
MOE_SHAPES = [("qwen2-moe-a2.7b", 16, 16, None), ("mixtral-8x7b", 32, 8, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,h,kh,window", MOE_SHAPES)
def test_flash_decode_sharded_at_moe_pod_shapes_is_bitwise(arch, h, kh,
                                                          window, dtype):
    """At a TP=2 pod's per-rank shapes (qwen2-moe 8/8 heads, G = 1;
    mixtral 16/4, G = 4, window 4096), both ranks on one card, B=4 x 512
    with ragged ``kv_len``: the shards side by side equal the
    single-device kernel bit for bit, with one counted launch per
    shard."""
    requires_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, L, d, tp = 4, 512, 128, 2
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, L, kh, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, L, kh, d), generator=gen, device="cuda").to(dt)
    kv_len = torch.tensor([1, 200, 377, 512], dtype=torch.int32,
                          device="cuda")
    cfg = SimpleNamespace(n_heads=h, n_kv_heads=kh)
    ranges = [P.kv_head_range(cfg, tp, r) for r in range(tp)]
    shards = [[c.contiguous() for c in q.chunk(tp, dim=2)]] + [
        [x[:, :, lo:hi].contiguous() for lo, hi in ranges] for x in (k, v)]
    before = ops.flash_decode_sharded.launches
    got = torch.cat(ops.flash_decode_sharded(
        *shards, kv_len=kv_len, q_offset=kv_len - 1, window=window), dim=2)
    assert ops.flash_decode_sharded.launches == before + tp
    want = ops.flash_decode(q, k, v, kv_len=kv_len, q_offset=kv_len - 1,
                            window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_moe_tp2_kernel_engine_chunk_and_swap_on_card():
    """fp32, TF32 off, reduced qwen2-moe-a2.7b: a TP=2 kernel engine (both
    ranks on ``cuda:0``) gives the single-device kernel engine's greedy
    tokens through a chunked prefill and a swap round trip, and every
    rank's slot rows come back bit for bit."""
    requires_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    kw = dict(max_slots=2, max_len=128, max_output=64, eos_id=-1,
              attn_impl="kernel")
    prompt = [11 + k % 60 for k in range(23)]
    streams = []
    for mesh in (None, make_mesh((2,), ("model",),
                                 devices=["cuda:0", "cuda:0"])):
        eng = InferenceEngine(cfg, params, EngineConfig(**kw), mesh=mesh,
                              device="cuda")
        job = Job(job_id=0, prompt="", prompt_tokens=prompt,
                  arrival_time=0.0)
        for w in range(10):
            toks, _ = eng.run_window([job], 4, prefill_chunk=6)
            job.generated.extend(toks[0])
            if w in (2, 7):  # mid-prefill, then mid-decode
                slot = torch.tensor([eng.slot_of[0]], device="cuda")
                before = [list(_leaves(_gather_slots(c, slot)))
                          for c in _ranks(eng.cache)]
                before = [[t.clone() for t in r] for r in before]
                assert eng.offload_job(0)
                eng.restore_job(job)
                slot = torch.tensor([eng.slot_of[0]], device="cuda")
                after = [list(_leaves(_gather_slots(c, slot)))
                         for c in _ranks(eng.cache)]
                assert all(torch.equal(a, b) for ra, rb in zip(after, before)
                           for a, b in zip(ra, rb))
        assert eng.num_chunk_dispatches >= 4
        streams.append(job.generated)
    assert streams[0] == streams[1]
