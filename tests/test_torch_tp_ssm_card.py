"""Tensor-parallel SSM and hybrid pods on the card (``gpu`` marker; each
test skips without a card, decided inside the test): ``ssd_scan`` on a
rank's share of mamba2-130m's and zamba2-7b's SSM heads against its plain
version, ``flash_decode_sharded`` at zamba2-7b's TP=2 shares bit for bit
against the single-device kernel, and TP=2 kernel engines of the reduced
SSM and hybrid configs against the single-device kernel engine through
an eviction and a swap round trip.  No JAX here: the card's machine has
none.

    python -m pytest -q -m gpu tests/test_torch_tp_ssm_card.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.engine.engine import (_gather_slots, _leaves,  # noqa: E402
                                       _ranks)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def requires_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,p,n,s,chunk", [(12, 64, 128, 512, 256),
                                           (56, 64, 64, 512, 256),
                                           (56, 64, 64, 180, 180)])
def test_ssd_scan_on_a_ranks_heads_matches_plain(h, p, n, s, chunk, dtype):
    """A TP=2 rank's SSM heads (mamba2-130m: 12 of 24 at (64, 128);
    zamba2-7b: 56 of 112 at (64, 64)), B=1: the kernel within the plain
    version's tolerance (2e-5 of the largest |value| abs, plus 2e-5 rel in
    fp32 and one bf16 ulp, 2^-7 rel, in bf16), one counted launch."""
    requires_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtv = torch.rand((1, s, h), generator=gen, device="cuda") * 0.1 + 1e-3
    x = (torch.randn((1, s, h, p), generator=gen, device="cuda")
         * dtv[..., None]).to(dt)
    a = -dtv * (torch.rand((h,), generator=gen, device="cuda") * 15 + 1)
    bm, cm = (torch.randn((1, s, h, n), generator=gen, device="cuda")
              .mul(0.5).to(dt) for _ in range(2))
    before = ops.ssd_scan.launches
    got = ops.ssd_scan(x, a, bm, cm, chunk=chunk)
    assert ops.ssd_scan.launches == before + 1
    want = ref.ssd_scan(x, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    rtol = 2e-5 if dtype == "float32" else 2.0 ** -7
    for g, w in zip(got, want):
        atol = 2e-5 * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_sharded_at_zamba2_pod_shapes_is_bitwise(dtype):
    """zamba2-7b's shared block on a TP=2 pod (16/16 heads of dim 112 a
    rank, window 4096), both ranks on one card, B=4 x 512 with ragged
    ``kv_len``: the shards side by side equal the single-device kernel
    bit for bit, one counted launch per shard."""
    requires_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, L, h, d, tp = 4, 512, 32, 112, 2
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, L, h, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, L, h, d), generator=gen, device="cuda").to(dt)
    kv_len = torch.tensor([1, 200, 377, 512], dtype=torch.int32,
                          device="cuda")
    kw = dict(kv_len=kv_len, q_offset=kv_len - 1, window=4096)
    shards = [[c.contiguous() for c in x.chunk(tp, dim=2)] for x in (q, k, v)]
    before = ops.flash_decode_sharded.launches
    got = torch.cat(ops.flash_decode_sharded(*shards, **kw), dim=2)
    assert ops.flash_decode_sharded.launches == before + tp
    want = ops.flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_ssm_tp2_kernel_engine_matches_one_device_on_card(arch):
    """fp32, TF32 off, the reduced config: a TP=2 kernel engine (both
    ranks on ``cuda:0``) gives the single-device kernel engine's greedy
    tokens through an eviction with a recompute resume and a swap round
    trip whose every rank's slot rows come back bit for bit."""
    requires_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    kw = dict(max_slots=2, max_len=128, max_output=64, eos_id=-1,
              attn_impl="kernel")
    prompts = [[11 + k % 60 for k in range(41)], [7, 8, 9, 10, 11]]
    streams = []
    for mesh in (None, make_mesh((2,), ("model",),
                                 devices=["cuda:0", "cuda:0"])):
        eng = InferenceEngine(cfg, params, EngineConfig(**kw), mesh=mesh,
                              device="cuda")
        jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
                for i, p in enumerate(prompts)]
        for w in range(6):
            if w == 2:  # recompute
                eng.evict_job(1)
            if w == 4:  # swap, bit for bit on every rank
                slot = torch.tensor([eng.slot_of[0]], device="cuda")
                before = [[t.clone() for t in _leaves(_gather_slots(c, slot))]
                          for c in _ranks(eng.cache)]
                assert eng.offload_job(0)
                eng.restore_job(jobs[0])
                slot = torch.tensor([eng.slot_of[0]], device="cuda")
                after = [list(_leaves(_gather_slots(c, slot)))
                         for c in _ranks(eng.cache)]
                assert all(torch.equal(a, b) for ra, rb in zip(after, before)
                           for a, b in zip(ra, rb))
            toks, _ = eng.run_window(jobs, 4)
            for j, t in zip(jobs, toks):
                j.generated.extend(t)
        streams.append([j.generated for j in jobs])
    assert streams[0] == streams[1]
