"""The dry run's layouts on the card (``gpu`` marker; each test skips
without a card, decided inside the test): ``flash_decode_int8_sharded``
at the per-rank shapes of qwen2-1.5b's TP=2 and TP=4 int8 pods, bit for
bit against the single-device int8 kernel; an int8 pod's greedy tokens
through the kernels against one device's; and the dry run's flops and
argument bytes against ``FlopCounterMode`` over the same rank program on
the card.  No JAX here: the card's machine has none.

    python -m pytest -q -m gpu tests/test_torch_dryrun_card.py
"""
import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun, make_mesh, shard_params  # noqa: E402
from repro_torch.launch.partition import kv_head_range  # noqa: E402
from repro_torch.launch.shapes import InputShape  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def requires_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
def test_int8_sharded_decode_is_bitwise(tp, dtype):
    requires_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    b, L, h, kh, d = 4, 512, 12, 2, 128
    q = torch.randn((b, 1, h, d), generator=g, device="cuda", dtype=dtype)
    k, v = (torch.empty((b, L, kh, d), dtype=torch.int8, device="cuda")
            .random_(-127, 128, generator=g) for _ in range(2))
    ks, vs = (torch.empty((b, L), device="cuda").uniform_(0.005, 0.025,
                                                          generator=g)
              for _ in range(2))
    kv_len = torch.tensor([1, 200, 377, L], dtype=torch.int32, device="cuda")
    kw = dict(kv_len=kv_len, q_offset=kv_len - 1)
    heads = SimpleNamespace(n_heads=h, n_kv_heads=kh)
    ranges = [kv_head_range(heads, tp, r) for r in range(tp)]
    qs = [c.contiguous() for c in q.chunk(tp, dim=2)]
    kss, vss = ([x[:, :, lo:hi].contiguous() for lo, hi in ranges]
                for x in (k, v))
    ops.reset_launches()
    got = torch.cat(ops.flash_decode_int8_sharded(
        qs, kss, vss, [ks] * tp, [vs] * tp, **kw), dim=2)
    assert ops.flash_decode_int8_sharded.launches == tp
    assert ops.flash_decode_int8.launches == 0
    assert torch.equal(got, ops.flash_decode_int8(q, k, v, ks, vs, **kw))
    want = ref.flash_decode_int8(q, k, v, ks, vs, **kw)
    assert float((got.float() - want.float()).abs().max()) <= (
        2e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.gpu
def test_int8_pod_tokens_equal_one_device_through_the_kernels():
    requires_card()
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              dtype="float32")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    mesh = make_mesh((2,), ("model",), devices=["cuda"] * 2)
    shards = shard_params(params, cfg, mesh)
    prompts = torch.randint(8, cfg.vocab_size, (4, 24), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(1), dtype=torch.int32)

    def run(p, cache, m):
        logits, _ = T.prefill(p, cfg, {"tokens": prompts}, cache, mesh=m)
        tok, toks = logits[:, -1].argmax(-1), []
        for _ in range(6):
            lg, _ = T.decode_step(p, cfg, tok[:, None], cache, mesh=m)
            tok = lg[:, -1].argmax(-1)
            toks.append(tok)
        return torch.stack(toks, 1)

    ops.reset_launches()
    want = run(params, T.init_cache(cfg, 4, 64, "cuda", kv_dtype="int8"),
               None)
    got = run(shards, T.init_cache(cfg, 4, 64, mesh=mesh, kv_dtype="int8"),
              mesh)
    assert torch.equal(got, want)
    assert ops.flash_decode_int8_sharded.launches == 6 * cfg.n_layers * 2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["decode", "train"])
def test_dry_run_counts_what_the_card_runs(kind):
    from torch.utils.flop_counter import FlopCounterMode

    requires_card()
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              dtype="float32")
    # 16 slots: a smaller decode batch is context-parallel
    shape = InputShape(f"{kind}_card", 64, 16 if kind == "decode" else 4,
                       kind)
    kv = "int8" if kind == "decode" else None
    for mesh_shape in ((1, 1), (1, 2)):
        rec = dryrun.lower_one(cfg.arch_id, shape.name, False,
                               input_shape=shape, cfg_override=cfg,
                               mesh_shape=mesh_shape, kv_dtype=kv)
        mesh = make_mesh(mesh_shape, ("data", "model"),
                         devices=["cuda"] * mesh_shape[1])
        step, inputs, tp = dryrun.rank_program(cfg, shape, mesh,
                                               kv_dtype=kv)
        raw = sum(dryrun._storages(inputs).values())
        with FlopCounterMode(display=False) as fc:
            if kind == "train":
                step(*inputs)
            else:
                with torch.no_grad():
                    step(*inputs)
        # the pod's totals, and the busiest rank's at least the mean
        assert fc.get_total_flops() == rec["cost_analysis"]["pod flops"]
        assert raw == rec["memory_analysis"]["pod_argument_size_in_bytes"]
        assert rec["flops"] * tp >= fc.get_total_flops()
