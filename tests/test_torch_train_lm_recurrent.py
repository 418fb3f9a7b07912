"""The port's LM training path against the JAX package on the CPU, SSM,
hybrid and audio families (as ``tests/test_torch_train_lm.py`` does for
the others, with its tolerances), and the entry points:
``repro_torch.launch.train`` (the loss falls; checkpoints cross to the
reference and back; its token stream is the reference's; ``--dry-run`` and
``--mesh multi`` are refused) and ``repro_torch.launch.generate`` (the
reference's JSONL byte for byte, read by ``serve --trace``).
"""
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import _lm_parity as H  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import generate as JGEN  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.launch import train as JTRAIN  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.training import restore_checkpoint as jax_restore  # noqa: E402
from repro.training import save_checkpoint as jax_save  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import generate, serve, train  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.models import forward, loss_fn  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import latest_step, restore_checkpoint  # noqa: E402
from repro_torch.training.tree import leaves  # noqa: E402

FAMILIES = ["ssm", "hybrid", "audio"]


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_reference(family):
    r = H.reference(family)
    with torch.no_grad():
        logits, aux = forward(r["tp"], r["cfg"], H.to_torch(r["batch"]))
    assert tuple(logits.shape) == r["logits"].shape
    assert H.rel_gap(logits.numpy(), r["logits"]) <= H.LOGIT_RTOL
    assert aux.item() == r["aux"] == 0.0


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_grads_match_reference(family):
    r = H.reference(family)
    loss, parts, grads = H.torch_loss_and_grads(loss_fn, r["cfg"], r["tp"],
                                                r["batch"])
    assert abs(loss - r["loss"]) <= H.LOSS_RTOL * abs(r["loss"])
    assert abs(parts["ce"] - r["parts"]["ce"]) <= H.LOSS_RTOL * abs(loss)
    gaps = H.grad_gaps(grads, r["grads"])
    assert max(gaps) <= H.GRAD_RTOL, gaps
    assert all(np.abs(g).max() > 0 for g in grads)


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_matches_no_remat(family):
    r = H.reference(family)
    plain = H.torch_loss_and_grads(loss_fn, r["cfg"], r["tp"], r["batch"])
    remat = H.torch_loss_and_grads(loss_fn, r["cfg"], r["tp"], r["batch"],
                                   remat=True)
    assert abs(plain[0] - remat[0]) < 1e-6
    assert max(H.grad_gaps(remat[2], plain[2])) < 1e-6


@pytest.mark.parametrize("family", FAMILIES)
def test_input_specs_train_batch_matches_reference(family):
    arch = H.ARCHS[family]
    want = JS.input_specs(jax_get_config(arch), JS.SHAPES["train_4k"])
    got = S.input_specs(get_config(arch), S.SHAPES["train_4k"])
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_ssd_kernel_refuses_grad():
    r = H.reference("ssm")
    tp = dict(r["tp"], embed=r["tp"]["embed"].clone().requires_grad_(True))
    b = H.to_torch(r["batch"])
    with pytest.raises(NotImplementedError, match="ssd_scan"):
        loss_fn(tp, r["cfg"], b, attn_impl="kernel")
    with torch.no_grad():
        got, _ = loss_fn(tp, r["cfg"], b, attn_impl="kernel")
    assert abs(got.item() - r["loss"]) <= H.LOSS_RTOL * r["loss"]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-vl-7b",
                                  "whisper-large-v3"])
def test_batches_match_reference(arch):
    """The first two batches of the token stream, key by key."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    mine, theirs = train.batches(cfg, 3, 24), JTRAIN.batches(jcfg, 3, 24)
    for _ in range(2):
        got, want = next(mine), next(theirs)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_train_cli_loss_falls_and_resumes(tmp_path, capsys):
    """Ten steps of the reduced qwen2-1.5b on the CPU: the loss falls, as
    ``examples/train_lm.py`` asserts; a resume restores the step."""
    argv = ["--device", "cpu", "--arch", "qwen2-1.5b", "--batch", "4",
            "--seq", "32", "--log-every", "5", "--ckpt", str(tmp_path)]
    run = train.main(argv + ["--steps", "10"])
    assert run["start"] == 0 and len(run["losses"]) == 10
    assert all(np.isfinite(run["losses"]))
    assert np.mean(run["losses"][-3:]) < run["losses"][0] - 0.1
    assert latest_step(str(tmp_path)) == 10
    again = train.main(argv + ["--steps", "2", "--resume"])
    assert again["start"] == 10 and latest_step(str(tmp_path)) == 12
    assert "resumed from step 10" in capsys.readouterr().out


def test_checkpoint_crosses_to_reference_and_back(tmp_path):
    """A checkpoint the port's CLI writes restores into the reference's
    LM param tree (the same leaves and shapes, the same values), and one
    the reference writes restores into the port's."""
    cfg = get_config("mamba2-130m").reduced()
    run = train.main(["--device", "cpu", "--arch", "mamba2-130m",
                      "--steps", "1", "--batch", "2", "--seq", "16",
                      "--ckpt", str(tmp_path / "a")])
    assert run["ckpt"]
    target = T.init_params(cfg, torch.Generator().manual_seed(0))
    mine, _ = restore_checkpoint(str(tmp_path / "a"), 1, target)
    jtarget = jax_init_params(jax.random.PRNGKey(0),
                              jax_get_config("mamba2-130m").reduced())
    theirs, meta = jax_restore(str(tmp_path / "a"), 1, jtarget)
    assert meta["arch"] == "mamba2-130m"
    for a, b in zip(leaves(mine), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jax_save(str(tmp_path / "b"), 7, theirs)
    back, _ = restore_checkpoint(str(tmp_path / "b"), 7, target)
    for a, b in zip(leaves(back), leaves(mine)):
        assert torch.equal(a, b)


def test_train_cli_refuses_dry_run_and_mesh_multi():
    for extra in (["--dry-run"], ["--mesh", "multi"]):
        with pytest.raises(SystemExit, match="queue 1, item 10"):
            train.main(["--device", "cpu", "--steps", "1"] + extra)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("process,rate", [("gamma", "2.0"),
                                          ("poisson", "1.5")])
def test_generate_matches_reference(tmp_path, monkeypatch, seed, process,
                                    rate):
    """The same JSONL bytes as the reference's generator, and the port's
    ``serve --trace`` reads every record of it."""
    argv = ["--n", "25", "--seed", str(seed), "--process", process,
            "--rate", rate]
    generate.main(argv + ["--out", str(tmp_path / "mine.jsonl")])
    monkeypatch.setattr(sys, "argv", ["generate"] + argv
                        + ["--out", str(tmp_path / "ref.jsonl")])
    JGEN.main()
    mine = (tmp_path / "mine.jsonl").read_bytes()
    assert mine == (tmp_path / "ref.jsonl").read_bytes()
    args = serve._parser().parse_args(
        ["--device", "cpu", "--trace", str(tmp_path / "mine.jsonl")])
    reqs, _ = serve.load_requests(args)
    lines = mine.decode().splitlines()
    assert len(reqs) == len(lines) == 25
    first = __import__("json").loads(lines[0])
    assert reqs[0].prompt_tokens == first["prompt_tokens"]
    assert reqs[0].arrival_time == first["arrival_time"]
