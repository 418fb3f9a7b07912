"""The port's copies of the repo's entry points over the package:
``data.workload.similarity_probe_sets`` against the reference's, and the
five examples (``python -m repro_torch.examples.<name>``) run on the CPU
with ``--device cpu`` at tiny flags.

Tolerances: the probe sets, the simulator's JCT lines and the checkpoint
layout are host data and compared exactly; the examples that serve or
train check what they promise (every request finishes with its tokens,
the loss falls, the checkpoint restores in the JAX package)."""
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import BGEPredictor as JaxBGE  # noqa: E402
from repro.core import PredictorConfig as JaxPredictorConfig  # noqa: E402
from repro.data import workload as jax_workload  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models.encoder import EncoderArchConfig as JaxEnc  # noqa: E402
from repro.training import latest_step as jax_latest  # noqa: E402
from repro.training import restore_checkpoint as jax_restore  # noqa: E402
from repro_torch.data import similarity_probe_sets  # noqa: E402
from repro_torch.examples import (quickstart, serve_isrtf,  # noqa: E402
                                  simulate_cluster, train_lm,
                                  train_predictor)

DEVICE_EXAMPLES = [quickstart, serve_isrtf, train_lm, train_predictor]


@pytest.mark.parametrize("seed", [0, 3])
def test_similarity_probe_sets_match_reference(seed):
    """Sentences and token ids equal the reference's, the same draws in
    the same order."""
    sim, dis, tok = similarity_probe_sets(n=40, seed=seed)
    jsim, jdis, jtok = jax_workload.similarity_probe_sets(n=40, seed=seed)
    assert sim == jsim and dis == jdis
    assert len(sim) == len(dis) == 40
    for a in sim + dis:
        assert tok.encode(a) == jtok.encode(a)
    assert similarity_probe_sets(n=40, seed=seed)[:2] == (sim, dis)


@pytest.mark.parametrize("mod", DEVICE_EXAMPLES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_exit_without_card(mod):
    """With no card and no ``--device cpu`` each example exits naming the
    reason, as the serve CLI does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is served")
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert "--device cuda" in str(e.value)
    assert "is_available() is False" in str(e.value)


def test_quickstart_cpu(capsys):
    """Every request finishes with its own token budget."""
    responses = quickstart.main(["--device", "cpu"])
    assert [r.n_tokens for r in sorted(responses,
                                       key=lambda r: r.request_id)] == [
        n for _, n in quickstart.PROMPTS]
    assert all(r.ok for r in responses)
    out = capsys.readouterr().out
    assert "streaming request 0:" in out and "mean JCT" in out


def test_serve_isrtf_cpu(capsys):
    """Each policy finishes every job with its target length."""
    results = serve_isrtf.main(["--device", "cpu", "--jobs", "5"])
    want = sorted(r.true_output_len for r in serve_isrtf.make_requests(5))
    for policy in serve_isrtf.POLICIES:
        _, responses = results[policy]
        assert all(r.ok for r in responses)
        assert sorted(r.n_tokens for r in responses) == want
    out = capsys.readouterr().out
    assert "isrtf vs fcfs:" in out and "sjf vs fcfs:" in out


def test_train_lm_cpu_checkpoint_restores_in_jax(tmp_path):
    """The loss falls, and the checkpoint restores into the reference's
    parameter tree (the JAX layout)."""
    ck = str(tmp_path / "lm")
    first, final, _ = train_lm.main(
        ["--device", "cpu", "--arch", "qwen2-1.5b", "--steps", "30",
         "--batch", "2", "--seq", "16", "--ckpt", ck])
    assert final < first
    target = jax_init(jax.random.PRNGKey(1),
                      jax_config("qwen2-1.5b").reduced())
    step = jax_latest(ck)
    restored, meta = jax_restore(ck, step, target)
    assert step == 30 and meta["arch"] == "qwen2-1.5b"
    a = jax.tree_util.tree_leaves(restored)
    b = jax.tree_util.tree_leaves(target)
    assert [x.shape for x in a] == [x.shape for x in b]
    assert abs(meta["loss"] - final) < 1e-6


def test_train_predictor_cpu_checkpoint_restores_in_jax(tmp_path):
    out = str(tmp_path / "pred")
    after, _ = train_predictor.main(["--device", "cpu", "--steps", "3",
                                     "--requests", "60", "--out", out])
    assert np.isfinite(after["mae"])
    cfg = JaxPredictorConfig(
        encoder=JaxEnc(d_model=128, n_heads=4, n_layers=3, d_ff=256,
                       max_len=192),
        n_fc_layers=8, fc_hidden=256, max_len=192, lr=1e-4)
    target = JaxBGE(cfg, seed=1).params
    restored, meta = jax_restore(out, jax_latest(out), target)
    assert jax_latest(out) == 3
    assert meta["metrics"]["mae"] == pytest.approx(after["mae"])
    assert [x.shape for x in jax.tree_util.tree_leaves(restored)] == [
        x.shape for x in jax.tree_util.tree_leaves(target)]


def test_simulate_cluster_prints_reference_lines(capsys, monkeypatch):
    """The port's example prints the reference script's lines, JCTs
    included, at the same flags."""
    flags = ["--model", "opt6.7", "--requests", "24"]
    simulate_cluster.main(flags)
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["simulate_cluster.py"] + flags)
    runpy.run_path("examples/simulate_cluster.py", run_name="__main__")
    ref = capsys.readouterr().out
    assert ours == ref
    assert ours.count("RPS") == 3 and ours.count("workers @") == 4
