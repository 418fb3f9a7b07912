"""The port's predictor training against the JAX package, on the CPU:
``loss_fn`` and its gradients (one head; two heads with each ranking loss
and ``same_step`` pairs), ``adamw_update`` with a trainable mask,
``schedule_lr``, ``clip_by_global_norm``, five ``fit`` steps, checkpoints
written by one package and restored by the other, and the dataset
functions.

Tolerances: losses are fp32 sums over the same parameters (rtol 1e-5);
gradients differ by summation order (atol 1e-6, rtol 1e-4: the smallest
gradient elements are near fp32 rounding).  After ``fit``, Adam divides
each gradient element by its own running magnitude, so an element whose
gradient sits at rounding level can step by up to ``lr`` either way on
each side: five steps bound that difference by 2 x 5 x lr.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import training as JT  # noqa: E402
from repro.core import predictor as JP  # noqa: E402
from repro.data import dataset as JD  # noqa: E402
from repro.data.workload import WorkloadGenerator as JaxWorkload  # noqa: E402
from repro.models import encoder as JE  # noqa: E402
from repro.models.objective import RankingConfig as JaxRankingConfig  # noqa: E402,E501
from repro_torch import training as TT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import predictor as TP  # noqa: E402
from repro_torch.data import dataset as TD  # noqa: E402
from repro_torch.data.workload import WorkloadGenerator  # noqa: E402
from repro_torch.models import encoder as TE  # noqa: E402
from repro_torch.models.objective import RankingConfig  # noqa: E402
from repro_torch.training.tree import leaves, unflatten  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
TINY = dict(encoder=dict(d_model=16, n_heads=2, n_layers=1, d_ff=32,
                         max_len=32), n_fc_layers=2, fc_hidden=16, max_len=32)

#: (ranking kwargs or None) per head set the loss is checked for
HEADS = {"one-head": None, "pairwise": {}, "listwise": {"loss": "listwise"},
         "same-step": {"pair_sampling": "same_step", "margin": 0.2}}


def pair(ranking=None, seed=0, **cfg_kw):
    shape = dict(TINY, **cfg_kw)
    jcfg = JP.PredictorConfig(
        encoder=JE.EncoderArchConfig(**shape["encoder"]),
        **{k: v for k, v in shape.items() if k != "encoder"},
        ranking=None if ranking is None else JaxRankingConfig(**ranking))
    tcfg = TP.PredictorConfig(
        encoder=TE.EncoderArchConfig(**shape["encoder"]),
        **{k: v for k, v in shape.items() if k != "encoder"},
        ranking=None if ranking is None else RankingConfig(**ranking))
    jpred = JP.BGEPredictor(jcfg, seed=seed)
    tpred = TP.BGEPredictor(tcfg, seed=seed, device="cpu")
    tpred.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpred.params), "cpu")
    return jpred, tpred


@pytest.fixture(scope="module")
def data():
    """The same step samples from both packages' dataset functions."""
    return (TD.make_predictor_dataset(60, seed=0, max_len=32, max_steps=3),
            JD.make_predictor_dataset(60, seed=0, max_len=32, max_steps=3))


def assert_trees_close(got, want, **tol):
    g, w = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a.detach().numpy() if torch.is_tensor(a) else np.asarray(a),
            np.asarray(b), **tol)


# --------------------------------------------------------------------------- #
# loss and gradients
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("heads", list(HEADS))
def test_loss_and_gradients_match_jax_grad(heads, data):
    jpred, tpred = pair(HEADS[heads])
    (train, _, _), _ = data
    batch = TD.pad_batch(train[:12], 32)
    batch["labels"][:3] = 0.0  # labels below 1 are clamped in the loss
    jloss, jm = jpred.loss_fn(jpred.params, batch)
    tloss, tm = tpred.loss_fn(tpred.params, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL)
    jgrads = jax.grad(lambda p: jpred.loss_fn(p, batch)[0])(jpred.params)
    flat = [p.detach().requires_grad_(True) for p in leaves(tpred.params)]
    loss, _ = tpred.loss_fn(unflatten(tpred.params, flat), batch)
    tgrads = torch.autograd.grad(loss, flat)
    assert_trees_close(list(tgrads), jgrads, **GRAD_TOL)


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #


def _tree(rng):
    return {"b": [rng.randn(3, 4).astype(np.float32),
                  rng.randn(5).astype(np.float32)],
            "a": {"w": rng.randn(2, 2).astype(np.float32)}}


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_schedule_lr_matches_reference(schedule):
    for warm, total in ((10, 100), (0, 50), (7, 7)):
        jcfg = JT.AdamWConfig(lr=3e-4, schedule=schedule, warmup_steps=warm,
                              total_steps=total)
        tcfg = TT.AdamWConfig(lr=3e-4, schedule=schedule, warmup_steps=warm,
                              total_steps=total)
        for step in (0, 1, 5, 7, 10, 30, 50, 99, 100, 150):
            want = float(JT.schedule_lr(jcfg, jnp.asarray(step, jnp.int32)))
            got = float(TT.schedule_lr(tcfg, torch.tensor(step,
                                                          dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(np.random.RandomState(0))
    jclip, jnorm = JT.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    tclip, tnorm = TT.clip_by_global_norm(params_from_numpy(tree, "cpu"),
                                          max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(float(TT.global_norm(tclip)),
                               min(float(jnorm), max_norm), rtol=1e-5)
    assert_trees_close(tclip, jclip, rtol=1e-6, atol=1e-7)


def test_adamw_update_with_a_mask_matches_reference():
    """Three AdamW steps with one leaf frozen: the frozen leaf keeps its
    value and zero moments; the others move as the reference's do."""
    rng = np.random.RandomState(1)
    params = _tree(rng)
    mask = {"b": [True, False], "a": {"w": True}}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               clip_norm=0.5)
    jcfg, tcfg = JT.AdamWConfig(**cfg), TT.AdamWConfig(**cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = JT.adamw_init(jp), TT.adamw_init(tp)
    for _ in range(3):
        grads = _tree(rng)
        jp, js, jm = JT.adamw_update(
            jcfg, jax.tree_util.tree_map(jnp.asarray, grads), js, jp,
            trainable_mask=mask)
        tp, ts, tm = TT.adamw_update(tcfg, params_from_numpy(grads, "cpu"),
                                     ts, tp, trainable_mask=mask)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    assert_trees_close(tp, jp, rtol=1e-6, atol=1e-7)
    assert_trees_close(ts.mu, js.mu, rtol=1e-5, atol=1e-8)
    assert_trees_close(ts.nu, js.nu, rtol=1e-5, atol=1e-10)
    np.testing.assert_array_equal(tp["b"][1].numpy(), params["b"][1])
    assert not ts.mu["b"][1].any() and not ts.nu["b"][1].any()


# --------------------------------------------------------------------------- #
# fit
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("heads,freeze", [("one-head", False),
                                          ("pairwise", False),
                                          ("same-step", True)])
def test_five_fit_steps_match_reference(heads, freeze, data):
    """Per-step history, final parameters and the residual statistics
    ``fit`` estimates (the frozen encoder stays bit for bit)."""
    jpred, tpred = pair(HEADS[heads], freeze_encoder=freeze)
    (ttrain, _, _), (jtrain, _, _) = data
    enc0 = [p.clone() for p in leaves(tpred.params["encoder"])]
    jh = jpred.fit(jtrain, num_steps=5, batch_size=8)
    th = tpred.fit(ttrain, num_steps=5, batch_size=8)
    assert sorted(th) == sorted(jh) == list(range(5))
    for i in jh:
        assert sorted(th[i]) == sorted(jh[i])
        for k in jh[i]:
            if k != "wall_s":
                np.testing.assert_allclose(th[i][k], jh[i][k], rtol=1e-4,
                                           err_msg=f"step {i} {k}")
    lr = tpred.cfg.lr
    assert_trees_close(tpred.params, jpred.params, atol=2 * 5 * lr, rtol=0)
    if freeze:
        for a, b in zip(leaves(tpred.params["encoder"]), enc0):
            assert torch.equal(a, b)
    assert sorted(tpred.resid_by_step) == sorted(jpred.resid_by_step)
    for k, (mu, s) in jpred.resid_by_step.items():
        np.testing.assert_allclose(tpred.resid_by_step[k], (mu, s),
                                   rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose([tpred.resid_mu, tpred.resid_sigma],
                               [jpred.resid_mu, jpred.resid_sigma],
                               rtol=1e-3, atol=1e-4)


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #


def _predict_tokens(pred):
    rng = np.random.RandomState(3)
    return pred.predict_tokens([rng.randint(8, 8192, size=n).tolist()
                                for n in (2, 9, 31, 40)])


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A two-head predictor saved by ``repro.training`` (three steps kept of
    four) restores into the port's tree: same leaves, same predictions."""
    jpred, _ = pair({}, seed=1)
    _, tpred = pair({}, seed=2)  # other weights until restored
    for step in (1, 2, 3, 7):
        JT.save_checkpoint(str(tmp_path), step, jpred.params, keep=3,
                           metadata={"step": step})
    assert TT.latest_step(str(tmp_path)) == JT.latest_step(str(tmp_path)) == 7
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003", "step_00000007"]
    tpred.params, meta = TT.restore_checkpoint(str(tmp_path), 7,
                                               tpred.params)
    assert meta == {"step": 7}
    assert_trees_close(tpred.params, jpred.params, rtol=0, atol=0)
    np.testing.assert_allclose(_predict_tokens(tpred),
                               _predict_tokens(jpred), rtol=2e-5)


def test_port_checkpoint_restores_into_jax(tmp_path):
    _, tpred = pair({}, seed=1)
    jpred, _ = pair({}, seed=2)
    path = TT.save_checkpoint(str(tmp_path), 5, tpred.params,
                              metadata={"by": "port"})
    assert path.endswith("step_00000005")
    assert TT.latest_step(str(tmp_path / "missing")) is None
    jpred.params, meta = JT.restore_checkpoint(str(tmp_path), 5,
                                               jpred.params)
    assert meta == {"by": "port"}
    assert_trees_close(tpred.params, jpred.params, rtol=0, atol=0)
    np.testing.assert_allclose(_predict_tokens(tpred),
                               _predict_tokens(jpred), rtol=2e-5)
    with pytest.raises(ValueError, match="leaves"):  # another structure
        TT.restore_checkpoint(str(tmp_path), 5, pair(None)[1].params)


# --------------------------------------------------------------------------- #
# dataset functions
# --------------------------------------------------------------------------- #


def _samples(s):
    return [(x.tokens, x.remaining, x.step, x.request_id) for x in s]


def test_dataset_functions_match_reference():
    treqs = WorkloadGenerator(seed=4).sample_requests(30)
    jreqs = JaxWorkload(seed=4).sample_requests(30)
    tsam = TD.build_step_samples(treqs, max_steps=4, max_len=48)
    jsam = JD.build_step_samples(jreqs, max_steps=4, max_len=48)
    assert _samples(tsam) == _samples(jsam)
    assert _samples(TD.iqr_filter(tsam)) == _samples(JD.iqr_filter(jsam))
    for a, b in zip(TD.split_622(tsam, seed=3), JD.split_622(jsam, seed=3)):
        assert _samples(a) == _samples(b)
    for prompt, gen, ml in (([5] * 3, list(range(40)), 16),
                            ([5] * 20, [1, 2], 8), ([], [], 4)):
        assert (TD.clip_step_input(prompt, gen, ml)
                == JD.clip_step_input(prompt, gen, ml))
    tit = TD.batch_iterator(tsam, 7, 48, seed=2)
    jit = JD.batch_iterator(jsam, 7, 48, seed=2)
    for _ in range(len(tsam) // 7 + 3):  # past one epoch: the reshuffle
        tb, jb = next(tit), next(jit)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    assert len(list(TD.batch_iterator(tsam, 7, 48, loop=False))) == (
        len(tsam) // 7)
    for a, b in zip(TD.make_predictor_dataset(50, seed=1, max_len=40),
                    JD.make_predictor_dataset(50, seed=1, max_len=40)):
        assert _samples(a) == _samples(b)
