"""The simulator ranked by a BGE predictor on the card (``gpu`` marker;
each test skips without a card, decided inside the test): a small fp32
predictor on ``cuda`` ranks a ``run_experiment`` pool deterministically,
two runs giving the same completion times bit for bit, and the runner
never moves or copies the predictor off its device.  No JAX here: the
card's machine has none.

    python -m pytest -q -m gpu tests/test_torch_simulate_card.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import PredictorConfig  # noqa: E402
from repro_torch.core import predictor as TP  # noqa: E402
from repro_torch.models.encoder import EncoderArchConfig  # noqa: E402
from repro_torch.simulate import ExperimentConfig, run_experiment  # noqa: E402
from repro_torch.training.tree import leaves  # noqa: E402

SMALL = PredictorConfig(
    encoder=EncoderArchConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128,
                              max_len=128),
    n_fc_layers=2, fc_hidden=64, max_len=128)


def requires_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def recorded(pred):
    """Log every ``observe`` call on ``pred`` (the scheduling trace; a
    finish observes 0) and every dispatch's predictions."""
    trace, dispatches = [], []
    predict_jobs = pred.predict_jobs

    def predict(jobs):
        out = predict_jobs(jobs)
        dispatches.append(list(out))
        return out

    pred.predict_jobs = predict
    pred.observe = lambda job, remaining: trace.append((job.job_id,
                                                        remaining))
    return trace, dispatches


@pytest.mark.gpu
def test_bge_ranked_run_on_card_is_deterministic():
    requires_card()
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pred = TP.BGEPredictor(SMALL, seed=0)
        assert all(t.device.type == "cuda" for t in leaves(pred.params))
        cfg = ExperimentConfig(policy="isrtf", predictor="bge",
                               n_requests=60, batch_size=4, seed=7)
        runs = []
        for _ in range(2):
            trace, dispatches = recorded(pred)
            m = run_experiment(cfg, bge=pred)
            runs.append((trace, dispatches, m))
            del pred.predict_jobs, pred.observe
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (t0, d0, m0), (t1, d1, m1) = runs
    assert d0 and d0 == d1
    assert t0 == t1
    assert m0 == m1 and m0["n_finished"] == 60


@pytest.mark.gpu
def test_runner_keeps_the_predictor_on_its_device():
    requires_card()
    pred = TP.BGEPredictor(SMALL, seed=1)
    params = pred.params
    where = [(t.device, t.data_ptr()) for t in leaves(params)]
    m = run_experiment(ExperimentConfig(predictor="bge", n_requests=16,
                                        seed=3), bge=pred)
    assert m["n_finished"] == 16
    assert pred.params is params
    assert [(t.device, t.data_ptr()) for t in leaves(params)] == where
    assert pred.device.type == "cuda"
