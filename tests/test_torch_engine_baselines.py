"""The engine's two reference baselines, ``EngineConfig(batched_prefill=
False)`` (one batch-1 prefill dispatch per admitted job) and
``masked_decode=False`` (every window at the full ``max_slots`` batch
with every slot alive), against the JAX ``InferenceEngine`` on the
reduced qwen2-1.5b (fp32) with its params carried across by the bridge:
greedy tokens, finished flags, dispatch counts and ``len`` vectors
identical; the recurrent families stay serial whatever
``batched_prefill`` says; the defaults still compact; and a TP=2 pod
under both baselines against one device.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import Job as JaxJob  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "qwen2-1.5b"
#: the reference's ``test_batched_prefill_matches_serial`` prompts
PROMPTS = [[11, 22, 33, 44], [5, 6, 7], [9, 8, 7, 6, 5],
           [1, 2, 3, 4, 5, 6, 7]]
BASE = dict(max_slots=4, max_len=128, max_output=64, eos_id=-1)
BASELINE = dict(batched_prefill=False, masked_decode=False)


@pytest.fixture(scope="module")
def setup():
    """One parameter tree for both engines: the reference init with the
    layer weights scaled by 3, so that greedy streams do not settle on one
    repeated token (``tests/test_torch_engine.py``)."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    for group in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for name in group:
            if name.startswith("w"):
                group[name] = group[name] * np.float32(3.0)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    return jcfg, cfg, jp, params_from_numpy(tree, "cpu")


def _jobs(job_cls, prompts=PROMPTS):
    return [job_cls(job_id=i, prompt=f"p{i}", prompt_tokens=list(p),
                    arrival_time=0.0) for i, p in enumerate(prompts)]


#: the port's attention paths and the reference's counterparts
JAX_IMPL = {"kernel": "pallas", "torch": "xla"}


def _engines(setup, mesh=None, impl="kernel", **kw):
    """(port engine, JAX engine) under the same options."""
    jcfg, cfg, jp, tp = setup
    opts = {**BASE, **kw}
    return (InferenceEngine(cfg, tp, EngineConfig(attn_impl=impl, **opts),
                            device="cpu", mesh=mesh),
            JaxEngine(jcfg, jp, JaxEngineConfig(attn_impl=JAX_IMPL[impl],
                                                **opts)))


def _lens(eng):
    cache = eng.cache
    if isinstance(cache, list):  # a pod: every rank's vector
        return [c["len"].tolist() for c in cache]
    lens = cache["len"]
    return (lens.tolist() if isinstance(lens, torch.Tensor)
            else np.asarray(lens).tolist())


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_batched_prefill_matches_serial(setup, impl):
    """The reference's case: one (batch, seq)-bucketed prefill dispatch
    against 4 batch-1 dispatches with full-width windows, both engines of
    both packages: identical tokens and finished flags, 1 against 4
    dispatches, equal ``len`` vectors."""
    out = {}
    for name, kw in (("batched", dict(batched_prefill=True)),
                     ("serial", BASELINE)):
        port, ref = _engines(setup, impl=impl, **kw)
        for eng, job_cls in ((port, Job), (ref, JaxJob)):
            toks, fin = eng.run_window(_jobs(job_cls), 8)
            out[name, eng is port] = (toks, fin, _lens(eng),
                                      eng.num_prefill_dispatches)
    for name in ("batched", "serial"):
        assert out[name, True] == out[name, False], name
    (tb, fb, lb, nb), (ts, fs, ls, ns) = out["batched", True], out[
        "serial", True]
    assert tb == ts and fb == fs and lb == ls
    assert (nb, ns) == (1, len(PROMPTS))
    assert len(set(tb[0])) > 1  # not a degenerate stream


def _unscheduled_windows(eng, job_cls):
    """Two jobs in two of four slots, one window; then a window of job 1
    alone (job 0 occupied, unscheduled), then job 0 again.  Returns each
    window's tokens, flags and ``len`` vector."""
    j0, j1 = _jobs(job_cls, [[11, 22, 33, 44], [5, 6, 7]])
    trace = []
    for batch, k in (([j0, j1], 6), ([j1], 5), ([j0], 6)):
        toks, fin = eng.run_window(batch, k)
        for j, t in zip(batch, toks):
            j.generated.extend(t)
        trace.append((toks, fin, _lens(eng), eng.num_decode_dispatches))
    return trace


@pytest.mark.parametrize("masked", [False, True])
def test_unscheduled_slot_len_matches_reference(setup, masked):
    """A window that leaves one occupied slot unscheduled: under the
    baseline it advances with the rest (and so do the empty slots), and
    its ``len`` after the window is the reference's; under the default it
    stays frozen.  Tokens of every window, the scheduled job's resumed
    stream included, are the reference's."""
    port, ref = _engines(setup, masked_decode=masked)
    got = _unscheduled_windows(port, Job)
    want = _unscheduled_windows(ref, JaxJob)
    assert got == want
    lens_before, lens_after = got[0][2], got[1][2]
    slot0 = port.slot_of[0]
    if masked:
        assert lens_after[slot0] == lens_before[slot0]
    else:
        assert lens_after[slot0] == lens_before[slot0] + 5
        assert all(n > 0 for n in lens_after)  # the empty slots advanced


@pytest.mark.parametrize("masked,shape", [(True, (4, 2)), (False, (4, 4))])
def test_decode_dispatch_shape(setup, masked, shape):
    """The default compacts two scheduled jobs to their batch bucket of 2;
    the baseline decodes all 4 slots (the reference's
    ``test_masked_decode_compacts_to_bucket``)."""
    port, _ = _engines(setup, masked_decode=masked)
    jobs = _jobs(Job)[:2]
    port.run_window(jobs, 4)
    port.run_window(jobs, 4)
    assert port._decode_shapes == {shape}
    assert port.num_decode_dispatches == 2 and port.num_decode_traces == 1


@pytest.mark.parametrize("batched", [True, False])
def test_recurrent_family_stays_serial(batched):
    """mamba2-130m admits serially, one batch-1 dispatch at the exact
    prompt length each, whatever ``batched_prefill`` says: the same
    dispatches and tokens either way."""
    cfg = get_config("mamba2-130m").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    out = []
    for flag in (True, batched):
        eng = InferenceEngine(cfg, params, EngineConfig(
            batched_prefill=flag, **BASE), device="cpu")
        toks, _ = eng.run_window(_jobs(Job)[:3], 4)
        out.append((toks, eng.num_prefill_dispatches,
                    sorted(eng._prefill_shapes)))
    assert out[0] == out[1]
    assert out[1][1] == 3 and out[1][2] == [(1, 3), (1, 4), (1, 5)]


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_baselines_on_a_tp2_pod_match_one_device(setup, impl):
    """Both baselines on a TP=2 pod: the reference case and an unscheduled
    window give the single-device port engine's tokens, and every rank
    the same ``len`` vector as one device."""
    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    pod, _ = _engines(setup, mesh=mesh, impl=impl, **BASELINE)
    one, _ = _engines(setup, impl=impl, **BASELINE)
    got = _unscheduled_windows(pod, Job)
    want = _unscheduled_windows(one, Job)
    for (gt, gf, gl, gd), (wt, wf, wl, wd) in zip(got, want):
        assert (gt, gf, gd) == (wt, wf, wd)
        assert gl == [wl, wl]
    toks, fin = pod.run_window(_jobs(Job)[2:], 4)
    assert pod.num_prefill_dispatches == 4
    want2 = one.run_window(_jobs(Job)[2:], 4)
    assert (toks, fin) == want2
