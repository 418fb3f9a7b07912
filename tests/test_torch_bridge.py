"""Parameter and cache bridge from the JAX reference to the PyTorch port.

Tolerances: the round trips are bit-exact (compared with ``array_equal``
on the raw values); init statistics are checked to a few standard errors.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import (cache_from_numpy, params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.engine import InferenceEngine  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "qwen2-1.5b"


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.PRNGKey(0),
                           jax_get_config(ARCH).reduced())


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_config_copy_matches_reference():
    for arch in (ARCH, "mamba2-130m"):
        for full in (False, True):
            want = jax_get_config(arch)
            got = get_config(arch)
            if not full:
                want, got = want.reduced(), got.reduced()
            for f in ("family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                      "qkv_bias", "tie_embeddings", "norm_eps", "rope_type",
                      "rope_theta", "attention_type", "swa_window", "dtype",
                      "max_position_embeddings", "attn_free", "ssm_d_inner",
                      "ssm_n_heads"):
                assert getattr(got, f) == getattr(want, f), (arch, f)
            assert (dataclasses.asdict(got.ssm)
                    == dataclasses.asdict(want.ssm)), arch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_exact(jax_params, dtype):
    """JAX -> numpy -> port -> numpy keeps every bit (bf16 leaves come back
    as float32, which holds every bf16 value exactly)."""
    jp = jax.tree_util.tree_map(lambda a: a.astype(dtype), jax_params)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(tree, device="cpu")
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    assert all(t.dtype == want_dtype
               for t in jax.tree_util.tree_leaves(tp))
    back = params_to_numpy(tp)
    want = dict(_leaves(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp)))
    got = dict(_leaves(back))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), path


def test_params_from_numpy_casts(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    tp = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    emb = tp["embed"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.float().numpy(),
        np.asarray(jax_params["embed"].astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def test_cache_from_numpy_matches_reference_prefill(jax_params):
    jcfg = jax_get_config(ARCH).reduced()
    rng = np.random.RandomState(0)
    toks = rng.randint(8, 512, size=(2, 16)).astype(np.int32)
    jc = JT.init_cache(jcfg, 2, 32)
    _, jc = JT.prefill(jax_params, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    assert not jc["kv"].ring and not jc["kv"].quantized
    tc = cache_from_numpy(np.asarray(jc["len"]), np.asarray(jc["kv"].k),
                          np.asarray(jc["kv"].v), device="cpu")
    assert tc["len"].dtype == torch.int32
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    np.testing.assert_array_equal(tc["kv"].k.numpy(), np.asarray(jc["kv"].k))
    np.testing.assert_array_equal(tc["kv"].v.numpy(), np.asarray(jc["kv"].v))


def test_init_params_has_reference_layout_and_distributions(jax_params):
    """The port's own init builds the reference's tree (same keys, shapes,
    dtypes) with the same distributions."""
    cfg = get_config(ARCH).reduced()
    tp = T.init_params(cfg, torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(p): (a.shape, str(a.dtype))
            for p, a in _leaves(jax_params)}
    got = {jax.tree_util.keystr(p): (tuple(t.shape),
                                     str(t.dtype).split(".")[1])
           for p, t in _leaves(tp)}
    assert got == want
    emb = tp["embed"]
    assert abs(float(emb.std()) - 0.02) < 0.001
    wq = tp["layers"]["attn"]["wq"]
    bound = 1.0 / np.sqrt(cfg.d_model)
    assert float(wq.abs().max()) <= bound
    assert abs(float(wq.std()) - bound / np.sqrt(3)) < 0.05 * bound
    assert float(tp["layers"]["attn"]["bq"].abs().max()) == 0.0
    assert bool((tp["final_norm"]["scale"] == 1).all())


def test_entry_points_asked_for_cuda_without_a_card_raise(jax_params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy(tree, device="cuda")
    cfg = get_config(ARCH).reduced()
    params = params_from_numpy(tree, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(cfg, params)  # the default device is the card
