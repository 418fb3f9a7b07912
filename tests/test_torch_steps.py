"""The port's step entry points against the JAX package on the CPU:
``launch.shapes.input_specs`` (shapes and dtypes of every input, full
width, every assigned shape, dense and int8 caches) and
``launch.steps.make_prefill_step`` / ``make_serve_step`` on the reduced
qwen2-1.5b (fp32): prefill logits within 2e-5 and greedy tokens identical
to the reference's step functions.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once, and
# more threads than cores only make each of them wait
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-5


def _walk(tree, prefix=""):
    """(path, leaf) of a nested dict of arrays, tensors or KV caches (JAX's
    or the port's, whose leaves carry the same names); a KV cache also
    gives its ring flag."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    elif hasattr(tree, "k_scale"):
        yield f"{prefix}/ring", tree.ring
        for name in ("k", "v", "k_scale", "v_scale"):
            if getattr(tree, name) is not None:
                yield from _walk(getattr(tree, name), f"{prefix}/{name}")
    else:
        yield prefix, tree


def _leaves(tree):
    """{path: (shape, dtype name)}, and each KV cache's ring flag."""
    return {path: leaf if isinstance(leaf, bool) else
            (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
            for path, leaf in _walk(tree)}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m"])
@pytest.mark.parametrize("shape", sorted(JS.SHAPES))
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_input_specs_match_reference_on_meta(arch, shape, kv_dtype):
    """Full width: the same inputs, shapes and dtypes as the reference's
    ``ShapeDtypeStruct`` tree, on the meta device (nothing allocated)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert S.SHAPES[shape] == S.InputShape(**dataclasses.asdict(
        JS.SHAPES[shape]))
    assert S.supported(cfg, S.SHAPES[shape]) == JS.supported(
        jcfg, JS.SHAPES[shape])
    want = JS.input_specs(jcfg, JS.SHAPES[shape], kv_dtype=kv_dtype)
    got = S.input_specs(cfg, S.SHAPES[shape], kv_dtype=kv_dtype)
    assert _leaves(got) == _leaves(want)
    assert all(leaf.device.type == "meta" for _, leaf in _walk(got)
               if isinstance(leaf, torch.Tensor))


def test_input_specs_on_a_real_device_are_zeros():
    cfg = get_config("qwen2-1.5b").reduced()
    specs = S.input_specs(cfg, S.InputShape("small", 32, 2, "decode"),
                          kv_dtype="int8", device="cpu")
    kv = specs["cache"]["kv"]
    assert tuple(specs["tokens"].shape) == (2, 1)
    assert kv.k.dtype == torch.int8 and not kv.ring
    assert all(int(t.abs().sum()) == 0 for t in
               (specs["tokens"], specs["cache"]["len"], kv.k, kv.v,
                kv.k_scale, kv.v_scale))


def test_input_specs_ring_for_long_context_only():
    cfg = get_config("qwen2-1.5b")
    kv = S.input_specs(cfg, S.SHAPES["long_500k"])["cache"]["kv"]
    assert kv.ring and kv.k.shape[2] == S.LONG_CONTEXT_WINDOW
    assert S._window(cfg, S.SHAPES["decode_32k"]) is None
    assert not S.supported(
        dataclasses.replace(cfg, long_context_mode="unsupported"),
        S.SHAPES["long_500k"])


def test_input_specs_refuse_families_not_ported():
    """No family is left unported: every family of the registry, the vlm
    and audio ones last, has ``input_specs`` with the reference's keys and
    shapes (qwen2-vl-7b's ``embeds`` and 3-D ``positions``, whisper's
    ``frames`` and its cross-K/V beside a decoder cache of 448 rows)."""
    assert {get_config(a).family for a in list_archs()} <= set(T.FAMILIES)
    for arch in ("qwen2-vl-7b", "whisper-large-v3"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name, shape in S.SHAPES.items():
            got = S.input_specs(cfg, shape)
            want = JS.input_specs(jcfg, JS.SHAPES[name])
            assert set(got) == set(want), (arch, name)
            for key in set(got) - {"cache"}:
                assert tuple(got[key].shape) == want[key].shape
            if "cache" in got:
                assert set(got["cache"]) == set(want["cache"])
                for leaf in set(got["cache"]) - {"len"}:
                    assert tuple(got["cache"][leaf].k.shape) == want[
                        "cache"][leaf].k.shape, (arch, name, leaf)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_step_functions_match_reference(kv_dtype, impl):
    """Prefill 3 prompts of 24 ids into a decode-shape cache of 64 rows,
    then 12 serve steps fed their own greedy tokens."""
    jcfg = jax_get_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    shape = S.InputShape("small", 64, 3, "decode")
    prompts = np.random.RandomState(7).randint(8, 512, (3, 24)).astype(
        np.int32)
    jl, jc = JSTEPS.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(prompts),
             "cache": JT.init_cache(jcfg, 3, 64, kv_dtype=kv_dtype)})
    specs = S.input_specs(cfg, shape, kv_dtype=kv_dtype, device="cpu")
    tl, tc = steps.make_prefill_step(cfg, attn_impl=impl)(
        tp, {"tokens": torch.from_numpy(prompts), "cache": specs["cache"]})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    jstep = JSTEPS.make_serve_step(jcfg)
    tstep = steps.make_serve_step(cfg, attn_impl=impl)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = tl[:, -1].argmax(-1).to(torch.int32)
    for _ in range(12):
        jtok, jc = jstep(jp, jtok[:, None], jc)
        ttok, tc = tstep(tp, ttok[:, None], tc)
        assert ttok.dtype == torch.int32
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
