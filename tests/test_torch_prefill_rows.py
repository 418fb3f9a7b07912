"""One-shot prefill's dense MLP in row chunks
(``transformer.PREFILL_MLP_ROWS``) against the JAX package on the CPU:
``launch.steps.make_prefill_step`` of the reduced qwen2-1.5b (2 layers,
d 128, 4/2 heads of dim 32, fp32) over an int8 cache, with the row budget
forced to 3 chunks of the 4 x 32 rows (48, 48 and a ragged 32, so that
chunks straddle the prompts), against the reference's step; the port
chunked against unchunked; a planted chunk that drops its last row; the
dry run with the budget forced against the unchunked record.

Tolerances: fp32 logits 2e-5 abs + rel against JAX (the same sums in
another order); cache scales 2e-5 and codes identical but for at most a
few off by exactly one, as ``tests/test_torch_int8.py`` holds them (a
value within rounding of a code boundary); chunked against unchunked
1e-6, the same products over fewer rows.
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
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "qwen2-1.5b"
B, SEQ = 4, 32
#: 3 chunks of the B * SEQ = 128 rows: 48, 48 and a ragged 32; the first
#: ends inside prompt 1, the second inside prompt 2
ROWS = 48
TOL = 2e-5
CHUNK_TOL = 1e-6
#: codes allowed to sit one step off JAX's (``tests/test_torch_int8.py``)
FLIPPED_CODES = 8


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _tokens():
    """B prompts of SEQ ids, the last right-padded after 19 ids."""
    toks = np.random.RandomState(11).randint(8, 512, (B, SEQ)).astype(
        np.int32)
    toks[-1, 19:] = 0
    return toks


def _port(cfg, tp, toks, rows=None):
    """The port's prefill step over a fresh int8 cache; ``rows`` forces
    the row budget (None: the module's, under which these rows run in one
    piece)."""
    if rows is not None:
        old, T.PREFILL_MLP_ROWS = T.PREFILL_MLP_ROWS, rows
    try:
        cache = T.init_cache(cfg, B, SEQ, "cpu", kv_dtype="int8")
        return steps.make_prefill_step(cfg)(
            tp, {"tokens": torch.from_numpy(toks), "cache": cache})
    finally:
        if rows is not None:
            T.PREFILL_MLP_ROWS = old


def _codes_off(got, want) -> int:
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    return int((diff > 0).sum())


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def test_unchunked_below_the_budget():
    """A batch within the budget runs in one piece (every served window,
    one 32768-token prompt), and prefill_32k's 2**20 rows in 4 chunks."""
    assert B * SEQ <= T.PREFILL_MLP_ROWS
    assert 32768 <= T.PREFILL_MLP_ROWS
    shape = S.SHAPES["prefill_32k"]
    assert -(-shape.global_batch * shape.seq_len // T.PREFILL_MLP_ROWS) == 4


def test_chunked_prefill_step_matches_reference(setup):
    jcfg, cfg, jp, tp = setup
    toks = _tokens()
    jl, jc = JSTEPS.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks),
             "cache": JT.init_cache(jcfg, B, SEQ, kv_dtype="int8")})
    tl, tc = _port(cfg, tp, toks, rows=ROWS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    got, want = tc["kv"], jc["kv"]
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=TOL, rtol=TOL)
    off = (_codes_off(got.k.numpy(), want.k)
           + _codes_off(got.v.numpy(), want.v))
    assert off <= FLIPPED_CODES


def test_chunked_equals_unchunked(setup):
    _, cfg, _, tp = setup
    toks = _tokens()
    whole_l, whole_c = _port(cfg, tp, toks)
    for rows in (ROWS, 1, SEQ, B * SEQ - 1):
        tl, tc = _port(cfg, tp, toks, rows=rows)
        assert _gap(tl, whole_l) <= CHUNK_TOL, rows
        for name in ("k_scale", "v_scale"):
            assert _gap(getattr(tc["kv"], name),
                        getattr(whole_c["kv"], name)) <= CHUNK_TOL
        assert _codes_off(tc["kv"].k, whole_c["kv"].k) == 0
        assert _codes_off(tc["kv"].v, whole_c["kv"].v) == 0


def test_chunk_that_drops_its_last_row_is_caught(setup, monkeypatch):
    """The planted fault: each chunk leaves its last row's MLP out (the
    last chunk ends at the last prompt's last position)."""
    _, cfg, _, tp = setup
    toks = _tokens()
    whole_l, _ = _port(cfg, tp, toks)

    def drop_last(fn, x, rows):
        flat = x.reshape(-1, x.shape[-1])
        out = torch.zeros_like(flat)
        for a in range(0, flat.shape[0], rows):
            b = min(a + rows, flat.shape[0]) - 1
            out[a:b] = fn(flat[a:b])
        return out.view_as(x)

    monkeypatch.setattr(T, "_in_rows", drop_last)
    tl, _ = _port(cfg, tp, toks, rows=ROWS)
    assert _gap(tl, whole_l) > 1e3 * CHUNK_TOL


def _record(cfg, mesh_shape, rows=None, monkeypatch=None):
    if rows is not None:
        monkeypatch.setattr(T, "PREFILL_MLP_ROWS", rows)
    return dryrun.lower_one(ARCH, "prefill_32k", False, cfg_override=cfg,
                            input_shape=S.InputShape("prefill_32k", SEQ, B,
                                                     "prefill"),
                            mesh_shape=mesh_shape, kv_dtype="int8")


@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 2)])
def test_dry_run_with_the_budget_forced(setup, monkeypatch, mesh_shape):
    """The same flops and arguments as the unchunked record, a lower peak
    (the MLP's transients of one chunk), and at (1, 2) the same
    collectives: one sum of the ranks' MLP partials a layer."""
    cfg = dataclasses.replace(setup[1])
    whole = _record(cfg, mesh_shape)
    chunked = _record(cfg, mesh_shape, ROWS, monkeypatch)
    assert chunked["flops"] == whole["flops"]
    assert (chunked["cost_analysis"]["pod flops"]
            == whole["cost_analysis"]["pod flops"])
    ma, mw = chunked["memory_analysis"], whole["memory_analysis"]
    assert ma["argument_size_in_bytes"] == mw["argument_size_in_bytes"]
    assert ma["peak_memory_in_bytes"] < mw["peak_memory_in_bytes"]
    assert chunked["collectives"] == whole["collectives"]
    if mesh_shape == (1, 2):
        # the embedding's sum, two sums a layer, the logits' gather, and
        # the int8 writes' max for K and for V a layer
        assert chunked["collectives"]["count"] == (
            1 + 2 * cfg.n_layers + 1 + 2 * cfg.n_layers)
