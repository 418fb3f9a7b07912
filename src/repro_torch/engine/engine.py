"""PyTorch inference engine — the port of ``repro.engine.engine``.

A fixed-capacity **slot** cache: every decode slot owns a contiguous KV
region (dense family) or a recurrent state (SSM family) of a
statically-shaped batched cache, and slots advance independently (per-slot
``len`` vector).  Preemption is slot eviction plus recompute on resume.

The paper's two additions to the serving engine are kept:
  * **iteration-wise execution** — ``run_window`` executes exactly K tokens
    (or to EOS) for the scheduled batch and returns partial outputs;
  * **configurable priorities** — the scheduler decides which jobs hold
    slots each window; ``evict_job``/``add_jobs`` implement preemption.

Fast path, as in the reference:
  * **batched bucketed prefill** — every newly scheduled job is admitted in
    ONE right-padded ``(batch_bucket, seq_bucket)`` prefill dispatch; the
    recurrent families (:data:`EXACT_PREFILL_FAMILIES`) admit serially, one
    batch-1 dispatch at the exact prompt length each;
  * **masked decode windows** — each decode step carries a per-slot
    ``active`` mask; below capacity the engine gathers the scheduled slots
    into a ``batch_bucket``-sized sub-cache, decodes it and scatters it
    back; a slot that emits EOS is frozen for the rest of the window;
  * **kernels** — ``attn_impl="kernel"`` runs prefill through the
    hand-written flash-attention (dense) or SSD-scan (SSM) kernel and every
    dense decode step through the flash-decode kernel; the SSM decode step
    is plain PyTorch, as in the reference (``"torch"`` is the plain
    reference path throughout).

PyTorch runs eagerly, so a decode window is a Python loop of steps and the
``num_*_traces`` counters count distinct dispatch shapes first seen (the
reference counts jit traces; both are bounded by the shape buckets).

Tensor parallelism: ``InferenceEngine(..., mesh=...)`` (a ``("model",)``
mesh, :mod:`repro_torch.launch.mesh`) holds one parameter shard and one
slot cache per rank, each on its rank's device, and drives every rank from
this one process (:mod:`repro_torch.models.transformer`); the slot
bookkeeping, the sampler and ``last_token`` stay on rank 0, so the executor
and the frontend see one engine.  :func:`make_tp_pods` builds data-parallel
pods of such engines.  Chunked prefill, KV swap and the live-to-simulator
calibration are later slices of the port.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.frontend import Backend, ExecResult
from repro_torch.core.job import Job
from repro_torch.data.dataset import batch_bucket, n_shape_buckets, seq_bucket
from repro_torch.data.tokenizer import EOS_ID, PAD_ID
from repro_torch.device import resolve_device, synchronize
from repro_torch.engine.sampler import SamplerConfig, sample
from repro_torch.launch import partition as P
from repro_torch.launch.mesh import make_mesh, pod_meshes
from repro_torch.models import transformer as T

#: recurrent-state families prefill at exact length (pad positions would be
#: absorbed into the state), so they keep serial batch-1 admission
EXACT_PREFILL_FAMILIES = ("ssm", "hybrid")


@dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4
    max_len: int = 512
    max_output: int = 1024
    eos_id: int = EOS_ID
    #: smallest prefill sequence bucket; padded lengths follow the
    #: power-of-two ``seq_bucket`` ladder up to ``max_len``
    prefill_bucket: int = 16
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    #: kernel implementation: "kernel" (the hand-written CUDA kernels;
    #: their plain versions on CPU tensors) or "torch" (plain PyTorch)
    attn_impl: str = "kernel"
    #: honour each request's own token budget (job.true_output_len acts as
    #: the request's ``max_tokens``)
    respect_job_max: bool = False


# --------------------------------------------------------------------------- #
# Slot-cache gather/scatter
# --------------------------------------------------------------------------- #


def _layer_leaves(cache) -> Dict[str, torch.Tensor]:
    """The cache's per-layer buffers by name; each has its slot (batch) axis
    at 1, after the layer axis (``len`` is the only leaf with it at 0)."""
    if "kv" in cache:
        return {"k": cache["kv"].k, "v": cache["kv"].v}
    return dict(cache["ssm"])


def _ranks(cache) -> List[Dict]:
    """The per-rank caches of a tensor-parallel cache (a list), or the one
    cache of a single-device engine."""
    return cache if isinstance(cache, list) else [cache]


def _gather_slots(cache, idx: torch.Tensor):
    """Copy slot rows ``idx`` of the cache into a sub-cache."""
    sub = {k: v[:, idx] for k, v in _layer_leaves(cache).items()}
    if "kv" in cache:
        return {"len": cache["len"][idx],
                "kv": T.KVCache(sub["k"], sub["v"], cache["kv"].ring)}
    return {"len": cache["len"][idx], "ssm": sub}


def _scatter_slots(big, small, slots: Sequence[int], n: int):
    """Write rows ``0..n-1`` of ``small`` into ``slots`` of ``big``, in
    place (rows beyond ``n`` are bucket padding).  Returns ``big``."""
    sl = torch.as_tensor(list(slots)[:n], dtype=torch.long,
                         device=big["len"].device)
    big["len"][sl] = small["len"][:n]
    small_leaves = _layer_leaves(small)
    for name, buf in _layer_leaves(big).items():
        buf[:, sl] = small_leaves[name][:, :n]
    return big


class InferenceEngine:
    """One backend worker's execution engine (one model, N slots) on one
    device: ``cuda`` unless the caller passes ``device="cpu"``.

    With ``mesh`` (a single-axis ``("model",)`` mesh: one TP pod of the
    dense family) ``params`` is the full tree, which the engine splits by
    ``launch.partition.shard_params``; ``device`` is then rank 0's device.
    Every rank runs the kernels of ``attn_impl``; a layout that does not
    split into ranks of one GQA ratio (the ``layout:`` reason of
    ``launch.partition.kernel_decode_support``) raises ``ValueError``
    here."""

    def __init__(self, model_cfg, params, cfg: Optional[EngineConfig] = None,
                 *, mesh=None, device="cuda", seed: int = 0):
        if cfg is None:
            cfg = EngineConfig()
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = P.tp_ranks(mesh)[0]
            params = P.shard_params(params, model_cfg, mesh)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.params = params
        self.cache = T.init_cache(model_cfg, cfg.max_slots, cfg.max_len,
                                  self.device, mesh=mesh)
        self.slot_job: List[Optional[int]] = [None] * cfg.max_slots
        self.slot_of: Dict[int, int] = {}
        self.last_token = np.full((cfg.max_slots, 1), PAD_ID, np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        #: dispatch counters; ``num_*_traces`` count distinct shapes first
        #: seen, bounded by :meth:`prefill_shape_bound` and
        #: :meth:`decode_batch_buckets`
        self.num_prefill_dispatches = 0
        self.num_decode_dispatches = 0
        self._prefill_shapes: Set[Tuple[int, int]] = set()
        self._decode_shapes: Set[Tuple[int, int]] = set()
        #: first generated token (sampled from prefill logits), pending emission
        self._pending_first: Dict[int, int] = {}
        #: tokens of context re-established by resume prefills, including
        #: the +1 seed token whose KV the first decode step writes
        self.resume_context_tokens = 0

    # ------------------------------------------------------------------ #
    def _set_lens(self, cache, lens: Sequence[int]) -> None:
        """Set ``len`` of every rank's cache to ``lens``: the ranks' lengths
        stay equal."""
        for c in _ranks(cache):
            c["len"] = torch.as_tensor(list(lens), dtype=torch.int32,
                                       device=c["len"].device)

    # ------------------------------------------------------------------ #
    @property
    def num_prefill_traces(self) -> int:
        return len(self._prefill_shapes)

    @property
    def num_decode_traces(self) -> int:
        return len(self._decode_shapes)

    def prefill_shape_bound(self) -> int:
        """Upper bound on distinct prefill shapes the bucketing can emit
        (attention families; exact-length families have one shape per
        prompt length, unbounded by design)."""
        return n_shape_buckets(self.cfg.max_slots, self.cfg.max_len,
                               self.cfg.prefill_bucket)

    def decode_batch_buckets(self) -> int:
        """Distinct decode batch sizes compaction can dispatch."""
        return len({min(batch_bucket(n), self.cfg.max_slots)
                    for n in range(1, self.cfg.max_slots + 1)})

    def synchronize(self) -> None:
        """Wait for this engine's queued device work, on every rank."""
        for dev in dict.fromkeys(c["len"].device for c in _ranks(self.cache)):
            synchronize(dev)

    # ------------------------------------------------------------------ #
    def free_slots(self) -> int:
        return self.slot_job.count(None)

    def has_job(self, job_id: int) -> bool:
        return job_id in self.slot_of

    def _resume_tokens(self, job: Job) -> List[int]:
        """Token stream to prefill: the prompt for a fresh job; for a
        resumed one ``prompt + generated[:-1]``, with decode seeded by the
        last already-emitted token (nothing is emitted twice)."""
        if job.generated:
            return list(job.prompt_tokens) + list(job.generated)[:-1]
        return list(job.prompt_tokens)

    def add_jobs(self, jobs: Sequence[Job]) -> List[int]:
        """Admit every job not yet holding a slot: attention families in
        ONE padded ``(batch_bucket, seq_bucket)`` prefill dispatch,
        exact-length families in serial batch-1 dispatches.  Returns each
        job's slot."""
        todo = [j for j in jobs if not self.has_job(j.job_id)]
        if todo:
            if len(todo) > self.free_slots():
                # all-or-nothing: fail before any partial serial admission
                raise RuntimeError(
                    f"admitting {len(todo)} jobs needs {len(todo)} free "
                    f"slots, engine has {self.free_slots()}")
            if self.model_cfg.family in EXACT_PREFILL_FAMILIES:
                for j in todo:
                    self._admit([j])
            else:
                self._admit(todo)
        return [self.slot_of[j.job_id] for j in jobs]

    def _admit(self, jobs: Sequence[Job]) -> List[int]:
        """One prefill dispatch admitting ``jobs`` (``add_jobs`` has checked
        that they fit)."""
        token_lists = [self._resume_tokens(j) for j in jobs]
        true_lens = [len(t) for t in token_lists]
        longest = max(true_lens)
        if longest > self.cfg.max_len:
            raise ValueError(
                f"prompt of {longest} tokens exceeds max_len="
                f"{self.cfg.max_len}")
        if self.model_cfg.family in EXACT_PREFILL_FAMILIES:
            # recurrent state must stay clean: exact length, batch 1
            assert len(jobs) == 1, "exact-length families admit serially"
            bb, sl = 1, true_lens[0]
        else:
            bb = batch_bucket(len(jobs))
            sl = seq_bucket(longest, self.cfg.max_len,
                            min_bucket=self.cfg.prefill_bucket)
        toks = np.full((bb, sl), PAD_ID, np.int32)
        last_index = np.zeros((bb,), np.int32)
        for i, t in enumerate(token_lists):
            toks[i, : len(t)] = t
            last_index[i] = len(t) - 1
        cache_n = T.init_cache(self.model_cfg, bb, self.cfg.max_len,
                               self.device, mesh=self.mesh)
        self._prefill_shapes.add((bb, sl))
        self.num_prefill_dispatches += 1
        logits, cache_n = T.prefill(
            self.params, self.model_cfg,
            {"tokens": torch.as_tensor(toks, device=self.device)}, cache_n,
            attn_impl=self.cfg.attn_impl,
            last_index=torch.as_tensor(last_index, device=self.device),
            mesh=self.mesh)
        # per-row true lengths (prefill stamps the padded length); rows past
        # a slot's len hold pad K/V that the kv_len mask hides
        self._set_lens(cache_n, true_lens + [0] * (bb - len(jobs)))
        slots = [s for s, owner in enumerate(self.slot_job)
                 if owner is None][: len(jobs)]
        for big, small in zip(_ranks(self.cache), _ranks(cache_n)):
            _scatter_slots(big, small, slots, len(jobs))
        first_tokens = torch.argmax(logits[:, -1], dim=-1).tolist()
        for i, (job, slot) in enumerate(zip(jobs, slots)):
            self.slot_job[slot] = job.job_id
            self.slot_of[job.job_id] = slot
            if job.generated:
                self.last_token[slot, 0] = job.generated[-1]
                # resume recomputes prompt + generated[:-1], and the seed
                # token's KV is written by the first decode step (+1)
                self.resume_context_tokens += true_lens[i] + 1
            else:
                self._pending_first[job.job_id] = first_tokens[i]
                self.last_token[slot, 0] = first_tokens[i]
        return slots

    def evict_job(self, job_id: int) -> None:
        slot = self.slot_of.pop(job_id, None)
        self._pending_first.pop(job_id, None)
        if slot is not None:
            self.slot_job[slot] = None
            self.last_token[slot, 0] = PAD_ID

    # ------------------------------------------------------------------ #
    def _decode_window(self, cache, last_tokens: torch.Tensor,
                       alive: torch.Tensor, window: int):
        """``window`` masked decode steps over ``cache`` (updated in place).
        Returns (cache, tokens (rows, window))."""
        self._decode_shapes.add((window, last_tokens.shape[0]))
        mc, ec = self.model_cfg, self.cfg
        toks = last_tokens
        out = []
        for _ in range(window):
            logits, cache = T.decode_step(self.params, mc, toks, cache,
                                          attn_impl=ec.attn_impl,
                                          active=alive, mesh=self.mesh)
            nxt = sample(logits[:, -1, :], self._gen, ec.sampler,
                         active=alive, pad_token=PAD_ID)
            # EOS freezes the slot for the rest of the window: no KV write,
            # no len advance, PAD emissions
            alive = alive & (nxt != ec.eos_id)
            out.append(nxt)
            toks = nxt[:, None]
        return cache, torch.stack(out, dim=1)

    def run_window(self, jobs: Sequence[Job], window: int
                   ) -> Tuple[List[List[int]], List[bool]]:
        """Execute K decode steps for ``jobs`` (admitting any that lack a
        slot via one batched prefill).  Returns
        (new_tokens_per_job, finished_per_job)."""
        if not jobs:
            return [], []
        self.add_jobs(jobs)
        results: Dict[int, Tuple[List[int], bool]] = {}
        self._decode_jobs(jobs, window, results)
        out_tokens = [list(results[j.job_id][0]) for j in jobs]
        finished = [results[j.job_id][1] for j in jobs]
        return out_tokens, finished

    def _decode_jobs(self, jobs: Sequence[Job], window: int,
                     results: Dict[int, Tuple[List[int], bool]]) -> None:
        """One masked/compacted decode dispatch for ``jobs`` (all holding
        prefilled slots); writes (tokens, finished) into ``results``."""
        slots = [self.slot_of[job.job_id] for job in jobs]
        prev_lens = _ranks(self.cache)[0]["len"].tolist()
        ms = self.cfg.max_slots
        order = sorted(slots)
        db = min(batch_bucket(len(order)), ms)
        compact = db < ms
        if compact:
            # decode only the scheduled slots, padded to the batch bucket
            # (pad rows duplicate a real slot but start dead, so they are
            # frozen no-ops and are never scattered back)
            gidx = np.asarray(order + [order[0]] * (db - len(order)),
                              np.int64)
            subs = [_gather_slots(c, torch.as_tensor(gidx,
                                                     device=c["len"].device))
                    for c in _ranks(self.cache)]
            sub_cache = subs if self.mesh is not None else subs[0]
            sub_last = self.last_token[gidx]
            alive0 = np.zeros((db,), bool)
            alive0[: len(order)] = True
            row_of = {slot: r for r, slot in enumerate(order)}
        else:
            # full-width dispatch, but unscheduled slots stay frozen
            sub_cache = self.cache
            sub_last = self.last_token
            alive0 = np.zeros((ms,), bool)
            alive0[slots] = True
            row_of = {s: s for s in slots}
        self.num_decode_dispatches += 1
        new_cache, toks = self._decode_window(
            sub_cache, torch.as_tensor(sub_last, device=self.device),
            torch.as_tensor(alive0, device=self.device), window)
        toks = toks.cpu().numpy()  # (rows, K)
        if compact:
            for big, small in zip(_ranks(self.cache), _ranks(new_cache)):
                _scatter_slots(big, small, order, len(order))
        lens = list(prev_lens)
        for job in jobs:
            slot = self.slot_of[job.job_id]
            scanned = toks[row_of[slot]].tolist()
            pending = self._pending_first.pop(job.job_id, None)
            if pending is not None:
                # first emission comes from the prefill logits; the window's
                # K-th token is unconsumed (its cache write is rolled back)
                seq = [pending] + scanned[: window - 1]
                consumed_scanned = len(seq) - 1
            else:
                seq = scanned[:window]
                consumed_scanned = len(seq)
            cap = self.cfg.max_output
            if self.cfg.respect_job_max and job.true_output_len > 0:
                cap = min(cap, job.true_output_len)
            if self.cfg.eos_id in seq:
                cut = seq.index(self.cfg.eos_id) + 1
                dropped = len(seq) - cut
                seq = seq[:cut]
                consumed_scanned -= dropped
                fin = True
            else:
                fin = False
            room = cap - job.tokens_generated
            if len(seq) >= room:
                dropped = len(seq) - room
                seq = seq[:room]
                consumed_scanned -= dropped
                fin = True
            results[job.job_id] = (seq, fin)
            self.last_token[slot, 0] = seq[-1] if seq else PAD_ID
            # the cache pointer advances exactly one position per consumed
            # write — robust to EOS freezing and to cap truncation
            lens[slot] = prev_lens[slot] + max(consumed_scanned, 0)
        self._set_lens(self.cache, lens)


def make_tp_pods(model_cfg, params, cfg: Optional[EngineConfig] = None, *,
                 n_pods: int = 1, tp: int = 1, devices=None
                 ) -> Dict[int, InferenceEngine]:
    """``n_pods`` data-parallel serving pods, each a ``tp``-way
    tensor-parallel :class:`InferenceEngine` on its own ``("model",)``
    mesh: the pods are the rows of a ``(n_pods, tp)`` ``("data", "model")``
    mesh over ``devices`` (default: every visible CUDA device once; a
    device may be listed more than once), so pod n takes
    ``devices[n * tp:(n + 1) * tp]``.  Each pod registers as one node with
    the frontend, and nothing crosses pods.  ``tp=1`` pods are plain
    single-device engines, with ``params`` copied to their device.  Raises
    ``RuntimeError`` when there are too few devices."""
    pods = pod_meshes(make_mesh((n_pods, tp), ("data", "model"),
                                devices=devices))
    if tp <= 1:
        return {n: InferenceEngine(model_cfg, _to_device(params, pod.ranks[0]),
                                   cfg, device=pod.ranks[0])
                for n, pod in enumerate(pods)}
    return {n: InferenceEngine(model_cfg, params, cfg, mesh=pod)
            for n, pod in enumerate(pods)}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(resolve_device(device))


# --------------------------------------------------------------------------- #
# Backend adapter for the ELIS frontend
# --------------------------------------------------------------------------- #


class EngineExecutor(Backend):
    """Wraps per-node InferenceEngines behind the frontend Backend ABC.
    Durations are measured wall-clock, with the device synchronised before
    the window's clock is read.  Every executed window is appended to
    ``window_log`` (node, batch, window, duration, tokens)."""

    def __init__(self, engines: Dict[int, InferenceEngine]):
        self.engines = engines
        self.window_log: List[Dict] = []

    def capacity(self, node: int) -> int:
        return self.engines[node].cfg.max_slots

    def free_capacity(self, node: int) -> int:
        return self.engines[node].free_slots()

    def execute(self, node: int, jobs: Sequence[Job], window: int,
                now: float) -> ExecResult:
        eng = self.engines[node]
        t0 = time.perf_counter()
        needed = sum(1 for job in jobs if not eng.has_job(job.job_id))
        if needed > eng.free_slots():
            raise RuntimeError(
                f"node {node}: batch needs {needed} free slots, "
                f"engine has {eng.free_slots()}")
        tokens, finished = eng.run_window(jobs, window)
        eng.synchronize()
        dur = time.perf_counter() - t0
        self.window_log.append({
            "node": node, "batch": len(jobs), "window": window,
            "duration_s": dur, "tokens": sum(len(t) for t in tokens),
        })
        return ExecResult(dur, tokens, finished)

    def evict(self, node: int, job: Job) -> None:
        self.engines[node].evict_job(job.job_id)

    # ------------------------------------------------------------------ #
    def node_counters(self) -> Dict[int, Dict[str, int]]:
        """Per-node dispatch counters."""
        windows = {n: 0 for n in self.engines}
        for rec in self.window_log:
            windows[rec["node"]] = windows.get(rec["node"], 0) + 1
        return {
            n: {"prefill_traces": eng.num_prefill_traces,
                "prefill_dispatches": eng.num_prefill_dispatches,
                "decode_traces": eng.num_decode_traces,
                "decode_dispatches": eng.num_decode_dispatches,
                "resume_context_tokens": eng.resume_context_tokens,
                "windows_executed": windows.get(n, 0)}
            for n, eng in self.engines.items()
        }

    def counters(self) -> Dict[str, int]:
        """Dispatch counters aggregated across this executor's engines."""
        agg = {"prefill_traces": 0, "prefill_dispatches": 0,
               "decode_traces": 0, "decode_dispatches": 0,
               "resume_context_tokens": 0,
               "windows_executed": len(self.window_log)}
        for per in self.node_counters().values():
            for k in agg:
                if k != "windows_executed":
                    agg[k] += per[k]
        return agg
