"""PyTorch inference engine — the port of ``repro.engine.engine``.

A fixed-capacity **slot** cache: every decode slot owns a contiguous KV
region (dense, MoE and vlm families; the audio family's cache adds its
cross-attention K/V), a recurrent state (SSM family) or both (hybrid
family) of a statically-shaped batched cache, and slots advance
independently (per-slot ``len`` vector).  Preemption is slot eviction plus recompute on resume, or
a swap of the slot's cache to host memory and back (``offload_job`` /
``restore_job``).

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
  * **chunked prefill** — ``run_window(..., prefill_chunk=C)`` admits new
    jobs into a slot without prefilling them and ingests at most one
    C-token chunk per window (:func:`repro_torch.models.transformer.
    prefill_chunk`), interleaved with the running decodes; ring, int8 and
    recurrent caches fall back to one-shot prefill with one warning;
  * **kernels** — ``attn_impl="kernel"`` runs one-shot prefill through the
    hand-written flash-attention (dense, MoE) or SSD-scan (SSM) kernel, or
    both (hybrid), and the attention of every decode step through the
    flash-decode kernel; the SSM decode step, the MoE experts and the chunk
    of a chunked prefill are plain PyTorch, as in the reference
    (``"torch"`` is the plain reference path throughout).

``EngineConfig(batched_prefill=False)`` and ``masked_decode=False`` are the
reference's pre-fast-path baselines, kept for benchmarking: one batch-1
prefill dispatch per admitted job, and every decode window at the full
``max_slots`` batch with every slot alive (empty and unscheduled slots
advance too, as in the reference).

PyTorch runs eagerly, so a decode window is a Python loop of steps and the
``num_*_traces`` counters count distinct dispatch shapes first seen (the
reference counts jit traces; both are bounded by the shape buckets).

Tensor parallelism: ``InferenceEngine(..., mesh=...)`` (a ``("model",)``
mesh, :mod:`repro_torch.launch.mesh`) holds one parameter shard and one
slot cache per rank, each on its rank's device, and drives every rank from
this one process (:mod:`repro_torch.models.transformer`); the slot
bookkeeping, the sampler and ``last_token`` stay on rank 0, so the executor
and the frontend see one engine.  :func:`make_tp_pods` builds data-parallel
pods of such engines (every family; an audio pod refuses its first
prefill as one device does).  A chunk of a
chunked prefill runs every rank over its own cache, and a swap stashes
every rank's slot rows, each copied back to its own rank's device; the
SSM families' per-rank states (their conv channels and heads) are slot
rows like the K/V, on the same slot axes.

The vlm family serves text only, as the reference's engine does: a job's
tokens, with their positions on all three M-RoPE axes, on one device or
a pod.  An audio engine (or pod) builds its cache (``cross_kv``, each
rank's query heads on a pod) but raises
``NotImplementedError`` at its first prefill
(:data:`AUDIO_PREFILL_NOT_SERVED`).

``EngineExecutor.calibrated_profile`` fits the measured window durations
back onto the simulator's latency model (live-to-simulator calibration).
"""
from __future__ import annotations

import time
import warnings
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
from repro_torch.simulate.profiles import CALIBRATION_MEAN_TOKENS, ModelProfile

#: why an audio engine admits no job (ROADMAP.md §3, "differs on purpose")
AUDIO_PREFILL_NOT_SERVED = (
    "the engine serves no audio prefill: a job carries prompt tokens and "
    "no frames for the encoder (the reference's engine passes tokens only, "
    "so its encode_audio raises KeyError); run the audio family through "
    "launch.steps.make_prefill_step with batch['frames']")

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
    #: admit all newly scheduled jobs in one padded (batch, seq)-bucketed
    #: prefill dispatch (False = one batch-1 dispatch per job, the
    #: pre-fast-path baseline kept for benchmarking)
    batched_prefill: bool = True
    #: compact decode dispatches to the batch bucket of the *scheduled*
    #: slots and freeze unscheduled/EOS slots (False = always decode the
    #: full ``max_slots`` batch, the pre-fast-path baseline)
    masked_decode: bool = True
    #: honour each request's own token budget (job.true_output_len acts as
    #: the request's ``max_tokens``)
    respect_job_max: bool = False


# --------------------------------------------------------------------------- #
# Slot-cache gather/scatter
# --------------------------------------------------------------------------- #


def _slot_axis(name: str) -> int:
    """Slot (batch) axis of the leaves under the cache entry ``name``:
    ``len`` has it at 0; the K/V buffers and scales and the SSM states at
    1, after the layer (or site) axis; the hybrid's ``groups_ssm`` at 2,
    after (n_groups, inner)."""
    if name == "len":
        return 0
    return 2 if name == "groups_ssm" else 1


def _leaves(tree):
    """The tensors of a cache entry (or whole cache), in a fixed order."""
    if isinstance(tree, T.KVCache):
        tree = [tree.k, tree.v, tree.k_scale, tree.v_scale]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    elif isinstance(tree, torch.Tensor):
        yield tree
        return
    for t in tree:
        if t is not None:
            yield from _leaves(t)


def _ranks(cache) -> List[Dict]:
    """The per-rank caches of a tensor-parallel cache (a list), or the one
    cache of a single-device engine."""
    return cache if isinstance(cache, list) else [cache]


def _gather_slots(cache, idx: torch.Tensor):
    """Copy slot rows ``idx`` of every leaf of the cache (each along its
    :func:`_slot_axis`) into a sub-cache of the same structure."""
    idx = idx.long()
    return {name: _map_leaves(entry, lambda t, ax=_slot_axis(name):
                              t.index_select(ax, idx))
            for name, entry in cache.items()}


def _scatter_slots(big, small, slots: Sequence[int], n: int):
    """Write rows ``0..n-1`` of ``small`` into ``slots`` of ``big``, in
    place, every leaf along its :func:`_slot_axis` (rows beyond ``n`` are
    bucket padding).  Returns ``big``."""
    sl = torch.as_tensor(list(slots)[:n], dtype=torch.long,
                         device=big["len"].device)
    for name, entry in big.items():
        ax = _slot_axis(name)
        for dst, src in zip(_leaves(entry), _leaves(small[name])):
            dst.index_copy_(ax, sl, src.narrow(ax, 0, n))
    return big


class InferenceEngine:
    """One backend worker's execution engine (one model, N slots) on one
    device: ``cuda`` unless the caller passes ``device="cpu"``.

    With ``mesh`` (a single-axis ``("model",)`` mesh: one TP pod of any
    family) ``params`` is the full tree, which the engine splits by
    ``launch.partition.shard_params``; ``device`` is then rank 0's
    device.  Every rank runs the kernels of ``attn_impl``, over its own
    share of the heads and widths, equal or not (a rank whose heads cut a
    GQA group in uniform segments); every width the engine moves (chunk
    views, swap stashes) is the rank cache's own.  A layout the port has
    none for (``launch.partition.layout_reason``: several SSM groups that
    do not divide over the ranks) raises ``ValueError`` here."""

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
        #: tokens of context re-established by resume prefills (full or
        #: chunked), including the +1 seed token whose KV the first decode
        #: step writes
        self.resume_context_tokens = 0
        self._warned: Set[str] = set()

        # ---- chunked prefill state (run_window(prefill_chunk=...)) ----
        #: job_id -> tokens already span-written into its slot's cache
        self._prefill_cursor: Dict[int, int] = {}
        #: job_id -> total tokens to prefill (prompt, or resume context)
        self._chunk_target: Dict[int, int] = {}
        #: job_id -> the full token stream being chunk-prefilled
        self._chunk_tokens: Dict[int, List[int]] = {}
        #: job_id -> True when the chunked prefill re-establishes a resumed
        #: job's context (counts toward ``resume_context_tokens``)
        self._chunk_resumed: Dict[int, bool] = {}
        self.num_chunk_dispatches = 0
        self._chunk_shapes: Set[int] = set()

        # ---- KV offload tier (offload_job/restore_job) ----
        #: job_id -> host (cpu) copy of the slot cache + decode bookkeeping
        self._host_stash: Dict[int, Dict] = {}
        #: watermark (stashed context tokens) bounding the host swap pool;
        #: None = unbounded.  ``EngineExecutor`` threads
        #: ``PreemptionConfig.swap_pool_tokens`` here; over-watermark
        #: swap-outs evict the COLDEST stashed victims to the
        #: recompute-fallback path (loud, once per engine)
        self.swap_pool_tokens: Optional[int] = None
        #: context tokens currently held in the host stash
        self.stash_tokens = 0
        #: stashes evicted by the watermark (victims fell back to recompute)
        self.n_stash_evictions = 0
        self.stash_evicted_tokens = 0

    # ------------------------------------------------------------------ #
    def _warn_once(self, key: str, msg: str) -> None:
        """Emit a ``UserWarning`` at most once per engine per ``key``: the
        guard behind every loud fallback (unsupported chunked prefill, the
        swap pool's watermark).  The message always carries the reason."""
        if key in self._warned:
            return
        self._warned.add(key)
        warnings.warn(msg, UserWarning, stacklevel=3)

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

    # ------------------------------------------------------------------ #
    # Chunked prefill
    # ------------------------------------------------------------------ #

    @property
    def num_chunk_traces(self) -> int:
        """Distinct padded chunk lengths dispatched so far."""
        return len(self._chunk_shapes)

    def chunk_supported(self) -> bool:
        """Chunked prefill needs a position-addressable dense KV cache:
        attention families only (recurrent state absorbs pads), no ring/SWA
        buffer (span writes are position-destructive there), no int8 KV
        (the chunk would attend a dequantized prefix while one-shot prefill
        attends the fresh unquantized K/V)."""
        if self.model_cfg.family not in T.CHUNKABLE_FAMILIES:
            return False
        kvc = _ranks(self.cache)[0].get("kv")
        return kvc is not None and not kvc.ring and not kvc.quantized

    def _alloc_slot(self, job: Job) -> int:
        """Claim a slot WITHOUT prefilling (chunked admission): the slot's
        ``len`` is zeroed and the prompt is span-written chunk by chunk
        across subsequent windows (stale K/V from a previous occupant is
        dead weight behind the kv_len mask, exactly as after a one-shot
        scatter)."""
        free = [s for s, owner in enumerate(self.slot_job) if owner is None]
        if not free:
            raise RuntimeError("no free slot to allocate")
        slot = free[0]
        toks = self._resume_tokens(job)
        if len(toks) > self.cfg.max_len:
            raise ValueError(
                f"prompt of {len(toks)} tokens exceeds max_len="
                f"{self.cfg.max_len}")
        self.slot_job[slot] = job.job_id
        self.slot_of[job.job_id] = slot
        self.last_token[slot, 0] = PAD_ID
        self._prefill_cursor[job.job_id] = 0
        self._chunk_target[job.job_id] = len(toks)
        self._chunk_tokens[job.job_id] = toks
        self._chunk_resumed[job.job_id] = bool(job.generated)
        for c in _ranks(self.cache):
            c["len"][slot] = 0
        return slot

    def prefill_incomplete(self, job_id: int) -> bool:
        """True while a chunk-admitted job still has prompt tokens to
        ingest — such a job is excluded from decode dispatches."""
        cur = self._prefill_cursor.get(job_id)
        return cur is not None and cur < self._chunk_target[job_id]

    def _run_chunk(self, job: Job, chunk: int) -> None:
        """Ingest the next (at most) ``chunk`` prompt tokens of ``job`` in
        one batch-1 dispatch against its slot's partially filled cache,
        which it updates in place (the slot's rows and ``len`` only, on
        every rank)."""
        jid = job.job_id
        toks_all = self._chunk_tokens[jid]
        cur = self._prefill_cursor[jid]
        target = self._chunk_target[jid]
        n = min(chunk, target - cur)
        padded = seq_bucket(n, self.cfg.max_len,
                            min_bucket=self.cfg.prefill_bucket)
        toks = np.full((1, padded), PAD_ID, np.int32)
        toks[0, :n] = toks_all[cur:cur + n]
        slot = self.slot_of[jid]
        # views of the slot's rows of each rank's cache: the chunk writes
        # through them in place
        subs = [{"len": c["len"][slot:slot + 1],
                 "kv": T.KVCache(c["kv"].k[:, slot:slot + 1],
                                 c["kv"].v[:, slot:slot + 1], c["kv"].ring)}
                for c in _ranks(self.cache)]
        self._chunk_shapes.add(padded)
        self.num_chunk_dispatches += 1
        logits, _ = T.prefill_chunk(
            self.params, self.model_cfg,
            {"tokens": torch.as_tensor(toks, device=self.device)},
            subs if self.mesh is not None else subs[0],
            attn_impl=self.cfg.attn_impl, start=cur, valid_len=n,
            mesh=self.mesh)
        for c in _ranks(self.cache):
            c["len"][slot] = cur + n
        self._prefill_cursor[jid] = cur + n
        if self._chunk_resumed[jid]:
            self.resume_context_tokens += n
        if cur + n >= target:
            # prefill complete: seed decode exactly like one-shot admission
            if job.generated:
                self.last_token[slot, 0] = job.generated[-1]
                self.resume_context_tokens += 1  # the seed token's KV write
            else:
                first = int(torch.argmax(logits[0, -1]))
                self._pending_first[jid] = first
                self.last_token[slot, 0] = first

    # ------------------------------------------------------------------ #
    # KV offload tier
    # ------------------------------------------------------------------ #

    def offload_job(self, job_id: int) -> bool:
        """Evict a job's slot but keep its cache in HOST memory — resume
        swaps it back in instead of paying recompute.  The stash is a cpu
        copy of every leaf of the slot's sub-cache, one per rank under a
        mesh (each rank's own KV heads), plus the decode bookkeeping (last
        token, pending first emission, chunk cursor), so a restored job
        continues bit for bit.

        With ``swap_pool_tokens`` set, the host stash is bounded: an
        over-watermark swap-out evicts the COLDEST stashed victims (oldest
        swap-outs, insertion order) to the recompute-fallback path; if the
        fresh stash alone exceeds the pool it is refused (returns False, the
        caller falls back to plain eviction + recompute)."""
        slot = self.slot_of.get(job_id)
        if slot is None:
            return False
        subs = [_gather_slots(c, torch.tensor([slot],
                                              device=c["len"].device))
                for c in _ranks(self.cache)]
        ctx = int(subs[0]["len"][0])
        self._host_stash[job_id] = {
            "cache": [_map_leaves(sub, lambda t: t.to("cpu"))
                      for sub in subs],
            "last": int(self.last_token[slot, 0]),
            "pending": self._pending_first.get(job_id),
            "cursor": self._prefill_cursor.get(job_id),
            "target": self._chunk_target.get(job_id),
            "tokens": self._chunk_tokens.get(job_id),
            "resumed": self._chunk_resumed.get(job_id),
            "ctx": ctx,
        }
        self.stash_tokens += ctx
        if self.swap_pool_tokens is not None:
            # evict coldest-first until under the watermark; the fresh
            # stash (newest) is only dropped when it alone exceeds the pool
            while (self.stash_tokens > self.swap_pool_tokens
                   and len(self._host_stash) > 1):
                self._evict_coldest_stash()
            if self.stash_tokens > self.swap_pool_tokens:
                self._evict_coldest_stash()  # the fresh stash itself
        self.evict_job(job_id)
        return job_id in self._host_stash

    def _evict_coldest_stash(self) -> None:
        """Watermark eviction: drop the oldest stash (coldest victim) —
        that job resumes through the recompute-fallback path."""
        victim, st = next(iter(self._host_stash.items()))
        del self._host_stash[victim]
        self.stash_tokens -= st["ctx"]
        self.n_stash_evictions += 1
        self.stash_evicted_tokens += st["ctx"]
        self._warn_once(
            "swap_pool_evict",
            f"host KV swap pool exceeded its {self.swap_pool_tokens}-token "
            f"watermark (PreemptionConfig.swap_pool_tokens); evicting the "
            f"coldest stashed victims to recompute-fallback — raise the "
            f"watermark or reduce preemption pressure if swap-ins were "
            f"expected to stay warm")

    def restore_job(self, job: Job) -> int:
        """Swap a host-stashed job back into a free slot, bit for bit (the
        stash's values are copied into the slot's rows, each rank's onto
        its own device; nothing aliases the stash)."""
        st = self._host_stash.pop(job.job_id)
        self.stash_tokens -= st["ctx"]
        free = [s for s, owner in enumerate(self.slot_job) if owner is None]
        if not free:
            raise RuntimeError("no free slot to restore into")
        slot = free[0]
        for c, sub in zip(_ranks(self.cache), st["cache"]):
            dev = c["len"].device
            _scatter_slots(c, _map_leaves(sub, lambda t: t.to(dev)), [slot],
                           1)
        self.slot_job[slot] = job.job_id
        self.slot_of[job.job_id] = slot
        self.last_token[slot, 0] = st["last"]
        if st["pending"] is not None:
            self._pending_first[job.job_id] = st["pending"]
        if st["cursor"] is not None:
            self._prefill_cursor[job.job_id] = st["cursor"]
            self._chunk_target[job.job_id] = st["target"]
            self._chunk_tokens[job.job_id] = st["tokens"]
            self._chunk_resumed[job.job_id] = st["resumed"]
        return slot

    def has_stash(self, job_id: int) -> bool:
        return job_id in self._host_stash

    def drop_stash(self, job_id: int) -> None:
        """Release a job's host-memory KV copy (terminal states, or a
        migration that abandons the cache)."""
        st = self._host_stash.pop(job_id, None)
        if st is not None:
            self.stash_tokens -= st["ctx"]

    # ------------------------------------------------------------------ #
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

    def add_job(self, job: Job) -> int:
        """Prefill one job into a free slot (batch-1 dispatch).  A job
        already holding a slot keeps it (no double admission); a full
        engine raises ``RuntimeError`` before any prefill."""
        return self.add_jobs([job])[0]

    def add_jobs(self, jobs: Sequence[Job]) -> List[int]:
        """Admit every job not yet holding a slot: attention families in
        ONE padded ``(batch_bucket, seq_bucket)`` prefill dispatch,
        exact-length families (or ``batched_prefill=False``) in serial
        batch-1 dispatches.  Returns each job's slot."""
        todo = [j for j in jobs if not self.has_job(j.job_id)]
        if todo:
            if len(todo) > self.free_slots():
                # all-or-nothing: fail before any partial serial admission
                raise RuntimeError(
                    f"admitting {len(todo)} jobs needs {len(todo)} free "
                    f"slots, engine has {self.free_slots()}")
            if (not self.cfg.batched_prefill
                    or self.model_cfg.family in EXACT_PREFILL_FAMILIES):
                for j in todo:
                    self._admit([j])
            else:
                self._admit(todo)
        return [self.slot_of[j.job_id] for j in jobs]

    def _admit(self, jobs: Sequence[Job]) -> List[int]:
        """One prefill dispatch admitting ``jobs`` (``add_jobs`` has checked
        that they fit).  The audio family raises ``NotImplementedError``:
        a job carries no frames for its encoder."""
        if self.model_cfg.family == "audio":
            raise NotImplementedError(AUDIO_PREFILL_NOT_SERVED)
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
        for state in (self._prefill_cursor, self._chunk_target,
                      self._chunk_tokens, self._chunk_resumed):
            state.pop(job_id, None)
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

    def run_window(self, jobs: Sequence[Job], window: int,
                   prefill_chunk: Optional[int] = None
                   ) -> Tuple[List[List[int]], List[bool]]:
        """Execute K decode steps for ``jobs`` (admitting any that lack a
        slot via one batched prefill).  Returns
        (new_tokens_per_job, finished_per_job).

        A job with a host-stashed cache is swapped back in first.  With
        ``prefill_chunk`` set (and :meth:`chunk_supported`), admission is
        *chunked*: new jobs claim a slot without prefilling, at most ONE job
        per window (the first incomplete one in batch order) ingests one
        ``prefill_chunk``-sized piece of its prompt, and only fully
        prefilled jobs join the decode dispatch — a job completing its
        final chunk in window W begins decoding in window W+1.  Mid-prefill
        jobs emit no tokens.  Unsupported caches fall back loudly to
        one-shot prefill.  Publishes each job's ``prefilled_tokens``."""
        if not jobs:
            return [], []
        # swap-in: batch members with a host-stashed cache restore it
        # instead of paying recompute (KV offload tier)
        for job in jobs:
            if not self.has_job(job.job_id) and self.has_stash(job.job_id):
                self.restore_job(job)
        chunked = prefill_chunk is not None
        if chunked and not self.chunk_supported():
            self._warn_once(
                "chunk_fallback",
                f"prefill_chunk is not supported for "
                f"family={self.model_cfg.family!r} with this cache "
                "(ring/quantized KV or recurrent state); falling back "
                "to one-shot prefill")
            chunked = False
        if chunked:
            for job in jobs:
                if not self.has_job(job.job_id):
                    self._alloc_slot(job)
            # decode eligibility is decided BEFORE the chunk runs: the job
            # completing its final chunk this window decodes next window
            incomplete = [j for j in jobs
                          if self.prefill_incomplete(j.job_id)]
            decode_jobs = [j for j in jobs
                           if not self.prefill_incomplete(j.job_id)]
            if incomplete:
                self._run_chunk(incomplete[0], prefill_chunk)
        else:
            self.add_jobs(jobs)
            decode_jobs = list(jobs)
        results = {j.job_id: ([], False) for j in jobs}
        if decode_jobs:
            self._decode_jobs(decode_jobs, window, results)
        out_tokens = [list(results[j.job_id][0]) for j in jobs]
        finished = [results[j.job_id][1] for j in jobs]
        # publish each job's materialized context (prompt + generated KV,
        # incl. the seed token): the scheduler's prefill-debt ranking and
        # the swap-vs-recompute break-even read it
        for job, seq in zip(jobs, out_tokens):
            if self.prefill_incomplete(job.job_id):
                job.prefilled_tokens = self._prefill_cursor[job.job_id]
            else:
                job.prefilled_tokens = (len(job.prompt_tokens)
                                        + job.tokens_generated + len(seq))
        return out_tokens, finished

    def _decode_jobs(self, jobs: Sequence[Job], window: int,
                     results: Dict[int, Tuple[List[int], bool]]) -> None:
        """One masked/compacted decode dispatch for ``jobs`` (all holding
        prefilled slots); writes (tokens, finished) into ``results``.
        With ``masked_decode=False`` the dispatch is the full ``max_slots``
        batch with every slot alive, so every slot advances, empty and
        unscheduled ones included, and keeps the ``len`` it reached, as in
        the reference's baseline."""
        slots = [self.slot_of[job.job_id] for job in jobs]
        prev_lens = _ranks(self.cache)[0]["len"].tolist()
        ms = self.cfg.max_slots
        order = sorted(slots)
        db = min(batch_bucket(len(order)), ms)
        compact = self.cfg.masked_decode and db < ms
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
            sub_cache = self.cache
            sub_last = self.last_token
            if self.cfg.masked_decode:
                # full-width dispatch, but unscheduled slots stay frozen
                alive0 = np.zeros((ms,), bool)
                alive0[slots] = True
            else:
                # pre-fast-path baseline: every slot advances every window
                alive0 = np.ones((ms,), bool)
            row_of = {s: s for s in slots}
        self.num_decode_dispatches += 1
        new_cache, toks = self._decode_window(
            sub_cache, torch.as_tensor(sub_last, device=self.device),
            torch.as_tensor(alive0, device=self.device), window)
        toks = toks.cpu().numpy()  # (rows, K)
        if compact:
            for big, small in zip(_ranks(self.cache), _ranks(new_cache)):
                _scatter_slots(big, small, order, len(order))
        # the lengths the window left (unscheduled slots advanced only in the
        # baseline), then each scheduled job's consumed writes
        lens = (list(prev_lens) if self.cfg.masked_decode
                else _ranks(self.cache)[0]["len"].tolist())
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


def _map_leaves(cache, fn):
    """A cache (or sub-cache) with ``fn`` applied to every tensor leaf."""
    if isinstance(cache, T.KVCache):
        return T.KVCache(*(None if t is None else fn(t)
                           for t in (cache.k, cache.v)), cache.ring,
                         *(None if t is None else fn(t)
                           for t in (cache.k_scale, cache.v_scale)))
    if isinstance(cache, dict):
        return {k: _map_leaves(v, fn) for k, v in cache.items()}
    return fn(cache)


# --------------------------------------------------------------------------- #
# Backend adapter for the ELIS frontend
# --------------------------------------------------------------------------- #


class EngineExecutor(Backend):
    """Wraps per-node InferenceEngines behind the frontend Backend ABC.
    Durations are measured wall-clock, with the device synchronised before
    the window's clock is read.  Every executed window is appended to
    ``window_log`` (node, batch, window, duration, tokens);
    ``calibrated_profile()`` fits those samples back onto the simulator's
    latency model (live-to-simulator calibration)."""

    def __init__(self, engines: Dict[int, InferenceEngine], *,
                 swap_bandwidth_bytes_s: float = 16e9,
                 swap_latency_s: float = 0.0005,
                 swap_pool_tokens: Optional[int] = None):
        self.engines = engines
        if swap_pool_tokens is not None:
            # PreemptionConfig.swap_pool_tokens: per-engine host-stash
            # watermark (None leaves any engine-level setting untouched)
            for eng in engines.values():
                eng.swap_pool_tokens = swap_pool_tokens
        self.window_log: List[Dict] = []
        #: host<->device copy model for the swap-vs-recompute break-even
        #: (``preempt_costs``) — the live copies themselves are measured
        #: wall-clock, these parameterise only the *decision*
        self.swap_bandwidth_bytes_s = swap_bandwidth_bytes_s
        self.swap_latency_s = swap_latency_s
        #: wall-clock seconds spent offloading per node since its last
        #: window — folded into the next window's reported duration so swap
        #: cost is attributed, not lost between windows
        self._pending_swap_s: Dict[int, float] = {}
        self.swapout_tokens = 0
        self.swapin_tokens = 0
        self.n_swapouts = 0
        self.n_swapins = 0
        #: per-node cached calibration fit for ``preempt_costs`` (refit
        #: after every 32 new windows; None until enough data)
        self._fit_cache: Dict[int, Tuple[int, object]] = {}

    def capacity(self, node: int) -> int:
        return self.engines[node].cfg.max_slots

    def free_capacity(self, node: int) -> int:
        return self.engines[node].free_slots()

    def execute(self, node: int, jobs: Sequence[Job], window: int,
                now: float, prefill_chunk: Optional[int] = None
                ) -> ExecResult:
        eng = self.engines[node]
        t0 = time.perf_counter()
        needed = sum(1 for job in jobs if not eng.has_job(job.job_id))
        if needed > eng.free_slots():
            raise RuntimeError(
                f"node {node}: batch needs {needed} free slots, "
                f"engine has {eng.free_slots()}")
        for j in jobs:
            if eng.has_stash(j.job_id):
                self.n_swapins += 1
                self.swapin_tokens += j.prefilled_tokens
        tokens, finished = eng.run_window(jobs, window,
                                          prefill_chunk=prefill_chunk)
        eng.synchronize()
        dur = time.perf_counter() - t0
        dur += self._pending_swap_s.pop(node, 0.0)
        self.window_log.append({
            "node": node, "batch": len(jobs), "window": window,
            "duration_s": dur, "tokens": sum(len(t) for t in tokens),
        })
        return ExecResult(dur, tokens, finished)

    def evict(self, node: int, job: Job) -> None:
        eng = self.engines[node]
        eng.drop_stash(job.job_id)
        eng.evict_job(job.job_id)
        job.prefilled_tokens = 0

    # ------------------------------------------------------------------ #
    # KV offload tier (Backend.offload / Backend.restore)
    # ------------------------------------------------------------------ #

    def offload(self, node: int, job: Job) -> bool:
        """Swap the job's slot cache to host memory (preemption that keeps
        the KV).  Its wall-clock cost, devices synchronised, is added to
        the node's next window duration."""
        eng = self.engines[node]
        t0 = time.perf_counter()
        ok = eng.offload_job(job.job_id)
        if ok:
            eng.synchronize()
            self._pending_swap_s[node] = (
                self._pending_swap_s.get(node, 0.0)
                + (time.perf_counter() - t0))
            self.swapout_tokens += job.prefilled_tokens
            self.n_swapouts += 1
        return ok

    def restore(self, node: int, job: Job) -> bool:
        """Explicit swap-in (execute() also restores lazily)."""
        eng = self.engines[node]
        if not eng.has_stash(job.job_id):
            return False
        eng.restore_job(job)
        return True

    def preempt_costs(self, node: int, job: Job
                      ) -> Optional[Tuple[float, float]]:
        """(swap_round_trip_s, recompute_s) estimates for preempting
        ``job`` — the ``auto`` preempt policy's break-even input.  Swap
        cost: two host<->device copies of the job's KV footprint at the
        configured bandwidth.  Recompute cost: the job's context through
        the *calibrated* prefill rate (None until enough measured windows
        exist — the caller then falls back to recompute)."""
        n = job.prefilled_tokens
        if n <= 0:
            return None
        mc = self.engines[node].model_cfg
        kv_bytes = (2 * mc.n_layers * (mc.n_kv_heads or mc.n_heads)
                    * mc.head_dim * T.DTYPES[mc.dtype].itemsize)
        swap_s = 2.0 * (self.swap_latency_s
                        + n * kv_bytes / self.swap_bandwidth_bytes_s)
        prof = self._cached_fit(node)
        if prof is None:
            return None
        rec_s = prof.prefill_ms(1, n) / 1000.0
        return swap_s, rec_s

    def _cached_fit(self, node: int):
        n_log = len(self.window_log)
        cached = self._fit_cache.get(node)
        if cached is not None and n_log - cached[0] < 32:
            return cached[1]
        try:
            prof = self.calibrated_profile(nodes=[node])
        except ValueError:
            prof = None
        self._fit_cache[node] = (n_log, prof)
        return prof

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
                "chunk_traces": eng.num_chunk_traces,
                "chunk_dispatches": eng.num_chunk_dispatches,
                "resume_context_tokens": eng.resume_context_tokens,
                "windows_executed": windows.get(n, 0)}
            for n, eng in self.engines.items()
        }

    def counters(self) -> Dict[str, int]:
        """Dispatch, chunk and swap counters aggregated across this
        executor's engines (:meth:`node_counters` keeps the per-node
        breakdown)."""
        agg = {"prefill_traces": 0, "prefill_dispatches": 0,
               "decode_traces": 0, "decode_dispatches": 0,
               "chunk_traces": 0, "chunk_dispatches": 0,
               "resume_context_tokens": 0,
               "windows_executed": len(self.window_log),
               "swapouts": self.n_swapouts, "swapins": self.n_swapins,
               "swapout_tokens": self.swapout_tokens,
               "swapin_tokens": self.swapin_tokens,
               "stash_evictions": sum(e.n_stash_evictions
                                      for e in self.engines.values()),
               "stash_evicted_tokens": sum(e.stash_evicted_tokens
                                           for e in self.engines.values())}
        for per in self.node_counters().values():
            for k in ("prefill_traces", "prefill_dispatches",
                      "decode_traces", "decode_dispatches",
                      "chunk_traces", "chunk_dispatches",
                      "resume_context_tokens"):
                agg[k] += per[k]
        return agg

    # ------------------------------------------------------------------ #
    # Live-to-simulator calibration
    # ------------------------------------------------------------------ #

    def calibrated_profile(self, name: str = "live-calibrated",
                           params_b: Optional[float] = None,
                           preempt_batch: int = 64,
                           mem_limit_frac: float = 0.4,
                           nodes: Optional[Sequence[int]] = None
                           ) -> ModelProfile:
        """Fit the simulator's latency model to the measured windows.

        The model (:mod:`repro_torch.simulate.profiles`):
            duration ≈ overhead + window · d1 · (1 + slowdown · (batch-1))
        is linear in (overhead, d1, d1·slowdown); a least-squares fit over
        ``window_log`` (dropping each (node, batch, window) shape's first
        occurrence, which pays the first launch's one-off costs, such as
        loading the kernels' modules) recovers ``decode_ms_1`` and
        ``batch_slowdown``.  ``nodes`` restricts the fit to a node subset;
        :meth:`calibrated_node_profiles` fits each node on its own."""
        keep = set(self.engines if nodes is None else nodes)
        unknown = keep - set(self.engines)
        if unknown:
            raise ValueError(
                f"calibrated_profile: unknown node(s) {sorted(unknown)}; "
                f"this executor drives nodes {sorted(self.engines)}")
        log = [rec for rec in self.window_log if rec["node"] in keep]
        seen = set()
        samples = []
        for rec in log:
            key = (rec["node"], rec["batch"], rec["window"])
            if key in seen:
                samples.append(rec)
            else:
                seen.add(key)  # first occurrence pays one-off costs
        if not samples:
            samples = list(log)
        if not samples:
            raise ValueError(
                "calibrated_profile: window_log holds no executed windows "
                f"for node(s) {sorted(keep)} — run at least one window via "
                "execute() before calibrating")
        w = np.array([r["window"] for r in samples], float)
        b = np.array([r["batch"] for r in samples], float)
        d = np.array([r["duration_s"] for r in samples], float)
        X = np.stack([np.ones_like(w), w, w * (b - 1)], axis=1)
        if np.linalg.matrix_rank(X) >= 3:
            (o, a, c), *_ = np.linalg.lstsq(X, d, rcond=None)
            a = float(max(a, 1e-9))
            slowdown = float(min(max(c / a, 0.0), 10.0))
            overhead = float(max(o, 0.0))
        else:
            # degenerate design (single batch size or window length):
            # attribute everything to the per-token rate
            a = float(max(np.mean(d / np.maximum(w, 1.0)), 1e-9))
            slowdown = 0.0
            overhead = 0.0
        #: per-window fixed cost (dispatch + host loop) the latency model's
        #: intercept absorbed
        self.fit_overhead_s = overhead
        mc = self.engines[min(keep)].model_cfg
        if params_b is None:
            # rough dense-transformer parameter count from the config
            params_b = 12 * mc.n_layers * mc.d_model ** 2 / 1e9
        return ModelProfile(
            name=name, params_b=params_b,
            avg_latency_ms=a * 1000.0 * CALIBRATION_MEAN_TOKENS,
            n_layers=mc.n_layers,
            n_kv_heads=mc.n_kv_heads or mc.n_heads,
            head_dim=mc.head_dim,
            preempt_batch=preempt_batch, mem_limit_frac=mem_limit_frac,
            batch_slowdown=slowdown,
        )

    def calibrated_node_profiles(self, prefix: str = "live-node", **kw
                                 ) -> Dict[int, ModelProfile]:
        """Per-node live fits: {node: ModelProfile}.  Also records each
        node's fitted per-window overhead in ``node_fit_overhead_s``."""
        profs, over = {}, {}
        for n in sorted(self.engines):
            profs[n] = self.calibrated_profile(name=f"{prefix}{n}",
                                               nodes=[n], **kw)
            over[n] = self.fit_overhead_s
        self.node_fit_overhead_s = over
        return profs

    def node_token_cost(self) -> Dict[int, float]:
        """Fitted seconds-per-token per node — the ``least_eta`` placement
        input, measured from this executor's own window log instead of
        assumed uniform."""
        return {n: p.decode_ms_1 / 1000.0
                for n, p in self.calibrated_node_profiles().items()}
