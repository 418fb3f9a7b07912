#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: name, count, power limit, torch and CUDA versions;
  2. build: every kernel of ``src/repro_torch/csrc`` with nvcc, in parallel;
  3. kernels against their plain PyTorch versions at the served shapes,
     bf16 and fp32, with times (kernel, plain version, and PyTorch's
     ``scaled_dot_product_attention`` as the attention kernels' yardstick)
     and the bound; the sharded decode (``flash_decode_sharded``) at the
     shard shapes of a TP=2 and a TP=4 pod, also bit for bit against the
     single-device kernel; the int8 decode (``flash_decode_int8``) at the
     served shape, at other head dims, group sizes and windows, and at one
     layer of the decode_32k cache (B=128, L=32768); the three decode
     wrappers also over a long, ragged cache (B=8, L=32768, kv_len 0 to
     L + 1), each row with the number of key splits its launch used;
     bf16 ``flash_attention`` also over one prompt of 32768 tokens and one
     layer of the prefill_32k shape (B=32 x 32768), checked on three
     slices of 256 query rows; each ``flash_attention`` row names the body
     of the kernel that ran, as the library's launcher recorded it (bf16:
     tensor-core, fp32: CUDA-core); ``ssd_scan`` at one and two chunks and
     a padded prompt, and in bf16 also one prompt of 8192 and one of 32768
     tokens (32 and 128 chunks), each row with the body that ran and the
     kernels the call launched (bf16: 2 or 3 tensor-core passes, fp32: 1),
     and one bf16 call of 32768 tokens profiled, its device time by pass;
     and rows at zamba2-7b's shapes (tagged ``zamba2-7b``): ``flash_attention``
     at B=1, S=15, 180, 399 (phase 9's prompts) and 512, 32/32 heads of dim
     112, window 4096, bf16 and fp32; ``flash_decode`` and
     ``flash_decode_int8`` at B=4 x 512 and over the long ragged cache (B=8
     x 32768), 32/32 heads of dim 112, window 4096; ``ssd_scan`` at H=112,
     (P, N) = (64, 64), bf16 and fp32: phase 9's one-chunk prompts of 15
     and 180 tokens (chunk = S), its 399 tokens padded to two chunks of
     256, and S=512 and 32768; rows tagged ``qwen2-vl-7b`` (28/4 heads of
     dim 128: a GQA group of 7 on the decode's group-of-8 instance):
     ``flash_attention`` at B=4 x 480 (phase 8's step path), 4 x 512 and
     B=1 at the longest of phase 8's prompts, ``flash_decode`` at 4 x 512
     and over the long ragged cache, ``flash_decode_int8`` at 4 x 512;
     and tagged ``whisper-large-v3`` (20/20 heads of dim 64):
     ``flash_attention`` at phase 10's 4 x 128 and prefill_32k's 32 x
     448, ``flash_decode`` at B=4 and B=128 over 448 rows; and tagged
     ``qwen2-moe-a2.7b`` and ``mixtral-8x7b``: ``flash_decode_sharded``
     at each rank's share of a TP=2 pod (16/16 and 32/8 heads of dim 128,
     mixtral with its window of 4096) at B=4 x 512, bit for bit the
     single-device kernel; and tagged ``qwen2-vl-7b TP=2`` and
     ``whisper-large-v3 TP=2`` (phase 13's ranks): ``flash_attention`` at
     a rank's 14/2 heads of dim 128 (B=4 x 480) and 10/10 of dim 64 (B=4
     x 128), with ``sdpa`` also over the unsplit heads, and
     ``flash_decode_sharded`` at B=4 x 512 and B=4 x 448 rows, bit for
     bit the single-device kernel; and tagged ``train`` (phase 14's
     evaluation forward): ``flash_attention`` at B=8 x 512 (qwen2-1.5b's
     heads) and ``ssd_scan`` at B=8 x 512 (mamba2-130m's);
  4. the served paths at full width: ``ElisServer`` -> ISRTF with the
     oracle predictor -> ``EngineExecutor`` ->
     ``InferenceEngine(attn_impl="kernel")`` serving a dozen requests to
     qwen2-1.5b (28 layers), then to mamba2-130m (24 layers), then to
     qwen2-1.5b on one tensor-parallel pod of 2 ranks (``dense-tp2``: on
     two cards when there are two, else both ranks on ``cuda:0``), bf16,
     random weights from a seed; each path's kernel launch counts are set
     to 0 just before it and read just after; one decode window of each is
     then profiled (device busy share, kernels); then the step entry points
     (``launch.steps``) of qwen2-1.5b over ``launch.shapes.input_specs``
     int8 caches: prefill and 32 serve steps over a 4 x 512 cache (launch
     counts reset before and read after), one step over the long_500k ring
     (no kernel), and last, after every earlier tensor is freed, 6 steps at
     decode_32k (B=128 over 32768 rows: a 61 GB int8 cache);
  5. kernel path against plain path, per model: identical greedy tokens at
     full width with 2 layers in fp32 through evictions and recompute
     resumes, and agreeing first prefill logits at full width and depth in
     bf16; for ``dense-tp2``, the TP kernel engine against the
     single-device kernel engine and the plain engine, and a TP=4 kernel
     engine (each rank holding the one KV head it reads) against the
     single-device kernel engine (fp32 tokens), and the TP=2 kernel model
     against the single-device kernel model (bf16 logits); for the int8
     step path, identical fp32 greedy tokens and agreeing bf16 decode
     logits;
  6. the serve CLI (``python -m repro_torch.launch.serve``, run in this
     process through ``main``) at full width, qwen2-1.5b in bf16 at 7 of
     its 28 layers (``CLI_DEPTH``, cut for the script's time): serve.py's
     defaults with ``--n 12``; then traffic that queues
     and preempts (``CLI_QUEUE``: 4 slots, 24 requests at 4 req/s, outputs
     up to 128 tokens) under ISRTF and FCFS on the same arrivals, in the
     order isrtf, fcfs, fcfs, isrtf (mean JCT of each, the ISRTF/FCFS
     ratio, preemptions, tokens/s); then the ISRTF run with
     ``--prefill-chunk 8 --preempt-policy swap``, and with
     ``--preempt-policy auto --probe-nodes 2``.  Every request must finish
     with ``min(true_output_len, max_output)`` tokens, ISRTF must preempt,
     the swap run must swap out, swap in and run prefill chunks, and each
     run's ``flash_attention`` and ``flash_decode`` launch counts (set to 0
     before it, read after) must be the engine's one-shot prefills and
     decode steps times its layers.  Beside it, one slot's cache is
     offloaded to the host and restored bit for bit at full width, its
     greedy stream equal to a resident engine's, and chunked prefill gives
     the fp32 greedy tokens of one-shot prefill at full width and 2
     layers;
  7. the BGE length predictor (``repro_torch.core.predictor``, fp32, no
     kernel of its own): a two-head predictor of full width (``BGE_BASE``,
     bge-base-en-v1.5, under two 8 x 1024 heads) against a CPU copy of
     its parameters on a pool of 5 (and each job alone: padding is inert;
     ids past the vocabulary), dispatch times for pools of 1, 8, 32 and
     128 at sequence bucket 512 against their flop bounds and for the
     CLI's small predictor at 32, 20 ``fit`` steps at 32 x 512 and one
     step against the CPU copy, then the CLI's predictor trained by
     ``examples/train_predictor.py``'s recipe (Table 2's metrics before and
     after) and checkpointed; then ISRTF served over ``CLI_QUEUE`` ranked
     by each, qwen2-1.5b at phase 6's ``CLI_DEPTH`` layers: (a) the CLI
     with ``--predictor bge --predictor-ckpt
     --calibrate ema+conformal``, (b) an ``ElisServer`` ordered by the
     full-width predictor's ranking head (``RankedPredictor`` under
     ``ema+conformal``, online head updates).  Each run must finish every
     request with its expected token count, with predictor dispatches, at
     most ``n_shape_buckets`` distinct dispatch shapes, kernel launches as
     the engine's dispatches say, and (b) at least one online update; it
     prints the predictor's device time per dispatch and its share of the
     serving wall time;
  8. the other archs (``OTHER_ARCHS``), bf16 at full width through phase
     4's served path with launch counts reset before each and read after:
     qwen2-moe-a2.7b at its 24 layers (prefill through the dense MoE
     block, decode through the grouped one), with one decode window under
     ``torch.cuda.set_sync_debug_mode("error")``, one profiled with the
     MoE block's device time per step against its bound, and its step
     entry points over a 4 x 512 int8 cache; llama3.2-3b (28 layers);
     yi-6b (32); mixtral-8x7b cut to 8 of its 32 layers (93.4 GB at full
     depth need a mesh; it reads its linear cache with ``window`` 4096);
     qwen2-vl-7b (28 layers, text only, as the reference's engine serves
     it), then its step entry points with the vision stub (256 patch
     embeddings on a 16 x 16 grid at temporal 0 and 224 text ids, 32
     serve steps over a 4 x 512 bf16 cache, launch counts reset before
     and read after; bf16 logits at 28 layers and fp32 greedy tokens and
     logits at 2 layers, kernel path against plain path); and
     qwen1.5-32b last, cut to 32 of its 64 layers to keep the script
     inside its time limit (further only if the free memory forces it,
     which it prints).  For each: the bytes allocated beside
     ``param_count``, fp32 greedy tokens of the kernel and plain engines at
     full width and 2 layers through evictions, and bf16 first prefill
     logits at the served depth within ``LOGIT_TOL_BF16``;
  9. the hybrid family: zamba2-7b, bf16 at full width and all 81 layers
     (13.5 GB), through phase 4's served path with launch counts reset
     before and read after (``ssd_scan`` 81 a prefill, ``flash_attention``
     13 a prefill, ``flash_decode`` 13 a decode step; every request with
     its expected token count), the bytes allocated beside
     ``param_count``, one decode window profiled, bf16 first prefill
     logits against the plain kernels on the kernels' inputs within
     ``HYBRID_LOGIT_TOL_BF16``, and its step entry points once over a 4 x
     512 cache; beforehand fp32 greedy tokens of the kernel and plain
     engines at full width and 13 layers (two groups and one tail layer)
     through evictions and a swap round trip, one slot's swap round trip
     bit for bit, and fp32 first prefill logits against the plain kernels
     within ``HYBRID_LOGIT_TOL_FP32``, at each prompt's last position
     and, for the prompts longer than one SSD chunk (one at least), at the
     first position of the second chunk;
 10. the audio family: whisper-large-v3, bf16 at full width, 32 encoder
     and 32 decoder layers (3.07 GB), through the step entry points (the
     engine serves no audio prefill): 4 prompts of 128 ids over their
     stub frames (4, 1500, 1280) and 32 serve steps with launch counts
     reset before and read after (``flash_attention`` 32 a prefill: the
     encoder and the cross-attention run plain, as in the reference;
     ``flash_decode`` 32 a step), one step profiled, bf16 logits against
     the plain path within ``AU_LOGIT_TOL_BF16``; beforehand fp32 greedy
     tokens of the kernel and plain paths at 2 + 2 layers; then one
     prefill_32k step (B=32 x 448 over 32 x 1500 frames) with its peak
     memory, and 6 decode_32k steps (B=128 over a cache filled with
     random self and cross K/V, every slot's ``len`` below 448);
 11. the MoE family on tensor-parallel pods of 2 ranks (on one card when
     there is one), and chunked prefill and KV swap under a mesh: for
     qwen2-moe-a2.7b served at 12 of its 24 layers and mixtral-8x7b at
     4 of 32, bf16 at full width, fp32 greedy tokens of the TP kernel engine against
     the single-device kernel engine at 2 layers through evictions and
     compacted windows and through a chunked prefill (chunk 64 of a
     230-token prompt) with one swap round trip mid-prefill and one
     mid-decode, every rank's slot rows bit for bit; the bytes allocated
     beside ``param_count``; phase 4's served path on the pod (launch
     counts reset before and read after: ``flash_decode_sharded`` layers
     x 2 a decode step, ``flash_attention`` layers x 2 a prefill); one
     decode window profiled; the pod's bf16 first prefill logits against
     the single-device kernel model within ``LOGIT_TOL_BF16``; then the
     serve CLI with ``--mesh 1x2 --arch qwen2-moe-a2.7b --prefill-chunk
     64 --preempt-policy auto`` on ``CLI_QUEUE`` at ``POD_CLI_DEPTH`` (3)
     layers (every request finished, its swaps and chunk dispatches
     printed) and
     one offload and restore through its executor;
 12. the SSM and hybrid families on tensor-parallel pods of 2 ranks (on
     one card when there is one): mamba2-130m served at 12 of its 24
     layers and zamba2-7b at 27 of its 81 (4 groups and the tail), bf16
     at full width.  For each, fp32 greedy
     tokens of the pods (mamba2-130m at TP=2 and TP=4, all 24 layers;
     zamba2-7b at TP=2 and phase 9's 13 layers) against the
     single-device kernel and plain engines through evictions, recompute
     resumes and a swap, and one swap round trip on the TP=2 pod, every
     rank's slot rows bit for bit; the bytes allocated beside
     ``param_count`` and the bytes the shards copy; phase 4's served path
     on the pod (launch counts reset before and read after: ``ssd_scan``
     layers x 2 a prefill, each launch on a rank's heads; zamba2-7b's
     ``flash_attention`` sites x 2 a prefill and
     ``flash_decode_sharded`` sites x 2 a decode step); one decode window
     profiled; the pod's bf16 first
     prefill logits against the single-device kernel model (and fp32 ones
     at the parity depth) within ``POD_LOGIT_TOL``; then the serve CLI with
     ``--mesh 1x2 --arch mamba2-130m --preempt-policy auto`` on
     ``CLI_QUEUE`` at ``POD_CLI_DEPTH`` (3) layers, and one offload and restore
     through its executor
     when the traffic swapped nothing.  Phase 3's rows tagged
     ``mamba2-130m TP=2`` and ``zamba2-7b TP=2`` hold the kernels at a
     rank's share of these pods (``ssd_scan`` at H=12, (64, 128) and
     H=56, (64, 64); ``flash_attention`` and ``flash_decode_sharded`` at
     16/16 heads of dim 112 a rank);
 13. the vlm and audio families on tensor-parallel pods of 2 ranks (on
     one card when there is one, else on two; the log says which), bf16
     at full width and depth: qwen2-vl-7b (28 layers) served and
     whisper-large-v3 (32 + 32 layers) stepped.  First, in fp32 at 2
     layers (2 + 2 for whisper): the vlm pod's greedy tokens against the
     single-device kernel and plain engines through evictions and a
     swap, one swap round trip every rank's rows bit for bit, its first
     prefill logits; and both pods' step path (``make_prefill_step`` /
     ``make_serve_step`` with ``mesh=``: 256 stub patches with (3, B, S)
     positions, or frames) against one device, tokens identical and
     logits within ``POD_LOGIT_TOL``.  Then at full depth: the bytes
     allocated beside ``param_count`` and the bytes the shards copy;
     phase 4's served path on the vlm pod (launch counts reset before
     and read after: ``flash_decode_sharded`` 28 x 2 a step,
     ``flash_attention`` 28 x 2 a prefill), one decode window profiled,
     its first prefill logits against one device; the step path of both
     pods (prefill and 32 serve steps, launches ``flash_attention``
     layers x 2 a prefill and ``flash_decode_sharded`` layers x 2 a step,
     one step profiled) and its bf16 logits against one device within
     ``POD_LOGIT_TOL``;
 14. the LM training step (``launch.steps.make_train_step``: autograd of
     ``models.loss_fn`` with remat and the plain attention, then AdamW),
     bf16 at full width on ``launch.train.batches`` (B=8 x S=512):
     qwen2-1.5b (28 layers), mamba2-130m (24) and qwen2-moe-a2.7b at 2
     of its 24 layers (its AdamW moments alone need ~115 GB at 24).  For
     each, 3 steps after a warm-up step (losses and gradient norms
     finite), the step's median wall time, tokens/s, its bound (8 N T
     plus the causal attention at 989 TFLOP/s) and share, the peak
     memory; beforehand the card's step in fp32 at 2 layers against the
     port's CPU step on the same params and batch (loss and every
     gradient leaf within ``TRAIN_LOSS_RTOL`` / ``TRAIN_GRAD_RTOL``; the
     planted fault ``detached_paths``, an attention or scan output
     detached as a kernel without a backward leaves it, must fail that
     check); the evaluation forward (``attn_impl="kernel"`` under
     ``torch.no_grad()``, launch counts reset before and read after:
     ``flash_attention`` once an attention layer, ``ssd_scan`` once an
     SSM layer) against the plain forward, fp32 at 2 layers and bf16 at
     the cell's depth; ``loss_fn(attn_impl="kernel")`` under grad must
     raise; then the CLI ``repro_torch.launch.train.main`` (3 steps of
     the reduced qwen2-1.5b with a checkpoint, and a ``--resume``);
 15. the live-to-simulation loop (``repro_torch.simulate``): (a) on phase
     4's qwen2-1.5b executor (full width and depth, bf16, the kernels),
     after its dozen requests under ISRTF, probe windows of 4 and 16
     tokens at batches of 1 and 2, three of each, then the simulator's
     latency model fitted to every window (``calibrated_profile``,
     ``fit_overhead_s``: decode_ms_1, batch_slowdown, the window
     overhead, ``kv_capacity_tokens``), launch counts from phase 4's
     reset to after the probes; (b) the same requests replayed through
     ``ElisServer`` over ``SimExecutor(profile, sched_overhead_s=...)``,
     live against simulated mean JCT (every request finished in both,
     ``assert_drained``; the ratio printed, not gated); (c) after phase
     7, the paper's Table 5 cell (``run_experiment``: llama-13b's A100
     profile, 200 requests, batch 4, 1x AVG.RequestRate, K = 50) under
     FCFS and ISRTF ranked by phase 7's full-width predictor on the card,
     its dispatches timed, then ISRTF again: the per-job completion times
     must agree bit for bit; (d) meanwhile, in worker processes, the
     scale fast path over (a)'s profile (``ScaleSimConfig``, noisy
     oracle, FCFS and ISRTF over ``SIM_SCALE_N`` flash_crowd requests at
     1x the profile's AVG.RequestRate at batch 4), and its head slice of
     ``SIM_EXACT_HEAD`` requests against the exact event loop: one node
     under ISRTF must be trace-identical; three under FCFS (a reference
     caveat) is printed.
 16. int8 pods, the dry run held against the card, and pod training
     (``launch.dryrun``, qwen2-1.5b): (a) served as a TP=2 pod (on one
     card) over int8 caches at full width and depth, bf16, through
     ``make_prefill_step`` and ``make_serve_step`` with ``mesh=``: ``STEPS``
     steps with launch counts reset before and read after
     (``flash_attention`` 28 x 2 a prefill, ``flash_decode_int8_sharded``
     28 x 2 a step), its first step's logits against one device's within
     ``INT8_POD_LOGIT_TOL_BF16``; fp32 at ``INT8_POD_DEPTH`` layers its
     greedy tokens and logits against one device's, and the planted
     per-rank scales (each rank quantizing with its own heads' amax) must
     fail that check; phase 3's ``flash_decode_int8_sharded`` row (tagged
     ``qwen2-1.5b TP=2``: 6/1 heads a rank) holds the kernel.  (b) the
     dry run on the meta device against the same rank program on the
     card (``dryrun.rank_program``) for the serve step over a 16 x 512
     int8 cache and the train step at B=8 x 512, each at a (1, 1) and a
     (1, 2) mesh, and the serve step also at (1, 16), the production
     mesh's model axis, where 4 of qwen2-1.5b's 16 ranks hold no heads
     (``DRY_WIDE_TP``): ``flops`` against ``FlopCounterMode`` over the card's
     step and the argument bytes against the card's inputs (both exact),
     the peak at most ``DRY_PEAK_MARGIN`` under ``max_memory_allocated``
     and never over it (a dry run without the cache, or without the
     largest leaf's moments, must fail that), the
     record's roofline beside the step's time, and the dry-run roofline of
     decode_32k and of the train step beside their hand bounds
     (``HAND_BOUND_MS``); (c) the training step as a TP=2 pod, fp32 at
     ``INT8_POD_DEPTH`` layers, its gathered gradients against one
     device's within phase 14's gates, and one ZeRO-1 step on a (2, 1)
     mesh at a constant lr against the unsliced step, its moments within
     ``ZERO1_MOMENT_RTOL`` and its params within ``ZERO1_PARAM_RTOL`` of
     the update's norm; the planted fault, the first pod's gradients in
     place of the pods' sum, must fail both.
 17. uneven pods (:func:`uneven_phase`): (a) llama3.2-3b as a TP=3 pod at
     full width and 28 layers (8 query heads a rank over GQA groups of 3,
     so ranks 0-2 read KV heads [0, 3), [2, 6), [5, 8) and launch each
     attention kernel as 2, 3 and 2 uniform segments; d_ff 8192 as
     2731 / 2731 / 2730 and vocab 128256 as 3 x 42752): fp32 at 2 layers
     its greedy tokens against the single-device kernel and plain engines
     through evictions and a swap, its prefill logits against one
     device's within ``POD_LOGIT_TOL`` (1e-3), which the planted
     ``segment_kv_offset`` (a cut rank's segments read their KV heads
     from the rank's first) must fail; phase 4's served path on the pod
     with launch counts (``rank_launches``: 7 a layer), its bf16 prefill
     logits against one device's (``TP_LOGIT_TOL_BF16``), and
     ``UNEVEN_INT8_STEPS`` steps over int8 caches; (b) whisper-large-v3
     as a TP=4 pod (vocab 51866 as 12967 / 12967 / 12966 / 12966) through
     the step functions, fp32 and bf16 logits against one device's
     within ``POD_LOGIT_TOL``, its step path with launch counts.  Phase
     3's rows tagged ``llama3.2-3b TP=3`` (the decode, the int8 decode
     and every rank's prefill over the cut shards, the decodes bit for
     bit the single-device kernel) and ``whisper-large-v3 TP=4`` hold the
     kernels at those shards.
 18. caches a pod splits other than by head (:func:`seq_phase`,
     :func:`seq_kernel_rows`): the partials and combine kernels against
     their plain versions and timed; qwen2-1.5b's sequence-sharded pod
     at (1, 2) in fp32 at 2 layers against one device (dense and int8),
     which the planted ``row0`` must fail; at full width and 28 layers
     over 4 x 32768 rows one device, the sequence-sharded, head-layout
     and planted pods fed one device's tokens, the first two within
     ``SEQ_BF16_TOL`` slot by slot and the planted one outside it, each
     beside a plain fp32 run of the same weights, with launch counts
     (bf16 and int8); the context-parallel decode at (2, 1) over a linear
     cache and long_500k's ring in fp32 against one device; the dry run
     of the sequence-sharded serve step against the card.
 19. the expert-parallel MoE scheme, whisper's split cross K/V and the
     examples (:func:`expert_phase`): (a) qwen2-moe-a2.7b as a TP=4 pod
     under ``moe_scheme="expert"`` (15 whole experts a rank): fp32 at 2
     layers against one device within ``POD_LOGIT_TOL`` (1e-3), which a
     planted expert range (rank 1's shifted by one) must fail; at full
     width and 24 layers in bf16 one device, then the expert pod and the
     tensor-scheme pod from the same weights through ``make_prefill_step``
     and 8 ``make_serve_step`` steps over 4 x 512, fed one device's
     tokens, the expert pod with launch counts; (b) the dry run of
     ``serve 16 x 512 int8`` at (1, 4) under the expert scheme against
     the card (``dry_vs_card``); (c) whisper-large-v3 at (1, 2) under
     ``kv_shard="seq"``, its cross K/V split by frames: fp32 at 2 + 2
     layers within ``AU_SEQ_TOL_FP32`` of one device, which a planted
     frame offset must fail, and at full width with launch counts; (d)
     ``repro_torch.examples.quickstart`` and ``serve_isrtf --jobs 8`` on
     the card, every request to its token budget.  Phase 3's rows tagged
     ``qwen2-moe-a2.7b expert TP=4`` hold the decode and prefill kernels
     at a rank's 4/4 heads.
 20. the prefill_32k step on one card and the engine's two baselines:
     (a) :func:`prefill_32k_phase`, after every earlier tensor is freed:
     ``make_prefill_step`` of qwen2-1.5b (28 layers, bf16, full width)
     at the reference's prefill_32k shape (B=32 x 32768 ids from a seeded
     generator) over an ``input_specs`` int8 cache, its dense MLP in row
     chunks (``transformer.PREFILL_MLP_ROWS``: 4 a layer); one step under
     ``FlopCounterMode`` and one timed, launch counts reset before and read
     after (``flash_attention`` 28 a step: the chunks add none); the dry
     run's record at (1, 1) against the card: flops and argument bytes
     exact, the peak at most ``DRY_PEAK_MARGIN`` (1%) under
     ``max_memory_allocated`` and never over it, and at most
     ``PREFILL_PEAK_SHARE`` (80%) of the card's memory; prompts 0 and 31
     alone at B=1 (one chunk): last-position logits within
     ``LOGIT_TOL_BF16`` of the batch's, their int8 cache rows at most one
     code apart (the share apart printed) and scales within 2^-7
     relative; fp32 at 2 layers over B=2 x 32768, chunked by
     ``PREFILL_PARITY_ROWS`` (24576: a chunk straddles the two prompts)
     against one piece, logits within ``POD_LOGIT_TOL``'s fp32 1e-3, codes
     at most one apart and scales within 1e-3, and the planted
     ``chunk_drops_last_row`` (each chunk leaves its last row out) must
     break the logits' gate.  Prints the step's wall time, prompt
     tokens/s, its bound (the dry run's flops at 989 TFLOP/s or bytes at
     3.35 TB/s, the larger), ``flash_attention``'s 28 x phase 3's time
     at this shape as a share of the wall, and the peak against the
     card's memory.  (b) :func:`baseline_phase`: phase 4's served path
     (qwen2-1.5b, 28 layers, bf16, the same 12 requests) on an engine with
     ``EngineConfig(batched_prefill=False, masked_decode=False)``, launch
     counts reset before and read after: every request with its expected
     token count, prefill dispatches equal to the admissions (requests
     and recompute resumes), ``flash_attention`` 28 a prefill dispatch,
     ``flash_decode`` 28 a decode step, every decode dispatch at the
     ``max_slots`` batch; fp32 greedy tokens, finished flags and lens at
     full width and 2 layers equal to the fast engine's over one window
     of four jobs (1 prefill dispatch against 4); tokens/s and mean JCT
     printed beside phase 4's fast run (host clock).
The last lines are a JSON object of per-kernel numbers, the card's name and
power limit as ``nvidia-smi`` reports them, and the result line.
Needs one CUDA card; imports neither JAX nor the JAX package.

    python3 chip_smoke.py --planted-fault drop_first_tile

checks the checks instead: it builds the kernels from a copy of ``csrc``
with one deliberate fault (``PLANTED_FAULTS``) in a temporary directory,
runs phase 3's comparisons and phase 5's comparisons (the int8 ones too,
and whisper's fp32 tokens and bf16 logits) against it, and prints how
many of them caught the fault, the rows at zamba2-7b's, qwen2-vl-7b's
and whisper's shapes tallied apart
(``drop_v_scale``: the int8 decode ignores V's scales;
``combine_no_rescale``: the decode's combine pass sums the splits'
partial states without rescaling them to a common maximum;
``p_in_bf16``: the bf16 prefill multiplies P rounded to bf16 by V, as
library kernels do, and not its hi/lo split; ``ssd_operands_in_bf16``:
the bf16 SSD passes do the same with their three fp32 operands;
``carry_no_decay``: the SSD carry pass does not decay the carried state;
``drop_carried_state``: the SSD scan drops the carried-state term of its
outputs, in both bodies); ``drop_rank_partial`` instead
drops one rank's attention output from the TP model's sums, in memory,
and runs phase 5's TP comparisons; ``rank_local_norm`` (alone) makes
each rank of an SSM or hybrid pod normalise over its own slice of
``d_inner``, in memory, and runs phase 12's fp32 token and bf16 logit
checks against it.  ``mrope_rank0_only`` (ranks > 0 of the vlm pod
rotate by the 2-D text positions, not the (3, B, S) ones) and
``cross_rank_local`` (each rank of the whisper pod adds only its own
heads' cross-attention output), alone or together (``POD_FAULTS``), run
phase 13's step-path checks of the pod each reaches, fp32 and bf16.

    python3 chip_smoke.py --window-bench 24

times 24 decode windows of the dense cell's engine and prints them as one
JSON line; copied into the root of another checkout it times that
checkout's ``src``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
#: where the model runs (a CPU rehearsal of phases 4-5 may set "cpu")
DEVICE = "cuda"
#: the served paths' widths: qwen2-1.5b heads and the engine's slot cache
HEADS, KV_HEADS, HEAD_DIM, MAX_LEN = 12, 2, 128, 512
#: mamba2-130m's SSD widths: SSM heads, head dim, state dim
SSM_HEADS, SSM_HEAD_DIM, SSM_STATE = 24, 64, 128
#: zamba2-7b's widths (phase 3's hybrid rows and phase 9): its shared
#: block's heads (MHA), head dim and window, and its SSD widths
HY_ARCH = "zamba2-7b"
HY_HEADS, HY_HEAD_DIM, HY_WINDOW = 32, 112, 4096
HY_SSD = (112, 64, 64)
#: qwen2-vl-7b's and whisper-large-v3's attention widths (phase 3's rows
#: tagged with their names, phases 8 and 10): heads, KV heads, head dim.
#: qwen2-vl's GQA group of 7 runs the decode kernel's instance of 8.
VL_ARCH, VL_WIDTHS = "qwen2-vl-7b", (28, 4, 128)
AU_ARCH, AU_WIDTHS = "whisper-large-v3", (20, 20, 64)
#: phase 11's tensor-parallel MoE pods (``TP`` ranks): each arch's heads,
#: KV heads and head dim, and its window; phase 3's ``flash_decode_sharded``
#: rows tagged with these names hold each rank's share of them
MOE_TP_SHAPES = [("qwen2-moe-a2.7b", (16, 16, 128), None),
                 ("mixtral-8x7b", (32, 8, 128), 4096)]
#: whisper's decoder rows: its self-attention cache holds at most
#: ``max_position_embeddings`` of them
AU_ROWS = 448
#: qwen2-vl-7b's step path (phase 8): ``VL_PATCHES`` stub patches on a
#: 16 x 16 grid, ``VL_TEXT`` text ids after them, then ``STEPS`` serve
#: steps, which fill the 4 x ``MAX_LEN`` cache to its last row
VL_PATCHES = 256
#: published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
#: flop/s by operand type (bf16 on the tensor cores, fp32 outside them),
#: kept with the port's roofline constants
from repro_torch.launch.mesh import HBM_BYTES_S, PEAK_FLOPS  # noqa: E402
#: kernel vs plain version, (atol, rtol) in |kernel - plain| <= atol + rtol
#: * |plain|.  Both compute in fp32 from the same inputs, so in fp32 they
#: differ only by summation order (online vs full softmax).  In bf16 each
#: rounds its fp32 result to bf16, so they differ by at most one bf16 ulp,
#: which is at most 2^-7 of the value, plus the fp32 difference near 0.
#: The SSD scan's outputs are sums of up to chunk x N products whose size
#: follows the inputs', so its atol is taken relative to the output's
#: largest |plain value| (``max_err(scaled=True)``); its ``a_cum`` is
#: summed in fp64 on both sides (kernels/ref.py), so only the order of the
#: product sums differs.
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-5, 2.0 ** -7)}
#: bf16 full-depth prefill logits, kernel engine vs plain engine.  On an
#: H100 the correct kernels gave a gap of 0.043 (|logit| <= 3.6) with the
#: CUDA-core prefill and 0.047 with the tensor-core one, one-ulp
#: differences carried through 28 layers; ``drop_first_tile`` gave 5.06
#: and 4.86.  ``bf16_accumulate`` gave 0.137 while the prefill rounded its
#: accumulator after every key, and 0.049 since it rounds after every
#: 64-key tile: the kernel rows of phase 3 catch it now, this gap does
#: not.  The limit lies between the correct reading and ``drop_first_tile``.
#: Phase 8 holds the other archs to it at their served depths; on an H100
#: they read 0.033-0.062 (dense) and, with the plain path routed to the
#: kernel path's experts (``moe_prefill_logit_gaps``), 0.020-0.023 (MoE).
#: Left to route for itself, mixtral's plain path sent 40 of 8192 (layer,
#: token) rows to other experts and its logits moved by 0.19: a discrete
#: jump in the routing, not the kernels' rounding, so that raw gap is
#: reported and held to the limit only when no row flips.
LOGIT_TOL_BF16 = 0.1
#: bf16 full-depth prefill logits of mamba2-130m: the kernel engine against
#: the same model with the kernel swapped for its plain version on the
#: kernel's own inputs.  The plain engine is no yardstick here: it casts
#: ``a`` to bf16 before its scan (as the reference's plain path does), so
#: it computes another function, and on an H100 it differed from the
#: correct kernel by 0.094 and from the ``drop_carried_state`` fault by
#: 0.090 (|logit| <= 2.6).  Against the plain scan, on an H100: the
#: correct kernel 0, ``drop_carried_state`` 0.047 and
#: ``ssd_operands_in_bf16`` 0.076; the limit lies between them.  A
#: tensor-core body whose fp32 operands were split in two bf16 parts and
#: whose diagonal term was summed on the tensor cores gave 0.047 too: with
#: these random weights y is nearly its diagonal term, and summed in
#: another order than the plain version's it flips y's rounding often
#: enough for 24 layers to carry it to the logits (ssd_scan.cu,
#: "Precision").
SSM_LOGIT_TOL_BF16 = 0.02
#: bf16 full-depth prefill logits of zamba2-7b (81 Mamba2 layers and 13
#: applications of its shared attention block): the kernel engine against
#: the same model with both kernels swapped for their plain versions on
#: the kernels' own inputs.  Not ``SSM_LOGIT_TOL_BF16``, for the reason
#: ``HYBRID_TOL_REASON`` gives (phase 9 prints it; PERF.md gives the
#: readings on an H100 it was set from).
HYBRID_LOGIT_TOL_BF16 = 0.2
HYBRID_TOL_REASON = (
    f"bf16 logit limit {HYBRID_LOGIT_TOL_BF16}, not SSM_LOGIT_TOL_BF16 "
    f"({SSM_LOGIT_TOL_BF16}): both kernels round some outputs one bf16 ulp "
    "off their plain versions (phase 3), and 81 layers carry any such "
    "difference to the logits, so this limit catches gross faults only; "
    "the fp32 logits hold the kernels to their plain versions")
#: fp32 first prefill logits of zamba2-7b at full width and
#: ``HY_PARITY_DEPTH`` layers, kernels against their plain versions on the
#: kernels' inputs, at each prompt's last position and at the first
#: position of its second SSD chunk.  In fp32 the two differ only by
#: summation order; the limit lies between the correct kernels' reading on
#: an H100 and ``drop_carried_state``'s (PERF.md).  Only fp32 reads the
#: chunk's first position: in bf16 the correct kernels already read more
#: there than ``SSM_LOGIT_TOL_BF16`` for mamba2-130m.
HYBRID_LOGIT_TOL_FP32 = 1e-3
#: the logit limit of each recurrent family and dtype, kernels against
#: their plain versions on the kernels' inputs (``ssm_prefill_logit_gaps``)
RECURRENT_LOGIT_TOL = {("ssm", "bfloat16"): SSM_LOGIT_TOL_BF16,
                       ("hybrid", "bfloat16"): HYBRID_LOGIT_TOL_BF16,
                       ("hybrid", "float32"): HYBRID_LOGIT_TOL_FP32}
#: bf16 full-depth prefill logits of qwen2-1.5b, the TP=2 kernel model
#: against the single-device kernel model.  They differ where the TP model
#: rounds each rank's row-parallel partial to bf16 before the sum (twice a
#: layer, 28 layers).  On an H100 (both ranks on one card) the correct
#: model gave 0.051 (|logit| <= 3.5), and the planted ``drop_rank_partial``
#: (one rank's attention output left out of every layer's sum) gave 4.98;
#: the limit lies between them.  fp32 greedy identity caught that fault too.
TP_LOGIT_TOL_BF16 = 0.1
#: first prefill logits of phase 12's SSM and hybrid pods against the
#: single-device kernel model, by family and dtype.  The pod computes the
#: same function and rounds otherwise: each rank rounds its ``out_proj``
#: partial to bf16 before the ranks add (as a row-parallel product under
#: the reference's GSPMD does), and its ``in_proj`` columns come from a
#: narrower product.  On an H100 the correct bf16 pods read 0.0957
#: (mamba2-130m, 24 layers, |logit| <= 2.5) and 0.1738 (zamba2-7b, 81
#: layers), and the planted ``rank_local_norm`` (each rank normalising
#: over its own slice of ``d_inner``) 0.4258 and 0.3223: the bf16 limits
#: lie between them, the family's kernel-vs-plain limit
#: (``RECURRENT_LOGIT_TOL``) held where it can (zamba2-7b's 0.2), not
#: mamba2-130m's 0.02, which a correct pod's rounding alone exceeds.  So,
#: as ``HYBRID_TOL_REASON`` says of phase 9, the bf16 limits catch gross
#: faults only; in fp32 the pod and one device differ by summation order
#: alone, and the fp32 limit holds them (PERF.md gives the readings).
#: Phase 13's vlm and audio pods, bf16 logits of the step path against one
#: device: on an H100 the correct pods read 0.0391 (qwen2-vl-7b, 28
#: layers, with stub patches and 3-D positions; its text prefill too) and
#: 0.0469 (whisper-large-v3, 32 + 32 layers), the planted
#: ``mrope_rank0_only`` 0.1758 and ``cross_rank_local`` 2.234: the 0.1
#: limits lie between them.  In fp32 the correct pods read 6.20e-6 and
#: 3.52e-6, the faults 0.376 and 1.52.
#: Phase 17's llama3.2-3b pod at TP=3 against one device: its bf16
#: limit is the dense TP=2 pod's (``TP_LOGIT_TOL_BF16``: a rank's partial
#: rounds to bf16 before the sum, twice a layer), its fp32 limit the
#: families' 1e-3; the planted ``segment_kv_offset`` must break the fp32
#: one.
POD_LOGIT_TOL = {("ssm", "bfloat16"): 0.2,
                 ("dense", "bfloat16"): TP_LOGIT_TOL_BF16,
                 ("dense", "float32"): 1e-3,
                 ("hybrid", "bfloat16"): HYBRID_LOGIT_TOL_BF16,
                 ("ssm", "float32"): 1e-3, ("hybrid", "float32"): 1e-3,
                 ("vlm", "bfloat16"): 0.1, ("audio", "bfloat16"): 0.1,
                 ("vlm", "float32"): 1e-3, ("audio", "float32"): 1e-3}
#: bf16 logits of the first decode step after prefill over an int8 cache
#: (full width and depth): the kernel path (dequantize in fp32) against the
#: plain path (dequantize to bf16, then sdpa, as the reference reads it).
#: On an H100 the correct kernel gave 0.047 (|logit| <= 4.1), and the
#: planted ``drop_v_scale`` 1.38; the limit lies between them.
INT8_LOGIT_TOL_BF16 = 0.1
#: fp32 prefill logits of qwen2-vl-7b's step path (vision stub) at full
#: width and 2 layers, kernel path against plain path: in fp32 they differ
#: only by summation order, a few 1e-6 of logits of order 1
VL_LOGIT_TOL_FP32 = 1e-3
#: bf16 full-depth logits of whisper-large-v3 (32 encoder and 32 decoder
#: layers) through the step path, kernel path against plain path: the
#: prefill's and the first step's.  Set between the correct kernels'
#: reading on an H100 and the planted faults' (PERF.md)
AU_LOGIT_TOL_BF16 = 0.1
#: ranks of the tensor-parallel cell
TP = 2
#: phase 12's tensor-parallel SSM and hybrid pods (``TP`` ranks): the tags
#: of phase 3's rows at each rank's share of them (mamba2-130m: 12 of 24
#: SSM heads; zamba2-7b: 56 of 112 SSM heads, 16/16 of its shared block's
#: 32/32 attention heads)
SSM_TP_TAG, HY_TP_TAG = f"mamba2-130m TP={TP}", f"{HY_ARCH} TP={TP}"
#: phase 13's vlm and audio pods: the tags of phase 3's rows at each
#: rank's share of them (qwen2-vl-7b: 14/2 heads of dim 128, a GQA group
#: of 7; whisper-large-v3: 10/10 heads of dim 64)
VL_TP_TAG, AU_TP_TAG = f"{VL_ARCH} TP={TP}", f"{AU_ARCH} TP={TP}"
#: phase 17's uneven pods: llama3.2-3b (24 / 8 heads of dim 128) at TP=3,
#: whose ranks hold 8 query heads each and cut GQA groups of 3 (KV heads
#: [0, 3), [2, 6), [5, 8): 2 + 3 + 2 segment launches a layer), d_ff 8192
#: as 2731 / 2731 / 2730 and vocab 128256 as 3 x 42752; and
#: whisper-large-v3 at TP=4, its vocab 51866 as 12967 / 12967 / 12966 /
#: 12966.  The tags of phase 3's rows at their shards
UNEVEN_ARCH, UNEVEN_TP, LL_WIDTHS = "llama3.2-3b", 3, (24, 8, 128)
AU_UNEVEN_TP = 4
UNEVEN_TAG = f"{UNEVEN_ARCH} TP={UNEVEN_TP}"
AU_UNEVEN_TAG = f"{AU_ARCH} TP={AU_UNEVEN_TP}"
#: int8 serve steps of phase 17 (a)'s pod
UNEVEN_INT8_STEPS = 8
#: one-line faults for ``--planted-fault``: (source, regex, replacement)
PLANTED_FAULTS = {
    # the int8 decode ignores V's scales (V read as its raw codes)
    "drop_v_scale": [
        ("decode_attention.cu",
         r"(vv\[u\]\[i\] = vv\[u\]\[i\]) \* sv;", r"\1;")],
    # skip the oldest key tile of every row that sees more than one tile
    # (in the decode kernel: its scores masked in the split that holds it;
    # in the prefill kernel: the block's first tile, 32 keys in the fp32
    # body and 64 in the bf16 tensor-core body)
    "drop_first_tile": [
        ("decode_attention.cu",
         r"const bool valid = t0 \+ lane < t_end;",
         "const bool valid = t0 + lane < t_end && "
         "!(t0 == lo && hi - lo > kTile);"),
        ("flash_attention.cu",
         r"for \(int t0 = lo; t0 < hi; t0 \+= kTile\)",
         "for (int t0 = hi - lo > kTile ? lo + kTile : lo; t0 < hi; "
         "t0 += kTile)"),
        ("flash_attention.cu",
         r"const int first = lo;",
         "const int first = hi - lo > kKeys ? lo + kKeys : lo;")],
    # round the output accumulator to the input dtype after every key (a
    # no-op in the fp32 prefill body); in the bf16 tensor-core prefill
    # body, round the O accumulator fragments to bf16 after each tile's P V
    "bf16_accumulate": [
        (src,
         r"(acc\[[hr]\]\[i\]) \+= "
         r"(pj \* (?:vv\[u\]\[i\]|vs\[j \* D \+ lane \+ 32 \* i\]));",
         r"\1 = to_f(from_f<T>(\1 + \2));")
        for src in ("decode_attention.cu", "flash_attention.cu")] + [
        ("flash_attention.cu",
         r"(pv_tile<D, MT>\(o, s, kt \+ kKeys \* RS, lane\);)",
         r"\1 for (auto& om : o) for (auto& oc : om) for (float& x : oc) "
         r"x = __bfloat162float(__float2bfloat16(x));")],
    # the bf16 prefill's P V with P rounded to bf16, as library kernels
    # multiply it: only the hi part of the hi/lo split, the lo mmas dropped
    "p_in_bf16": [
        ("flash_attention.cu",
         r"\n *mma_bf16\(o\[mt\]\[c(?: \+ 1)?\], pl\[mt\], vf\[[02]\], "
         r"vf\[[13]\]\);", "")],
    # the decode's combine pass sums the splits' partial states without
    # rescaling each by exp(m_s - M)
    "combine_no_rescale": [
        ("decode_attention.cu",
         r"const float e_s = ml\[2 \* s \+ 1\] > 0\.f \? "
         r"expf\(ml\[2 \* s\] - M\) : 0\.f;",
         "const float e_s = ml[2 * s + 1] > 0.f ? 1.f : 0.f;")],
    # drop the carried-state term exp(a_cum) C h_in of every query row, in
    # the fp32 body and in the bf16 output pass; it changes nothing when S
    # <= chunk (the state carried in is zero)
    "drop_carried_state": [
        ("ssd_scan.cu",
         r"const float e = row < nq \? expf\(acum\[q0 \+ row\]\) : 0\.f;",
         "const float e = 0.f;"),
        ("ssd_scan.cu",
         r"const float e_a = in_a \? expf\(ac_a\) : 0\.f, "
         r"e_b = in_b \? expf\(ac_b\) : 0\.f;",
         "const float e_a = 0.f, e_b = 0.f;")],
    # the bf16 SSD passes multiply their fp32 operands (x o decay, h_in and
    # the masked scores) rounded to bf16: the hi parts alone, the mid and
    # lo mmas dropped
    "ssd_operands_in_bf16": [
        ("ssd_scan.cu", r"\n *mma_bf16\([^;\n]*_(?:mid|lo)\b[^;\n]*\);", "")],
    # the bf16 carry pass adds each chunk's state to the carried one without
    # decaying the carried one by exp(a_cum[-1])
    "carry_no_decay": [
        ("ssd_scan.cu", r"hc\[j\] = hc\[j\] \* ez \+ sv\[j\];",
         "hc[j] = hc[j] + sv[j];")],
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls are captured in
    one CUDA graph, and CUDA events around its replay give the time of the
    back-to-back launches with no host work between them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def eager_ms(fn, iters: int, warmup: int = 3) -> float:
    """Time per call of ``fn()`` called eagerly back to back, from CUDA
    events: the device time, or the host's time to issue the call when
    the host is the slower of the two."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tp_devices(tp: int = TP):
    """The ranks of a ``tp``-way pod: distinct cards when there are ``tp``
    of them, else every rank on the first card (or on ``DEVICE`` when it
    is the CPU)."""
    import torch
    if DEVICE == "cpu":
        return ["cpu"] * tp
    if torch.cuda.device_count() >= tp:
        return [f"cuda:{i}" for i in range(tp)]
    return ["cuda:0"] * tp


def synchronize_all() -> None:
    import torch
    if DEVICE != "cpu":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def max_err(out, want, dtype_name: str, scaled: bool = False):
    """(max |out - want|, the largest share of the tolerance that an
    element uses: the check passes when it is at most 1).  ``out`` and
    ``want`` may be tuples of tensors; ``scaled`` takes atol relative to
    each output's largest |want| (the SSD scan)."""
    if isinstance(out, tuple):
        errs = [max_err(o, w, dtype_name, scaled) for o, w in zip(out, want)]
        return max(e[0] for e in errs), max(e[1] for e in errs)
    atol, rtol = TOL[dtype_name]
    if scaled:
        atol *= float(want.float().abs().max())
    diff = (out.float() - want.float()).abs()
    share = diff / (atol + rtol * want.float().abs())
    return float(diff.max()), float(share.max())


# --------------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #


def decode_case(B: int, dtype, gen, widths=(HEADS, KV_HEADS, HEAD_DIM),
                L: int = MAX_LEN):
    """flash_decode inputs at ``widths`` (heads, KV heads, head dim; the
    served qwen2-1.5b's by default): the slot cache of ``L`` rows with
    ragged per-slot depths (1 and L included)."""
    import torch
    h, kh, d = widths
    q = torch.randn((B, 1, h, d), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((B, L, kh, d), generator=gen, device="cuda",
                    dtype=dtype)
    v = torch.randn((B, L, kh, d), generator=gen, device="cuda",
                    dtype=dtype)
    lens = ([L] if B == 1 else [1, 200, 377, L][:B] if B <= 4 else
            [1 + (97 * i) % L for i in range(B - 1)] + [L])
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, kv_len - 1


#: the long, ragged decode cases of phase 3: B slots over L rows (16 splits
#: of 2048 on an H100), kv_len 0, 1, within one tile, just past it, inside
#: a split, just past a split edge, L - 1 and L + 1; with and without a
#: window whose lower edge falls inside a split
LONG_B, LONG_L = 8, 32768
LONG_KV_LEN = [0, 1, 31, 33, 1000, 16385, 32767, 32769]
LONG_WINDOW = 3000


def long_decode_case(dtype, gen, widths=(HEADS, KV_HEADS, HEAD_DIM)):
    """flash_decode inputs at ``widths`` (as :func:`decode_case`) over the
    long, ragged cache (``LONG_B`` x ``LONG_L``, ``LONG_KV_LEN``)."""
    import torch
    h, kh, d = widths
    q = torch.randn((LONG_B, 1, h, d), generator=gen, device="cuda",
                    dtype=dtype)
    k, v = (torch.randn((LONG_B, LONG_L, kh, d), generator=gen,
                        device="cuda", dtype=dtype) for _ in range(2))
    kv_len = torch.tensor(LONG_KV_LEN, dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, (kv_len - 1).clamp(0, LONG_L)


def visible_keys(q_pos: int, kv_len: int, window) -> int:
    lo = 0 if window is None else max(q_pos - window + 1, 0)
    return max(min(kv_len, q_pos + 1) - lo, 0)


def bound(bytes_moved: float, flops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_case(S: int, pad: int, dtype, gen,
             widths=(SSM_HEADS, SSM_HEAD_DIM, SSM_STATE), B: int = 1):
    """ssd_scan inputs at ``widths`` (H, P, N; mamba2-130m's by default),
    B prompts: the model's ``x * dt``, ``a = dt * A``, B and C, with a trained
    Mamba2's long memory (dt in [1e-3, 0.1], A in [-16, -1]) so that the
    carried state and the far off-diagonal scores matter; the last ``pad``
    positions are zero, as the model pads a prompt to a multiple of the
    chunk."""
    import math

    import torch
    H, P, N = widths
    shape = (B, S, H)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(torch.rand(shape, generator=gen, device="cuda")
                   * (hi - lo) + lo)
    A = torch.rand((H,), generator=gen, device="cuda") * 15 + 1
    x = torch.randn(shape + (P,), generator=gen,
                    device="cuda") * dt[..., None]
    bm = torch.randn(shape + (N,), generator=gen, device="cuda") * 0.5
    cm = torch.randn(shape + (N,), generator=gen, device="cuda") * 0.5
    a = -dt * A
    if pad:
        for t in (x, a, bm, cm):
            t[:, S - pad:] = 0
    return x.to(dtype), a, bm.to(dtype), cm.to(dtype)


def ssd_work(S: int, chunk: int, es: int,
             widths=(SSM_HEADS, SSM_HEAD_DIM, SSM_STATE), B: int = 1):
    """(bytes, flops) the scan needs at B prompts and ``widths`` (H, P, N):
    x, a, B, C read once, y and the final state written once; per head and
    chunk the causal scores (c(c+1)/2 pairs x 2N), their product with x (x
    2P), and the carried-state term and state update (4cPN)."""
    H, P, N = widths
    bytes_moved = B * (2 * S * H * P * es + 4 * S * H + 2 * S * H * N * es
                       + H * P * N * es)
    pairs = chunk * (chunk + 1) // 2
    flops = B * H * (S // chunk) * (2 * pairs * (N + P)
                                    + 4 * chunk * P * N)
    return bytes_moved, flops


#: the SSD rows of phase 3, (S, chunk, pad), B=1 at mamba2-130m's widths: a
#: one-chunk prompt (chunk = S = 137), two chunks (the carry), a 300-token
#: prompt zero-padded to two 256-long chunks (the served bf16 row is the
#: second); in bf16 also two long prompts of 32 and 128 chunks
SSD_ROWS = [(137, 137, 0), (512, 256, 0), (512, 256, 212)]
SSD_LONG_ROWS = [(8192, 256, 0), (32768, 256, 0)]
#: the SSD rows at zamba2-7b's widths (``HY_SSD``), bf16 and fp32: phase
#: 9's shapes (prompts of 15 and 180 ids, one chunk each, chunk = S; one of
#: 399 ids zero-padded to two chunks of 256), two whole chunks and one
#: prompt of 32768 tokens
HY_SSD_ROWS = [(15, 15, 0), (180, 180, 0), (512, 256, 113), (512, 256, 0),
               (32768, 256, 0)]
#: the ``flash_attention`` rows at zamba2-7b's shared block, B=1: phase 9's
#: exact-length prompts of 15, 180 and 399 ids (a partial last tile) and one
#: of 512
HY_PREFILL_S = (15, 180, 399, MAX_LEN)
#: the body of ``ssd_scan.cu`` each dtype must run
SSD_BODY = {"bfloat16": "tensor-core", "float32": "CUDA-core"}


def ssd_kernels(dtype_name: str, n_chunks: int) -> int:
    """Kernels one ``ssd_scan`` call launches: the fp32 body one; the bf16
    passes three (chunk states, carry, outputs), two for one chunk."""
    if dtype_name == "float32":
        return 1
    return 2 if n_chunks == 1 else 3


def ssd_launch():
    """(body, kernels) of the last ``ssd_scan`` launch, as the library
    recorded them."""
    from repro_torch.kernels import build

    body = build.load("ssd_scan_last_body")()
    if body not in (0, 1):
        raise AssertionError(f"ssd_scan: no body recorded ({body})")
    return (SSD_BODY["float32"] if body == 0 else SSD_BODY["bfloat16"],
            build.load("ssd_scan_last_kernels")())


def check_ssd(record, gen, dtype, timed) -> None:
    """``ssd_scan`` at the ``SSD_ROWS`` (and, in bf16, ``SSD_LONG_ROWS``)
    and, at zamba2-7b's widths, the ``HY_SSD_ROWS`` against its plain
    version, with ``ssd_case``'s long-memory inputs and ``ssd_work``'s
    bound; with ``timed``, one bf16 call of the longest mamba2 row is also
    profiled, so its time splits by pass."""
    import torch

    from repro_torch.kernels import ops, ref

    dn = str(dtype).split(".")[1]
    long_rows = SSD_LONG_ROWS if dtype == torch.bfloat16 else []
    mamba = (SSM_HEADS, SSM_HEAD_DIM, SSM_STATE)
    # phase 12's pods: each rank's share of the SSM heads
    ssm_rank = (SSM_HEADS // TP, SSM_HEAD_DIM, SSM_STATE)
    hy_rank = (HY_SSD[0] // TP,) + HY_SSD[1:]
    # and phase 14's evaluation forward: mamba2-130m's B x S training batch
    rows = ([(r, mamba, "", 1) for r in SSD_ROWS + long_rows]
            + [(r, HY_SSD, HY_ARCH, 1) for r in HY_SSD_ROWS]
            + [((512, 256, 0), ssm_rank, SSM_TP_TAG, 1)]
            + [(r, hy_rank, HY_TP_TAG, 1) for r in HY_SSD_ROWS if r[0] <= 512]
            + [((TRAIN_S, 256, 0), mamba, TRAIN_TAG, TRAIN_B)])
    for (S, chunk, pad), widths, arch, B in rows:
        x, a, bm, cm = ssd_case(S, pad, dtype, gen, widths, B)
        b_ms, b_by = bound(*ssd_work(S, chunk, dtype.itemsize, widths, B),
                           dn)
        H, P, N = widths
        record("ssd_scan", dict(dtype=dn, B=B, S=S, chunk=chunk, pad=pad,
                                H=H, P=P, N=N, arch=arch, bound_ms=b_ms,
                                bound_by=b_by),
               lambda: ops.ssd_scan(x, a, bm, cm, chunk=chunk),
               lambda: ref.ssd_scan(x, a, bm, cm, chunk=chunk), None,
               20 if S <= 512 else 5)
        if timed and long_rows and (S, chunk, pad) == long_rows[-1] and (
                widths == mamba):
            profiled(f"ssd_scan bf16 B=1 S={S} chunk={chunk}, one call",
                     lambda: ops.ssd_scan(x, a, bm, cm, chunk=chunk))
        del x, a, bm, cm
    torch.cuda.empty_cache()


def check_kernels(timed: bool = True):
    """Phase 3: every kernel against its plain version at the served
    shapes; with ``timed`` also the times of both and of the library call
    (where there is one).  Returns (rows, failures)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # phase 19's rows draw from their own stream, so that every earlier
    # row keeps the inputs it had before they were added
    gen19 = torch.Generator(device="cuda").manual_seed(SEED + 19)
    rows = {"flash_decode": [], "flash_attention": [], "ssd_scan": [],
            "flash_decode_sharded": [], "flash_decode_int8": [],
            "flash_decode_int8_sharded": []}
    failures = []

    def record(name, row, run, plain, lib, iters, timed_fns=None,
               exact=False):
        """Check ``run()`` against ``plain()`` (and, with ``exact``, that
        ``row["bitwise"]`` holds); with ``timed``, time them (or the pair
        ``timed_fns`` in their place) and ``lib``."""
        out = run()
        if name == "ssd_scan":
            row["body"], row["kernels"] = ssd_launch()
        want = plain()
        synchronize_all()
        if name == "flash_attention":
            row["body"] = prefill_body()
            if not row["body"].startswith(PREFILL_BODY[row["dtype"]]):
                failures.append((name, f"{row['dtype']} ran the "
                                 f"{row['body']} body", row))
        if name == "ssd_scan" and (
                row["body"] != SSD_BODY[row["dtype"]] or row["kernels"]
                != ssd_kernels(row["dtype"], row["S"] // row["chunk"])):
            failures.append((name, f"{row['dtype']} ran the {row['body']} "
                             f"body in {row['kernels']} kernels", row))
        row["max_abs_err"], row["tol_share"] = max_err(
            out, want, row["dtype"], scaled=name == "ssd_scan")
        if exact and not row["bitwise"]:
            failures.append((name, "not bit for bit the single-device "
                             "kernel", row))
        t_run, t_plain = timed_fns or (run, plain)
        if timed:
            row.update(ms=cuda_ms(t_run, iters),
                       eager_ms=eager_ms(t_run, iters),
                       plain_ms=row.get("plain_ms") if t_plain is None
                       else cuda_ms(t_plain, max(iters // 10, 5)),
                       library_ms=None if lib is None else cuda_ms(lib, iters))
        rows[name].append(row)
        if not row["tol_share"] <= 1.0:
            failures.append((name, row))

    def dense_decode(q, k, v, kv_len, q_off, window, iters, sharded,
                     arch=""):
        """``flash_decode`` against its plain version (and, with
        ``sharded``, ``flash_decode_sharded`` at TP=2 and TP=4); ``arch``
        tags the rows at another arch's widths than the served ones."""
        B, L, kh, d = k.shape
        lens = kv_len.tolist()
        pos = torch.arange(L, device="cuda")
        keep = (pos[None] < kv_len[:, None]) & (pos[None] <= q_off[:, None])
        if window is not None:
            keep &= pos[None] > q_off[:, None] - window
        mask = keep[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        n_keys = [visible_keys(o, min(n, L), window)
                  for o, n in zip(q_off.tolist(), lens)]
        bytes_moved = (2 * q.numel() * es + 8 * B
                       + 2 * sum(n_keys) * kh * d * es)
        flops = 4 * q.shape[2] * d * sum(n_keys)
        b_ms, b_by = bound(bytes_moved, flops, dn)
        record("flash_decode", dict(
            dtype=dn, B=B, L=L, window=window,
            kv_len=lens if B <= 8 else f"{min(lens)}-{max(lens)}, ragged",
            n_split=ops.decode_plan(B, L, q.device)[0], bound_ms=b_ms,
            bound_by=b_by, arch=arch, heads=f"{q.shape[2]}/{kh}", D=d),
            lambda: ops.flash_decode(q, k, v, kv_len=kv_len,
                                     q_offset=q_off, window=window),
            lambda: ref.flash_decode(q, k, v, kv_len=kv_len,
                                     q_offset=q_off, window=window),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
        if sharded:
            check_sharded(record, q, k, v, kv_len, q_off, dn, es, iters)

    def prefill_inputs(B, S, widths, tp, dt, g):
        """q, k, v (B, S, heads, D) of one rank of a ``tp``-way pod of
        ``widths``, drawn from ``g``."""
        h, kh, d = widths[0] // tp, widths[1] // tp, widths[2]
        q = torch.randn((B, S, h, d), generator=g, device="cuda", dtype=dt)
        k, v = (torch.randn((B, S, kh, d), generator=g, device="cuda",
                            dtype=dt) for _ in range(2))
        return q, k, v

    def shared_stream(state):
        """A stream at ``state`` advanced past phase 19's bf16 draws (its
        decode and prefill rows'): the stream the next row would read had
        those rows drawn from ``gen``, as they once did."""
        g = torch.Generator(device="cuda")
        g.set_state(state)
        decode_case(4, torch.bfloat16, g, MOE_TP_SHAPES[0][1])
        prefill_inputs(EXPERT_SLOTS, EXPERT_PROMPT, MOE_TP_SHAPES[0][1],
                       EXPERT_TP, torch.bfloat16, g)
        return g

    def prefill_row(B, S, widths, window, arch="", tp=1, g=None):
        """``flash_attention`` (causal) at B x S and ``widths`` (heads, KV
        heads, head dim) against its plain version, with ``sdpa``; with
        ``tp`` > 1, at one rank's share of a ``tp``-way pod's heads, and
        ``sdpa`` also timed over the unsplit heads (``unsplit_ms``).
        ``g``: the random stream (default ``gen``)."""
        q, k, v = prefill_inputs(B, S, widths, tp, dtype, g or gen)
        h, kh, d = q.shape[2], k.shape[2], q.shape[3]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        i = torch.arange(S, device="cuda")
        m = (i[None] <= i[:, None]) & (i[None] > i[:, None] - (window or S))
        n_pairs = sum(visible_keys(p, S, window) for p in range(S))
        bytes_moved = (2 * q.numel() + 2 * k.numel()) * es
        b_ms, b_by = bound(bytes_moved, 4 * B * h * d * n_pairs, dn)
        # a window that masks nothing (S <= window) is causal alone
        causal = window is None or S <= window
        record("flash_attention", dict(
            dtype=dn, B=B, S=S, window=window, bound_ms=b_ms, bound_by=b_by,
            note="", arch=arch, heads=f"{h}/{kh}", D=d),
            lambda: ops.flash_attention(q, k, v, window=window),
            lambda: ref.flash_attention(q, k, v, window=window),
            (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            if causal else
            (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m, enable_gqa=True)), 50)
        if tp > 1 and timed:
            qu, ku, vu = (x.repeat_interleave(tp, dim=1)
                          for x in (qt, kt, vt))
            rows["flash_attention"][-1]["unsplit_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    qu, ku, vu, is_causal=True, enable_gqa=True), 50)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        es = dtype.itemsize
        for B in (1, 4):
            for window in (None, 64):
                dense_decode(*decode_case(B, dtype, gen), window, 200,
                             B == 4 and window is None)
        # a long, ragged cache: many splits per slot, empty ones among them
        for window in (None, LONG_WINDOW):
            dense_decode(*long_decode_case(dtype, gen), window, 20,
                         window is None)
        # zamba2-7b's shared block: MHA at head dim 112, its window
        hy = (HY_HEADS, HY_HEADS, HY_HEAD_DIM)
        dense_decode(*decode_case(4, dtype, gen, hy), HY_WINDOW, 200, False,
                     HY_ARCH)
        dense_decode(*long_decode_case(dtype, gen, hy), HY_WINDOW, 20, False,
                     HY_ARCH)
        # qwen2-vl-7b (GQA 28/4: the group-of-8 instance) and whisper's
        # decoder (MHA at head dim 64, its 448 rows; decode_32k's B=128)
        dense_decode(*decode_case(4, dtype, gen, VL_WIDTHS), None, 200,
                     False, VL_ARCH)
        dense_decode(*long_decode_case(dtype, gen, VL_WIDTHS), None, 20,
                     False, VL_ARCH)
        for B in (4, 128):
            dense_decode(*decode_case(B, dtype, gen, AU_WIDTHS, AU_ROWS),
                         None, 200 if B == 4 else 50, False, AU_ARCH)
        # the MoE pods of phase 11 and the hybrid pod of phase 12: each
        # rank's heads of a TP=2 pod
        for arch, widths, window in MOE_TP_SHAPES + [(HY_TP_TAG, hy,
                                                       HY_WINDOW)]:
            check_sharded(record, *decode_case(4, dtype, gen, widths), dn,
                          es, 200, window=window, tps=(TP,), arch=arch)
        # and phase 13's vlm and audio pods (whisper over its 448 rows)
        check_sharded(record, *decode_case(4, dtype, gen, VL_WIDTHS), dn,
                      es, 200, tps=(TP,), arch=VL_TP_TAG)
        check_sharded(record, *decode_case(4, dtype, gen, AU_WIDTHS,
                                           AU_ROWS), dn, es, 200,
                      tps=(TP,), arch=AU_TP_TAG)
        # phase 17's uneven pods: llama3.2-3b's ranks at TP=3, which cut
        # GQA groups, and whisper's at TP=4
        state = gen.get_state()
        check_sharded(record, *decode_case(4, dtype, gen, LL_WIDTHS), dn, es,
                      200, tps=(UNEVEN_TP,), arch=UNEVEN_TAG)
        if dtype == torch.float32:
            # a second fp32 case of the cut segments, on which they once
            # differed from the single-device kernel in the last bits
            check_sharded(record, *decode_case(4, dtype, shared_stream(
                state), LL_WIDTHS), dn, es, 200, tps=(UNEVEN_TP,),
                arch=UNEVEN_TAG + ", second case")
        check_sharded(record, *decode_case(4, dtype, gen, AU_WIDTHS,
                                           AU_ROWS), dn, es, 200,
                      tps=(AU_UNEVEN_TP,), arch=AU_UNEVEN_TAG)
        # phase 19's expert pod: a rank's 4/4 heads of qwen2-moe at TP=4
        check_sharded(record, *decode_case(4, dtype, gen19,
                                           MOE_TP_SHAPES[0][1]),
                      dn, es, 200, tps=(EXPERT_TP,), arch=EXPERT_TAG)
        torch.cuda.empty_cache()
        check_int8(record, gen, dtype)
        check_int8_sharded(record, gen, dtype)
        check_int8_sharded(record, gen, dtype, UNEVEN_TP, LL_WIDTHS,
                           UNEVEN_TAG)
        for B in (1, 4):
            for S in (16, 128, 512):
                for window in (None, 64):
                    prefill_row(B, S, (HEADS, KV_HEADS, HEAD_DIM), window)
        # zamba2-7b's shared block: exact-length prompts, one at a time;
        # and a rank's 16/16 heads of phase 12's pod
        for S in HY_PREFILL_S:
            prefill_row(1, S, hy, HY_WINDOW, HY_ARCH)
        prefill_row(1, MAX_LEN, (HY_HEADS // TP, HY_HEADS // TP,
                                 HY_HEAD_DIM), HY_WINDOW, HY_TP_TAG)
        # qwen2-vl-7b: the step path's patches and text, 4 x 512, and the
        # longest of phase 8's prompts alone; whisper's decoder: phase
        # 10's prompts and prefill_32k's 32 x 448
        for B, S in ((4, VL_PATCHES + VL_TEXT), (4, MAX_LEN),
                     (1, max(len(r.prompt_tokens)
                             for r in make_requests(12, SEED)))):
            prefill_row(B, S, VL_WIDTHS, None, VL_ARCH)
        for B, S in ((STEP_SLOTS, STEP_PROMPT), (32, AU_ROWS)):
            prefill_row(B, S, AU_WIDTHS, None, AU_ARCH)
        # a rank's heads of phase 13's pods, with sdpa also over the
        # unsplit heads
        prefill_row(4, VL_PATCHES + VL_TEXT, VL_WIDTHS, None, VL_TP_TAG,
                    tp=TP)
        prefill_row(STEP_SLOTS, STEP_PROMPT, AU_WIDTHS, None, AU_TP_TAG,
                    tp=TP)
        # and phase 17's: every rank of the llama3.2-3b pod, cut groups as
        # segments; a rank of the whisper pod at TP=4
        check_cut_prefill(record, gen, dtype, LL_WIDTHS, UNEVEN_TP, 4,
                          MAX_LEN, UNEVEN_TAG)
        prefill_row(STEP_SLOTS, STEP_PROMPT, AU_WIDTHS, None, AU_UNEVEN_TAG,
                    tp=AU_UNEVEN_TP)
        # and phase 19's expert pod: a rank of qwen2-moe at TP=4
        prefill_row(EXPERT_SLOTS, EXPERT_PROMPT, MOE_TP_SHAPES[0][1], None,
                    EXPERT_TAG, tp=EXPERT_TP, g=gen19)
        # phase 14's evaluation forward: qwen2-1.5b's training batch
        prefill_row(TRAIN_B, TRAIN_S, (HEADS, KV_HEADS, HEAD_DIM), None,
                    TRAIN_TAG)
        if dtype == torch.bfloat16:
            check_long_prefill(record, gen, timed)
            if timed:
                check_row_tiles(gen, failures)
        check_ssd(record, gen, dtype, timed)
    for name, rs in rows.items():
        log(f"[kernels] {name}: kernel vs plain version on the card")
        for r in rs:
            atol, rtol = TOL[r["dtype"]]
            if name == "flash_decode_sharded":
                shape = (f"B={r['B']} L={r['L']} kv_len={r['kv_len']} "
                         f"window={r['window']} n_split={r['n_split']} "
                         f"{r['heads']} heads per rank x {r['tp']} ranks on "
                         f"one card ({r['segments']} launches), bitwise == "
                         f"single-device kernel: {r['bitwise']} (max gap "
                         f"{r['kernel_gap']:.3e}); per call, all shards")
            elif name == "flash_decode":
                shape = (f"B={r['B']} L={r['L']} kv_len={r['kv_len']} "
                         f"window={r['window']} n_split={r['n_split']}")
            elif name == "flash_decode_int8_sharded":
                shape = (f"B={r['B']} L={r['L']} kv_len={r['kv_len']} "
                         f"{r['heads']} heads per rank x {r['tp']} ranks on "
                         f"one card ({r['segments']} launches), D={r['D']} "
                         f"window={r['window']} "
                         f"n_split={r['n_split']}, bitwise == single-device "
                         f"kernel: {r['bitwise']}; per call, all shards")
            elif name == "flash_decode_int8":
                shape = (f"B={r['B']} L={r['L']} kv_len={r['kv_len']} "
                         f"{r['heads']} heads D={r['D']} "
                         f"window={r['window']} n_split={r['n_split']}"
                         f"{r['note']}")
            elif name == "flash_attention":
                shape = (f"B={r['B']} S={r['S']} window={r['window']} "
                         f"[{r['body']}]{r['note']}")
            else:
                shape = (f"B={r['B']} S={r['S']} chunk={r['chunk']} "
                         f"pad={r['pad']} H={r['H']} P={r['P']} "
                         f"N={r['N']} [{r['body']}, {r['kernels']} "
                         f"kernels]")
            if r.get("arch"):
                shape = (f"{r['arch']}: {shape}" if name == "ssd_scan" else
                         f"{r['arch']} ({r['heads']} heads, D={r['D']}): "
                         f"{shape}")
            line = (f"  {r['dtype']:<8} {shape}: "
                    f"max_abs_err={r['max_abs_err']:.3e}, "
                    f"{r['tol_share']:.3f} of tol (atol {atol:g}"
                    f"{' x max|plain|' if name == 'ssd_scan' else ''} + rtol "
                    f"{rtol:g})")
            if timed:
                lib = ("no single PyTorch call" if r["library_ms"] is None
                       else f"{r.get('library', 'sdpa')} "
                            f"{r['library_ms']:.4f} ms")
                if "unsplit_ms" in r:
                    lib += (f" (over the unsplit heads "
                            f"{r['unsplit_ms']:.4f} ms)")
                plain = ("" if r["plain_ms"] is None
                         else f"plain {r['plain_ms']:.4f} ms, ")
                line += (f"; kernel {r['ms']:.4f} ms (eager "
                         f"{r['eager_ms']:.4f}), {plain}{lib}, bound "
                         f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
            log(line)
    return rows, failures


#: the body of ``flash_attention.cu`` each dtype must run
PREFILL_BODY = {"bfloat16": "tensor-core", "float32": "CUDA-core"}
#: the long prefill rows of phase 3, (B, S), bf16, causal, at the served
#: heads: one prompt of 32768 tokens, and one layer of the reference's
#: prefill_32k shape (B=32 x 32768)
LONG_PREFILL = [(1, 32768), (32, 32768)]
#: query rows of each slice on which a long row is checked: the first, a
#: middle and the last LONG_SLICE rows.  The plain version over a whole
#: long prompt cannot run (its fp32 scores would take 51 GB at B=1), so it
#: runs over each slice's queries and the keys they may see (rows [a, b)
#: of the output over keys [0, b) at query offset a: the same rows), in
#: groups of LONG_CHECK_BATCH batch rows
LONG_SLICE, LONG_CHECK_BATCH = 256, 4
#: query rows of a block when the plain version is timed over a whole long
#: row (:func:`plain_blocks`): its fp32 scores are at most 12 x 4096 x
#: 32768 x 4 bytes = 6.4 GB a block
LONG_PLAIN_BLOCK = 4096
#: shapes (B, S), bf16, causal, at the served heads, at which phase 3 times
#: each instance of the prefill's tensor-core body, 1 and 2 row tiles a
#: warp: the launcher picks 2 when its grid of 128-row blocks makes
#: kMinWaves = 2 waves of 2 blocks on every SM (flash_attention.cu), i.e.
#: at least 528 blocks on 132 SMs: 192 at the served shape, 768 and 3072
#: at one prompt of 8192 and of 32768 tokens
ROW_TILE_SHAPES = [(4, 512), (1, 8192), (1, 32768)]


def prefill_body() -> str:
    """The body of ``flash_attention.cu`` that its last launch ran, as the
    library's launcher recorded it: "tensor-core" (with 1 or 2 row tiles
    a warp) or "CUDA-core"."""
    from repro_torch.kernels import build

    body = build.load("flash_attention_last_body")()
    if body not in (0, 1, 2):
        raise AssertionError(f"flash_attention: no body recorded ({body})")
    return ("CUDA-core" if body == 0 else
            f"tensor-core, {body} row tile{'s' * (body > 1)} a warp")


def long_slices(S: int):
    """The first, a middle and the last ``LONG_SLICE`` query rows of a
    prompt of S tokens, as [a, b) ranges."""
    mid = S // 2 - LONG_SLICE // 2
    return [(0, LONG_SLICE), (mid, mid + LONG_SLICE), (S - LONG_SLICE, S)]


def plain_slices(q, k, v, slices):
    """The plain causal prefill's output on the query rows of ``slices``,
    concatenated: rows [a, b) over keys [0, b) at query offset a, in
    groups of ``LONG_CHECK_BATCH`` batch rows."""
    import torch

    from repro_torch.kernels import ref

    B = q.shape[0]
    return torch.cat([torch.cat([
        ref.flash_attention(q[i:i + LONG_CHECK_BATCH, a:b],
                            k[i:i + LONG_CHECK_BATCH, :b],
                            v[i:i + LONG_CHECK_BATCH, :b], q_offset=a)
        for i in range(0, B, LONG_CHECK_BATCH)], dim=0)
        for a, b in slices], dim=1)


def plain_blocks(q, k, v) -> None:
    """The plain causal prefill over every query row of q, in blocks of
    ``LONG_PLAIN_BLOCK`` rows of one batch row each: rows [a, b) over
    keys [0, b) at query offset a, the same rows as one call over the
    whole prompt, whose scores would not fit.  The outputs are dropped:
    this times the plain version over the kernel's whole work."""
    from repro_torch.kernels import ref

    B, S = q.shape[:2]
    for i in range(B):
        for a in range(0, S, LONG_PLAIN_BLOCK):
            b = min(a + LONG_PLAIN_BLOCK, S)
            ref.flash_attention(q[i:i + 1, a:b], k[i:i + 1, :b],
                                v[i:i + 1, :b], q_offset=a)


def check_row_tiles(gen, failures) -> None:
    """bf16 causal ``flash_attention`` at each ``ROW_TILE_SHAPES`` shape
    with each instance of its tensor-core body, 1 and 2 row tiles a warp
    (forced through ``flash_attention_row_tiles``), beside the instance the
    launcher picks by grid size: each instance's output checked on
    ``long_slices`` against the plain version, and its device time, both
    logged; a disagreement or the wrong instance is added to
    ``failures``."""
    import torch

    from repro_torch.kernels import build, ops

    force = build.load("flash_attention_row_tiles")
    last_body = build.load("flash_attention_last_body")
    for B, S in ROW_TILE_SHAPES:
        q = torch.randn((B, S, HEADS, HEAD_DIM), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, KV_HEADS, HEAD_DIM), generator=gen,
                            device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        slices = long_slices(S)
        want = plain_slices(q, k, v, slices)
        ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        row = dict(B=B, S=S, picked=last_body(), ms={}, tol_share={})
        try:
            for mt in (1, 2):
                if force(mt) != 0:
                    raise RuntimeError("flash_attention_row_tiles refused "
                                       f"{mt}")
                out = ops.flash_attention(q, k, v)
                torch.cuda.synchronize()
                if last_body() != mt:
                    failures.append(("flash_attention", f"forced {mt} row "
                                     f"tiles a warp, ran {last_body()}",
                                     row))
                got = torch.cat([out[:, a:b] for a, b in slices], dim=1)
                row["tol_share"][mt] = max_err(got, want, "bfloat16")[1]
                if not row["tol_share"][mt] <= 1.0:
                    failures.append(("flash_attention", f"{mt} row tiles "
                                     "a warp", row))
                row["ms"][mt] = cuda_ms(lambda: ops.flash_attention(q, k, v),
                                        50 if S <= 512 else 5)
        finally:
            force(0)
        log(f"[kernels] flash_attention bf16 B={B} S={S} causal, by row "
            f"tiles a warp (the launcher picks {row['picked']}): "
            + ", ".join(f"{mt}: {row['ms'][mt]:.4f} ms, "
                        f"{row['tol_share'][mt]:.3f} of tol"
                        for mt in (1, 2)))
        del q, k, v, want
        torch.cuda.empty_cache()


def check_long_prefill(record, gen, timed: bool) -> None:
    """bf16 ``flash_attention`` at the ``LONG_PREFILL`` shapes: the kernel
    over the whole prompt, checked on three slices of ``LONG_SLICE`` query
    rows against the plain version; the kernel and ``sdpa`` (causal, GQA)
    timed over the whole prompt with few iterations, the plain version
    once over it, block by block (:func:`plain_blocks`, CUDA events)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    for B, S in LONG_PREFILL:
        q = torch.randn((B, S, HEADS, HEAD_DIM), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, KV_HEADS, HEAD_DIM), generator=gen,
                            device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        slices = long_slices(S)

        def run():
            out = ops.flash_attention(q, k, v)
            return torch.cat([out[:, a:b] for a, b in slices], dim=1)

        def plain():
            return plain_slices(q, k, v, slices)

        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        bytes_moved = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        flops = 4 * B * HEADS * HEAD_DIM * (S * (S + 1) // 2)
        b_ms, b_by = bound(bytes_moved, flops, "bfloat16")
        record("flash_attention", dict(
            dtype="bfloat16", B=B, S=S, window=None,
            heads=f"{HEADS}/{KV_HEADS}", D=HEAD_DIM,
            bound_ms=b_ms, bound_by=b_by,
            plain_ms=event_ms(lambda: plain_blocks(q, k, v), reps=1,
                              warmup=0) if timed else None,
            note=f"; checked on query rows {slices}; plain timed once, in "
                 f"blocks of {LONG_PLAIN_BLOCK} query rows"),
            run, plain,
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            2 if B > 1 else 5,
            timed_fns=(lambda: ops.flash_attention(q, k, v), None))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def rank_shards(heads, tp: int):
    """The shards of a ``tp``-rank pod of ``heads`` (``n_heads``,
    ``n_kv_heads``): each rank's query heads ``[q0, q1)``, the KV heads
    they read, its uniform GQA segments (``kernels.ops.head_segments``),
    and the wrappers' ``head_starts`` / ``group`` arguments."""
    from repro_torch.kernels import ops
    from repro_torch.launch.partition import head_range, kv_head_range

    g = heads.n_heads // heads.n_kv_heads
    qr = [head_range(heads, tp, r) for r in range(tp)]
    kr = [kv_head_range(heads, tp, r) for r in range(tp)]
    segs = [ops.head_segments(a, b - a, g) for a, b in qr]
    return qr, kr, segs, dict(head_starts=[a for a, _ in qr], group=g)


def shard_heads(qr, kr) -> str:
    """A pod's heads per rank, "q/kv": one figure where the ranks hold
    equal shares, else each rank's."""
    per = [f"{b - a}/{d - c}" for (a, b), (c, d) in zip(qr, kr)]
    return per[0] if len(set(per)) == 1 else ",".join(per)


def check_sharded(record, q, k, v, kv_len, q_off, dn, es, iters,
                  window=None, tps=(2, 4), arch=""):
    """``flash_decode_sharded`` at the shard shapes of ``tps``-way pods
    with all ranks on one card: the decode inputs split into each rank's
    contiguous query-head range (``partition.head_range``: unequal where
    the ranks do not divide the heads), each with the KV heads it reads,
    and launched with the ranks' first heads and the group size, so a rank
    that cuts a GQA group runs as uniform segments.  The stitched output
    must equal the single-device kernel bit for bit and lie within the
    tolerance of the plain version.  Times are per call, all shards: the
    wrapper, its plain version, and ``sdpa`` over the unsplit heads (one
    call computing the stitched function); the bound is that of the whole
    call (each shard reads its own KV heads' rows).  ``arch`` tags rows at
    another arch's widths than the served ones."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    h, kh, d = q.shape[2], k.shape[2], q.shape[3]
    heads = SimpleNamespace(n_heads=h, n_kv_heads=kh)
    L = k.shape[1]
    pos = torch.arange(L, device=q.device)
    keep = pos[None] < kv_len[:, None]
    if window is not None:
        keep &= pos[None] > q_off[:, None] - window
    keep = keep[:, None, None, :]
    n_keys = [visible_keys(o, min(n, L), window)
              for o, n in zip(q_off.tolist(), kv_len.tolist())]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kw = dict(kv_len=kv_len, q_offset=q_off, window=window)
    for tp in tps:
        qr, ranges, segs, at = rank_shards(heads, tp)
        qs = [q[:, :, a:b].contiguous() for a, b in qr]
        ks, vs = ([x[:, :, lo:hi].contiguous() for lo, hi in ranges]
                  for x in (k, v))
        stitched = torch.cat(ops.flash_decode_sharded(qs, ks, vs, **kw, **at),
                             dim=2)
        single = ops.flash_decode(q, k, v, **kw)
        bitwise = bool(torch.equal(stitched, single))
        kernel_gap = float((stitched.float() - single.float()).abs().max())
        del stitched, single
        kv_read = sum(hi - lo for lo, hi in ranges)
        n_launch = sum(map(len, segs))
        bytes_moved = (2 * q.numel() * es + 8 * q.shape[0] * n_launch
                       + 2 * sum(n_keys) * kv_read * d * es)
        b_ms, b_by = bound(bytes_moved, 4 * h * d * sum(n_keys), dn)
        record("flash_decode_sharded", dict(
            dtype=dn, B=q.shape[0], L=L, kv_len=kv_len.tolist(), tp=tp,
            heads=shard_heads(qr, ranges), D=d, window=window, arch=arch,
            n_split=ops.decode_plan(q.shape[0], L, q.device)[0],
            segments=n_launch, bitwise=bitwise, kernel_gap=kernel_gap,
            bound_ms=b_ms, bound_by=b_by),
            lambda: torch.cat(ops.flash_decode_sharded(qs, ks, vs, **kw,
                                                       **at), dim=2),
            lambda: torch.cat(ref.flash_decode_sharded(
                qs, ks, vs, segments=segs, **kw), dim=2),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep, enable_gqa=True), iters,
            timed_fns=(lambda: ops.flash_decode_sharded(qs, ks, vs, **kw,
                                                        **at),
                       lambda: ref.flash_decode_sharded(
                           qs, ks, vs, segments=segs, **kw)),
            exact=True)


def check_cut_prefill(record, gen, dtype, widths, tp: int, B: int, S: int,
                      arch: str) -> None:
    """``flash_attention`` on each rank's heads of a ``tp``-rank pod of
    ``widths`` (heads, KV heads, head dim) whose ranks cut GQA groups,
    all ranks on one card, as the pod's prefill launches it (each rank's
    first head and the group size: a cut rank runs as uniform segments).
    The stitched output must lie within the tolerance of the plain
    version; whether it is bit for bit the single-device kernel's is
    printed (the bf16 body's tiles are per head, so it should be).  Times
    per call, all ranks: the wrapper, its plain version, and ``sdpa`` over
    the unsplit heads; the bound is the whole call's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dn, es = str(dtype).split(".")[1], dtype.itemsize
    h, kh, d = widths
    q = torch.randn((B, S, h, d), generator=gen, device="cuda", dtype=dtype)
    k, v = (torch.randn((B, S, kh, d), generator=gen, device="cuda",
                        dtype=dtype) for _ in range(2))
    qr, kr, segs, at = rank_shards(SimpleNamespace(n_heads=h, n_kv_heads=kh),
                                   tp)
    qs = [q[:, :, a:b].contiguous() for a, b in qr]
    ks, vs = ([x[:, :, lo:hi].contiguous() for lo, hi in kr] for x in (k, v))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def run():
        return [ops.flash_attention(qq, kk, vv, head_start=h0,
                                    group=at["group"])
                for qq, kk, vv, h0 in zip(qs, ks, vs, at["head_starts"])]

    def plain():
        return [ref.over_segments(ref.flash_attention, qq, kk, vv, sg)
                for qq, kk, vv, sg in zip(qs, ks, vs, segs)]

    bitwise = bool(torch.equal(torch.cat(run(), dim=2),
                               ops.flash_attention(q, k, v)))
    n_pairs = sum(visible_keys(p, S, None) for p in range(S))
    kv_read = sum(hi - lo for lo, hi in kr)
    b_ms, b_by = bound((2 * q.numel() + 2 * B * S * kv_read * d) * es,
                       4 * B * h * d * n_pairs, dn)
    record("flash_attention", dict(
        dtype=dn, B=B, S=S, window=None, bound_ms=b_ms, bound_by=b_by,
        note=(f", {tp} ranks ({shard_heads(qr, kr)} heads), "
              f"{sum(map(len, segs))} segment launches, bitwise == "
              f"single-device kernel: {bitwise}; per call, all ranks"),
        arch=arch, heads=shard_heads(qr, kr), D=d, tp=tp, bitwise=bitwise),
        lambda: torch.cat(run(), dim=2), lambda: torch.cat(plain(), dim=2),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True), 50,
        timed_fns=(run, plain))


#: int8 decode cases of phase 3: (B, L, heads, KV heads, head dim, kv_len
#: per slot, window); the first is the served shape; kv_len 0 and L + 1 (a
#: step at len == L) are among them
INT8_CASES = [
    (4, MAX_LEN, HEADS, KV_HEADS, HEAD_DIM, [1, 200, 377, MAX_LEN], None),
    (4, MAX_LEN, HEADS, KV_HEADS, HEAD_DIM, [1, 200, 377, MAX_LEN], 64),
    (4, MAX_LEN, 4, 4, 32, [0, 17, 300, MAX_LEN + 1], None),
    (4, MAX_LEN, 16, 1, 64, [5, 129, MAX_LEN + 1, MAX_LEN], 100),
    (LONG_B, LONG_L, HEADS, KV_HEADS, HEAD_DIM, LONG_KV_LEN, None),
    (LONG_B, LONG_L, HEADS, KV_HEADS, HEAD_DIM, LONG_KV_LEN, LONG_WINDOW),
]
#: the int8 decode at zamba2-7b's shared block (MHA, head dim 112, its
#: window): the served shape and the long ragged cache.  No served path
#: runs it (the hybrid cell's cache is bf16); the instance is held here.
HY_INT8_CASES = [
    (4, MAX_LEN, HY_HEADS, HY_HEADS, HY_HEAD_DIM, [1, 200, 377, MAX_LEN],
     HY_WINDOW),
    (LONG_B, LONG_L, HY_HEADS, HY_HEADS, HY_HEAD_DIM, LONG_KV_LEN, HY_WINDOW),
]
#: the int8 decode at qwen2-vl-7b's widths (GQA 28/4 over the group-of-8
#: instance); no served path runs it, the instance is held here
VL_INT8_CASES = [(4, MAX_LEN) + VL_WIDTHS + ([1, 200, 377, MAX_LEN], None)]
#: slots of the decode_32k layer compared with (and timed against) the
#: plain version: a full layer's K and V dequantized would take 8.6 GB
#: in fp32
SUB_BATCH = 8


def int8_kv(B: int, L: int, kh: int, d: int, gen):
    """Random int8 K/V codes (B, L, KH, D) in [-127, 127] and positive fp32
    scales (B, L), filled in place on the card."""
    import torch
    k, v = (torch.empty((B, L, kh, d), dtype=torch.int8, device="cuda")
            .random_(-127, 128, generator=gen) for _ in range(2))
    ks, vs = (torch.empty((B, L), device="cuda").uniform_(
        0.005, 0.025, generator=gen) for _ in range(2))
    return k, v, ks, vs


def int8_bytes(q, kh: int, d: int, n_keys: int) -> float:
    """Bytes a flash_decode_int8 call must move: q read and out written,
    the two per-slot vectors, and per visible key its K and V codes and
    its two fp32 scales."""
    return (2 * q.numel() * q.element_size() + 8 * q.shape[0]
            + n_keys * (2 * kh * d + 8))


def check_int8(record, gen, dtype) -> None:
    """``flash_decode_int8`` against its plain version (dequantize in fp32,
    then the plain decode) in ``INT8_CASES``, and at one layer of the
    ``decode_32k`` cache (B=128, L=32768, every slot at depth 32767): the
    full batch for the kernel's and the library call's times, checked on
    its first ``SUB_BATCH`` slots, and the sub-batch alone for kernel,
    plain and library times on the same inputs.  The library call is
    ``sdpa`` (GQA) over K/V already dequantized to bf16, the dequantize
    left out of its time: PyTorch has no single call over int8 K/V."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.launch.shapes import SHAPES

    dn = str(dtype).split(".")[1]

    def case(q, k, v, ks, vs, kv_len, q_off, window, note, iters, arch=""):
        B, L, kh, d = k.shape
        lens = kv_len.tolist()
        n_keys = sum(visible_keys(o, min(n, L), window)
                     for o, n in zip(q_off.tolist(), lens))
        b_ms, b_by = bound(int8_bytes(q, kh, d, n_keys),
                           4 * q.shape[2] * d * n_keys, dn)
        pos = torch.arange(L, device="cuda")
        keep = (pos[None] < kv_len[:, None]) & (pos[None] <= q_off[:, None])
        if window is not None:
            keep &= pos[None] > q_off[:, None] - window
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (ref.dequantize(c, s).to(torch.bfloat16).transpose(1, 2)
                  .contiguous() for c, s in ((k, ks), (v, vs)))
        kw = dict(kv_len=kv_len, q_offset=q_off, window=window)
        row = dict(dtype=dn, B=B, L=L, kv_len=lens, heads=f"{q.shape[2]}/"
                   f"{kh}", D=d, window=window, note=note, arch=arch,
                   n_split=ops.decode_plan(B, L, q.device)[0], bound_ms=b_ms,
                   bound_by=b_by, library="sdpa over bf16-dequantized K/V "
                   "(dequantize not timed)")
        record("flash_decode_int8", row,
               lambda: ops.flash_decode_int8(q, k, v, ks, vs, **kw),
               lambda: ref.flash_decode_int8(q, k, v, ks, vs, **kw),
               lambda: F.scaled_dot_product_attention(
                   qt.to(torch.bfloat16), kt, vt, attn_mask=keep[:, None,
                                                                 None, :],
                   enable_gqa=True), iters)

    cases = ([c + ("",) for c in INT8_CASES]
             + [c + (HY_ARCH,) for c in HY_INT8_CASES]
             + [c + (VL_ARCH,) for c in VL_INT8_CASES])
    for B, L, h, kh, d, lens, window, arch in cases:
        q = torch.randn((B, 1, h, d), generator=gen, device="cuda",
                        dtype=dtype)
        k, v, ks, vs = int8_kv(B, L, kh, d, gen)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        case(q, k, v, ks, vs, kv_len, (kv_len - 1).clamp(0, L), window, "",
             200 if L == MAX_LEN else 20, arch)
        del q, k, v, ks, vs
    # one layer of the decode_32k cache
    shape = SHAPES["decode_32k"]
    B, L = shape.global_batch, shape.seq_len
    q = torch.randn((B, 1, HEADS, HEAD_DIM), generator=gen, device="cuda",
                    dtype=dtype)
    k, v, ks, vs = int8_kv(B, L, KV_HEADS, HEAD_DIM, gen)
    kv_len = torch.full((B,), L, dtype=torch.int32, device="cuda")
    q_off = kv_len - 1
    n_keys = B * L
    b_ms, b_by = bound(int8_bytes(q, KV_HEADS, HEAD_DIM, n_keys),
                       4 * HEADS * HEAD_DIM * n_keys, dn)
    n = SUB_BATCH
    kw = dict(kv_len=kv_len, q_offset=q_off)
    sub = dict(kv_len=kv_len[:n], q_offset=q_off[:n])
    # the library call over the whole layer: K/V dequantized to bf16 in
    # (B, KH, L, D), 4.3 GB, slot group by slot group (not timed), freed
    # just after; every key is visible, so sdpa needs no mask
    qt = q.transpose(1, 2).to(torch.bfloat16).contiguous()
    kt, vt = (torch.empty((B, KV_HEADS, L, HEAD_DIM), dtype=torch.bfloat16,
                          device="cuda") for _ in range(2))
    for i in range(0, B, n):
        for dst, c, sc in ((kt, k, ks), (vt, v, vs)):
            dst[i:i + n] = ref.dequantize(c[i:i + n], sc[i:i + n]).to(
                torch.bfloat16).transpose(1, 2)
    record("flash_decode_int8", dict(
        dtype=dn, B=B, L=L, kv_len=f"{L} x {B}", heads=f"{HEADS}/{KV_HEADS}",
        D=HEAD_DIM, window=None, n_split=ops.decode_plan(B, L, q.device)[0],
        bound_ms=b_ms, bound_by=b_by,
        note=f" (decode_32k layer; checked on its first {n} slots; plain "
             f"timed on the {n}-slot row)",
        library="sdpa over the whole layer's bf16-dequantized K/V "
                "(dequantize not timed)"),
        lambda: ops.flash_decode_int8(q, k, v, ks, vs, **kw)[:n],
        lambda: ref.flash_decode_int8(q[:n], k[:n], v[:n], ks[:n], vs[:n],
                                      **sub),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True),
        20, timed_fns=(
            lambda: ops.flash_decode_int8(q, k, v, ks, vs, **kw), None))
    del qt, kt, vt
    torch.cuda.empty_cache()
    case(q[:n], k[:n], v[:n], ks[:n], vs[:n], kv_len[:n], q_off[:n], None,
         f" (decode_32k, first {n} slots)", 20)
    del q, k, v, ks, vs
    torch.cuda.empty_cache()


def check_int8_sharded(record, gen, dtype, tp: int = TP,
                       widths=(HEADS, KV_HEADS, HEAD_DIM),
                       arch: str = "") -> None:
    """``flash_decode_int8_sharded`` at the shard shapes of a ``tp``-rank
    pod of ``widths`` (by default phase 16's int8 pod: qwen2-1.5b at TP=2,
    6/1 heads of dim 128 a rank), B=4 x ``MAX_LEN``, all ranks on one
    card: each rank's int8 codes of its KV heads and the shared scales,
    launched with the ranks' first heads and the group size (a rank that
    cuts a group runs as uniform segments).  The stitched output must
    equal the single-device int8 kernel bit for bit and lie within the
    tolerance of the plain version.  Times per call, all shards: the
    wrapper, its plain version, and ``sdpa`` (GQA) over the unsplit
    heads' K/V dequantized to bf16 (the dequantize not timed); the bound
    is the whole call's bytes (each shard reads its own KV heads' codes
    and both scales)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dn = str(dtype).split(".")[1]
    B, L = 4, MAX_LEN
    h, kh, d = widths
    q = torch.randn((B, 1, h, d), generator=gen, device="cuda", dtype=dtype)
    k, v, ks, vs = int8_kv(B, L, kh, d, gen)
    kv_len = torch.tensor([1, 200, 377, MAX_LEN], dtype=torch.int32,
                          device="cuda")
    q_off = kv_len - 1
    qr, ranges, segs, at = rank_shards(SimpleNamespace(n_heads=h,
                                                       n_kv_heads=kh), tp)
    qs = [q[:, :, a:b].contiguous() for a, b in qr]
    kss, vss = ([x[:, :, lo:hi].contiguous() for lo, hi in ranges]
                for x in (k, v))
    kw = dict(kv_len=kv_len, q_offset=q_off)
    args = (qs, kss, vss, [ks] * tp, [vs] * tp)
    bitwise = bool(torch.equal(
        torch.cat(ops.flash_decode_int8_sharded(*args, **kw, **at), dim=2),
        ops.flash_decode_int8(q, k, v, ks, vs, **kw)))
    n_keys = sum(visible_keys(o, min(n, L), None)
                 for o, n in zip(q_off.tolist(), kv_len.tolist()))
    kv_read = sum(hi - lo for lo, hi in ranges)
    b_ms, b_by = bound(int8_bytes(q, kv_read, d, n_keys)
                       + 8 * n_keys * (tp - 1) + 8 * B * (tp - 1),
                       4 * h * d * n_keys, dn)
    pos = torch.arange(L, device="cuda")
    keep = ((pos[None] < kv_len[:, None]) & (pos[None] <= q_off[:, None]))
    qt = q.transpose(1, 2).to(torch.bfloat16).contiguous()
    kt, vt = (ref.dequantize(c, sc).to(torch.bfloat16).transpose(1, 2)
              .contiguous() for c, sc in ((k, ks), (v, vs)))
    record("flash_decode_int8_sharded", dict(
        dtype=dn, B=B, L=L, kv_len=kv_len.tolist(), tp=tp,
        heads=shard_heads(qr, ranges), D=d, window=None,
        n_split=ops.decode_plan(B, L, q.device)[0],
        segments=sum(map(len, segs)), bitwise=bitwise, bound_ms=b_ms,
        bound_by=b_by, arch=arch or f"qwen2-1.5b TP={tp}",
        library="sdpa over bf16-dequantized K/V (dequantize not timed)"),
        lambda: torch.cat(ops.flash_decode_int8_sharded(*args, **kw, **at),
                          dim=2),
        lambda: torch.cat(ref.flash_decode_int8_sharded(
            *args, segments=segs, **kw), dim=2),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep[:, None, None, :], enable_gqa=True),
        200, timed_fns=(
            lambda: ops.flash_decode_int8_sharded(*args, **kw, **at),
            lambda: ref.flash_decode_int8_sharded(*args, segments=segs,
                                                  **kw)),
        exact=True)


# --------------------------------------------------------------------------- #
# Phase 4: the served path at full width
# --------------------------------------------------------------------------- #


def make_requests(n: int, seed: int, max_prompt: int = 200,
                  vocab: int = 8192):
    """``n`` requests: prompt ids in [8, vocab), prompt lengths
    8-``max_prompt``, true output lengths 8-64; half arrive at 0, half
    staggered."""
    import numpy as np

    from repro_torch.core import Request

    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(8, max_prompt + 1))
        reqs.append(Request(
            prompt=f"request {i}",
            prompt_tokens=[int(t) for t in rng.randint(8, vocab, size=plen)],
            arrival_time=0.0 if i < n // 2 else 0.05 * (i - n // 2 + 1),
            request_id=i,
            true_output_len=int(rng.randint(8, 65))))
    return reqs


def tp_mesh(tp: int = TP):
    from repro_torch.launch import make_mesh
    return make_mesh((tp,), ("model",), devices=tp_devices(tp))


def served_frontend():
    """The served path's frontend (serve.py's defaults): ISRTF, windows of
    8, 4 slots, preemption on."""
    from repro_torch.core import (FrontendConfig, PreemptionConfig,
                                  SchedulerConfig)

    return FrontendConfig(
        n_nodes=1,
        scheduler=SchedulerConfig(policy="isrtf", window=8, batch_size=4),
        preemption=PreemptionConfig(enabled=True),
        observe_in_flight=False)


def serve(cfg, params, requests, *, attn_impl: str, mesh=None,
          **engine_opts):
    """Drive the served path (serve.py's defaults) over ``requests`` on one
    engine (a TP pod with ``mesh``; ``engine_opts``: more ``EngineConfig``
    fields); returns (responses, executor, wall seconds)."""
    from repro_torch.core import ElisServer, OraclePredictor
    from repro_torch.engine import EngineConfig, EngineExecutor, InferenceEngine

    ecfg = EngineConfig(max_slots=4, max_len=MAX_LEN, max_output=32,
                        eos_id=-1, respect_job_max=True, attn_impl=attn_impl,
                        **engine_opts)
    engine = InferenceEngine(cfg, params, ecfg, device=DEVICE, mesh=mesh)
    executor = EngineExecutor({0: engine})
    server = ElisServer(served_frontend(), OraclePredictor(), executor)
    for r in requests:
        server.submit(r)
    synchronize_all()
    t0 = time.perf_counter()
    responses = server.drain()
    synchronize_all()
    return responses, executor, time.perf_counter() - t0


def describe(cfg, mesh=None) -> str:
    if mesh is not None:
        return (f"{describe(cfg)}, tensor parallel over {len(mesh.ranks)} "
                f"ranks on "
                f"{', '.join(map(str, mesh.ranks))}"
                + (" (the ranks share one card: no interconnect is measured)"
                   if len(set(mesh.ranks)) == 1 else ""))
    if cfg.family == "ssm":
        s = cfg.ssm
        return (f"{cfg.arch_id}: {cfg.n_layers} layers, d_model "
                f"{cfg.d_model}, {cfg.ssm_n_heads} SSM heads of head dim "
                f"{s.head_dim}, d_state {s.d_state}, chunk {s.chunk_size}, "
                f"vocab {cfg.vocab_size}, {cfg.dtype}")
    if cfg.family == "hybrid":
        from repro_torch.models.transformer import hybrid_layout

        s, (groups, inner, tail) = cfg.ssm, hybrid_layout(cfg)
        return (f"{cfg.arch_id}: {cfg.n_layers} Mamba2 layers ({groups} "
                f"groups of {inner}, {tail} tail), d_model {cfg.d_model}, "
                f"{cfg.ssm_n_heads} SSM heads of head dim {s.head_dim}, "
                f"d_state {s.d_state}, chunk {s.chunk_size}; one shared "
                f"attention block after each group, {cfg.n_heads}/"
                f"{cfg.n_kv_heads} heads of dim {cfg.head_dim}, window "
                f"{cfg.swa_window}, d_ff {cfg.d_ff}; vocab "
                f"{cfg.vocab_size}, {cfg.dtype}")
    return (f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}, {cfg.dtype}")


def check_launches(launches, want) -> None:
    """Every count in ``want`` (name -> (count, why)) as stated and above
    0, and every other kernel not launched."""
    for name, n in launches.items():
        if name not in want and n:
            raise AssertionError(f"{name} launched {n} times on a path that "
                                 "does not run it")
    for name, (n, why) in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"want {n} = {why}")
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the path")


def rank_launches(cfg, tp: int) -> int:
    """The attention kernels' launches a layer (or shared-block site) over
    the ranks of a ``tp``-rank pod: one per uniform GQA segment of each
    rank's query heads (``kernels.ops.head_segments``), so ``tp`` where
    the ranks cut no group, up to three a rank where they do
    (llama3.2-3b at TP=3: 2 + 3 + 2 = 7), none for a rank with no heads;
    1 on one device."""
    if tp == 1:
        return 1
    from repro_torch.kernels import ops
    from repro_torch.launch import partition as P

    return sum(len(ops.head_segments(q0, P.local_config(cfg, tp, r).n_heads,
                                     g))
               for r, (q0, g) in enumerate(P.rank_heads(cfg, tp)))


def path_launches(cfg, tp: int, prefills: int, steps: int,
                  step_note: str = "") -> dict:
    """name -> (launches, why) of a served run on one engine (a pod of
    ``tp`` ranks) with ``prefills`` one-shot prefill dispatches and
    ``steps`` decode steps: ``flash_attention`` and ``ssd_scan`` once a
    layer (or shared-block site) and rank a prefill; the decode kernel (``flash_decode_sharded`` on
    a pod: one launch a rank) once a layer or site a step; a rank whose
    heads cut a GQA group launches each attention kernel once per uniform
    segment (:func:`rank_launches`).  The SSM decode step launches
    nothing.  A run with no one-shot prefill (every job admitted in
    chunks) expects no prefill kernel."""
    decode = "flash_decode" if tp == 1 else "flash_decode_sharded"
    segs = rank_launches(cfg, tp) if cfg.family != "ssm" else tp
    ranks = (f"{tp} ranks x " if segs == tp else
             f"{segs} segment launches over {tp} ranks x ") if tp > 1 else ""
    per = f"{cfg.n_layers} layers x {ranks}"
    pf = f"{prefills} prefill dispatches"
    if cfg.family in ("ssm", "hybrid"):
        want = {"ssd_scan": (cfg.n_layers * tp * prefills,
                             f"{cfg.n_layers} layers x "
                             + (f"{tp} ranks x " if tp > 1 else "") + pf)}
        if cfg.family == "hybrid":
            from repro_torch.models.transformer import hybrid_layout

            sites = hybrid_layout(cfg)[0]
            site = f"{sites} shared-block sites x {ranks}"
            want["flash_attention"] = (sites * segs * prefills, site + pf)
            want[decode] = (sites * segs * steps,
                            f"{site}{steps} decode steps{step_note}")
    else:
        want = {decode: (cfg.n_layers * segs * steps,
                         f"{per}{steps} decode steps{step_note}"),
                "flash_attention": (cfg.n_layers * segs * prefills, per + pf)}
    return {name: w for name, w in want.items()
            if prefills or name not in ("ssd_scan", "flash_attention")}


def served_path(cfg, params, requests, mesh=None, keep=None,
                **engine_opts):
    """Serve ``requests`` through the kernel path (on one TP pod with
    ``mesh``; ``engine_opts`` as :func:`serve`'s) with every launch count
    set to 0 just before and read just after; check every request, and
    that the path's kernels ran as often as its dispatches say.  Returns
    the launch counts; ``keep``, a dict, also receives the executor, the
    responses and the wall seconds (phase 15 calibrates on them, phase 20
    compares with them)."""
    from repro_torch.core import summarize
    from repro_torch.kernels import ops

    ops.reset_launches()
    responses, executor, wall = serve(cfg, params, requests,
                                      attn_impl="kernel", mesh=mesh,
                                      **engine_opts)
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    counters = executor.counters()
    want = {r.request_id: min(32, r.true_output_len) for r in requests}
    bad = [(r.request_id, r.status.value, r.n_tokens, want[r.request_id])
           for r in responses
           if not r.ok or r.n_tokens != want[r.request_id]]
    if len(responses) != len(requests) or bad:
        raise AssertionError(f"requests not served as expected: {bad}")
    if any(not 0 <= t < cfg.vocab_size for r in responses for t in r.tokens):
        raise AssertionError("a generated token lies outside the vocabulary")
    decode_steps = sum(rec["window"] for rec in executor.window_log)
    tp = 1 if mesh is None else len(mesh.ranks)
    want_launches = path_launches(cfg, tp, counters["prefill_dispatches"],
                                  decode_steps)
    check_launches(launches, want_launches)
    n_tok = sum(r.n_tokens for r in responses)
    m = summarize(responses)
    log(f"[serve] {describe(cfg, mesh)}"
        + (f"; EngineConfig {engine_opts}" if engine_opts else ""))
    log(f"[serve] {len(responses)}/{len(requests)} requests FINISHED with "
        f"the expected token counts; {n_tok} tokens in {wall:.3f} s wall = "
        f"{n_tok / wall:.1f} tokens/s; JCT mean {m['jct_mean']:.3f} s, p99 "
        f"{m['jct_p99']:.3f} s; queueing delay mean "
        f"{m['queuing_delay_mean']:.3f} s; TTFT mean {m['ttft_mean']:.3f} s; "
        f"preemptions {m['preemptions']}")
    log("[serve] launches: " + "; ".join(
        f"{name} {launches[name]} = {why}"
        for name, (_, why) in want_launches.items())
        + f" (all counts: {json.dumps(launches)})")
    log(f"[serve] engine counters: {json.dumps(counters)}")
    if keep is not None:
        keep.update(executor=executor, responses=responses, wall=wall)
    return launches


def profile_window(cfg, params, requests, mesh=None) -> None:
    """Where a steady decode window's time goes: one window of 8 steps at 4
    live slots under ``torch.profiler`` (:func:`profiled`)."""
    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine

    eng = InferenceEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=MAX_LEN, max_output=64, eos_id=-1),
        device=DEVICE, mesh=mesh)
    jobs = [Job(job_id=r.request_id, prompt="",
                prompt_tokens=list(r.prompt_tokens), arrival_time=0.0)
            for r in requests[:4]]
    eng.run_window(jobs, 8)  # prefill, and a first window as warm-up
    cards = 1 if mesh is None else len(set(mesh.ranks))
    profiled(f"{cfg.arch_id}"
             f"{'' if mesh is None else f' TP={len(mesh.ranks)} on {cards} card(s)'}"
             f": one decode window (8 steps, 4 slots, {cfg.n_layers} layers)",
             lambda: eng.run_window(jobs, 8))


def profiled(what: str, fn, annotations=()) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` and log its host wall
    time, the device's busy time (the sum of the kernels' durations: one
    stream per card, so they do not overlap on one card; with ranks on two
    cards it is summed over both) and the kernels that took most of it.
    Returns ``wall_ms`` and ``busy_ms``, and for each name in
    ``annotations`` (``record_function`` ranges that ``fn`` opens) the
    device time of the kernels launched inside those ranges, in ms.  The
    host's operators are recorded only when ``annotations`` asks for
    ranges: recording them cost more host time than the window itself
    (PERF.md, section 4)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    synchronize_all()
    activities = [ProfilerActivity.CUDA]
    if annotations:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize_all()
        wall = time.perf_counter() - t0
    by_name, spans = {}, {name: 0.0 for name in annotations}
    for e in prof.events():
        if e.name in spans:
            # the range's own device-side marker spans its gaps too: read
            # the kernels of its host-side event and of its children
            if e.device_type == DeviceType.CPU:
                spans[e.name] += getattr(e, "device_time_total",
                                         None) or e.cuda_time_total
        elif e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e3
    log(f"[profile] {what} under torch.profiler: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), "
        f"{len(by_name)} kernel names")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    # the eight longest, and every other kernel of the port's sources (the
    # decode's combine pass among them)
    shown = ranked[:8] + [(n, us) for n, us in ranked[8:]
                          if "(anonymous namespace)::" in n]
    for name, us in shown:
        log(f"[profile]   {us / 1e3:8.3f} ms {100 * us / 1e3 / busy:5.1f}% "
            f"of busy  {name[:90]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy,
            **{name: us / 1e3 for name, us in spans.items()}}


# --------------------------------------------------------------------------- #
# Phases 4-5 for the step entry points (launch/steps.py) over int8 caches
# --------------------------------------------------------------------------- #

#: the small int8 step path: B slots of a cache of MAX_LEN rows, prompts of
#: PROMPT ids (the reference's prefill_step takes no last_index, so the
#: prompts share one length), STEPS greedy serve steps
STEP_SLOTS, STEP_PROMPT, STEPS = 4, 128, 32
#: qwen2-vl-7b's step path: text ids after the ``VL_PATCHES`` patches
VL_TEXT = MAX_LEN - VL_PATCHES - STEPS


def step_prompts():
    """``STEP_SLOTS`` prompts of ``STEP_PROMPT`` ids, cut from the served
    cells' requests."""
    prompts = [r.prompt_tokens[:STEP_PROMPT] for r in make_requests(64, SEED)
               if len(r.prompt_tokens) >= STEP_PROMPT][:STEP_SLOTS]
    if len(prompts) < STEP_SLOTS:
        raise AssertionError("too few requests with long enough prompts")
    return prompts


def small_cache(cfg, kv_dtype="int8"):
    """An input_specs cache of ``STEP_SLOTS`` x ``MAX_LEN`` rows."""
    from repro_torch.launch.shapes import InputShape, input_specs
    shape = InputShape("serve_512", MAX_LEN, STEP_SLOTS, "decode")
    return input_specs(cfg, shape, kv_dtype=kv_dtype, device=DEVICE)["cache"]


def run_steps(cfg, params, attn_impl: str, n_steps: int = STEPS):
    """:func:`step_run` over the prompts into a fresh int8 cache; returns
    (tokens (B, 1 + n_steps), host wall seconds of each step)."""
    import torch

    prompts = torch.as_tensor(step_prompts(), device=DEVICE)
    _, toks, walls, _ = step_run(cfg, params, {"tokens": prompts},
                                 small_cache(cfg), attn_impl, n_steps)
    return toks, walls


def int8_step_path(cfg, params) -> int:
    """Phase 4, small cache: prefill and ``STEPS`` serve steps through the
    kernels with every launch count set to 0 just before and read just
    after.  Returns ``flash_decode_int8``'s count."""
    import statistics

    from repro_torch.kernels import ops

    ops.reset_launches()
    toks, walls = run_steps(cfg, params, "kernel")
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    n = cfg.n_layers
    check_launches(launches, {
        "flash_attention": (n, f"{n} layers x 1 prefill"),
        "flash_decode_int8": (n * STEPS, f"{n} layers x {STEPS} steps")})
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("a generated token lies outside the vocabulary")
    med = statistics.median(walls) * 1e3
    log(f"[int8] make_prefill_step + make_serve_step over an input_specs "
        f"int8 cache ({STEP_SLOTS} slots x {MAX_LEN} rows), "
        f"{describe(cfg)}: {STEP_SLOTS} prompts of {STEP_PROMPT} ids, "
        f"{STEPS} greedy steps; step wall median {med:.2f} ms (min "
        f"{min(walls) * 1e3:.2f}), {STEP_SLOTS / (med / 1e3):.1f} tokens/s")
    log(f"[int8] launches: flash_attention {launches['flash_attention']} = "
        f"{n} x 1 prefill; flash_decode_int8 "
        f"{launches['flash_decode_int8']} = {n} x {STEPS} steps; "
        f"flash_decode {launches['flash_decode']} (all counts: "
        f"{json.dumps(launches)})")
    return launches["flash_decode_int8"]


def fill_int8(kv, gen, length: int, lens) -> None:
    """Fill an int8 cache layer by layer, in place: codes in [-127, 127],
    scales in [0.005, 0.025], and every slot's ``len`` set to ``length``."""
    for i in range(kv.k.shape[0]):
        for codes in (kv.k[i], kv.v[i]):
            codes.random_(-127, 128, generator=gen)
        for scale in (kv.k_scale[i], kv.v_scale[i]):
            scale.uniform_(0.005, 0.025, generator=gen)
    lens.fill_(length)


def ring_step(cfg, params) -> None:
    """Phase 4, ring cache: one ``make_serve_step`` at long_500k (B=1, an
    int8 ring of 8192 rows, filled, at position 524287): read plain, as the
    reference reads a ring, so no decode kernel launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.shapes import SHAPES, input_specs
    from repro_torch.launch.steps import make_serve_step

    shape = SHAPES["long_500k"]
    specs = input_specs(cfg, shape, kv_dtype="int8", device=DEVICE)
    cache = specs["cache"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    fill_int8(cache["kv"], gen, shape.seq_len - 1, cache["len"])
    tokens = torch.randint(8, cfg.vocab_size, (shape.global_batch, 1),
                           generator=gen, device=DEVICE, dtype=torch.int32)
    ops.reset_launches()
    tok, cache = make_serve_step(cfg)(params, tokens, cache)
    synchronize_all()
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    if any(launches.values()):
        raise AssertionError(f"the ring step launched a kernel: {launches}")
    if not (0 <= int(tok[0]) < cfg.vocab_size and cache["kv"].ring):
        raise AssertionError("long_500k ring step: bad token or cache")
    log(f"[int8] long_500k: make_serve_step over an int8 ring of "
        f"{cache['kv'].k.shape[2]} rows (B={shape.global_batch}, position "
        f"{shape.seq_len - 1}): token {int(tok[0])}; read plain as in the "
        f"reference, no decode kernel launched ({json.dumps(launches)})")


def int8_greedy_parity(cfg) -> bool:
    """Phase 5: fp32 greedy tokens of the small int8 step path at full
    width and 2 layers, kernel path against plain path: identical?"""
    import torch

    from repro_torch.models import transformer as T

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params2 = T.init_params(
        cfg2, torch.Generator(device=DEVICE).manual_seed(SEED + 1))
    got, _ = run_steps(cfg2, params2, "kernel")
    want, _ = run_steps(cfg2, params2, "torch")
    same = int((got == want).sum())
    log(f"[parity] {cfg.arch_id} fp32, full width, 2 layers, int8 cache: "
        f"step functions' greedy tokens, kernel path vs plain path, "
        f"identical on {same}/{want.numel()} tokens ({STEP_SLOTS} slots x "
        f"{1 + STEPS})")
    return bool(torch.equal(got, want))


def int8_logit_gaps(cfg, params):
    """Phase 5, bf16 at full width and depth: the prompts prefilled into an
    int8 cache through the kernels, then one decode step over copies of
    that cache through the kernel path and the plain path.  Returns
    (max |kernel - plain| of the step's logits, max |int8 kernel - the same
    step over a bf16 cache| (quantization error, reported only), whether
    the kernel's logits are finite)."""
    import copy

    import torch

    from repro_torch.models import transformer as T

    prompts = torch.as_tensor(step_prompts(), device=DEVICE)

    def step_logits(kv_dtype, impls):
        logits, cache = T.prefill(params, cfg, {"tokens": prompts},
                                  small_cache(cfg, kv_dtype))
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        return [T.decode_step(params, cfg, tok, copy.deepcopy(cache),
                              attn_impl=impl)[0].float() for impl in impls]

    kernel, plain = step_logits("int8", ("kernel", "torch"))
    (dense,) = step_logits(None, ("kernel",))
    gap = float((kernel - plain).abs().max())
    quant = float((kernel - dense).abs().max())
    finite = bool(torch.isfinite(kernel).all())
    log(f"[parity] {cfg.arch_id} bf16, full width and depth, int8 cache: "
        f"first decode step's logits {tuple(kernel.shape)}, max |kernel - "
        f"plain| = {gap:.4e} (tol {INT8_LOGIT_TOL_BF16}), max |logit| = "
        f"{float(plain.abs().max()):.3f}, finite={finite}; reported, not "
        f"checked: max |int8 kernel - bf16 cache kernel| = {quant:.4e} "
        f"(quantization error)")
    return gap, quant, finite


def decode_32k_steps(cfg) -> None:
    """Phase 4, large cache: ``make_serve_step`` at decode_32k (B=128,
    L=32768) over an int8 cache built by ``input_specs`` on the card and
    filled in place, every slot at depth 32767: one warm-up step and 5
    timed ones (devices synchronised; median), with their launches, the
    cache's bytes, the peak memory and the step's bound.  The bf16 cache
    this shape would need is computed, never allocated."""
    import statistics

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.shapes import SHAPES, input_specs
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T

    free, total = torch.cuda.mem_get_info()
    log(f"[int8] decode_32k: device memory free {free / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB before its weights and cache")
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, torch.Generator(device=DEVICE)
                           .manual_seed(SEED))
    shape = SHAPES["decode_32k"]
    cache = input_specs(cfg, shape, kv_dtype="int8", device=DEVICE)["cache"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    fill_int8(cache["kv"], gen, shape.seq_len - 1, cache["len"])
    tok = torch.randint(8, cfg.vocab_size, (shape.global_batch,),
                        generator=gen, device=DEVICE, dtype=torch.int32)
    kv = cache["kv"]
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (kv.k, kv.v, kv.k_scale, kv.v_scale))
    param_bytes = sum(t.numel() * t.element_size() for t in
                      _tensors(params))
    bf16_cache = 2 * kv.k.numel() * 2
    serve = make_serve_step(cfg)
    ops.reset_launches()
    walls = []
    for i in range(6):
        synchronize_all()
        t0 = time.perf_counter()
        tok, cache = serve(params, tok[:, None], cache)
        synchronize_all()
        if i:
            walls.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    n = cfg.n_layers
    check_launches(launches, {"flash_decode_int8": (
        6 * n, f"{n} layers x 6 steps")})
    if not bool(((tok >= 0) & (tok < cfg.vocab_size)).all()):
        raise AssertionError("decode_32k: a token lies outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    step_bound = (cache_bytes + param_bytes) / HBM_BYTES_S * 1e3
    log(f"[int8] decode_32k: make_serve_step, B={shape.global_batch}, int8 "
        f"cache of {shape.seq_len} rows ({cache_bytes / 1e9:.2f} GB: codes "
        f"and fp32 scales), every slot at depth {shape.seq_len - 1}, "
        f"{describe(cfg)} ({param_bytes / 1e9:.2f} GB of weights): step "
        f"wall median {statistics.median(walls) * 1e3:.2f} ms over 5 "
        f"(min {min(walls) * 1e3:.2f}; after 1 warm-up); bound "
        f"{step_bound:.2f} ms (cache and weights read once at 3.35 TB/s)")
    log(f"[int8] decode_32k: flash_decode_int8 {launches['flash_decode_int8']}"
        f" = {n} x 6 steps; peak memory allocated {peak / 1e9:.2f} GB; a "
        f"bf16 cache of this shape would need {bf16_cache / 1e9:.1f} GB "
        f"(computed, not allocated)")
    profiled(f"decode_32k: one make_serve_step (B={shape.global_batch})",
             lambda: serve(params, tok[:, None], cache))


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


# --------------------------------------------------------------------------- #
# Phase 5: kernel path against plain path
# --------------------------------------------------------------------------- #


def greedy_streams(cfg, params, prompts, attn_impl: str, n_out: int,
                   mesh=None, swap: bool = False):
    """Serve ``prompts`` on one engine (a TP pod with ``mesh``) with a
    fixed schedule: each window runs the (at most 4) unfinished jobs with
    the fewest tokens, evicting the others, so jobs are preempted and
    re-admitted by recompute; with ``swap`` the first of them is swapped
    to the host instead and back in when it is scheduled again.  Returns
    (streams, evictions and swap-outs)."""
    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine

    eng = InferenceEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=MAX_LEN, max_output=n_out, eos_id=-1,
        attn_impl=attn_impl), device=DEVICE, mesh=mesh)
    jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
            for i, p in enumerate(prompts)]
    evictions = 0
    while True:
        live = [j for j in jobs if len(j.generated) < n_out]
        if not live:
            break
        batch = sorted(live, key=lambda j: (len(j.generated), j.job_id))[:4]
        for j in jobs:
            if eng.has_job(j.job_id) and j not in batch:
                if not (swap and evictions == 0 and eng.offload_job(j.job_id)):
                    eng.evict_job(j.job_id)
                evictions += 1
        toks, _ = eng.run_window(batch, 8)
        for j, t in zip(batch, toks):
            j.generated.extend(t)
    return [list(j.generated) for j in jobs], evictions


def fp32_model(cfg, depth: int):
    """``cfg`` in fp32 at full width and ``depth`` layers, and its random
    weights on the card from ``SEED + 1``: the model of the fp32 parity
    checks."""
    import torch

    from repro_torch.models import transformer as T

    cfg2 = dataclasses.replace(cfg, n_layers=depth, dtype="float32")
    return cfg2, T.init_params(
        cfg2, torch.Generator(device=DEVICE).manual_seed(SEED + 1))


def greedy_parity(cfg, requests, meshes=(), depth: int = 2,
                  swap: bool = False) -> bool:
    """fp32 greedy tokens of the kernel and plain engines at full width and
    ``depth`` layers, through evictions and recompute resumes (the first
    eviction a swap round trip, with ``swap``): identical (and at least one
    eviction)?  With ``meshes``, the kernel engine of each TP pod against
    the single-device kernel engine, and the first pod's against the plain
    engine too."""
    cfg2, params2 = fp32_model(cfg, depth)
    prompts = [list(r.prompt_tokens) for r in requests[:6]]
    runs = {"kernel engine": ("kernel", None), "plain engine": ("torch", None)}
    pairs = [] if meshes else [("kernel engine", "plain engine")]
    for m in meshes:
        name = f"TP={len(m.ranks)} kernel engine"
        runs[name] = ("kernel", m)
        pairs.append((name, "kernel engine"))
    if meshes:
        pairs.insert(1, (pairs[0][0], "plain engine"))
    streams = {name: greedy_streams(cfg2, params2, prompts, impl, 24, m,
                                    swap)
               for name, (impl, m) in runs.items()}
    ok = True
    for name, other in pairs:
        (got, evictions), (want, _) = streams[name], streams[other]
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        total = sum(len(w) for w in want)
        resumes = ("recompute resumes" if not swap else
                   "recompute resumes, the first a swap round trip")
        log(f"[parity] {cfg.arch_id} fp32, full width, {depth} layers: "
            f"{name} vs {other} greedy tokens identical on {same}/{total} "
            f"tokens of {len(prompts)} requests ({evictions} evictions + "
            f"{resumes})")
        ok &= got == want and evictions > 0
    return ok


def prefill_batch(requests):
    """The first four prompts right-padded to 256 ids, and each one's last
    index: the batch whose first prefill logits phase 5 compares."""
    import numpy as np

    toks = np.zeros((4, 256), np.int32)
    last = np.zeros((4,), np.int32)
    for i, r in enumerate(requests[:4]):
        toks[i, : len(r.prompt_tokens)] = r.prompt_tokens
        last[i] = len(r.prompt_tokens) - 1
    return toks, last


def prefill_logit_gap(cfg, params_bf16, requests, mesh=None):
    """max |kernel - plain| of the first prefill logits at full width and
    depth in bf16; with ``mesh``, max |TP kernel - single-device kernel|.
    Returns (gap, whether the kernel's logits are finite)."""
    import torch

    from repro_torch.launch import shard_params
    from repro_torch.models import transformer as T

    toks, last = prefill_batch(requests)
    runs = {"kernel": ("kernel", None), "plain": ("torch", None)}
    if mesh is not None:
        runs = {f"TP={len(mesh.ranks)} kernel": ("kernel", mesh),
                "kernel": runs["kernel"]}
    logits = {}
    for name, (impl, m) in runs.items():
        params = params_bf16 if m is None else shard_params(params_bf16, cfg,
                                                            m)
        out, _ = T.prefill(params, cfg,
                           {"tokens": torch.as_tensor(toks, device=DEVICE)},
                           T.init_cache(cfg, 4, MAX_LEN, DEVICE, mesh=m),
                           attn_impl=impl,
                           last_index=torch.as_tensor(last, device=DEVICE),
                           mesh=m)
        logits[name] = out.float()
        del params
    (got_name, got), (want_name, want) = logits.items()
    gap = float((got - want).abs().max())
    scale = float(want.abs().max())
    finite = bool(torch.isfinite(got).all())
    tol = LOGIT_TOL_BF16 if mesh is None else TP_LOGIT_TOL_BF16
    log(f"[parity] {cfg.arch_id} bf16, full width and depth: first prefill "
        f"logits {tuple(got.shape)}, max |{got_name} - {want_name}| = "
        f"{gap:.4e} (tol {tol}), max |logit| = {scale:.3f}, finite={finite}")
    return gap, finite


def moe_prefill_logit_gaps(cfg, params_bf16, requests, mesh=None):
    """The MoE family's first prefill logits at full width and served depth
    in bf16: the kernel path against the plain path (with ``mesh``: the
    single-device kernel model against the TP kernel model) as they are
    (``raw``), and against the other path made to route every token to
    the experts the kernel path's router chose (``pinned``; each expert
    weighted by the other path's own probabilities; the TP model routes
    once a layer, on rank 0).  The kernels move the router's input
    by an ulp or so; where two experts' probabilities lie closer than
    that, the choice flips, and a token whose experts change changes by
    the size of an expert's output: a discrete jump that no tolerance on
    the kernels' rounding bounds.  Pinned, only the rounding remains.  The
    TP model's partial sums round in another order, so its router input
    moves in the same way.  Returns (raw gap, pinned gap, routing flips:
    (layer, token) rows whose expert set differs, finite)."""
    import torch

    from repro_torch.launch import shard_params
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    toks, last = prefill_batch(requests)
    router = M.router_probs
    chosen, flips = [], [0]

    def record(p, c, x):
        out = router(p, c, x)
        chosen.append(out[2])
        return out

    def replay(p, c, x):
        probs, _, own = router(p, c, x)
        idx = chosen[replay.i]
        replay.i += 1
        flips[0] += int((own.sort(-1).values != idx.sort(-1).values)
                        .any(-1).sum())
        w = probs.gather(-1, idx)
        if c.moe.norm_topk_prob:
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return probs, w, idx

    replay.i = 0

    # the other path: the plain model, or the TP kernel model
    other, impl, params = "plain", "torch", params_bf16
    if mesh is not None:
        other, impl = f"TP={len(mesh.ranks)} kernel", "kernel"
        params = shard_params(params_bf16, cfg, mesh)

    def first_logits(route, p=params_bf16, impl="kernel", m=None):
        M.router_probs = route
        try:
            out, _ = T.prefill(p, cfg,
                               {"tokens": torch.as_tensor(toks,
                                                          device=DEVICE)},
                               T.init_cache(cfg, 4, MAX_LEN, DEVICE, mesh=m),
                               attn_impl=impl,
                               last_index=torch.as_tensor(last,
                                                          device=DEVICE),
                               mesh=m)
        finally:
            M.router_probs = router
        return out.float()

    got = first_logits(record)
    raw = float((got - first_logits(router, params, impl, mesh))
                .abs().max())
    pinned = float((got - first_logits(replay, params, impl, mesh))
                   .abs().max())
    finite = bool(torch.isfinite(got).all())
    del params
    log(f"[parity] {cfg.arch_id} bf16, full width, {cfg.n_layers} layers: "
        f"first prefill logits {tuple(got.shape)}, max |kernel - {other}| "
        f"= {raw:.4e} with the {other} path's own routing ({flips[0]} of "
        f"{cfg.n_layers * toks.size} (layer, token) rows route to other "
        f"experts than on the kernel path), {pinned:.4e} with the kernel "
        f"path's routing (tol {LOGIT_TOL_BF16}; the raw gap too when no "
        f"row flips); max |logit| = {float(got.abs().max()):.3f}, "
        f"finite={finite}")
    return raw, pinned, flips[0], finite


def ssm_prefill_logit_gaps(cfg, params, requests, at_chunk: bool = False):
    """The SSM and hybrid families prefill each prompt alone at its exact
    length: for the two longest prompts (two chunks: at least one must be
    longer than one SSD chunk) and the two shortest (one chunk), max
    |kernel - x| of the first prefill logits at full width and the served
    depth in ``cfg.dtype``, where x is the plain engine ("plain") and the
    same model with each kernel it calls (``ssd_scan``, and for the hybrid
    ``flash_attention``) swapped for its plain version on the kernel's own
    inputs ("plain_kernels", at each prompt's last position; with
    ``at_chunk`` also "plain_kernels_at_chunk", at the first position of
    the second chunk, where the carried state weighs most: the random
    init's decay leaves little of it at the last position).  Returns
    (gaps, whether the kernel's logits are finite)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T

    # the model calls the wrappers through the module ``ops``
    swapped = ["ssd_scan"] + (["flash_attention"]
                              if cfg.family == "hybrid" else [])
    chunk = cfg.ssm.chunk_size

    by_len = sorted(requests, key=lambda r: len(r.prompt_tokens))
    prompts = [r.prompt_tokens for r in by_len[:2] + by_len[-2:]]
    lens = [len(p) for p in prompts]
    if max(lens) <= chunk:
        raise AssertionError(f"{cfg.arch_id}: no prompt of {lens} tokens "
                             f"spans two SSD chunks of {chunk}")

    def first_logits(prompt, impl, index):
        out, _ = T.prefill(params, cfg,
                           {"tokens": torch.as_tensor([prompt],
                                                      device=DEVICE)},
                           T.init_cache(cfg, 1, MAX_LEN, DEVICE),
                           attn_impl=impl,
                           last_index=torch.as_tensor([index], device=DEVICE))
        return out.float()

    gaps = {"plain": 0.0, "plain_kernels": 0.0, "plain_kernels_at_chunk": 0.0}
    finite, scale = True, 0.0
    kernels = {name: getattr(ops, name) for name in swapped}
    for prompt in prompts:
        at = {"plain_kernels": len(prompt) - 1}
        if at_chunk and len(prompt) > chunk:
            at["plain_kernels_at_chunk"] = chunk
        for key, index in at.items():
            got = first_logits(prompt, "kernel", index)
            finite &= bool(torch.isfinite(got).all())
            scale = max(scale, float(got.abs().max()))
            if key == "plain_kernels":
                gaps["plain"] = max(gaps["plain"], float(
                    (got - first_logits(prompt, "torch", index)).abs().max()))
            for name in swapped:
                setattr(ops, name, getattr(ref, name))
            try:
                want = first_logits(prompt, "kernel", index)
            finally:
                for name, fn in kernels.items():
                    setattr(ops, name, fn)
            gaps[key] = max(gaps[key], float((got - want).abs().max()))
    at_pos = (f" and {gaps['plain_kernels_at_chunk']:.4e} at position "
              f"{chunk}" if at_chunk else "")
    log(f"[parity] {cfg.arch_id} {cfg.dtype}, full width, {cfg.n_layers} "
        f"layers: first prefill logits of prompts of {lens} tokens, max "
        f"|kernel - plain engine| = {gaps['plain']:.4e}, max |kernel - the "
        f"plain {' and '.join(swapped)} on the kernels' inputs| = "
        f"{gaps['plain_kernels']:.4e} at the last position{at_pos} (tol "
        f"{RECURRENT_LOGIT_TOL[cfg.family, cfg.dtype]}), max |logit| = "
        f"{scale:.3f}, finite={finite}")
    return gaps, finite


def recurrent_logit_failures(cfg, gaps, finite):
    """What of :func:`ssm_prefill_logit_gaps`' result fails its limit
    (``RECURRENT_LOGIT_TOL``): a list of reasons, empty when it passes."""
    tol = RECURRENT_LOGIT_TOL[cfg.family, cfg.dtype]
    gap = max(gaps["plain_kernels"], gaps["plain_kernels_at_chunk"])
    if finite and gap <= tol:
        return []
    return [f"{cfg.dtype} prefill logits of {cfg.n_layers} layers, kernel - "
            f"plain kernels = {gap:.4e} (tol {tol}), finite={finite}"]


def planted_fault(kind: str, models) -> dict:
    """Build the kernels from a temporary copy of ``csrc`` carrying the
    fault ``kind`` and run every comparison of phases 3 and 5 against it,
    for each (cfg, params, requests) of ``models``; returns how many of
    them caught the fault."""
    import tempfile

    from repro_torch.kernels import build

    work = Path(tempfile.mkdtemp(prefix="planted-fault-"))
    saved = build.CSRC, build.BUILD_DIR
    try:
        shutil.copytree(build.CSRC, work / "csrc")
        for src, pattern, repl in PLANTED_FAULTS[kind]:
            path = work / "csrc" / src
            text, n = re.subn(pattern, repl, path.read_text())
            if n == 0:
                raise AssertionError(f"{kind}: nothing to change in {src}")
            path.write_text(text)
        build.CSRC, build.BUILD_DIR = work / "csrc", work / "build"
        build._loaded.clear()
        t0 = time.perf_counter()
        build.build_all()
        log(f"[fault] {kind}: kernels built from a faulty copy of csrc in "
            f"{time.perf_counter() - t0:.1f} s")
        rows, failures = check_kernels(timed=False)
        caught = {}
        for name, rr in rows.items():
            for dn in TOL:
                # the rows at another arch's widths (zamba2-7b: D = 112,
                # (P, N) = (64, 64); qwen2-vl-7b: GQA 28/4; whisper: D =
                # 64, MHA; the MoE pods' ranks) are tallied apart
                for arch in ("", HY_ARCH, VL_ARCH, AU_ARCH,
                             *(a for a, _, _ in MOE_TP_SHAPES),
                             SSM_TP_TAG, HY_TP_TAG, VL_TP_TAG, AU_TP_TAG):
                    rs = [r for r in rr if r["dtype"] == dn
                          and r.get("arch", "") == arch]
                    if rs:
                        caught[f"{name} {dn}{' ' + arch if arch else ''}"] = {
                            "caught": sum(not r["tol_share"] <= 1.0
                                          for r in rs),
                            "cases": len(rs),
                            "tol_shares": [r["tol_share"] for r in rs]}
        served = {}
        for cfg, params, requests in models:
            if cfg.family == "audio":
                gap, finite = audio_logit_gap(cfg, params)
                served[cfg.arch_id] = {
                    "greedy_fp32_caught": not audio_greedy_parity(cfg),
                    "logit_gaps_bf16": {"plain": gap},
                    "logit_tol_bf16": AU_LOGIT_TOL_BF16,
                    "logit_caught": not (finite
                                         and gap <= AU_LOGIT_TOL_BF16)}
                continue
            greedy_same = greedy_parity(
                cfg, requests,
                depth=HY_PARITY_DEPTH if cfg.family == "hybrid" else 2)
            if cfg.family in ("ssm", "hybrid"):
                gaps, finite = ssm_prefill_logit_gaps(cfg, params, requests)
                bad = recurrent_logit_failures(cfg, gaps, finite)
            else:
                gap, finite = prefill_logit_gap(cfg, params, requests)
                gaps = {"plain": gap}
                bad = [] if finite and gap <= LOGIT_TOL_BF16 else [gap]
            served[cfg.arch_id] = {
                "greedy_fp32_caught": not greedy_same,
                "logit_gaps_bf16": gaps, "logit_caught": bool(bad)}
            if cfg.family == "hybrid":
                cfg32, params32 = fp32_model(cfg, HY_PARITY_DEPTH)
                gaps32, finite32 = ssm_prefill_logit_gaps(
                    cfg32, params32, requests, at_chunk=True)
                del params32
                served[cfg.arch_id].update(
                    logit_gaps_fp32=gaps32,
                    logit_fp32_caught=bool(recurrent_logit_failures(
                        cfg32, gaps32, finite32)))
            if cfg.family == "dense":
                gap8, _, finite8 = int8_logit_gaps(cfg, params)
                served[cfg.arch_id].update(
                    int8_greedy_fp32_caught=not int8_greedy_parity(cfg),
                    int8_logit_gap_bf16=gap8,
                    int8_logit_tol_bf16=INT8_LOGIT_TOL_BF16,
                    int8_logit_caught=not (finite8
                                           and gap8 <= INT8_LOGIT_TOL_BF16))
    finally:
        build.CSRC, build.BUILD_DIR = saved
        build._loaded.clear()
        shutil.rmtree(work, ignore_errors=True)
    return {"planted_fault": kind, "kernel_checks": caught, **served}


@contextlib.contextmanager
def rank_local_norm():
    """The planted TP fault ``rank_local_norm``, in memory: each rank of a
    pod normalises its heads' y over its own slice of ``d_inner``, the
    Mamba2 block's gated norm without the cross-rank sum of squares."""
    from repro_torch.models import ssm as S

    right = S.gated_partials

    def faulty(ps, cfg, ys, zs):
        return [right([p], cfg, [y], [z])[0] for p, y, z in zip(ps, ys, zs)]

    S.gated_partials = faulty
    try:
        yield
    finally:
        S.gated_partials = right


@contextlib.contextmanager
def mrope_rank0_only():
    """The planted TP fault ``mrope_rank0_only``, in memory: only rank 0 of
    a pod rotates its heads by the prompt's (3, B, S) M-RoPE positions;
    the other ranks get the 2-D text positions (0 .. S - 1 on all three
    axes), as a prefill without ``positions`` gives them."""
    import torch

    from repro_torch.models import transformer as T

    right = T._rank_cos_sins

    def faulty(cfg, pos, ranks):
        out = right(cfg, pos, ranks)
        if pos.ndim == 3:
            b, s = pos.shape[1:]
            text = torch.arange(s, device=pos.device).expand(b, s)
            out[1:] = right(cfg, text, ranks[1:])
        return out

    T._rank_cos_sins = faulty
    try:
        yield
    finally:
        T._rank_cos_sins = right


@contextlib.contextmanager
def cross_rank_local():
    """The planted TP fault ``cross_rank_local``, in memory: each rank of
    an audio pod adds only its own heads' cross-attention output to its
    residual stream, the ranks' ``wo`` partials never summed."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    right = T._cross_mlp

    def faulty(cfg, lcfgs, lps, hs, crosses, moe_impl, rows=None):
        hs = [h + L.cross_attention_block(
            lp["cross"], lc, L.apply_norm(cfg, lp["cross_norm"], h), kv)
            for lp, lc, h, kv in zip(lps, lcfgs, hs, crosses)]
        return T._mlp(cfg, lcfgs, lps, hs, moe_impl, rows=rows)

    T._cross_mlp = faulty
    try:
        yield
    finally:
        T._cross_mlp = right


#: phase 13's in-memory pod faults for ``--planted-fault``; each raises
#: nothing, and phase 13's fp32 checks must catch it
POD_FAULTS = {"mrope_rank0_only": mrope_rank0_only,
              "cross_rank_local": cross_rank_local}


def tp_planted_fault(cfg, params, requests) -> dict:
    """``drop_rank_partial``: leave the last rank's attention output (its
    ``wo`` partial) out of every layer's sum in the TP model, in prefill and
    decode, and run phase 5's TP=2 comparisons against it; returns whether
    each caught the fault."""
    import itertools

    import torch

    from repro_torch.models import layers as L

    block, decode = L.attention_block, L.attention_decode
    calls = itertools.count()

    def faulty_block(p, lcfg, *args, **kw):
        out, kv = block(p, lcfg, *args, **kw)
        # the TP prefill calls each layer's ranks in order
        if lcfg.n_heads < cfg.n_heads and next(calls) % TP == TP - 1:
            out = torch.zeros_like(out)
        return out, kv

    def faulty_decode(*args, **kw):
        outs = decode(*args, **kw)
        if len(outs) > 1:
            outs[-1] = torch.zeros_like(outs[-1])
        return outs

    L.attention_block, L.attention_decode = faulty_block, faulty_decode
    try:
        greedy_same = greedy_parity(cfg, requests, (tp_mesh(),))
        gap, finite = prefill_logit_gap(cfg, params, requests, tp_mesh())
    finally:
        L.attention_block, L.attention_decode = block, decode
    return {"planted_fault": "drop_rank_partial",
            "greedy_fp32_caught": not greedy_same,
            "logit_gap_bf16": gap, "logit_tol_bf16": TP_LOGIT_TOL_BF16,
            "logit_caught": not (finite and gap <= TP_LOGIT_TOL_BF16)}


# --------------------------------------------------------------------------- #
# Phase 6: the serve CLI (launch/serve.py) at full width
# --------------------------------------------------------------------------- #

#: traffic that queues and preempts on one card: 24 requests at 4 req/s
#: (Gamma arrivals) with outputs up to 128 tokens, against 4 slots that
#: serve far fewer requests a second at full width
CLI_QUEUE = ["--slots", "4", "--window", "8", "--n", "24", "--rate", "4",
             "--max-output", "128", "--seed", "0"]
#: the depth phases 6 and 7 serve qwen2-1.5b at (full width, 7 of its
#: 28 layers): cut to 14 for the script's time once phase 16 took it to
#: 1099 s of its 1200 on an H100 with a slow host, and phase 7's two
#: ranked runs too once phase 17 took it to 1106 s (they ran all 28, so
#: their JCT was not comparable with phase 6's oracle ISRTF runs); cut to
#: 7 once phase 20 took it to 1169.8 s on a slow host; phase 4 serves all
#: 28
CLI_DEPTH = 7
#: the depth of the pod CLI runs of phases 11 (qwen2-moe-a2.7b) and 12
#: (mamba2-130m): 3 layers, cut from their served depth of 12 to 6 for the
#: script's time once phase 17 took it to 1106 s on a slow host, and to 3
#: once phase 20 took it to 1169.8 s
POD_CLI_DEPTH = 3
#: the runs of phase 6, in order: serve.py's defaults, then ISRTF and FCFS
#: on the same arrivals (isrtf, fcfs, fcfs, isrtf), then ISRTF with chunked
#: prefill and swap preemption, and with the ``auto`` break-even after a
#: live probe of the node's token cost
CLI_RUNS = [
    ("defaults", ["--n", "12"]),
    ("isrtf", CLI_QUEUE + ["--policy", "isrtf"]),
    ("fcfs", CLI_QUEUE + ["--policy", "fcfs"]),
    ("fcfs", CLI_QUEUE + ["--policy", "fcfs"]),
    ("isrtf", CLI_QUEUE + ["--policy", "isrtf"]),
    ("isrtf chunk+swap", CLI_QUEUE + ["--policy", "isrtf",
                                      "--prefill-chunk", "8",
                                      "--preempt-policy", "swap"]),
    ("isrtf auto+probe", CLI_QUEUE + ["--policy", "isrtf",
                                      "--preempt-policy", "auto",
                                      "--probe-nodes", "2"]),
]


def cli_run(name: str, argv, predictor_probe=None, after=None, depth=None):
    """Run ``repro_torch.launch.serve.main(argv)`` in this process with
    every launch count set to 0 just before and read just after; check
    it as :func:`check_served` does.  ``predictor_probe``, when given, is
    called on the predictor the CLI builds, before it serves; ``after``
    on the executor it served with, after the check; ``depth`` cuts the
    arch to that many layers.  Returns the run's numbers."""
    import contextlib
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as cli

    argv = list(argv) + ["--device", DEVICE]
    args = cli._parser().parse_args(argv)
    want_tokens = {r.request_id: min(r.true_output_len, args.max_output)
                   for r in cli.load_requests(args)[0]}
    out, err = io.StringIO(), io.StringIO()
    build_predictor, get_config = cli.build_predictor, cli.get_config
    if depth is not None:
        cli.get_config = lambda arch: dataclasses.replace(
            get_config(arch), n_layers=depth)
    if predictor_probe is not None:
        def probed(*a):
            pred = build_predictor(*a)
            predictor_probe(pred)
            return pred
        cli.build_predictor = probed
    ops.reset_launches()
    synchronize_all()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            responses, executor = cli.main(argv)
    finally:
        cli.build_predictor, cli.get_config = build_predictor, get_config
    synchronize_all()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    if len(lines) != len(want_tokens):
        raise AssertionError(f"serve CLI run {name!r}: {len(lines)} request "
                             f"lines, want {len(want_tokens)}")
    probe_windows = probe_steps = 0
    if args.probe_nodes:
        per = (args.probe_nodes + 1) * len({1, min(2, args.slots)})
        probe_windows = per * len(cli.PROBE_WINDOWS)
        probe_steps = per * sum(cli.PROBE_WINDOWS)
    run = check_served(name, responses, executor, want_tokens, launches,
                       wall, probe_windows, probe_steps)
    log(f"[cli]   (python -m repro_torch.launch.serve {' '.join(argv)})")
    for ln in err.getvalue().splitlines():
        log(f"[cli]   {ln}")
    if after is not None:
        after(executor)
    del responses, executor
    gc.collect()
    if DEVICE != "cpu":
        import torch
        torch.cuda.empty_cache()
    return run


def check_served(name, responses, executor, want_tokens, launches, wall,
                 probe_windows=0, probe_steps=0) -> dict:
    """Check one served run: every request finished with
    ``min(true_output_len, max_output)`` tokens (``want_tokens``) and the
    kernels ran as often as the engine's dispatches say (a chunk of a
    chunked prefill launches nothing: it attends with the plain ``sdpa``,
    as the reference does).  Logs and returns the run's numbers."""
    from repro_torch.core import summarize

    bad = [(r.request_id, r.status.value, r.n_tokens,
            want_tokens.get(r.request_id)) for r in responses
           if not r.ok or r.n_tokens != want_tokens.get(r.request_id)]
    if bad or len(responses) != len(want_tokens):
        raise AssertionError(f"serve run {name!r}: requests not served "
                             f"as expected: {bad}")
    # a window decodes iff it emits tokens (every decoding job emits at
    # least one); the others only ran a prefill chunk
    decoding = [rec for rec in executor.window_log if rec["tokens"] > 0]
    steps = sum(rec["window"] for rec in decoding)
    counters = executor.counters()
    if counters["decode_dispatches"] != len(decoding) + probe_windows:
        raise AssertionError(
            f"serve run {name!r}: {counters['decode_dispatches']} decode "
            f"dispatches, but {len(decoding)} windows emitted tokens and "
            f"{probe_windows} probe windows ran")
    eng = executor.engines[0]
    tp = 1 if eng.mesh is None else len(eng.mesh.ranks)
    decode = "flash_decode" if tp == 1 else "flash_decode_sharded"
    prefills = counters["prefill_dispatches"]
    want = path_launches(eng.model_cfg, tp, prefills, steps + probe_steps,
                         f" ({probe_steps} of them probes)"
                         if probe_steps else "")
    check_launches(launches, want)
    m = summarize(responses)
    n_tok = sum(r.n_tokens for r in responses)
    busy = sum(rec["duration_s"] for rec in executor.window_log)
    run = {"name": name, "jct_mean": m["jct_mean"], "jct_p99": m["jct_p99"],
           "queue_mean": m["queuing_delay_mean"],
           "preemptions": m["preemptions"], "tokens": n_tok,
           "tokens_s": n_tok / m["makespan"], "wall_s": wall,
           "launches": launches, "counters": counters}
    log(f"[cli] {name}: {len(responses)}/{len(want_tokens)} requests "
        f"FINISHED with the expected token counts; JCT mean "
        f"{m['jct_mean']:.3f} s, p99 {m['jct_p99']:.3f} s; queueing delay "
        f"mean {m['queuing_delay_mean']:.3f} s; preemptions "
        f"{m['preemptions']}; {n_tok} tokens over a {m['makespan']:.3f} s "
        f"serving makespan = {run['tokens_s']:.1f} tokens/s "
        f"({n_tok / busy:.1f} over the {busy:.3f} s of windows); swapouts "
        f"{counters['swapouts']}, swapins {counters['swapins']}, chunk "
        f"dispatches {counters['chunk_dispatches']}, resume prefill tokens "
        f"{counters['resume_context_tokens']}; {decode} "
        f"{launches[decode]}, flash_attention "
        f"{launches['flash_attention']}, ssd_scan {launches['ssd_scan']}; "
        f"{wall:.1f} s wall")
    return run


def serve_cli_phase() -> dict:
    """Phase 6: drive ``repro_torch.launch.serve.main`` through
    :data:`CLI_RUNS` and check what they must show: ISRTF preempts, the
    swap run swaps out and in and runs prefill chunks; print ISRTF's and
    FCFS's mean JCT and their ratio.  Returns the phase's launch counts,
    summed over its runs, and the ISRTF runs' mean JCTs."""
    runs = [cli_run(name, argv, depth=CLI_DEPTH) for name, argv in CLI_RUNS]
    by = {}
    for r in runs:
        by.setdefault(r["name"], []).append(r)
    isrtf = [r["jct_mean"] for r in by["isrtf"]]
    fcfs = [r["jct_mean"] for r in by["fcfs"]]
    ratio = (sum(isrtf) / len(isrtf)) / (sum(fcfs) / len(fcfs))
    log(f"[cli] same arrivals ({' '.join(CLI_QUEUE)}), in the order isrtf, "
        f"fcfs, fcfs, isrtf: ISRTF mean JCT {isrtf} s, FCFS {fcfs} s; "
        f"ISRTF/FCFS = {ratio:.4f}; ISRTF preemptions "
        f"{[r['preemptions'] for r in by['isrtf']]}, tokens/s "
        f"{[round(r['tokens_s'], 1) for r in by['isrtf']]} (FCFS "
        f"{[round(r['tokens_s'], 1) for r in by['fcfs']]})")
    if not all(r["preemptions"] > 0 for r in by["isrtf"]):
        raise AssertionError("serve CLI: ISRTF never preempted: the "
                             "traffic does not queue")
    swap = by["isrtf chunk+swap"][0]["counters"]
    if not (swap["swapouts"] > 0 and swap["swapins"] > 0
            and swap["chunk_dispatches"] > 0):
        raise AssertionError(f"serve CLI: the chunk+swap run did not swap "
                             f"out, swap in and chunk: {swap}")
    total = {}
    for r in runs:
        for n, c in r["launches"].items():
            total[n] = total.get(n, 0) + c
    if not (total["flash_decode"] > 0 and total["flash_attention"] > 0):
        raise AssertionError(f"serve CLI: a kernel never launched: {total}")
    log(f"[cli] launches over the phase: {json.dumps(total)}")
    return {"launches": total, "isrtf_jct": isrtf}


# --------------------------------------------------------------------------- #
# Phase 7: the BGE length predictor, its training, ISRTF ranked by it
# --------------------------------------------------------------------------- #

#: the full-width predictor's encoder (None: ``BGE_BASE``, bge-base-en-v1.5;
#: a CPU rehearsal may give a smaller ``EncoderArchConfig``)
PREDICTOR_ENCODER = None
#: pools timed at sequence bucket 512 (the full width's max_len)
PREDICTOR_POOLS = (1, 8, 32, 128)
#: fit steps of the full-width predictor at 32 x 512
FULL_FIT_STEPS = 20
#: the CLI predictor's training: examples/train_predictor.py's recipe
CLI_FIT = dict(requests=1200, max_len=192, max_steps=6, batch=32,
               steps=600)
#: card against CPU, the full-width predictor's means and rank scores:
#: both are fp32 (TF32 off), so they differ by order of summation through
#: 12 post-LN layers and 8 FC layers, amplified by the heads' exp; 1e-3 of
#: a prediction is a tenth of a token at ~100 tokens, far below the 50-token
#: window that ISRTF's ranking resolves
PREDICTOR_RTOL = 1e-3


class DispatchTimer:
    """Times every dispatch of a BGE predictor: CUDA events around its
    kernels (the device time) and the host clock around the whole call,
    which returns host numbers (what a scheduling window waits for); and
    the distinct dispatch shapes.  Its share of a run's wall time counts
    the online head updates too, where a ranked adapter makes them."""

    def __init__(self, pred):
        import torch

        self.device_ms, self.wall_ms, self.shapes = [], [], set()
        #: host time of the ranked adapter's online head updates
        self.update_ms = []
        apply, predict = pred._apply, pred.predict

        def timed_apply(params, tokens, mask):
            self.shapes.add(tokens.shape)
            if DEVICE == "cpu":
                return apply(params, tokens, mask)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = apply(params, tokens, mask)
            end.record()
            self._events = (start, end)
            return out

        def timed_predict(jobs):
            t0 = time.perf_counter()
            out = predict(jobs)
            self.wall_ms.append((time.perf_counter() - t0) * 1e3)
            if DEVICE != "cpu":
                start, end = self._events
                end.synchronize()
                self.device_ms.append(start.elapsed_time(end))
            return out

        pred._apply, pred.predict = timed_apply, timed_predict

    def summary(self, wall_s: float) -> dict:
        import statistics

        dev = self.device_ms or [float("nan")]
        return {"dispatches": len(self.wall_ms),
                "device_ms_median": statistics.median(dev),
                "device_ms_mean": sum(dev) / len(dev),
                "wall_ms_mean": sum(self.wall_ms) / max(len(self.wall_ms), 1),
                "updates": len(self.update_ms),
                "update_ms_mean": (sum(self.update_ms)
                                   / max(len(self.update_ms), 1)),
                "share_of_wall": (sum(self.wall_ms) + sum(self.update_ms))
                / 1e3 / wall_s,
                "shapes": sorted(self.shapes)}


def predictor_flops(cfg, batch: int, seq: int) -> float:
    """Flops of one dispatch over a (batch, seq) bucket: the encoder's
    projections, attention products and MLP per token, and the heads per
    row (multiply-adds count two)."""
    e = cfg.encoder
    per_token = e.n_layers * (2 * (4 * e.d_model ** 2 + 2 * e.d_model * e.d_ff)
                              + 2 * 2 * seq * e.d_model)
    heads = 2 if cfg.ranking is not None else 1
    head = 2 * (2 * e.d_model * cfg.fc_hidden
                + (cfg.n_fc_layers - 2) * cfg.fc_hidden ** 2
                + cfg.fc_hidden)
    return batch * seq * per_token + heads * batch * head


def event_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median time of ``fn()`` (which returns host data) over ``reps``
    calls: CUDA events on the card, the host clock in a CPU rehearsal."""
    import statistics

    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if DEVICE == "cpu":
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def predictor_jobs(n: int, lengths, vocab: int, seed: int):
    """``n`` jobs whose inputs are ``lengths`` ids long in all (prompt and
    generated split in two), with generated ids past ``vocab`` (the
    engine's qwen2-1.5b ids reach 151935)."""
    import numpy as np

    from repro_torch.core import Job

    rng = np.random.RandomState(seed)
    jobs = []
    for i in range(n):
        total = int(lengths[i % len(lengths)])
        p = max(total // 2, 1)
        j = Job(job_id=i, prompt="", arrival_time=0.0,
                prompt_tokens=rng.randint(8, vocab, size=p).tolist())
        j.generated = rng.randint(8, 151936, size=max(total - p - 2, 0)
                                  ).tolist()
        jobs.append(j)
    return jobs


def predictor_parity(pred, cpu) -> dict:
    """The full-width predictor on the card against its CPU copy: a pool
    of 5 (batch bucket 8) and each job alone; ids past the vocabulary."""
    import numpy as np

    jobs = predictor_jobs(5, (24, 90, 150, 300, 510), 30522, SEED)
    got = pred.predict(jobs)
    want = cpu.predict(jobs)
    alone = [pred.predict([j])[0] for j in jobs]
    vals = lambda ps: np.array([[p.mean, p.rank_score] for p in ps])
    g, w, a = vals(got), vals(want), vals(alone)
    if not np.isfinite(g).all():
        raise AssertionError(f"predictor: non-finite predictions {g}")
    err = float(np.max(np.abs(g - w) / np.abs(w)))
    err_alone = float(np.max(np.abs(a - g) / np.abs(g)))
    log(f"[predictor] full width, card vs CPU: pool of 5 (batch bucket 8, "
        f"seq bucket 512), means {g[:, 0].round(3).tolist()}, rank scores "
        f"{g[:, 1].round(3).tolist()}; max relative error {err:.3e} "
        f"(limit {PREDICTOR_RTOL}); each job alone vs in the pool "
        f"{err_alone:.3e}")
    if not (err <= PREDICTOR_RTOL and err_alone <= PREDICTOR_RTOL):
        raise AssertionError("predictor: the card disagrees with the CPU "
                             "or padding is not inert")
    return {"max_rel_err": err, "alone_rel_err": err_alone}


def predictor_dispatch_times(pred, small) -> list:
    """Full-width dispatches over pools at sequence bucket 512, each
    against its flop bound (fp32 on the CUDA cores), and the CLI's small
    predictor at a pool of 32."""
    rows = []
    for p, n in [(pred, n) for n in PREDICTOR_POOLS] + [(small, 32)]:
        ml = p.cfg.max_len
        lists = [[8 + (i * 7 + t) % 30000 for t in range(ml)]
                 for i in range(n)]
        ms = event_ms(lambda: p.predict_tokens_ranked(lists)
                      if p.cfg.ranking is not None
                      else p.predict_tokens(lists))
        flops = predictor_flops(p.cfg, n, ml)
        bound = flops / PEAK_FLOPS["float32"] * 1e3
        rows.append({"pool": n, "seq": ml, "d_model": p.cfg.encoder.d_model,
                     "ms": ms, "bound_ms": bound, "tflop": flops / 1e12})
        log(f"[predictor] dispatch, d_model {p.cfg.encoder.d_model} x "
            f"{p.cfg.encoder.n_layers} layers, pool {n} x seq {ml}: "
            f"{ms:.3f} ms (median of 5, CUDA events around the call) "
            f"against a bound of {bound:.3f} ms ({flops / 1e12:.3f} TFLOP "
            f"at {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s)")
    return rows


def fit_step_parity(pred, cpu, samples) -> None:
    """One training step at a reduced batch on the card and on the CPU
    from the same parameters: loss and parameters allclose."""
    import numpy as np

    from repro_torch.data import pad_batch
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    from repro_torch.training.tree import leaves

    opt = AdamWConfig(lr=pred.cfg.lr, warmup_steps=1, total_steps=10)
    batch = pad_batch(samples[:2], pred.cfg.max_len)
    out = []
    for p in (pred, cpu):
        step = make_train_step(p.loss_fn, opt)
        params, _, m = step(p.params, adamw_init(p.params), batch)
        out.append(([t.detach().cpu().numpy() for t in leaves(params)],
                    {k: float(v) for k, v in m.items()}))
    (gp, gm), (wp, wm) = out
    # from a zero state one AdamW step moves every trainable element by lr
    # times the sign of its gradient (plus decay), so an element whose
    # gradient is at rounding level may step either way: 2 lr apart
    atol = 2.0 * opt.lr
    perr = max(float(np.max(np.abs(a - b))) for a, b in zip(gp, wp))
    lerr = abs(gm["loss"] - wm["loss"]) / abs(wm["loss"])
    log(f"[predictor] one fit step at 2 x {pred.cfg.max_len}, card vs CPU: "
        f"loss {gm['loss']:.6f} vs {wm['loss']:.6f} (relative {lerr:.2e}), "
        f"grad norm {gm['grad_norm']:.6f} vs {wm['grad_norm']:.6f}, "
        f"params max |diff| {perr:.3e} (limit {atol:.1e})")
    if not (lerr <= 1e-4 and perr <= atol):
        raise AssertionError("predictor: a training step on the card "
                             "disagrees with the CPU")


def train_cli_predictor(small, ckpt_dir: str) -> dict:
    """The CLI's predictor trained on the card by
    examples/train_predictor.py's recipe and checkpointed; Table 2's
    metrics (and Kendall-tau) on the test split before and after."""
    from repro_torch.data import make_predictor_dataset
    from repro_torch.training import save_checkpoint

    c = CLI_FIT
    train, val, test = make_predictor_dataset(
        c["requests"], seed=0, max_len=c["max_len"], max_steps=c["max_steps"])
    before = small.evaluate(test)
    t0 = time.perf_counter()
    hist = small.fit(train, num_steps=c["steps"], batch_size=c["batch"])
    fit_s = time.perf_counter() - t0
    after = small.evaluate(test)
    last = hist[c["steps"] - 1]
    step_ms = ((last["wall_s"] - hist[0]["wall_s"]) / (c["steps"] - 1)
               * 1e3)
    path = save_checkpoint(ckpt_dir, c["steps"], small.params,
                           metadata={"metrics": after})
    fmt = lambda m: ", ".join(f"{k} {v:.4f}" for k, v in m.items())
    log(f"[predictor] CLI predictor ({len(train)} train / {len(val)} val / "
        f"{len(test)} test samples): {c['steps']} steps at {c['batch']} x "
        f"{c['max_len']} in {fit_s:.1f} s ({step_ms:.2f} ms a step); test "
        f"before: {fmt(before)}; after: {fmt(after)}; loss "
        f"{hist[0]['loss']:.4f} -> {last['loss']:.4f}; checkpoint {path}")
    if not (after["mae"] < before["mae"]):
        raise AssertionError("predictor: training did not lower the MAE")
    return {"before": before, "after": after, "step_ms": step_ms}


def ranked_server_run(pred) -> dict:
    """(b): an ``ElisServer`` of full-width qwen2-1.5b at ``CLI_DEPTH``
    layers (bf16, the kernels) over ``CLI_QUEUE``'s traffic, ISRTF ordered
    by the ranking head of the full-width two-head predictor (ranked
    adapter, ``ema+conformal``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import (ElisServer, FrontendConfig,
                                  PreemptionConfig, SchedulerConfig,
                                  make_predictor)
    from repro_torch.engine import EngineConfig, EngineExecutor, InferenceEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as cli
    from repro_torch.models import transformer as T

    args = cli._parser().parse_args(CLI_QUEUE + ["--device", DEVICE])
    requests = cli.load_requests(args)[0]
    want_tokens = {r.request_id: min(r.true_output_len, args.max_output)
                   for r in requests}
    cfg = get_config("qwen2-1.5b")
    cfg = (cfg.reduced() if DEVICE == "cpu"
           else dataclasses.replace(cfg, n_layers=CLI_DEPTH))
    params = T.init_params(cfg, torch.Generator(DEVICE).manual_seed(0))
    engine = InferenceEngine(cfg, params, EngineConfig(
        max_slots=args.slots, max_len=512, max_output=args.max_output,
        eos_id=-1, respect_job_max=True, attn_impl="kernel"), device=DEVICE)
    executor = EngineExecutor({0: engine})
    timer = DispatchTimer(pred)
    ranked = make_predictor("ranked", bge=pred, calibration="ema+conformal")
    adapter = ranked.base.base
    update = adapter._update_heads

    def timed_update():
        t0 = time.perf_counter()
        update()
        synchronize_all()
        timer.update_ms.append((time.perf_counter() - t0) * 1e3)
    adapter._update_heads = timed_update
    server = ElisServer(FrontendConfig(
        n_nodes=1,
        scheduler=SchedulerConfig(policy="isrtf", window=args.window,
                                  batch_size=args.slots,
                                  rank_by="rank_score"),
        preemption=PreemptionConfig(enabled=True),
        observe_in_flight=False), ranked, executor)
    for r in requests:
        server.submit(r)
    ops.reset_launches()
    synchronize_all()
    t0 = time.perf_counter()
    responses = server.drain()
    synchronize_all()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    run = check_served("isrtf, full-width two-head predictor, rank_score",
                       responses, executor, want_tokens, launches, wall)
    run["predictor"] = timer.summary(wall)
    run["n_updates"] = adapter.n_updates
    run["max_pool"] = len(requests)
    del responses, executor, engine, params, server
    return run


def predictor_phase(oracle_isrtf_jct) -> dict:
    """Phase 7: the BGE predictor at full width (card against CPU,
    dispatch times, training), the CLI's predictor trained and restored
    by ``--predictor-ckpt``, and ISRTF served ranked by each."""
    import torch

    from repro_torch.core import BGEPredictor, PredictorConfig, RankingConfig
    from repro_torch.data import make_predictor_dataset, n_shape_buckets
    from repro_torch.launch import serve as cli
    from repro_torch.models import encoder as E
    from repro_torch.training.tree import leaves, tree_map

    t_phase = time.perf_counter()
    enc = PREDICTOR_ENCODER or E.BGE_BASE
    cfg = PredictorConfig(encoder=enc, max_len=enc.max_len,
                          ranking=RankingConfig())
    pred = BGEPredictor(cfg, seed=SEED, device=DEVICE)
    cpu = BGEPredictor(cfg, seed=SEED, device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), pred.params)
    n_params = sum(t.numel() for t in leaves(pred.params))
    log(f"[predictor] two-head BGE predictor: encoder d_model {enc.d_model}, "
        f"{enc.n_heads} heads, {enc.n_layers} layers, d_ff {enc.d_ff}, vocab "
        f"{enc.vocab_size}, max_len {cfg.max_len}; heads {cfg.n_fc_layers} x "
        f"{cfg.fc_hidden}; {n_params / 1e6:.1f} M parameters, fp32, seed "
        f"{SEED}")
    out = {"parity": predictor_parity(pred, cpu)}
    small = cli.build_predictor(SimpleNamespace(
        predictor="bge", predictor_ckpt=None, calibrate="none"), DEVICE)
    out["dispatch"] = predictor_dispatch_times(pred, small)

    train, _, _ = make_predictor_dataset(600, seed=0, max_len=cfg.max_len)
    fit_step_parity(pred, cpu, train)
    del cpu
    gc.collect()
    hist = pred.fit(train, num_steps=FULL_FIT_STEPS, batch_size=32)
    last = hist[FULL_FIT_STEPS - 1]
    step_ms = (last["wall_s"] - hist[0]["wall_s"]) / (FULL_FIT_STEPS - 1) * 1e3
    bound = 3 * predictor_flops(cfg, 32, cfg.max_len) / PEAK_FLOPS[
        "float32"] * 1e3
    log(f"[predictor] full-width fit: {FULL_FIT_STEPS} steps at 32 x "
        f"{cfg.max_len}, {step_ms:.2f} ms a step (host clock between the "
        f"logged steps, which read the loss) against a bound of "
        f"{bound:.2f} ms (3x the forward's flops); loss {hist[0]['loss']:.4f}"
        f" -> {last['loss']:.4f}")
    if not all(math.isfinite(h["loss"]) for h in hist.values()):
        raise AssertionError("predictor: a fit loss is not finite")
    out["fit_step_ms"], out["fit_bound_ms"] = step_ms, bound

    ckpt = ROOT / "build" / "predictor_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    out["cli_training"] = train_cli_predictor(small, str(ckpt))
    del small

    # (a) the CLI: ISRTF ranked by the trained CLI predictor, restored
    timers = []
    run_a = cli_run("isrtf bge+ckpt ema+conformal",
                    CLI_QUEUE + ["--policy", "isrtf", "--predictor", "bge",
                                 "--predictor-ckpt", str(ckpt),
                                 "--calibrate", "ema+conformal"],
                    predictor_probe=lambda p: timers.append(
                        DispatchTimer(p.base.base)), depth=CLI_DEPTH)
    run_a["predictor"] = timers[0].summary(run_a["wall_s"])
    run_a["max_pool"] = int(CLI_QUEUE[CLI_QUEUE.index("--n") + 1])
    # (b) an ElisServer ranked by the full-width two-head predictor
    run_b = ranked_server_run(pred)
    if run_b["n_updates"] <= 0:
        raise AssertionError("predictor: the ranked adapter never updated "
                             "its heads online")
    oracle = sum(oracle_isrtf_jct) / len(oracle_isrtf_jct)
    for run, p in ((run_a, 192), (run_b, cfg.max_len)):
        s = run["predictor"]
        bound = n_shape_buckets(run["max_pool"], p)
        if not (s["dispatches"] > 0 and len(s["shapes"]) <= bound):
            raise AssertionError(f"predictor: {run['name']}: "
                                 f"{s['dispatches']} dispatches, shapes "
                                 f"{s['shapes']} (bound {bound})")
        log(f"[predictor] {run['name']}: JCT mean {run['jct_mean']:.3f} s, "
            f"p99 {run['jct_p99']:.3f} s, {run['tokens_s']:.1f} tokens/s, "
            f"preemptions {run['preemptions']}; predictor: "
            f"{s['dispatches']} dispatches over {len(s['shapes'])} shapes "
            f"(bound {bound}): {s['shapes']}, device time "
            f"{s['device_ms_median']:.3f} ms median ({s['device_ms_mean']:.3f}"
            f" mean) a dispatch, {s['wall_ms_mean']:.3f} ms on the host "
            f"clock; {s['updates']} online head updates of "
            f"{s['update_ms_mean']:.1f} ms; {100 * s['share_of_wall']:.2f}% "
            f"of the {run['wall_s']:.1f} s serving wall; mean JCT / phase "
            f"6's oracle ISRTF runs' "
            f"{run['jct_mean'] / oracle:.4f}")
    log(f"[predictor] (b) online head updates: {run_b['n_updates']}")
    out["runs"] = [run_a, run_b]
    # phase 15 (c) ranks Table 5's cell by this predictor
    out["pred"] = pred
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[predictor] phase 7 in {time.perf_counter() - t_phase:.1f} s")
    return out


def slot_rows(eng, job_id):
    """Copies of the job's slot rows of every rank's cache: [rank][leaf]."""
    import torch

    from repro_torch.engine.engine import _gather_slots, _leaves, _ranks

    rows = []
    for c in _ranks(eng.cache):
        idx = torch.tensor([eng.slot_of[job_id]], device=c["len"].device)
        rows.append([t.clone() for t in _leaves(_gather_slots(c, idx))])
    return rows


def swap_round_trip(eng, job, between) -> None:
    """Offload ``job`` to the host, run ``between()`` (which may overwrite
    its freed slot), restore it: every rank's slot rows must come back bit
    for bit."""
    import torch

    before = slot_rows(eng, job.job_id)
    if not eng.offload_job(job.job_id):
        raise AssertionError("swap round trip: offload refused")
    between()
    eng.restore_job(job)
    after = slot_rows(eng, job.job_id)
    if not (len(after) == len(before) and all(
            torch.equal(a, b) for ra, rb in zip(after, before)
            for a, b in zip(ra, rb))):
        raise AssertionError("swap round trip: a rank's restored slot rows "
                             "differ from the offloaded ones")


def swap_roundtrip(cfg, params, requests, mesh=None) -> None:
    """One slot's cache offloaded to the host and restored, at full width
    (on one TP pod with ``mesh``): bit for bit on every rank
    (:func:`swap_round_trip`), and the greedy streams of both jobs equal
    to those of an engine that keeps the job resident over the same
    schedule (the job sits out one window either way)."""
    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine

    prompts = [list(r.prompt_tokens) for r in requests[:2]]
    streams = []
    for swap in (True, False):
        eng = InferenceEngine(cfg, params, EngineConfig(
            max_slots=2, max_len=MAX_LEN, max_output=64, eos_id=-1),
            device=DEVICE, mesh=mesh)
        jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
                for i, p in enumerate(prompts)]

        def window(batch):
            toks, _ = eng.run_window(batch, 8)
            for j, t in zip(batch, toks):
                j.generated.extend(t)

        window(jobs)
        if swap:
            n_bytes = sum(t.numel() * t.element_size()
                          for rank in slot_rows(eng, 0) for t in rank)
            swap_round_trip(eng, jobs[0], lambda: window(jobs[1:]))
        else:
            window(jobs[1:])
        window(jobs)
        window(jobs)
        streams.append([list(j.generated) for j in jobs])
        del eng
    if streams[0] != streams[1]:
        raise AssertionError(f"swap round trip: streams differ from the "
                             f"resident engine's: {streams}")
    pod = "" if mesh is None else f" on a TP={len(mesh.ranks)} pod"
    log(f"[swap] {cfg.arch_id} {cfg.dtype}, full width, {cfg.n_layers} "
        f"layers{pod}: one slot's cache ({n_bytes / 1e6:.1f} MB, "
        f"{MAX_LEN} rows"
        f"{', its recurrent states too' if cfg.ssm.enabled else ''}) "
        f"offloaded to the host and "
        f"restored bit for bit; greedy streams of both jobs identical to a "
        f"resident engine's over the same schedule "
        f"({sum(map(len, streams[0]))} tokens)")


def chunk_parity(cfg, requests) -> None:
    """fp32 greedy tokens at full width and 2 layers: chunked prefill (8
    tokens a window, plain ``sdpa``) against one-shot prefill
    (``flash_attention``), identical on every token."""
    import torch

    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.models import transformer as T

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params2 = T.init_params(
        cfg2, torch.Generator(device=DEVICE).manual_seed(SEED + 1))
    prompts = [list(r.prompt_tokens)[:40] for r in requests[:4]]
    streams = []
    for chunk in (None, 8):
        eng = InferenceEngine(cfg2, params2, EngineConfig(
            max_slots=4, max_len=MAX_LEN, max_output=64, eos_id=-1),
            device=DEVICE)
        jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
                for i, p in enumerate(prompts)]
        while any(len(j.generated) < 16 for j in jobs):
            toks, _ = eng.run_window(jobs, 8, prefill_chunk=chunk)
            for j, t in zip(jobs, toks):
                j.generated.extend(t)
        streams.append([j.generated[:16] for j in jobs])
        chunks = eng.num_chunk_dispatches
    same = sum(a == b for g, w in zip(*streams) for a, b in zip(g, w))
    log(f"[parity] {cfg.arch_id} fp32, full width, 2 layers: chunked "
        f"prefill (chunk 8, {chunks} chunk dispatches) vs one-shot prefill "
        f"greedy tokens identical on {same}/{16 * len(prompts)} tokens")
    if streams[0] != streams[1]:
        raise AssertionError("chunked prefill: fp32 greedy tokens differ "
                             "from one-shot prefill's")


def build_report() -> None:
    """Log ptxas's registers and spills of every kernel instance, by
    kernel (demangled with ``c++filt`` where the machine has it)."""
    from repro_torch.kernels import build

    for name in build.SOURCES:
        entry, lines = "?", []
        for line in build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line:
                lines.append((entry, line.strip()))
        names = sorted({e for e, _ in lines})
        if shutil.which("c++filt") and names:
            out = subprocess.run(["c++filt"], input="\n".join(names),
                                 capture_output=True, text=True).stdout
            demangled = dict(zip(names, out.splitlines()))
        else:
            demangled = {}
        for entry, line in lines:
            short = re.sub(r"\(anonymous namespace\)::", "",
                           demangled.get(entry, entry)).split("(")[0]
            log(f"[build] {name}: {short}: {line}")


#: the decode kernel's denominator update as the compiler was left to
#: round it (fused in some group-size instances, not in others)
UNPINNED_L = (r"l\[h\] = __fmaf_rn\(l\[h\], alpha, p\);",
              "l[h] = l[h] * alpha + p;")


def rounding_scan(n: int) -> dict:
    """The decode kernel's cut GQA segments against one device in fp32,
    built as it is and from a copy of ``csrc`` whose denominator update
    the compiler may fuse or not (``UNPINNED_L``): over ``n`` draws of
    llama3.2-3b's TP=3 ranks (7 segment launches) and ``n // 6`` of
    qwen2-1.5b's TP=16 (one head a rank), how many differ from the
    single-device kernel and by how much (bf16 too), and the single-device
    decode's time at the served shape and decode_32k's 8 x 32768 (bf16,
    fp32, int8), each version timed twice, in the order as built,
    unpinned, unpinned, as built."""
    import tempfile

    import torch

    from repro_torch.kernels import build, ops
    from repro_torch.models.layers import quantize_kv

    saved = build.CSRC, build.BUILD_DIR
    work = Path(tempfile.mkdtemp(prefix="rounding-scan-"))
    shutil.copytree(build.CSRC, work / "csrc")
    path = work / "csrc" / "decode_attention.cu"
    text, k = re.subn(*UNPINNED_L, path.read_text())
    if k != 1:
        raise AssertionError("rounding scan: the denominator update not found")
    path.write_text(text)
    versions = {"as built": saved, "unpinned": (work / "csrc",
                                                work / "build")}

    def use(name):
        build.CSRC, build.BUILD_DIR = versions[name]
        build._loaded.clear()

    def scan(dtype, draws, widths, tp, seed0):
        qr, ranges, _, at = rank_shards(
            SimpleNamespace(n_heads=widths[0], n_kv_heads=widths[1]), tp)
        differ, gap = 0, 0.0
        for i in range(draws):
            g = torch.Generator(device="cuda").manual_seed(seed0 + i)
            q, kk, v, kv_len, q_off = decode_case(4, dtype, g, widths)
            kw = dict(kv_len=kv_len, q_offset=q_off)
            qs = [q[:, :, a:b].contiguous() for a, b in qr]
            ks, vs = ([x[:, :, lo:hi].contiguous() for lo, hi in ranges]
                      for x in (kk, v))
            d = float((torch.cat(ops.flash_decode_sharded(
                qs, ks, vs, **kw, **at), dim=2).float()
                - ops.flash_decode(q, kk, v, **kw).float()).abs().max())
            differ += d > 0
            gap = max(gap, d)
        return {"differ": differ, "of": draws, "max_gap": gap}

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = {f"{dn} B=4 L={MAX_LEN}": decode_case(4, dt, gen)
             for dn, dt in (("bf16", torch.bfloat16),
                            ("fp32", torch.float32))}
    cases.update({f"{dn} B={LONG_B} L={LONG_L}": long_decode_case(dt, gen)
                  for dn, dt in (("bf16", torch.bfloat16),
                                 ("fp32", torch.float32))})
    q, kk, v, kv_len, q_off = cases[f"bf16 B={LONG_B} L={LONG_L}"]
    (kq, ksc), (vq, vsc) = quantize_kv(kk), quantize_kv(v)
    out = {}
    try:
        use("unpinned")
        t0 = time.perf_counter()
        build.build_all(("decode_attention",))
        log(f"[rounding] the unpinned decode kernel built in "
            f"{time.perf_counter() - t0:.1f} s")
        for name in ("as built", "unpinned", "unpinned", "as built"):
            use(name)
            r = out.setdefault(name, {"ms": {}})
            if "fp32 llama3.2-3b TP=3" not in r:
                r["fp32 llama3.2-3b TP=3"] = scan(torch.float32, n,
                                                  LL_WIDTHS, UNEVEN_TP, 1000)
                r["fp32 qwen2-1.5b TP=16"] = scan(
                    torch.float32, n // 6, (HEADS, KV_HEADS, HEAD_DIM), 16,
                    7000)
                r["bf16 llama3.2-3b TP=3"] = scan(torch.bfloat16, n // 3,
                                                  LL_WIDTHS, UNEVEN_TP, 5000)
            for c, (cq, ck, cv, cl, co) in cases.items():
                r["ms"].setdefault(c, []).append(cuda_ms(
                    lambda: ops.flash_decode(cq, ck, cv, kv_len=cl,
                                             q_offset=co), 100))
            r["ms"].setdefault(f"int8 B={LONG_B} L={LONG_L}", []).append(
                cuda_ms(lambda: ops.flash_decode_int8(
                    q, kq, vq, ksc, vsc, kv_len=kv_len, q_offset=q_off),
                    100))
    finally:
        build.CSRC, build.BUILD_DIR = saved
        build._loaded.clear()
        shutil.rmtree(work, ignore_errors=True)
    for name, r in out.items():
        log(f"[rounding] {name}: " + json.dumps(r))
    if out["as built"]["fp32 llama3.2-3b TP=3"]["differ"]:
        raise AssertionError(f"the cut segments differ from one device: "
                             f"{out['as built']}")
    return out


def window_bench(cfg, params, n: int) -> None:
    """Host wall time of ``n`` steady decode windows (8 steps) of the
    single-device kernel engine over 4 slots, devices synchronised around
    each, after one warm-up window: with all 4 slots live (one full-width
    dispatch), then with 2 live (a compacted one: the 2 slots gathered into
    a batch of 2 and scattered back).  The time of the served dense path's
    Python body.  Runs unchanged against an older checkout of ``src`` (copy
    this script into its root), to compare two versions in one call."""
    import statistics

    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine

    eng = InferenceEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=MAX_LEN, max_output=8 * (2 * n + 2),
        eos_id=-1), device=DEVICE)
    jobs = [Job(job_id=i, prompt="", prompt_tokens=list(range(8, 8 + plen)),
                arrival_time=0.0) for i, plen in enumerate((40, 90, 140, 190))]
    for live in (4, 2):
        eng.run_window(jobs[:live], 8)
        walls = []
        for _ in range(n):
            synchronize_all()
            t0 = time.perf_counter()
            eng.run_window(jobs[:live], 8)
            synchronize_all()
            walls.append((time.perf_counter() - t0) * 1e3)
        log(json.dumps({"window_bench": str(ROOT), "windows": n, "steps": 8,
                        "slots": 4, "live": live,
                        "median_ms": statistics.median(walls),
                        "min_ms": min(walls), "ms": walls}))


# --------------------------------------------------------------------------- #
# Phase 8: the other archs
# --------------------------------------------------------------------------- #

#: phase 8's archs in order, each with the depth it is served at (None:
#: full depth).  qwen2-vl-7b serves text through the engine, as the
#: reference's does, and its step entry points with the vision stub.
#: mixtral-8x7b is 93.4 GB of bf16 weights at its 32
#: layers, one card's worth only under a mesh (ROADMAP queue 1, item 8),
#: so it is cut to 8 layers.  qwen1.5-32b (70.4 GB at its 64 layers) runs
#: last, after every earlier tensor is freed, cut to 32 layers: the whole
#: depth fits one card, but phase 13 needed the room in the script's time
#: (PERF.md, section 4).
OTHER_ARCHS = [("qwen2-moe-a2.7b", None), ("llama3.2-3b", None),
               ("yi-6b", None), ("mixtral-8x7b", 8), (VL_ARCH, None),
               ("qwen1.5-32b", 32)]
#: the arch whose step entry points phase 8 runs over an int8 cache
STEP_ARCH = "qwen2-moe-a2.7b"
#: device memory a served arch keeps free beside its weights and its two
#: slot caches (the engine's and a prefill's) for activations and the
#: allocator's rounding, in bytes
HEADROOM_BYTES = 6e9


def layer_bytes(cfg):
    """(bytes of one layer's weights, bytes of the rest: embeddings, head
    and final norm) in the config's dtype, from ``param_count`` (exact for
    the dense family; the MoE family's counts the reference's quirk)."""
    es = 2 if cfg.dtype == "bfloat16" else 4
    rest = dataclasses.replace(cfg, n_layers=0).param_count()
    return (cfg.param_count() - rest) // cfg.n_layers * es, rest * es


def served_depth(cfg, depth, copies: int = 1):
    """The depth ``cfg`` is served at: ``depth`` (a stated cut) or the full
    depth, cut further to what the free device memory holds beside two
    4 x ``MAX_LEN`` slot caches and ``HEADROOM_BYTES``, with ``copies``
    of each layer's weights (2 for a TP pod: the full tree and the ranks'
    shards).  Returns (depth, why it was cut or None)."""
    import torch

    n, why = cfg.n_layers, None
    if depth is not None and depth < n:
        full = layer_bytes(cfg)[0] * cfg.n_layers
        fits = (DEVICE == "cpu" or full < torch.cuda.get_device_properties(
            0).total_memory)
        n, why = depth, (f"{depth} of {cfg.n_layers} layers: " + (
            "a stated cut that keeps the script inside its time limit"
            if fits else f"the {full / 1e9:.1f} GB of all layers fit one "
            "card only under a mesh (ROADMAP queue 1, item 8)"))
    if DEVICE == "cpu":
        return n, why
    free = torch.cuda.mem_get_info()[0]
    per, rest = layer_bytes(cfg)
    cache = 2 * 2 * 4 * MAX_LEN * cfg.n_kv_heads * cfg.head_dim * 2
    fits = int((free - copies * rest - HEADROOM_BYTES)
               // (copies * per + cache))
    if fits < n:
        n, why = fits, (f"{fits} of {cfg.n_layers} layers: "
                        f"{free / 1e9:.2f} GB free, {rest / 1e9:.2f} GB "
                        f"for the embeddings and head, {per / 1e9:.3f} GB "
                        f"a layer, x {copies}, "
                        f"{HEADROOM_BYTES / 1e9:.0f} GB kept free")
    return n, why


def moe_decode_window(cfg, params, requests) -> None:
    """The MoE arch's decode window, 8 steps at 4 live slots: one window
    profiled with the MoE block (``moe_partials``) as a ``record_function``
    range named ``moe_block`` (its device
    time per step against its bound: the routed experts' weights that this
    window's router chose, distinct per layer and step, and the shared
    path's and router's, read once at 3.35 TB/s), then one window of
    ``_decode_window`` under ``torch.cuda.set_sync_debug_mode("error")``:
    a host sync anywhere in the decode steps (the MoE block's included)
    raises."""
    import torch

    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.models import moe as M

    eng = InferenceEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=MAX_LEN, max_output=64, eos_id=-1),
        device=DEVICE)
    jobs = [Job(job_id=r.request_id, prompt="",
                prompt_tokens=list(r.prompt_tokens), arrival_time=0.0)
            for r in requests[:4]]
    eng.run_window(jobs, 8)  # prefill, and a first window as warm-up
    routed = []
    block, router = M.moe_partials, M.router_probs

    def annotated(*a, **kw):
        with torch.profiler.record_function("moe_block"):
            return block(*a, **kw)

    def logged(*a, **kw):
        out = router(*a, **kw)
        routed.append(out[2])
        return out

    M.moe_partials, M.router_probs = annotated, logged
    try:
        prof = profiled(f"{cfg.arch_id}: one decode window (8 steps, 4 "
                        f"slots, {cfg.n_layers} layers), moe_block "
                        "annotated", lambda: eng.run_window(jobs, 8),
                        annotations=("moe_block",))
    finally:
        M.moe_partials, M.router_probs = block, router
    m, d, es = cfg.moe, cfg.d_model, 2
    if len(routed) != 8 * cfg.n_layers:
        raise AssertionError(f"{len(routed)} router calls in the window, "
                             f"want 8 steps x {cfg.n_layers} layers")
    distinct = [int(torch.unique(i).numel()) for i in routed]
    fixed = (3 * d * m.shared_d_ff if m.num_shared_experts else 0) + d * (
        m.num_experts + 1)
    bound_ms = sum(n * 3 * d * m.expert_d_ff + fixed
                   for n in distinct) * es / HBM_BYTES_S * 1e3 / 8
    moe_ms = prof["moe_block"] / 8
    log(f"[moe] {cfg.arch_id}: moe_block device time {moe_ms:.3f} ms a "
        f"step ({cfg.n_layers} layers, 4 tokens) against a bound of "
        f"{bound_ms:.3f} ms ({moe_ms / bound_ms:.2f}x): {min(distinct)}-"
        f"{max(distinct)} distinct routed experts a layer (mean "
        f"{sum(distinct) / len(distinct):.2f}; at most "
        f"{min(4 * m.top_k, m.num_experts)}), weights read once at 3.35 "
        f"TB/s; {100 * prof['moe_block'] / prof['busy_ms']:.1f}% of the "
        f"window's device busy time")
    last = torch.as_tensor(eng.last_token, device=eng.device)
    alive = torch.ones((4,), dtype=torch.bool, device=eng.device)
    synchronize_all()
    if DEVICE != "cpu":
        torch.cuda.set_sync_debug_mode("error")
    try:
        _, toks = eng._decode_window(eng.cache, last, alive, 8)
    finally:
        if DEVICE != "cpu":
            torch.cuda.set_sync_debug_mode("default")
    synchronize_all()
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("sync-free window: a token lies outside the "
                             "vocabulary")
    log(f"[moe] {cfg.arch_id}: one decode window (8 steps, 4 slots, "
        "grouped MoE) ran under torch.cuda.set_sync_debug_mode('error'): "
        "no host sync")


def vision_batch(cfg, seed: int) -> dict:
    """``STEP_SLOTS`` rows of qwen2-vl-7b's step path, from ``seed``:
    ``frontend_tokens`` stub patch embeddings (N(0, 0.02), the token
    embeddings' scale) with 3-D positions on a square grid at temporal 0,
    then ``MAX_LEN - frontend_tokens - STEPS`` text ids at the next
    position on all three axes."""
    import torch

    from repro_torch.models.transformer import DTYPES

    n, b = cfg.frontend_tokens, STEP_SLOTS
    text = MAX_LEN - n - STEPS
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    side = math.isqrt(n - 1) + 1
    i = torch.arange(n, device=DEVICE)
    img = torch.stack([torch.zeros_like(i), i // side, i % side])
    txt = torch.arange(side, side + text, device=DEVICE).expand(3, text)
    pos = torch.cat([img, txt], 1)[:, None].expand(3, b, n + text)
    return {
        "tokens": torch.randint(8, cfg.vocab_size, (b, text), generator=gen,
                                device=DEVICE, dtype=torch.int32),
        "embeds": (torch.randn((b, n, cfg.d_model), generator=gen,
                               device=DEVICE) * 0.02).to(DTYPES[cfg.dtype]),
        "positions": pos.to(torch.int32).contiguous()}


def step_run(cfg, params, batch, cache, attn_impl: str, n_steps: int,
             mesh=None):
    """``make_prefill_step`` over ``batch`` into ``cache``, then
    ``n_steps`` greedy ``make_serve_step`` steps (on one TP pod with
    ``mesh``: ``params`` the ranks' shards, ``cache`` their caches).
    Returns (the prefill logits in fp32, tokens (B, 1 + n_steps), host
    wall seconds of each step, devices synchronised, the cache)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    logits, cache = make_prefill_step(cfg, attn_impl=attn_impl, mesh=mesh)(
        params, {**batch, "cache": cache})
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    serve = make_serve_step(cfg, attn_impl=attn_impl, mesh=mesh)
    toks, walls = [tok], []
    for _ in range(n_steps):
        synchronize_all()
        t0 = time.perf_counter()
        tok, cache = serve(params, tok[:, None], cache)
        synchronize_all()
        walls.append(time.perf_counter() - t0)
        toks.append(tok)
    return logits.float(), torch.stack(toks, dim=1), walls, cache


def step_logit_gap(cfg, params, batch, make_cache):
    """The step path's logits, kernel path against plain path on the same
    inputs: the prefill's (``make_prefill_step`` over ``batch`` into
    ``make_cache()``) and the first decode step's, both paths fed the
    kernel path's greedy token.  Returns (max |kernel - plain|, max
    |logit|, whether the kernel's logits are finite)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    out, tok = {}, None
    for impl in ("kernel", "torch"):
        logits, cache = make_prefill_step(cfg, attn_impl=impl)(
            params, {**batch, "cache": make_cache()})
        if tok is None:
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
        step, _ = T.decode_step(params, cfg, tok, cache, attn_impl=impl)
        out[impl] = (logits.float(), step.float())
        del cache
    gap = max(float((a - b).abs().max())
              for a, b in zip(out["kernel"], out["torch"]))
    scale = max(float(a.abs().max()) for a in out["torch"])
    finite = all(bool(torch.isfinite(a).all()) for a in out["kernel"])
    return gap, scale, finite


def vlm_steps(cfg, params) -> list:
    """Phase 8, qwen2-vl-7b's step entry points with the vision stub
    (:func:`vision_batch`) over an ``input_specs`` bf16 cache of
    ``STEP_SLOTS`` x ``MAX_LEN`` rows: prefill and ``STEPS`` serve steps
    through the kernels with every launch count set to 0 just before and
    read just after; the prefill's and the first step's bf16 logits at the
    served depth against the plain path within ``LOGIT_TOL_BF16``; and at
    full width and 2 layers in fp32, greedy tokens of the kernel and plain
    paths identical and their prefill logits within ``VL_LOGIT_TOL_FP32``.
    Returns what failed."""
    import statistics

    import torch

    from repro_torch.kernels import ops

    failures = []
    batch = vision_batch(cfg, SEED + 4)
    s = batch["positions"].shape[-1]
    ops.reset_launches()
    _, toks, walls, cache = step_run(cfg, params, batch,
                                     small_cache(cfg, None), "kernel", STEPS)
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    n = cfg.n_layers
    check_launches(launches, {
        "flash_attention": (n, f"{n} layers x 1 prefill"),
        "flash_decode": (n * STEPS, f"{n} layers x {STEPS} steps")})
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        failures.append(f"{cfg.arch_id} step path: a token lies outside "
                        "the vocabulary")
    med = statistics.median(walls) * 1e3
    log(f"[vlm] make_prefill_step over {cfg.frontend_tokens} stub patches "
        f"(3-D positions on a grid at temporal 0) and "
        f"{s - cfg.frontend_tokens} text ids, then {STEPS} make_serve_step steps, {STEP_SLOTS} slots "
        f"x {MAX_LEN} rows ({int(cache['len'].max())} filled), "
        f"{describe(cfg)}: step wall median {med:.2f} ms (min "
        f"{min(walls) * 1e3:.2f}), {STEP_SLOTS / (med / 1e3):.1f} tokens/s; "
        f"launches: flash_attention {launches['flash_attention']} = {n} x 1 "
        f"prefill, flash_decode {launches['flash_decode']} = {n} x {STEPS} "
        f"steps")
    del cache
    gap, scale, finite = step_logit_gap(cfg, params, batch,
                                        lambda: small_cache(cfg, None))
    log(f"[parity] {cfg.arch_id} bf16, full width, {n} layers, step path "
        f"with the vision stub: prefill and first step logits, max |kernel "
        f"- plain| = {gap:.4e} (tol {LOGIT_TOL_BF16}), max |logit| = "
        f"{scale:.3f}, finite={finite}")
    if not finite or not gap <= LOGIT_TOL_BF16:
        failures.append(f"{cfg.arch_id} step path: bf16 logits, kernel - "
                        f"plain = {gap:.4e} (tol {LOGIT_TOL_BF16})")
    cfg32, params32 = fp32_model(cfg, 2)
    batch32 = {**batch, "embeds": batch["embeds"].float()}
    runs = {impl: step_run(cfg32, params32, batch32,
                           small_cache(cfg32, None), impl, STEPS)
            for impl in ("kernel", "torch")}
    (kl, kt, _, _), (pl, pt, _, _) = runs["kernel"], runs["torch"]
    gap32 = float((kl - pl).abs().max())
    same = int((kt == pt).sum())
    log(f"[parity] {cfg.arch_id} fp32, full width, 2 layers, step path with "
        f"the vision stub: greedy tokens, kernel vs plain, identical on "
        f"{same}/{pt.numel()} ({STEP_SLOTS} slots x {1 + STEPS}); prefill "
        f"logits max |kernel - plain| = {gap32:.4e} (tol "
        f"{VL_LOGIT_TOL_FP32})")
    if not torch.equal(kt, pt) or not gap32 <= VL_LOGIT_TOL_FP32:
        failures.append(f"{cfg.arch_id} fp32 step path: tokens identical on "
                        f"{same}/{pt.numel()}, logit gap {gap32:.4e}")
    return failures


def other_archs_phase(archs=None) -> dict:
    """Phase 8: each arch of ``archs`` (default :data:`OTHER_ARCHS`) in
    bf16 at full width, from random weights, through ``ElisServer`` with
    the oracle and ISRTF (phase 4's served path: 4 slots, ``MAX_LEN``, a
    dozen requests, launch counts reset before and read after), its decode
    window profiled, its first prefill logits against the plain path at
    the served depth, and beforehand its fp32 greedy tokens, kernel engine
    against plain engine, at full width and 2 layers.  The MoE archs also
    run a decode window under sync-debug (:func:`moe_decode_window`),
    :data:`STEP_ARCH` the step entry points over an int8 cache and
    qwen2-vl-7b its step entry points with the vision stub
    (:func:`vlm_steps`).  Every check is made for every arch before the
    phase fails.  Returns each arch's served-path launch counts."""
    import torch

    from repro_torch.configs import get_config

    archs = OTHER_ARCHS if archs is None else archs
    requests = make_requests(12, SEED)
    failures, launches = [], {}
    for arch, depth in archs:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if DEVICE == "cpu":  # a rehearsal: reduced widths, the served window
            cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16",
                                      swa_window=cfg.swa_window)
        if not greedy_parity(cfg, requests):
            failures.append(f"{arch}: fp32 greedy tokens differ between "
                            "the kernel and plain engines, or no eviction")
        gc.collect()
        torch.cuda.empty_cache()
        n, why = served_depth(cfg, depth)
        full = cfg
        cfg = dataclasses.replace(cfg, n_layers=n)
        if why:
            log(f"[archs] {arch}: depth cut to {why}")
        base = torch.cuda.memory_allocated() if DEVICE != "cpu" else 0
        params = random_params(cfg)
        held = sum(t.numel() * t.element_size() for t in _tensors(params))
        count = sum(t.numel() for t in _tensors(params))
        alloc = (torch.cuda.memory_allocated() - base if DEVICE != "cpu"
                 else held)
        log(f"[archs] {describe(cfg)}; weights: {held / 1e9:.3f} GB in "
            f"{count:,} parameters, {alloc / 1e9:.3f} GB allocated; "
            f"param_count {cfg.param_count():,} at this depth, "
            f"{full.param_count():,} at {full.n_layers} layers "
            f"(active {full.active_param_count():,})")
        launches[arch] = served_path(cfg, params, requests)
        if cfg.moe.enabled:
            moe_decode_window(cfg, params, requests)
            raw, gap, flips, finite = moe_prefill_logit_gaps(cfg, params,
                                                             requests)
            if not flips:
                gap = max(gap, raw)
        else:
            profile_window(cfg, params, requests)
            gap, finite = prefill_logit_gap(cfg, params, requests)
        if not finite or not gap <= LOGIT_TOL_BF16:
            failures.append(f"{arch}: bf16 prefill logits, kernel - plain "
                            f"= {gap:.4e} (tol {LOGIT_TOL_BF16})")
        if arch == STEP_ARCH:
            int8_step_path(cfg, params)
        if arch == VL_ARCH:
            failures += vlm_steps(cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[archs] {arch} in {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("phase 8: " + "; ".join(failures))
    return launches


# --------------------------------------------------------------------------- #
# Phase 9: the hybrid family (zamba2-7b)
# --------------------------------------------------------------------------- #

#: the depth of phase 9's fp32 parity runs: two groups of 6 and one tail
#: layer, so the shared block is applied twice and a tail layer runs
HY_PARITY_DEPTH = 13


def hybrid_requests(cfg):
    """Phase 9's requests: prompts of 8-400 ids, so that the longest span
    two SSD chunks of 256."""
    return make_requests(12, SEED, max_prompt=400, vocab=cfg.vocab_size)


def hybrid_step(cfg, params) -> dict:
    """zamba2-7b's step entry points once: ``make_prefill_step`` over an
    ``input_specs`` cache of ``STEP_SLOTS`` x ``MAX_LEN`` rows (bf16) with
    ``STEP_SLOTS`` prompts of ``STEP_PROMPT`` ids, then one
    ``make_serve_step``; launch counts set to 0 just before, read just
    after.  Returns the counts."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.transformer import hybrid_layout

    sites = hybrid_layout(cfg)[0]
    prompts = torch.as_tensor(step_prompts(), device=DEVICE)
    ops.reset_launches()
    synchronize_all()
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(cfg)(
        params, {"tokens": prompts, "cache": small_cache(cfg, None)})
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    synchronize_all()
    t1 = time.perf_counter()
    tok, cache = make_serve_step(cfg)(params, tok[:, None], cache)
    synchronize_all()
    t2 = time.perf_counter()
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    check_launches(launches, {
        "ssd_scan": (cfg.n_layers, f"{cfg.n_layers} layers x 1 prefill"),
        "flash_attention": (sites, f"{sites} sites x 1 prefill"),
        "flash_decode": (sites, f"{sites} sites x 1 serve step")})
    if not bool(((tok >= 0) & (tok < cfg.vocab_size)).all()):
        raise AssertionError("a generated token lies outside the vocabulary")
    log(f"[hybrid] make_prefill_step ({STEP_SLOTS} prompts of {STEP_PROMPT} "
        f"ids, {(t1 - t0) * 1e3:.1f} ms) and one make_serve_step "
        f"({(t2 - t1) * 1e3:.1f} ms) over an input_specs cache of "
        f"{STEP_SLOTS} x {MAX_LEN} rows; launches: "
        f"{json.dumps(launches)}")
    return launches


def hybrid_phase() -> dict:
    """Phase 9: zamba2-7b in bf16 at full width and all 81 layers, from
    random weights, through phase 4's served path (launch counts reset
    before and read after: ``ssd_scan`` 81 a prefill, ``flash_attention``
    13 a prefill, ``flash_decode`` 13 a decode step), one decode window
    profiled, its first prefill logits against the plain kernels on the
    kernels' inputs, and its step entry points once; beforehand, fp32
    greedy tokens of the kernel and plain engines at full width and
    ``HY_PARITY_DEPTH`` layers through evictions and a swap round trip, one
    slot's swap round trip bit for bit there, and its fp32 first prefill
    logits against the plain kernels within ``HYBRID_LOGIT_TOL_FP32``.
    Returns the served path's launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = get_config(HY_ARCH)
    if DEVICE == "cpu":  # a rehearsal: reduced widths, the served window
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16",
                                  swa_window=cfg.swa_window)
    requests = hybrid_requests(cfg)
    failures = []
    depth = min(HY_PARITY_DEPTH, cfg.n_layers)
    if not greedy_parity(cfg, requests, depth=depth, swap=True):
        failures.append("fp32 greedy tokens differ between the kernel and "
                        "plain engines, or no eviction")
    cfg32, params = fp32_model(cfg, depth)
    swap_roundtrip(cfg32, params, requests)
    failures += recurrent_logit_failures(
        cfg32, *ssm_prefill_logit_gaps(cfg32, params, requests,
                                       at_chunk=True))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    base = torch.cuda.memory_allocated() if DEVICE != "cpu" else 0
    params = random_params(cfg)
    held = sum(t.numel() * t.element_size() for t in _tensors(params))
    count = sum(t.numel() for t in _tensors(params))
    alloc = torch.cuda.memory_allocated() - base if DEVICE != "cpu" else held
    log(f"[hybrid] {describe(cfg)}; weights: {held / 1e9:.3f} GB in "
        f"{count:,} parameters, {alloc / 1e9:.3f} GB allocated; "
        f"param_count {cfg.param_count():,}")
    launches = served_path(cfg, params, requests)
    profile_window(cfg, params, requests)
    log(f"[hybrid] {HYBRID_TOL_REASON}")
    failures += recurrent_logit_failures(
        cfg, *ssm_prefill_logit_gaps(cfg, params, requests))
    hybrid_step(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[hybrid] phase 9 in {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("phase 9: " + "; ".join(failures))
    return launches


# --------------------------------------------------------------------------- #
# Phase 10: the audio family (whisper-large-v3)
# --------------------------------------------------------------------------- #


def audio_batch(cfg, b: int, s: int, seed: int) -> dict:
    """``b`` prompts of ``s`` random ids and their stub frame embeddings
    (b, n_frames, d_model), N(0, 1) in the config's dtype, from
    ``seed``."""
    import torch

    from repro_torch.models.transformer import DTYPES

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return {"tokens": torch.randint(8, cfg.vocab_size, (b, s), generator=gen,
                                    device=DEVICE, dtype=torch.int32),
            "frames": torch.randn((b, cfg.encoder.n_frames, cfg.d_model),
                                  generator=gen, device=DEVICE).to(
                                      DTYPES[cfg.dtype])}


def audio_cache(cfg, b: int):
    """An ``input_specs`` decode cache of ``b`` slots: ``AU_ROWS``
    self-attention rows and the cross-K/V beside them."""
    from repro_torch.launch.shapes import InputShape, input_specs
    return input_specs(cfg, InputShape("serve_448", AU_ROWS, b, "decode"),
                       device=DEVICE)["cache"]


def audio_depth(cfg, n: int):
    """``cfg`` cut to ``n`` encoder and ``n`` decoder layers."""
    return dataclasses.replace(cfg, n_layers=n, encoder=dataclasses.replace(
        cfg.encoder, n_layers=n))


def audio_greedy_parity(cfg) -> bool:
    """fp32 greedy tokens of the step path at full width and 2 + 2 layers,
    kernel path against plain path, over ``STEP_SLOTS`` prompts of
    ``STEP_PROMPT`` ids and their frames, ``STEPS`` steps: identical?"""
    import torch

    from repro_torch.models import transformer as T

    cfg2 = dataclasses.replace(audio_depth(cfg, 2), dtype="float32")
    params2 = T.init_params(
        cfg2, torch.Generator(device=DEVICE).manual_seed(SEED + 1))
    batch = audio_batch(cfg2, STEP_SLOTS, STEP_PROMPT, SEED + 5)
    (kl, kt, _, _), (pl, pt, _, _) = (
        step_run(cfg2, params2, batch, audio_cache(cfg2, STEP_SLOTS), impl,
                 STEPS) for impl in ("kernel", "torch"))
    same = int((kt == pt).sum())
    log(f"[parity] {cfg.arch_id} fp32, full width, 2 + 2 layers, step path "
        f"over frames: greedy tokens, kernel vs plain, identical on "
        f"{same}/{pt.numel()} ({STEP_SLOTS} prompts x {1 + STEPS}); prefill "
        f"logits max |kernel - plain| = {float((kl - pl).abs().max()):.4e}")
    return bool(torch.equal(kt, pt))


def audio_logit_gap(cfg, params):
    """bf16 logits at full width and depth, kernel path against plain
    path (:func:`step_logit_gap`) over phase 10's prompts and frames.
    Returns (gap, finite)."""
    gap, scale, finite = step_logit_gap(
        cfg, params, audio_batch(cfg, STEP_SLOTS, STEP_PROMPT, SEED + 5),
        lambda: audio_cache(cfg, STEP_SLOTS))
    log(f"[parity] {cfg.arch_id} bf16, full width, {cfg.encoder.n_layers} + "
        f"{cfg.n_layers} layers: prefill and first step logits, max |kernel "
        f"- plain| = {gap:.4e} (tol {AU_LOGIT_TOL_BF16}), max |logit| = "
        f"{scale:.3f}, finite={finite}")
    return gap, finite


def audio_prefill_32k(cfg, params) -> None:
    """prefill_32k: one ``make_prefill_step`` at B=32 over ``input_specs``
    inputs filled on the card (448 decoder ids and 1500 frames a row),
    its launches, wall time and the peak memory allocated."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.shapes import SHAPES, input_specs
    from repro_torch.launch.steps import make_prefill_step

    shape = SHAPES["prefill_32k"]
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    specs = input_specs(cfg, shape, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    specs["tokens"].random_(8, cfg.vocab_size, generator=gen)
    specs["frames"].normal_(generator=gen)
    b, s = specs["tokens"].shape
    ops.reset_launches()
    synchronize_all()
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(cfg)(params, specs)
    synchronize_all()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    n = cfg.n_layers
    check_launches(launches, {"flash_attention": (n, f"{n} decoder layers "
                                                     "x 1 prefill")})
    if not (bool(torch.isfinite(logits).all())
            and tuple(logits.shape) == (b, 1, cfg.vocab_size)):
        raise AssertionError(f"prefill_32k: logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    peak = torch.cuda.max_memory_allocated() if DEVICE != "cpu" else 0
    kv, cross = cache["kv"], cache["cross_kv"]
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (kv.k, kv.v, cross.k, cross.v))
    log(f"[audio] prefill_32k: make_prefill_step, B={b} x {s} decoder ids "
        f"over {b} x {cfg.encoder.n_frames} frames: {wall * 1e3:.1f} ms "
        f"wall (the {cfg.encoder.n_layers}-layer encoder's attention plain, "
        f"as in the reference); flash_attention "
        f"{launches['flash_attention']} = {n} x 1 prefill; cache "
        f"{cache_bytes / 1e9:.2f} GB (self and cross K/V); peak memory "
        f"allocated {peak / 1e9:.2f} GB")


def audio_decode_32k(cfg, params) -> None:
    """decode_32k: ``make_serve_step`` at B=128 over an ``input_specs``
    cache filled on the card in place (random self and cross K/V, every
    slot's ``len`` below 448): one warm-up step and 5 timed ones (median),
    their launches, the cache's bytes and the peak memory."""
    import statistics

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.shapes import SHAPES, input_specs
    from repro_torch.launch.steps import make_serve_step

    shape = SHAPES["decode_32k"]
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    specs = input_specs(cfg, shape, device=DEVICE)
    cache = specs["cache"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    kv, cross = cache["kv"], cache["cross_kv"]
    for buf in (kv.k, kv.v, cross.k, cross.v):
        for layer in buf:
            layer.normal_(generator=gen)
    b, rows = kv.k.shape[1], kv.k.shape[2]
    cache["len"].copy_(torch.randint(rows // 2, rows - 8, (b,),
                                     generator=gen, device=DEVICE))
    tok = specs["tokens"][:, 0].random_(8, cfg.vocab_size, generator=gen)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (kv.k, kv.v, cross.k, cross.v))
    param_bytes = sum(t.numel() * t.element_size() for t in
                      _tensors(params))
    serve = make_serve_step(cfg)
    ops.reset_launches()
    walls = []
    for i in range(6):
        synchronize_all()
        t0 = time.perf_counter()
        tok, cache = serve(params, tok[:, None], cache)
        synchronize_all()
        if i:
            walls.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    n = cfg.n_layers
    check_launches(launches, {"flash_decode": (6 * n, f"{n} layers x 6 "
                                                      "steps")})
    if not bool(((tok >= 0) & (tok < cfg.vocab_size)).all()):
        raise AssertionError("decode_32k: a token lies outside the "
                             "vocabulary")
    peak = torch.cuda.max_memory_allocated() if DEVICE != "cpu" else 0
    bound = (cache_bytes + param_bytes) / HBM_BYTES_S * 1e3
    log(f"[audio] decode_32k: make_serve_step, B={b}, self-attention cache "
        f"of {rows} rows (len {int(cache['len'].min())}-"
        f"{int(cache['len'].max())} after the steps) and cross-K/V over "
        f"{cfg.encoder.n_frames} frames, {cache_bytes / 1e9:.2f} GB: step "
        f"wall median {statistics.median(walls) * 1e3:.2f} ms over 5 (min "
        f"{min(walls) * 1e3:.2f}; after 1 warm-up); bound {bound:.2f} ms "
        f"(cache and weights read once at 3.35 TB/s); flash_decode "
        f"{launches['flash_decode']} = {n} x 6 steps; peak memory allocated "
        f"{peak / 1e9:.2f} GB")


def audio_phase() -> dict:
    """Phase 10: whisper-large-v3 in bf16 at full width, 32 encoder and 32
    decoder layers, from random weights, through the step entry points
    (``launch/steps.py``; the engine serves no audio prefill): fp32 greedy
    tokens of the kernel and plain paths at 2 + 2 layers first; then
    ``STEP_SLOTS`` prompts of ``STEP_PROMPT`` ids over their frames and
    ``STEPS`` serve steps with launch counts reset before and read after
    (``flash_attention`` 32 a prefill: the encoder and the cross-attention
    launch none; ``flash_decode`` 32 a step), one step profiled, bf16
    logits against the plain path within ``AU_LOGIT_TOL_BF16``; then
    prefill_32k and decode_32k.  Returns the launch counts of the first
    step run."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_serve_step

    t0 = time.perf_counter()
    cfg = get_config(AU_ARCH)
    if DEVICE == "cpu":  # a rehearsal: reduced widths, the published rows
        cfg = dataclasses.replace(
            cfg.reduced(), dtype="bfloat16",
            max_position_embeddings=cfg.max_position_embeddings)
    failures = []
    if not audio_greedy_parity(cfg):
        failures.append("fp32 greedy tokens differ between the kernel and "
                        "plain step paths")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() if DEVICE != "cpu" else 0
    params = random_params(cfg)
    held = sum(t.numel() * t.element_size() for t in _tensors(params))
    count = sum(t.numel() for t in _tensors(params))
    alloc = torch.cuda.memory_allocated() - base if DEVICE != "cpu" else held
    log(f"[audio] {cfg.arch_id}: {cfg.encoder.n_layers} encoder layers over "
        f"{cfg.encoder.n_frames} frames, {cfg.n_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; weights: {held / 1e9:.3f} GB in {count:,} "
        f"parameters, {alloc / 1e9:.3f} GB allocated; param_count "
        f"{cfg.param_count():,}")
    batch = audio_batch(cfg, STEP_SLOTS, STEP_PROMPT, SEED + 5)
    ops.reset_launches()
    _, toks, walls, cache = step_run(cfg, params, batch,
                                     audio_cache(cfg, STEP_SLOTS), "kernel",
                                     STEPS)
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    n = cfg.n_layers
    check_launches(launches, {
        "flash_attention": (n, f"{n} decoder layers x 1 prefill"),
        "flash_decode": (n * STEPS, f"{n} decoder layers x {STEPS} steps")})
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        failures.append("a generated token lies outside the vocabulary")
    med = statistics.median(walls) * 1e3
    log(f"[audio] make_prefill_step ({STEP_SLOTS} prompts of {STEP_PROMPT} "
        f"ids over their frames) and {STEPS} make_serve_step steps over an "
        f"input_specs cache of {STEP_SLOTS} x {AU_ROWS} rows: step wall "
        f"median {med:.2f} ms (min {min(walls) * 1e3:.2f}), "
        f"{STEP_SLOTS / (med / 1e3):.1f} tokens/s; launches: "
        f"flash_attention {launches['flash_attention']} = {n} x 1 prefill, "
        f"flash_decode {launches['flash_decode']} = {n} x {STEPS} steps "
        f"(all counts: {json.dumps(launches)})")
    last = toks[:, -1]
    profiled(f"{cfg.arch_id}: one make_serve_step ({STEP_SLOTS} slots, "
             f"{n} decoder layers)",
             lambda: make_serve_step(cfg)(params, last[:, None], cache))
    del cache
    gap, finite = audio_logit_gap(cfg, params)
    if not finite or not gap <= AU_LOGIT_TOL_BF16:
        failures.append(f"bf16 logits, kernel - plain = {gap:.4e} (tol "
                        f"{AU_LOGIT_TOL_BF16})")
    gc.collect()
    torch.cuda.empty_cache()
    audio_prefill_32k(cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    audio_decode_32k(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[audio] phase 10 in {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("phase 10: " + "; ".join(failures))
    return launches


# --------------------------------------------------------------------------- #
# Phase 11: tensor-parallel MoE pods; chunked prefill and KV swap under a mesh
# --------------------------------------------------------------------------- #

#: phase 11's pods, each arch with the depth it is served at: mixtral's
#: weights and their shards at 32 layers would not fit one card; both are
#: cut (qwen2-moe-a2.7b to 12 of 24 layers, mixtral to 4, half of phase
#: 8's 8) to leave phase 13 room in the script's time (PERF.md, section
#: 4); phase 8 serves qwen2-moe-a2.7b at all 24 on one device
MOE_TP_ARCHS = [("qwen2-moe-a2.7b", 12), ("mixtral-8x7b", 4)]
#: the chunk of phase 11's chunked prefills, and the length of the prompt
#: that its fp32 parity run chunks (more than 3 chunks)
MOE_TP_CHUNK, MOE_TP_LONG = 64, 230
#: phase 11's CLI run: ``CLI_QUEUE`` on one TP pod of qwen2-moe-a2.7b,
#: chunked, preempting by the ``auto`` break-even, at the pod's served
#: depth (12 of 24 layers: at 24 it took 117.9 of the phase's 144.0 s on
#: an H100 with a slow host)
MOE_TP_CLI = CLI_QUEUE + ["--policy", "isrtf", "--arch", "qwen2-moe-a2.7b",
                          "--mesh", f"1x{TP}", "--prefill-chunk",
                          str(MOE_TP_CHUNK), "--preempt-policy", "auto"]
#: a greedy token may flip between two sums of the same fp32 logits only
#: where the top two logits tie this closely
FP32_TIE = 1e-5


def chunk_swap_streams(cfg, params, prompts, mesh=None, n_out: int = 16):
    """Two jobs on one kernel engine (a TP pod with ``mesh``), chunked
    prefill of ``MOE_TP_CHUNK`` tokens a window: job 0 (``prompts[0]``,
    over 3 chunks) is swapped to the host and back once mid-prefill, after
    its first chunk, and once mid-decode, each time across a window of job
    1 alone (:func:`swap_round_trip`).  Returns (streams, chunk
    dispatches)."""
    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine

    eng = InferenceEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=MAX_LEN, max_output=64, eos_id=-1),
        device=DEVICE, mesh=mesh)
    jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
            for i, p in enumerate(prompts)]

    def window(batch):
        toks, _ = eng.run_window(batch, 8, prefill_chunk=MOE_TP_CHUNK)
        for j, t in zip(batch, toks):
            j.generated.extend(t)

    window(jobs)
    if not eng.prefill_incomplete(0):
        raise AssertionError("chunked prefill: job 0 finished in one chunk")
    swap_round_trip(eng, jobs[0], lambda: window(jobs[1:]))
    swapped = False
    while any(len(j.generated) < n_out for j in jobs):
        window([j for j in jobs if len(j.generated) < n_out])
        if (not swapped and 0 < len(jobs[0].generated) < n_out
                and len(jobs[1].generated) < n_out):
            swap_round_trip(eng, jobs[0], lambda: window(jobs[1:]))
            swapped = True
    if not swapped:
        raise AssertionError("chunked prefill: no swap mid-decode")
    return [j.generated[:n_out] for j in jobs], eng.num_chunk_dispatches


def first_divergence(cfg, params, prompts, got, want):
    """Where two greedy streams of the same prompts first differ: (request,
    position, top-2 margin of the single-device fp32 logits there), or
    None when they agree."""
    import torch

    from repro_torch.models import transformer as T

    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        pos = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                   min(len(g), len(w)))
        seq = list(prompts[i]) + list(w[:pos])
        logits, _ = T.prefill(params, cfg, {"tokens": torch.as_tensor(
            [seq], device=DEVICE)}, T.init_cache(cfg, 1, MAX_LEN, DEVICE))
        top = logits[0, -1].float().topk(2).values
        return i, pos, float(top[0] - top[1])
    return None


def tp_stream_parity(cfg, requests, mesh) -> list:
    """fp32 greedy tokens at full width and 2 layers, the TP kernel engine
    against the single-device kernel engine: through compacted windows,
    evictions and recompute resumes (:func:`greedy_streams`), and through
    a chunked prefill and two swap round trips
    (:func:`chunk_swap_streams`).  Where tokens differ, the first position
    and the single-device top-2 logit margin there are printed: a margin
    under ``FP32_TIE`` is a tie, anything larger a fault.  Returns the
    failures."""
    cfg2, params2 = fp32_model(cfg, 2)
    prompts = [list(r.prompt_tokens) for r in requests[:6]]
    long = [t for r in requests for t in r.prompt_tokens][:MOE_TP_LONG]
    runs, failures = {}, []
    for name, m in (("kernel engine", None),
                    (f"TP={len(mesh.ranks)} kernel engine", mesh)):
        runs[name] = (greedy_streams(cfg2, params2, prompts, "kernel", 24, m),
                      chunk_swap_streams(cfg2, params2, [long, prompts[0]],
                                         m))
    (one, _), (chunked, chunks) = runs.pop("kernel engine")
    (name, ((one_tp, ev), (chunked_tp, chunks_tp))), = runs.items()
    for what, got, want, ps in (
            ("evictions", one_tp, one, prompts),
            ("chunked prefill + swaps", chunked_tp, chunked,
             [long, prompts[0]])):
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        log(f"[moe-tp] {cfg.arch_id} fp32, full width, 2 layers: {name} vs "
            f"kernel engine greedy tokens identical on {same}/"
            f"{sum(map(len, want))} tokens of {len(ps)} requests ({what}"
            + (f"; {ev} evictions + recompute resumes, compacted windows)"
               if what == "evictions" else
               f"; a {len(long)}-token prompt in chunks of {MOE_TP_CHUNK}: "
               f"{chunks_tp} chunk dispatches (single device {chunks}); "
               "one swap round trip mid-prefill and one mid-decode, every "
               "rank's slot rows bit for bit)"))
        div = first_divergence(cfg2, params2, ps, got, want)
        if div is not None:
            i, pos, margin = div
            tie = margin < FP32_TIE
            log(f"[moe-tp]   first difference: request {i}, token {pos}; "
                f"top-2 margin there {margin:.3e} "
                + ("< FP32_TIE: a tie" if tie else f">= {FP32_TIE}: a fault"))
            if not tie:
                failures.append(f"{cfg.arch_id}: fp32 greedy tokens of the "
                                f"TP engine differ ({what}) at a margin of "
                                f"{margin:.3e}")
    if ev <= 0:
        failures.append(f"{cfg.arch_id}: no eviction was driven")
    if chunks_tp < 4:
        failures.append(f"{cfg.arch_id}: {chunks_tp} chunk dispatches")
    return failures


def executor_swap(executor, tag: str = "moe-tp") -> None:
    """One job admitted, decoded, offloaded to the host and restored
    through the executor of a TP pod (``EngineExecutor.offload`` /
    ``restore``), every rank's slot rows bit for bit, then decoded on and
    evicted."""
    import torch

    from repro_torch.core import Job

    eng = executor.engines[0]
    job = Job(job_id=10 ** 6, prompt="", arrival_time=0.0,
              prompt_tokens=make_requests(1, SEED + 3)[0].prompt_tokens)
    job.generated.extend(executor.execute(0, [job], 8, 0.0).tokens[0])
    before = slot_rows(eng, job.job_id)
    if not executor.offload(0, job) or eng.has_job(job.job_id):
        raise AssertionError("executor swap: offload refused")
    if not executor.restore(0, job):
        raise AssertionError("executor swap: restore refused")
    after = slot_rows(eng, job.job_id)
    if not all(torch.equal(a, b) for ra, rb in zip(after, before)
               for a, b in zip(ra, rb)):
        raise AssertionError("executor swap: a rank's rows differ")
    executor.execute(0, [job], 8, 0.0)
    executor.evict(0, job)
    log(f"[{tag}] executor of the CLI's pod: one job offloaded and "
        f"restored through EngineExecutor.offload/restore, its slot rows "
        f"on all {len(after)} ranks bit for bit; swapouts "
        f"{executor.counters()['swapouts']}")


def moe_tp_phase() -> dict:
    """Phase 11: the MoE family on ``TP``-rank pods (ranks on one card when
    there is one), bf16 at full width, from random weights.  For each arch
    of :data:`MOE_TP_ARCHS`: fp32 greedy tokens of the TP kernel engine
    against the single-device kernel engine at 2 layers
    (:func:`tp_stream_parity`); then at the served depth the bytes
    allocated beside ``param_count``, phase 4's served path on the pod
    (launch counts reset before and read after: ``flash_decode_sharded``
    layers x ranks a decode step, ``flash_attention`` layers x ranks a
    prefill), one decode window profiled, and the first prefill logits of
    the pod against the single-device kernel model within
    ``LOGIT_TOL_BF16`` (:func:`moe_prefill_logit_gaps`).  Then the serve
    CLI on one pod of qwen2-moe-a2.7b (:data:`MOE_TP_CLI`), and one swap
    through its executor.  Returns each arch's served-path launch
    counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import shard_params

    t_phase = time.perf_counter()
    requests = make_requests(12, SEED)
    mesh = tp_mesh()
    failures, launches = [], {}
    for arch, depth in MOE_TP_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if DEVICE == "cpu":  # a rehearsal: reduced widths, the served window
            cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16",
                                      swa_window=cfg.swa_window)
        failures += tp_stream_parity(cfg, requests, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        n, why = served_depth(cfg, depth, copies=2)
        full = cfg
        cfg = dataclasses.replace(cfg, n_layers=n)
        if why:
            log(f"[moe-tp] {arch}: depth cut to {why}")
        base = torch.cuda.memory_allocated() if DEVICE != "cpu" else 0
        params = random_params(cfg)
        alloc = (torch.cuda.memory_allocated() - base if DEVICE != "cpu"
                 else sum(t.numel() * t.element_size()
                          for t in _tensors(params)))
        shards = shard_params(params, cfg, mesh)
        copied = pod_copies(params, shards)
        del shards
        log(f"[moe-tp] {describe(cfg, mesh)}; weights {alloc / 1e9:.3f} GB "
            f"allocated, param_count {cfg.param_count():,} at this depth "
            f"({full.param_count():,} at {full.n_layers} layers); the pod's "
            f"shards copy {copied / 1e9:.3f} GB of split leaves (the "
            f"replicated router, gates and norms are shared by the ranks)")
        launches[arch] = served_path(cfg, params, requests, mesh)
        gc.collect()
        profile_window(cfg, params, requests, mesh)
        gc.collect()
        raw, gap, flips, finite = moe_prefill_logit_gaps(cfg, params,
                                                         requests, mesh)
        if not flips:
            gap = max(gap, raw)
        if not finite or not gap <= LOGIT_TOL_BF16:
            failures.append(f"{arch}: bf16 prefill logits, single-device - "
                            f"TP kernel = {gap:.4e} (tol {LOGIT_TOL_BF16})")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[moe-tp] {arch} in {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("phase 11: " + "; ".join(failures))
    t0 = time.perf_counter()
    run = cli_run("moe tp2 chunk+auto", MOE_TP_CLI, after=executor_swap,
                  depth=POD_CLI_DEPTH)
    c = run["counters"]
    log(f"[moe-tp] CLI on one TP={TP} pod of qwen2-moe-a2.7b: swapouts "
        f"{c['swapouts']}, swapins {c['swapins']}, chunk dispatches "
        f"{c['chunk_dispatches']} in {time.perf_counter() - t0:.1f} s")
    if c["chunk_dispatches"] <= 0:
        raise AssertionError("phase 11: the CLI run dispatched no chunk")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe-tp] phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------------------------------------------- #
# Phase 12: the SSM and hybrid families on tensor-parallel pods
# --------------------------------------------------------------------------- #

#: phase 12's pods: (arch, the pod sizes its fp32 parity runs, the depth of
#: that run: mamba2-130m whole, zamba2-7b at phase 9's; the depth the pod
#: is served at: 12 of mamba2-130m's 24 layers and 27 of zamba2-7b's 81 (4
#: groups of 6 and the 3 tail layers), cut to leave phase 13 room in the
#: script's time (PERF.md, section 4); phase 9 serves zamba2-7b at all 81)
SSM_TP_ARCHS = [("mamba2-130m", (TP, 4), None, 12),
                (HY_ARCH, (TP,), HY_PARITY_DEPTH, 27)]
#: phase 12's CLI run: ``CLI_QUEUE`` on one TP pod of mamba2-130m under
#: ISRTF, preempting by the ``auto`` break-even, at the pod's served
#: depth (12 of 24 layers: at 24 it took ~70 of the phase's 140.7 s on
#: the same host)
SSM_TP_CLI = CLI_QUEUE + ["--policy", "isrtf", "--arch", "mamba2-130m",
                          "--mesh", f"1x{TP}", "--preempt-policy", "auto"]


def pod_parity(cfg, params, requests, meshes, tag: str = "ssm-tp") -> list:
    """fp32 greedy tokens of each TP kernel engine of ``meshes`` against
    the single-device kernel engine and the plain engine, through
    evictions, recompute resumes and one swap round trip
    (:func:`greedy_streams`).  Where tokens differ, the first position and
    the single-device top-2 logit margin there (of a one-shot prefill of
    the context) are printed: a margin under ``FP32_TIE`` is a tie,
    anything larger a fault.  Returns the failures."""
    prompts = [list(r.prompt_tokens) for r in requests[:6]]
    runs = {"kernel engine": ("kernel", None), "plain engine": ("torch", None)}
    for m in meshes:
        runs[f"TP={len(m.ranks)} kernel engine"] = ("kernel", m)
    streams = {name: greedy_streams(cfg, params, prompts, impl, 24, m, True)
               for name, (impl, m) in runs.items()}
    failures = []
    pairs = [(name, other) for name in list(runs)[2:]
             for other in ("kernel engine", "plain engine")]
    for name, other in [("kernel engine", "plain engine")] + pairs:
        (got, evictions), (want, _) = streams[name], streams[other]
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        log(f"[{tag}] {cfg.arch_id} fp32, full width, {cfg.n_layers} "
            f"layers: {name} vs {other} greedy tokens identical on {same}/"
            f"{sum(map(len, want))} tokens of {len(prompts)} requests "
            f"({evictions} evictions + recompute resumes, the first a swap "
            "round trip)")
        if evictions <= 0:
            failures.append(f"{cfg.arch_id}: no eviction was driven")
        div = first_divergence(cfg, params, prompts, got, want)
        if div is not None:
            i, pos, margin = div
            tie = margin < FP32_TIE
            log(f"[{tag}]   first difference: request {i}, token {pos}; "
                f"top-2 margin there {margin:.3e} "
                + ("< FP32_TIE: a tie" if tie else f">= {FP32_TIE}: a fault"))
            if not tie:
                failures.append(f"{cfg.arch_id}: fp32 greedy tokens of the "
                                f"{name} differ from the {other}'s at a "
                                f"margin of {margin:.3e}")
    return failures


def pod_logit_gap(cfg, params, requests, mesh, tag: str = "ssm-tp"):
    """max |pod - single-device kernel model| of the first prefill logits
    in ``cfg.dtype`` at ``cfg``'s depth, each of the two longest and two
    shortest prompts alone at its exact length (as the engine admits
    them).  Returns the failures against ``POD_LOGIT_TOL`` and the
    gap."""
    import torch

    from repro_torch.launch import shard_params
    from repro_torch.models import transformer as T

    by_len = sorted(requests, key=lambda r: len(r.prompt_tokens))
    prompts = [r.prompt_tokens for r in by_len[:2] + by_len[-2:]]
    shards = shard_params(params, cfg, mesh)
    gap, scale, finite = 0.0, 0.0, True
    for prompt in prompts:
        out = {}
        for name, p, m in (("pod", shards, mesh), ("one", params, None)):
            logits, _ = T.prefill(p, cfg, {"tokens": torch.as_tensor(
                [prompt], device=DEVICE)},
                T.init_cache(cfg, 1, MAX_LEN, DEVICE, mesh=m), mesh=m)
            out[name] = logits.float()
        finite &= bool(torch.isfinite(out["pod"]).all())
        gap = max(gap, float((out["pod"] - out["one"]).abs().max()))
        scale = max(scale, float(out["one"].abs().max()))
    del shards
    tol = POD_LOGIT_TOL[cfg.family, cfg.dtype]
    log(f"[{tag}] {cfg.arch_id} {cfg.dtype}, full width, {cfg.n_layers} "
        f"layers: first prefill logits of prompts of "
        f"{[len(p) for p in prompts]} tokens, max |TP={len(mesh.ranks)} "
        f"pod - single-device kernel model| = {gap:.4e} (tol {tol}), max "
        f"|logit| = {scale:.3f}, finite={finite}")
    bad = [] if finite and gap <= tol else [
        f"{cfg.arch_id}: {cfg.dtype} prefill logits at {cfg.n_layers} "
        f"layers, TP pod - single-device kernel = {gap:.4e} (tol {tol}), "
        f"finite={finite}"]
    return bad, gap


def pod_copies(params, shards) -> float:
    """Bytes of the storages the ranks' shards hold apart from the full
    tree's (a replicated leaf on the full tree's device, and a rank's piece
    that is a contiguous view of a full leaf, share its storage)."""
    own = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
           for sh in shards for t in _tensors(sh)}
    full = {t.untyped_storage().data_ptr() for t in _tensors(params)}
    return sum(b for p, b in own.items() if p not in full)


def pod_model(arch: str, depth):
    """Phase 12's model of ``arch``: (bf16 config at full width and depth,
    its requests, the fp32 config and weights of the parity runs at
    ``depth`` layers, or all of them); on the CPU, a rehearsal, the
    reduced widths with the served window."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if DEVICE == "cpu":
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16",
                                  swa_window=cfg.swa_window)
    return cfg, hybrid_requests(cfg), fp32_model(
        cfg, min(depth or cfg.n_layers, cfg.n_layers))


def ssm_cli_swap(executor) -> None:
    """After phase 12's CLI run: one swap through its executor when the
    traffic swapped nothing (:func:`executor_swap`)."""
    if executor.counters()["swapouts"] == 0:
        log("[ssm-tp] the CLI run swapped nothing: one swap through its "
            "executor")
        executor_swap(executor, "ssm-tp")


def ssm_tp_phase() -> dict:
    """Phase 12: the SSM and hybrid families on ``TP``-rank pods (ranks on
    one card when there is one), bf16 at full width, from random weights.
    For each arch of :data:`SSM_TP_ARCHS`: fp32 greedy tokens of the pods
    against the single-device kernel and plain engines
    (:func:`pod_parity`) and one swap round trip on the TP=2 pod, every
    rank's rows bit for bit; then at the served depth of
    :data:`SSM_TP_ARCHS` the bytes allocated beside ``param_count`` and
    the bytes the shards copy, phase 4's served path
    on the pod (launch counts reset before and read after: ``ssd_scan``
    layers x ranks a prefill; zamba2-7b's ``flash_attention`` sites x ranks
    a prefill and ``flash_decode_sharded`` sites x ranks a decode step),
    one decode window profiled, and the pod's first prefill logits
    against the single-device kernel model within ``POD_LOGIT_TOL``, in
    fp32 at the parity depth and in bf16 at the served depth
    (:func:`pod_logit_gap`).  Then the serve CLI
    on one pod of mamba2-130m (:data:`SSM_TP_CLI`), with one swap through
    its executor if its traffic swapped nothing.  Returns each arch's
    served-path launch counts."""
    import torch

    from repro_torch.launch import shard_params

    t_phase = time.perf_counter()
    mesh = tp_mesh()
    failures, launches = [], {}
    for arch, tps, depth, served in SSM_TP_ARCHS:
        t0 = time.perf_counter()
        cfg, requests, (cfg32, params32) = pod_model(arch, depth)
        failures += pod_parity(cfg32, params32, requests,
                               [tp_mesh(t) for t in tps])
        failures += pod_logit_gap(cfg32, params32, requests, mesh)[0]
        swap_roundtrip(cfg32, params32, requests, mesh)
        del params32
        gc.collect()
        torch.cuda.empty_cache()
        n, why = served_depth(cfg, served, copies=2)
        cfg = dataclasses.replace(cfg, n_layers=n)
        if why:
            log(f"[ssm-tp] {arch}: depth cut to {why}")
        base = torch.cuda.memory_allocated() if DEVICE != "cpu" else 0
        params = random_params(cfg)
        alloc = (torch.cuda.memory_allocated() - base if DEVICE != "cpu"
                 else sum(t.numel() * t.element_size()
                          for t in _tensors(params)))
        shards = shard_params(params, cfg, mesh)
        copied = pod_copies(params, shards)
        pod = (torch.cuda.memory_allocated() - base if DEVICE != "cpu"
               else alloc + copied)
        log(f"[ssm-tp] {describe(cfg, mesh)}; weights {alloc / 1e9:.3f} GB "
            f"allocated, param_count {cfg.param_count():,}; the pod's "
            f"shards copy {copied / 1e9:.3f} GB (the "
            "split leaves, each rank's packed in_proj and conv columns with "
            "B and C whole; replicated leaves are shared), "
            f"{pod / 1e9:.3f} GB allocated with the full tree")
        del shards
        launches[arch] = served_path(cfg, params, requests, mesh)
        gc.collect()
        profile_window(cfg, params, requests, mesh)
        gc.collect()
        failures += pod_logit_gap(cfg, params, requests, mesh)[0]
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[ssm-tp] {arch} in {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("phase 12: " + "; ".join(failures))
    t0 = time.perf_counter()
    run = cli_run("ssm tp2 auto", SSM_TP_CLI, after=ssm_cli_swap,
                  depth=POD_CLI_DEPTH)
    c = run["counters"]
    log(f"[ssm-tp] CLI on one TP={TP} pod of mamba2-130m: swapouts "
        f"{c['swapouts']}, swapins {c['swapins']}, preemptions "
        f"{run['preemptions']} in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ssm-tp] phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def ssm_tp_planted_fault() -> dict:
    """``rank_local_norm``: each rank of a pod normalises over its own
    slice of ``d_inner`` (:func:`rank_local_norm`), in memory; phase 12's
    fp32 pod parity and fp32 and bf16 logit gaps run against it on both
    pods.  Returns whether each caught the fault."""
    from repro_torch.configs import get_config

    import torch

    out = {"planted_fault": "rank_local_norm"}
    for arch, tps, depth, _ in SSM_TP_ARCHS:
        cfg, requests, (cfg32, params32) = pod_model(arch, depth)
        params = random_params(cfg)
        with rank_local_norm():
            bad = pod_parity(cfg32, params32, requests,
                             [tp_mesh(t) for t in tps])
            bad32, gap32 = pod_logit_gap(cfg32, params32, requests,
                                         tp_mesh())
            bad16, gap16 = pod_logit_gap(cfg, params, requests, tp_mesh())
        out[arch] = {"greedy_fp32_caught": bool(bad),
                     "logit_gap_fp32": gap32, "logit_fp32_caught": bool(bad32),
                     "logit_gap_bf16": gap16, "logit_caught": bool(bad16)}
        del params32, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# Phase 13: the vlm and audio families on tensor-parallel pods
# --------------------------------------------------------------------------- #

#: the depth of phase 13's fp32 runs: the vlm pod's layers, and whisper's
#: encoder and decoder layers each
VL_TP_PARITY_DEPTH, AU_TP_PARITY_DEPTH = 2, 2


def pod_arch(arch: str):
    """Phase 13's model of ``arch``: (the bf16 config at full width and
    depth, the fp32 config and weights of its parity runs, the step
    path's batch of a config, the cache rows a slot); on the CPU, a
    rehearsal, the reduced widths with the published rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    if DEVICE == "cpu":
        cfg = dataclasses.replace(
            cfg.reduced(), dtype="bfloat16",
            max_position_embeddings=cfg.max_position_embeddings)
    if cfg.family == "audio":
        cfg32 = dataclasses.replace(audio_depth(cfg, AU_TP_PARITY_DEPTH),
                                    dtype="float32")
        params32 = T.init_params(
            cfg32, torch.Generator(device=DEVICE).manual_seed(SEED + 1))
        return (cfg, (cfg32, params32),
                lambda c: audio_batch(c, STEP_SLOTS, STEP_PROMPT, SEED + 5),
                AU_ROWS)
    return (cfg, fp32_model(cfg, VL_TP_PARITY_DEPTH),
            lambda c: vision_batch(c, SEED + 4), MAX_LEN)


def pod_step_parity(cfg, params, batch, rows: int, mesh, tag: str):
    """The step path of a TP pod against one device on the same weights
    and inputs: ``make_prefill_step`` over ``batch`` into caches of
    ``rows`` rows a slot, then one ``make_serve_step``-sized decode step
    fed the pod's greedy token; the max |pod - one device| over both
    logits within ``POD_LOGIT_TOL``.  In fp32 also the greedy tokens of
    the prefill and ``STEPS`` serve steps (:func:`step_run`), identical.
    Returns (failures, gap)."""
    import torch

    from repro_torch.launch import shard_params
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    n_slots = batch["tokens"].shape[0]
    out, toks, tok = {}, {}, None
    for name, m in (("pod", mesh), ("one", None)):
        p = params if m is None else shard_params(params, cfg, m)
        logits, cache = make_prefill_step(cfg, mesh=m)(
            p, {**batch, "cache": T.init_cache(cfg, n_slots, rows, DEVICE,
                                               mesh=m)})
        if tok is None:
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
        step, _ = T.decode_step(p, cfg, tok, cache, mesh=m)
        out[name] = (logits.float(), step.float())
        del cache
        if cfg.dtype == "float32":
            toks[name] = step_run(cfg, p, batch, T.init_cache(
                cfg, n_slots, rows, DEVICE, mesh=m), "kernel", STEPS, m)[1]
        del p
    gap = max(float((a - b).abs().max())
              for a, b in zip(out["pod"], out["one"]))
    scale = max(float(a.abs().max()) for a in out["one"])
    finite = all(bool(torch.isfinite(a).all()) for a in out["pod"])
    tol = POD_LOGIT_TOL[cfg.family, cfg.dtype]
    depth = (f"{cfg.encoder.n_layers} + {cfg.n_layers}"
             if cfg.family == "audio" else str(cfg.n_layers))
    log(f"[{tag}] {cfg.arch_id} {cfg.dtype}, full width, {depth} layers, "
        f"step path ({'frames' if cfg.family == 'audio' else 'stub patches, 3-D positions'}): prefill and "
        f"first step logits, max |TP={len(mesh.ranks)} pod - one device| "
        f"= {gap:.4e} (tol {tol}), max |logit| = {scale:.3f}, "
        f"finite={finite}")
    bad = [] if finite and gap <= tol else [
        f"{cfg.arch_id}: {cfg.dtype} step-path logits, pod - one device = "
        f"{gap:.4e} (tol {tol}), finite={finite}"]
    if toks:
        same = int((toks["pod"] == toks["one"]).sum())
        log(f"[{tag}] {cfg.arch_id} fp32, {depth} layers, step path: greedy "
            f"tokens, pod vs one device, identical on {same}/"
            f"{toks['one'].numel()} ({n_slots} slots x {1 + STEPS})")
        if not torch.equal(toks["pod"], toks["one"]):
            bad.append(f"{cfg.arch_id}: fp32 step-path tokens of the pod "
                       f"identical on {same}/{toks['one'].numel()}")
    return bad, gap


def pod_step_path(cfg, params, batch, rows: int, mesh, tag: str) -> dict:
    """The step path on a TP pod through the kernels: ``make_prefill_step``
    over ``batch`` and ``STEPS`` serve steps, launch counts set to 0 just
    before and read just after (``flash_attention`` layers x ranks a
    prefill, ``flash_decode_sharded`` layers x ranks a step), the step
    wall median; one serve step profiled.  Returns the launch counts."""
    import statistics

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import shard_params
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T

    shards = shard_params(params, cfg, mesh)
    caches = T.init_cache(cfg, STEP_SLOTS, rows, DEVICE, mesh=mesh)
    ops.reset_launches()
    _, toks, walls, caches = step_run(cfg, shards, batch, caches, "kernel",
                                      STEPS, mesh)
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    n, tp = cfg.n_layers, len(mesh.ranks)
    segs = rank_launches(cfg, tp)
    check_launches(launches, {
        "flash_attention": (n * segs, f"{n} layers x {segs} rank launches "
                                      "x 1 prefill"),
        "flash_decode_sharded": (n * segs * STEPS, f"{n} layers x {segs} "
                                                   f"rank launches x {STEPS} "
                                                   "steps")})
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.arch_id} pod step path: a token lies "
                             "outside the vocabulary")
    med = statistics.median(walls) * 1e3
    what = (f"{STEP_SLOTS} prompts of {batch['tokens'].shape[1]} ids over "
            "their frames" if cfg.family == "audio" else
            f"{cfg.frontend_tokens} stub patches (3-D positions) and "
            f"{batch['tokens'].shape[1]} text ids")
    log(f"[{tag}] make_prefill_step(mesh=) ({what}) and {STEPS} "
        f"make_serve_step(mesh=) steps over per-rank bf16 caches of "
        f"{STEP_SLOTS} x {rows} rows, {describe(cfg, mesh)}: step wall "
        f"median {med:.2f} ms (min {min(walls) * 1e3:.2f}), "
        f"{STEP_SLOTS / (med / 1e3):.1f} tokens/s; launches: "
        f"flash_attention {launches['flash_attention']} = {n} x {segs} x 1 "
        f"prefill, flash_decode_sharded "
        f"{launches['flash_decode_sharded']} = {n} x {segs} x {STEPS} steps "
        f"(all counts: {json.dumps(launches)})")
    last = toks[:, -1]
    profiled(f"{cfg.arch_id} TP={tp}: one make_serve_step(mesh=) "
             f"({STEP_SLOTS} slots, {n} layers)",
             lambda: make_serve_step(cfg, mesh=mesh)(shards, last[:, None],
                                                     caches))
    del caches, shards
    return launches


def vlm_audio_tp_phase() -> dict:
    """Phase 13: qwen2-vl-7b served and whisper-large-v3 stepped on
    ``TP``-rank pods (ranks on one card when there is one), bf16 at full
    width and depth, from random weights.  First, at the parity depth in
    fp32: the vlm pod's greedy tokens against the single-device kernel and
    plain engines through evictions and a swap (:func:`pod_parity`), one
    swap round trip every rank's rows bit for bit, its first prefill
    logits; both pods' step path with patches and 3-D positions, or with
    frames, against one device (:func:`pod_step_parity`: tokens identical,
    logits within ``POD_LOGIT_TOL``).  Then at full depth: the bytes
    allocated beside ``param_count`` and the bytes the shards copy; for
    the vlm pod phase 4's served path (launch counts reset before and read
    after: ``flash_decode_sharded`` layers x ranks a step,
    ``flash_attention`` layers x ranks a prefill), one decode window
    profiled and its first prefill logits against one device; for both,
    the step path through the kernels (:func:`pod_step_path`) and its
    bf16 logits against one device.  Returns each arch's launch counts:
    the vlm pod's served path and the audio pod's step path."""
    import torch

    from repro_torch.launch import shard_params

    t_phase = time.perf_counter()
    mesh = tp_mesh()
    requests = make_requests(12, SEED)
    failures, launches = [], {}
    for arch, tag in ((VL_ARCH, "vlm-tp"), (AU_ARCH, "audio-tp")):
        t0 = time.perf_counter()
        cfg, (cfg32, params32), make_batch, rows = pod_arch(arch)
        if cfg.family == "vlm":
            failures += pod_parity(cfg32, params32, requests, [mesh], tag)
            failures += pod_logit_gap(cfg32, params32, requests, mesh,
                                      tag)[0]
            swap_roundtrip(cfg32, params32, requests, mesh)
        failures += pod_step_parity(cfg32, params32, make_batch(cfg32), rows,
                                    mesh, tag)[0]
        del params32
        gc.collect()
        torch.cuda.empty_cache()
        n, why = served_depth(cfg, None, copies=2)
        if why:
            raise AssertionError(f"phase 13: {arch} does not fit at full "
                                 f"depth: {why}")
        base = torch.cuda.memory_allocated() if DEVICE != "cpu" else 0
        params = random_params(cfg)
        alloc = (torch.cuda.memory_allocated() - base if DEVICE != "cpu"
                 else sum(t.numel() * t.element_size()
                          for t in _tensors(params)))
        shards = shard_params(params, cfg, mesh)
        copied = pod_copies(params, shards)
        del shards
        log(f"[{tag}] {describe(cfg, mesh)}"
            + (f", {cfg.encoder.n_layers} encoder layers over "
               f"{cfg.encoder.n_frames} frames" if cfg.encoder.n_layers
               else "")
            + f"; weights {alloc / 1e9:.3f} GB allocated, param_count "
            f"{cfg.param_count():,}; the pod's shards copy "
            f"{copied / 1e9:.3f} GB (the split leaves; replicated norms and "
            "learned positions are shared by the ranks)")
        batch = make_batch(cfg)
        if cfg.family == "vlm":
            launches[arch] = served_path(cfg, params, requests, mesh)
            gc.collect()
            profile_window(cfg, params, requests, mesh)
            gc.collect()
            failures += pod_logit_gap(cfg, params, requests, mesh, tag)[0]
            pod_step_path(cfg, params, batch, rows, mesh, tag)
        else:
            launches[arch] = pod_step_path(cfg, params, batch, rows, mesh,
                                           tag)
        gc.collect()
        failures += pod_step_parity(cfg, params, batch, rows, mesh, tag)[0]
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{tag}] {arch} in {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("phase 13: " + "; ".join(failures))
    log(f"[vlm-tp] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def pod_planted_fault(kinds) -> dict:
    """The in-memory pod faults ``kinds`` of :data:`POD_FAULTS`, each run
    against phase 13's step-path checks of the pod it reaches
    (``mrope_rank0_only`` the vlm pod with stub patches and 3-D
    positions, ``cross_rank_local`` the audio pod): fp32 tokens and
    logits at the parity depth and bf16 logits at full depth.  Returns
    whether each caught the fault, and the gaps."""
    import torch

    out = {}
    for kind in kinds:
        arch = VL_ARCH if kind == "mrope_rank0_only" else AU_ARCH
        cfg, (cfg32, params32), make_batch, rows = pod_arch(arch)
        with POD_FAULTS[kind]():
            bad32, gap32 = pod_step_parity(cfg32, params32, make_batch(cfg32),
                                           rows, tp_mesh(), kind)
            del params32
            gc.collect()
            params = random_params(cfg)
            bad16, gap16 = pod_step_parity(cfg, params, make_batch(cfg),
                                           rows, tp_mesh(), kind)
        out[kind] = {"arch": arch, "fp32_caught": bool(bad32),
                     "fp32_failures": bad32, "logit_gap_fp32": gap32,
                     "logit_gap_bf16": gap16,
                     "logit_tol_bf16": POD_LOGIT_TOL[cfg.family, cfg.dtype],
                     "bf16_caught": bool(bad16)}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return {"planted_fault": "pod", **out}


# --------------------------------------------------------------------------- #
# Phase 14: the LM training step
# --------------------------------------------------------------------------- #

#: phase 14's cells, bf16 at full width: each arch with the depth it trains
#: at (None: all its layers).  qwen2-moe-a2.7b trains 2 of its 24 layers:
#: at 24 its fp32 AdamW moments alone (2 x 14.3 B params) take ~115 GB
#: (:func:`train_cell` logs the figure from the params it builds)
TRAIN_ARCHS = [("qwen2-1.5b", None), ("mamba2-130m", None),
               ("qwen2-moe-a2.7b", 2)]
#: the training batch (``launch.train.batches``): B x S ids, and the
#: number of timed steps after one warm-up step
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 3
#: the tag of phase 3's rows at the evaluation forward's kernel shapes
TRAIN_TAG = "train"
#: the fp32 check of the card's training step against the CPU's: each
#: cell's full width at this depth, a batch of B x S ids
TRAIN_CHECK_DEPTH, TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 2, 16
#: the check's gates (TF32 off).  The loss: relative.  Each gradient leaf:
#: max |card - CPU| over max |CPU|.  Both are fp32 programs that sum in
#: different orders; a gradient entry sums T = 32 tokens times inner
#: widths of up to 151936 (the vocab), each order's error growing like
#: sqrt(n) * 2^-24 ~ 2.3e-5 for the longest sum, through a few such sums
#: in series over 2 layers: ~1e-4 at most.  The gate is 10x that, and a
#: path cut by a detached output reads 1.0 (its leaf's gradient is 0).
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
#: the kernel forward's loss against the plain forward's, bf16 at full
#: depth, absolute: a token's CE moves at most twice the largest logit
#: move, which phase 5's gates hold to ``LOGIT_TOL_BF16`` (the SSM's plain
#: scan casts ``a`` to bf16, so its logits differ from the kernel's by
#: ~0.094; see ``SSM_LOGIT_TOL_BF16``)
TRAIN_KERNEL_LOSS_TOL_BF16 = 2 * LOGIT_TOL_BF16
#: the same in fp32 at ``TRAIN_CHECK_DEPTH`` layers, relative
TRAIN_KERNEL_LOSS_RTOL_FP32 = 1e-4


def matmul_params(cfg, params) -> int:
    """The weights every token multiplies in a training step: all of them
    but an untied embedding table (a lookup), the dense MoE dispatch's
    every expert included."""
    from repro_torch.training.tree import leaves

    n = sum(t.numel() for t in leaves(params))
    return n - (0 if cfg.tie_embeddings else params["embed"].numel())


def train_flops(cfg, params, b: int, s: int) -> float:
    """The step's flops: 8 N T for the forward, the remat re-forward and
    the backward (2 + 2 + 4 per weight and token), plus the causal
    attention's scores and values, 2 B H D S^2 a forward, times 4."""
    from repro_torch.models import transformer as T

    flops = 8.0 * matmul_params(cfg, params) * b * s
    if cfg.family == "ssm":
        return flops
    sites = (T.hybrid_layout(cfg)[0] if cfg.family == "hybrid"
             else cfg.n_layers)
    return flops + 4 * 2.0 * b * cfg.n_heads * cfg.head_dim * s * s * sites


def loss_and_grads(cfg, params, batch):
    """The gradient half of ``launch.steps.make_train_step`` (remat on):
    (loss, every leaf's gradient in JAX's order, zeros for a leaf the
    loss does not reach), on the params' device."""
    import torch

    from repro_torch.models import loss_fn
    from repro_torch.training.loop import to_device
    from repro_torch.training.tree import leaves, unflatten

    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = loss_fn(unflatten(params, flat), cfg,
                      to_device(batch, flat[0].device), remat=True)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.item(), [torch.zeros_like(p) if g is None else g.detach()
                         for p, g in zip(flat, grads)]


@contextlib.contextmanager
def detached_paths():
    """Phase 14's planted fault: a forward whose attention output (and
    SSD scan output) is detached from the graph, as a kernel without a
    backward would leave it: the loss is unchanged, and the gradients of
    everything before it read 0."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S

    sdpa, scan = L.sdpa, S.ssd_chunked
    L.sdpa = lambda *a, **k: sdpa(*a, **k).detach()
    S.ssd_chunked = lambda *a, **k: tuple(t.detach() for t in scan(*a, **k))
    try:
        yield
    finally:
        L.sdpa, S.ssd_chunked = sdpa, scan


def grad_gap(card, cpu):
    """(loss gap relative, the largest per-leaf gradient gap): max |card -
    CPU| over max |CPU| of each leaf (a leaf 0 on both reads 0); the
    gradients lie on one device."""
    (lc, gc_), (lp, gp) = card, cpu
    gaps = []
    for a, b in zip(gc_, gp):
        den = float(b.abs().max())
        num = float((a - b).abs().max())
        gaps.append(0.0 if den == num == 0 else num / max(den, 1e-30))
    return abs(lc - lp) / abs(lp), max(gaps)


def train_cpu_check(cfg) -> list:
    """The card's training step against the port's CPU step, fp32 (TF32
    off) at ``TRAIN_CHECK_DEPTH`` layers of ``cfg``'s width, the same
    params and batch: the loss and every gradient leaf within their gates;
    the planted fault (:func:`detached_paths`) must fail the check.  Then
    the kernel forward under ``torch.no_grad()`` against the plain one
    within ``TRAIN_KERNEL_LOSS_RTOL_FP32``.  Returns failures."""
    import torch

    from repro_torch.launch import train
    from repro_torch.models import loss_fn
    from repro_torch.training.tree import tree_map

    failures = []
    cfg2, params = fp32_model(cfg, min(TRAIN_CHECK_DEPTH, cfg.n_layers))
    host = tree_map(lambda t: t.cpu(), params)
    batch = next(train.batches(cfg2, TRAIN_CHECK_B, TRAIN_CHECK_S, SEED))
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(cfg2, host, batch)
    t_cpu = time.perf_counter() - t0
    del host
    # compared on the card: one copy of the CPU's gradients there
    cpu = loss, [g.to(params["embed"].device) for g in grads]
    del grads
    card = loss_and_grads(cfg2, params, batch)
    dl, dg = grad_gap(card, cpu)
    with detached_paths():
        fl, fg = grad_gap(loss_and_grads(cfg2, params, batch), cpu)
    caught = not (fl <= TRAIN_LOSS_RTOL and fg <= TRAIN_GRAD_RTOL)
    log(f"[train] {cfg.arch_id}: fp32 step at {cfg2.n_layers} layers, B="
        f"{TRAIN_CHECK_B} x S={TRAIN_CHECK_S}, card vs CPU ({t_cpu:.1f} s on "
        f"the CPU): loss {card[0]:.6f} vs {cpu[0]:.6f} (gap {dl:.3e}, gate "
        f"{TRAIN_LOSS_RTOL:g}), gradients: largest leaf gap {dg:.3e} of "
        f"{len(cpu[1])} leaves (gate {TRAIN_GRAD_RTOL:g}); planted fault "
        f"(attention / scan output detached): loss gap {fl:.3e}, gradient "
        f"gap {fg:.3e}, {'caught' if caught else 'MISSED'}")
    if not (dl <= TRAIN_LOSS_RTOL and dg <= TRAIN_GRAD_RTOL):
        failures.append(f"{cfg.arch_id}: fp32 step differs from the CPU's "
                        f"(loss {dl:.3e}, gradients {dg:.3e})")
    if not caught:
        failures.append(f"{cfg.arch_id}: the detached-path fault passed "
                        "the CPU check")
    with torch.no_grad():
        lk, counts = kernel_loss(cfg2, params, batch)
        lt, _ = loss_fn(params, cfg2, batch, attn_impl="torch")
    gap = abs(lk - lt.item()) / abs(lt.item())
    log(f"[train] {cfg.arch_id}: fp32 evaluation forward at "
        f"{cfg2.n_layers} layers, kernels vs plain: loss {lk:.6f} vs "
        f"{lt.item():.6f} (gap {gap:.3e}, gate "
        f"{TRAIN_KERNEL_LOSS_RTOL_FP32:g}); launches {counts}")
    if not gap <= TRAIN_KERNEL_LOSS_RTOL_FP32:
        failures.append(f"{cfg.arch_id}: fp32 kernel forward loss gap "
                        f"{gap:.3e}")
    return failures


def kernel_loss(cfg, params, batch):
    """``loss_fn(attn_impl="kernel")`` (call under ``torch.no_grad()``)
    with the launch counts set to 0 just before and read just after;
    checks they are the forward's: ``flash_attention`` once an attention
    layer, ``ssd_scan`` once an SSM layer, nothing else.  Returns (loss,
    counts)."""
    from repro_torch.kernels import ops
    from repro_torch.models import loss_fn
    from repro_torch.models import transformer as T
    from repro_torch.training.loop import to_device

    batch = to_device(batch, params["embed"].device)
    ops.reset_launches()
    loss, _ = loss_fn(params, cfg, batch, attn_impl="kernel")
    counts = {n: f.launches for n, f in ops.KERNELS.items()}
    n_ssm = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_attn = (0 if cfg.family == "ssm" else T.hybrid_layout(cfg)[0]
              if cfg.family == "hybrid" else cfg.n_layers)
    want = {"flash_attention": (n_attn, f"{n_attn} attention layers x 1"),
            "ssd_scan": (n_ssm, f"{n_ssm} SSM layers x 1")}
    check_launches(counts, {k: v for k, v in want.items() if v[0]})
    return loss.item(), counts


def train_cell(arch: str, depth) -> dict:
    """One cell of phase 14 (module docstring): returns its numbers and
    the evaluation forward's launch counts."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps, train
    from repro_torch.models import loss_fn
    from repro_torch.training import AdamWConfig, adamw_init
    from repro_torch.training.loop import to_device
    from repro_torch.training.tree import leaves

    t_cell = time.perf_counter()
    full = get_config(arch)
    cfg = full
    if depth is not None and depth < full.n_layers:
        cfg = dataclasses.replace(full, n_layers=depth)
    failures = train_cpu_check(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = random_params(cfg)
    n = sum(t.numel() for t in leaves(params))
    if cfg is not full:
        per_layer = sum(t.numel() for t in leaves(params["layers"])) / depth
        log(f"[train] {arch}: trained at {depth} of its {full.n_layers} "
            f"layers, full width (at {full.n_layers} its fp32 AdamW moments "
            f"alone would take "
            f"{8 * (n + (full.n_layers - depth) * per_layer) / 1e9:.1f} GB)")
    logits = TRAIN_B * TRAIN_S * cfg.vocab_size * 4
    log(f"[train] {arch}: memory reckoned before the run: {2 * n / 1e9:.2f} "
        f"GB of bf16 params, {2 * n / 1e9:.2f} GB of gradients, "
        f"{8 * n / 1e9:.2f} GB of fp32 AdamW moments, {logits / 1e9:.2f} GB "
        f"of fp32 logits: {(12 * n + logits) / 1e9:.1f} GB "
        f"before activations (remat keeps one residual stream a layer) and "
        f"the update's new trees")
    it = train.batches(cfg, TRAIN_B, TRAIN_S, SEED)
    step = steps.make_train_step(cfg, opt_cfg=AdamWConfig(
        lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS + 1))
    state = adamw_init(params)
    torch.cuda.reset_peak_memory_stats()
    walls, losses, norms = [], [], []
    for i in range(TRAIN_STEPS + 1):
        batch = next(it)
        synchronize_all()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        synchronize_all()
        if i:  # the first step warms up
            walls.append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(walls) * 1e3
    tokens = TRAIN_B * TRAIN_S
    b_ms = train_flops(cfg, params, TRAIN_B, TRAIN_S) / PEAK_FLOPS[
        "bfloat16"] * 1e3
    finite = all(math.isfinite(x) for x in losses + norms)
    log(f"[train] {arch}: make_train_step (remat, AdamW, plain attention) "
        f"at full width, {cfg.n_layers} layers, bf16, B={TRAIN_B} x S="
        f"{TRAIN_S}: losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"gradient norms {', '.join(f'{x:.4f}' for x in norms)} (after one "
        f"warm-up step); step wall median {med:.2f} ms (devices "
        f"synchronised; {', '.join(f'{w * 1e3:.2f}' for w in walls)}), "
        f"{tokens / med * 1e3:.0f} tokens/s; bound {b_ms:.2f} ms (8 N T + "
        f"attention at 989 TFLOP/s, N = {matmul_params(cfg, params) / 1e9:.3f}"
        f" B): {100 * b_ms / med:.1f}% of it; peak memory allocated "
        f"{peak / 1e9:.2f} GB ({nvidia_smi_line()})")
    if not finite:
        failures.append(f"{arch}: a loss or gradient norm is not finite")
    del state
    gc.collect()
    with torch.no_grad():
        batch = to_device(next(it), params["embed"].device)
        lk, counts = kernel_loss(cfg, params, batch)
        lt = loss_fn(params, cfg, batch, attn_impl="torch")[0].item()
    gap = abs(lk - lt)
    log(f"[train] {arch}: bf16 evaluation forward at {cfg.n_layers} layers, "
        f"kernels vs plain: loss {lk:.5f} vs {lt:.5f} (gap {gap:.3e}, gate "
        f"{TRAIN_KERNEL_LOSS_TOL_BF16:g}); launches {json.dumps(counts)}")
    if not gap <= TRAIN_KERNEL_LOSS_TOL_BF16:
        failures.append(f"{arch}: bf16 kernel forward loss gap {gap:.3e}")
    grad_on = dict(params, embed=params["embed"].detach().requires_grad_(True))
    ops.reset_launches()
    try:
        loss_fn(grad_on, cfg, batch, attn_impl="kernel")
        failures.append(f"{arch}: loss_fn(attn_impl='kernel') ran under "
                        "grad")
    except NotImplementedError as e:
        log(f"[train] {arch}: loss_fn(attn_impl='kernel') under grad "
            f"raises: {e}")
    if any(f.launches for f in ops.KERNELS.values()):
        failures.append(f"{arch}: a kernel launched under grad")
    del params, grad_on
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 14: " + "; ".join(failures))
    log(f"[train] {arch} in {time.perf_counter() - t_cell:.1f} s")
    return {"launches": counts, "step_ms": med, "tokens_s": tokens / med
            * 1e3, "bound_ms": b_ms, "peak_gb": peak / 1e9,
            "losses": losses}


def train_cli() -> None:
    """``repro_torch.launch.train.main`` in this process: 3 steps of the
    reduced qwen2-1.5b with a checkpoint under ``build/``, then a
    ``--resume`` that must report the restored step."""
    from repro_torch.launch import train

    ckpt = ROOT / "build" / "lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", "qwen2-1.5b", "--log-every", "1", "--ckpt", str(ckpt),
            "--device", "cpu" if DEVICE == "cpu" else "cuda"]
    first = train.main(argv + ["--steps", "3"])
    again = train.main(argv + ["--steps", "1", "--resume"])
    shutil.rmtree(ckpt, ignore_errors=True)
    if again["start"] != 3 or not all(
            math.isfinite(x) for x in first["losses"] + again["losses"]):
        raise AssertionError(f"phase 14: the train CLI's resume started at "
                             f"{again['start']} or a loss is not finite")
    log(f"[train] CLI: 3 steps (losses {first['losses']}), checkpoint, "
        f"--resume from step {again['start']} (loss {again['losses']})")


def train_phase() -> dict:
    """Phase 14 (module docstring).  Returns each cell's numbers."""
    t0 = time.perf_counter()
    out = {arch: train_cell(arch, depth) for arch, depth in TRAIN_ARCHS}
    train_cli()
    log(f"[train] phase 14 in {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# Phase 15: the live-to-simulation loop (repro_torch.simulate)
# --------------------------------------------------------------------------- #


#: (a)'s probe windows on phase 4's dense executor, after its dozen
#: requests: each window length at each batch width, three times (the
#: first of each shape is dropped by the fit), so that the fit can tell
#: the per-window overhead from the per-token rate
SIM_PROBE_WINDOWS, SIM_PROBE_BATCHES, SIM_PROBE_REPEATS = (4, 16), (1, 2), 3
#: (c): the paper's Table 5 cell (llama-13b's A100 latency profile, batch
#: 4, 1x AVG.RequestRate, K = 50), ranked by phase 7's predictor
SIM_TABLE5 = dict(model="lam13", n_requests=200, batch_size=4,
                  rps_multiple=1.0, window=50, predictor="bge", seed=7)
#: (d): the scale fast path over (a)'s profile: requests of the flash_crowd
#: scenario at 1x the profile's AVG.RequestRate at batch 4 (50,000: at
#: 100,000 the two policies took 131 and 169 s of host time beside an
#: H100, more than the phase's room; PERF.md, section 4); the head
#: slice held against the exact event loop; the node count of the
#: multi-node FCFS slice (a reference caveat: printed, not gated)
SIM_SCALE_N, SIM_SCALE_BATCH, SIM_EXACT_HEAD, SIM_MULTI_NODE = (
    50_000, 4, 2_000, 3)


def probe_jobs(first_id: int, batch: int):
    """``batch`` probe jobs of 3 prompt tokens (benchmarks/live_engine.py's
    probes), ids from ``first_id``."""
    from repro_torch.core import Job

    return [Job(job_id=first_id + k, prompt="probe", arrival_time=0.0,
                prompt_tokens=[10 + (7 * (first_id + k) + i) % 50
                               for i in range(3)])
            for k in range(batch)]


def sim_calibrate(cfg, requests, served) -> dict:
    """Phase 15 (a) and (b) on phase 4's dense executor (``served``: its
    executor and responses, after the dozen requests under ISRTF): the
    probe windows, the fit of the simulator's latency model
    (``calibrated_profile``, ``fit_overhead_s``), and the same requests
    replayed through ``SimExecutor`` over the fit.  Launch counts run on
    from phase 4's reset (before the dozen requests) to after the probes.
    Returns the fitted profile and overhead."""
    from repro_torch.core import ElisServer, OraclePredictor, summarize
    from repro_torch.kernels import ops
    from repro_torch.simulate import SimExecutor

    t0 = time.perf_counter()
    executor, live = served["executor"], served["responses"]
    eng = executor.engines[0]
    first = 1 << 20
    for window in SIM_PROBE_WINDOWS:
        for batch in SIM_PROBE_BATCHES:
            for _ in range(SIM_PROBE_REPEATS):
                probes = probe_jobs(first, batch)
                first += batch
                executor.execute(0, probes, window, 0.0)
                for job in probes:
                    eng.evict_job(job.job_id)
    synchronize_all()
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    counters = executor.counters()
    steps = sum(rec["window"] for rec in executor.window_log)
    check_launches(launches, path_launches(
        cfg, 1, counters["prefill_dispatches"], steps))
    log("[sim] (a) windows (batch, window, duration ms): " + ", ".join(
        f"({r['batch']}, {r['window']}, {r['duration_s'] * 1e3:.2f})"
        for r in executor.window_log))
    prof = executor.calibrated_profile(name=f"live-{cfg.arch_id}")
    overhead = executor.fit_overhead_s
    fitted = {"decode_ms_1": prof.decode_ms_1,
              "batch_slowdown": prof.batch_slowdown,
              "window_overhead_ms": overhead * 1e3,
              "kv_capacity_tokens": prof.kv_capacity_tokens(),
              "avg_latency_ms": prof.avg_latency_ms}
    log(f"[sim] (a) {cfg.arch_id} ({cfg.n_layers} layers, {cfg.dtype}, "
        f"kernels) calibrated on {len(executor.window_log)} windows (phase "
        f"4's and the probes: windows {SIM_PROBE_WINDOWS} x batches "
        f"{SIM_PROBE_BATCHES} x {SIM_PROBE_REPEATS}): decode_ms_1 {prof.decode_ms_1:.4f} ms, "
        f"batch_slowdown {prof.batch_slowdown:.5f}, window overhead "
        f"{overhead * 1e3:.4f} ms, kv_capacity_tokens "
        f"{prof.kv_capacity_tokens()}, avg_latency_ms "
        f"{prof.avg_latency_ms:.2f}; launches over the run "
        f"{json.dumps({n: c for n, c in launches.items() if c})} "
        f"({nvidia_smi_line()})")
    # the rate and the capacity must be positive; the fit clamps the
    # overhead and the slowdown at 0 from below, where a window's fixed
    # cost or a wider batch's extra cost is lost in the noise
    if not (all(math.isfinite(v) for v in fitted.values())
            and fitted["decode_ms_1"] > 0
            and fitted["kv_capacity_tokens"] > 0
            and fitted["window_overhead_ms"] >= 0
            and fitted["batch_slowdown"] >= 0):
        raise AssertionError(f"phase 15 (a): fitted numbers not finite, or "
                             f"the rate or capacity not positive: {fitted}")
    for name in ("flash_attention", "flash_decode"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 15 (a): {name} never launched")

    # (b): the same requests through the simulator over the fit; each
    # replays the stream the live run emitted (the live run capped it at
    # the engine's max_output)
    by_id = {r.request_id: r for r in live}
    replay = [dataclasses.replace(
        r, true_output_len=by_id[r.request_id].n_tokens,
        output_tokens=list(by_id[r.request_id].tokens)) for r in requests]
    server = ElisServer(served_frontend(), OraclePredictor(),
                        SimExecutor(prof, sched_overhead_s=overhead))
    for r in replay:
        server.submit(r)
    sim = server.drain()
    server.frontend.state.assert_drained()
    bad = [(r.request_id, r.status.value, r.n_tokens) for r in sim
           if not r.ok or r.n_tokens != by_id[r.request_id].n_tokens]
    if len(sim) != len(requests) or bad or not all(r.ok for r in live):
        raise AssertionError(f"phase 15 (b): requests not finished in both "
                             f"runs: {bad}")
    m_live, m_sim = summarize(live), summarize(sim)
    log(f"[sim] (b) {len(sim)}/{len(requests)} requests finished live and "
        f"simulated: JCT mean live {m_live['jct_mean']:.4f} s, simulated "
        f"{m_sim['jct_mean']:.4f} s (ratio sim/live "
        f"{m_sim['jct_mean'] / m_live['jct_mean']:.4f}); p99 live "
        f"{m_live['jct_p99']:.4f} s, simulated {m_sim['jct_p99']:.4f} s; "
        f"preemptions live {m_live['preemptions']}, simulated "
        f"{m_sim['preemptions']}; (a)+(b) in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"profile": prof, "overhead_s": overhead, "fitted": fitted,
            "launches": launches, "jct_live": m_live["jct_mean"],
            "jct_sim": m_sim["jct_mean"]}


@contextlib.contextmanager
def finished_responses(out: list):
    """Collect the finished responses ``run_experiment`` summarizes (its
    per-job completion times) into ``out``."""
    from repro_torch.simulate import runner

    summarize = runner.summarize

    def tap(done):
        out[:] = list(done)
        return summarize(done)

    runner.summarize = tap
    try:
        yield
    finally:
        runner.summarize = summarize


def table5_run(pred, policy: str) -> dict:
    """One run of (c): the cell under ``policy``, ranked by ``pred``, with
    its dispatches timed and every job's predictions and completion time
    recorded."""
    from repro_torch.simulate import ExperimentConfig, run_experiment

    for attr in ("_apply", "predict"):     # earlier timers' wrappers
        pred.__dict__.pop(attr, None)
    timer = DispatchTimer(pred)
    predict, preds = pred.predict, {}

    def recorded(jobs):
        out = predict(jobs)
        for job, p in zip(jobs, out):
            preds.setdefault(job.job_id, []).append(p.mean)
        return out

    pred.predict = recorded
    done = []
    t0 = time.perf_counter()
    with finished_responses(done):
        m = run_experiment(ExperimentConfig(policy=policy, **SIM_TABLE5),
                           bge=pred)
    wall = time.perf_counter() - t0
    for attr in ("_apply", "predict"):
        pred.__dict__.pop(attr, None)
    return {"summary": m, "wall_s": wall, "predictor": timer.summary(wall),
            "finish": {r.request_id: r.finish_time for r in done},
            "order": [r.request_id for r in sorted(
                done, key=lambda r: (r.finish_time, r.request_id))],
            "predictions": preds}


def table5_cell(pred) -> dict:
    """Phase 15 (c): Table 5's cell under FCFS and ISRTF (twice), ranked by
    phase 7's full-width predictor on the card."""
    from repro_torch.core import improvement
    from repro_torch.data import n_shape_buckets

    t0 = time.perf_counter()
    runs = {name: table5_run(pred, name.split()[0])
            for name in ("fcfs", "isrtf", "isrtf again")}
    n = SIM_TABLE5["n_requests"]
    bound = n_shape_buckets(n, pred.cfg.max_len)
    for name, run in runs.items():
        m, s = run["summary"], run["predictor"]
        if m["n_finished"] != n or m["n_unfinished"]:
            raise AssertionError(f"phase 15 (c): {name}: {m['n_finished']}"
                                 f"/{n} finished")
        if name != "fcfs" and not (0 < s["dispatches"]
                                   and len(s["shapes"]) <= bound):
            raise AssertionError(f"phase 15 (c): {name}: {s['dispatches']} "
                                 f"dispatches over shapes {s['shapes']} "
                                 f"(bound {bound})")
        log(f"[sim] (c) Table 5 cell ({SIM_TABLE5['model']}'s A100 profile, "
            f"{n} requests, batch {SIM_TABLE5['batch_size']}, "
            f"{SIM_TABLE5['rps_multiple']}x AVG.RequestRate, K = "
            f"{SIM_TABLE5['window']}) {name}: JCT mean "
            f"{m['jct_mean']:.4f} s, p99 {m['jct_p99']:.4f} s (simulated "
            f"clock); {run['wall_s']:.2f} s on the host; predictor "
            f"{s['dispatches']} dispatches over {len(s['shapes'])} shapes "
            f"(bound {bound}): {s['shapes']}, device time "
            f"{s['device_ms_median']:.3f} ms median "
            f"({s['device_ms_mean']:.3f} mean) a dispatch, "
            f"{s['wall_ms_mean']:.3f} ms on the host clock, "
            f"{100 * s['share_of_wall']:.2f}% of the run's host time")
    a, b = runs["isrtf"], runs["isrtf again"]
    if a["finish"] != b["finish"]:
        jid = next(j for j in a["order"] if a["finish"][j]
                   != b["finish"].get(j))
        pa, pb = a["predictions"].get(jid, []), b["predictions"].get(jid, [])
        k = next((i for i, (x, y) in enumerate(zip(pa, pb)) if x != y),
                 min(len(pa), len(pb)))
        raise AssertionError(
            f"phase 15 (c): the two ISRTF runs differ first at job {jid}: "
            f"finished at {a['finish'][jid]!r} and "
            f"{b['finish'].get(jid)!r}; its predictions first differ at "
            f"dispatch {k}: {pa[k:k + 1]} and {pb[k:k + 1]}")
    imp = improvement(runs["fcfs"]["summary"], a["summary"])
    log(f"[sim] (c) ISRTF over FCFS: {imp:.2f}% lower mean JCT; the two "
        f"ISRTF runs' {n} completion times are identical bit for bit; (c) "
        f"in {time.perf_counter() - t0:.1f} s ({nvidia_smi_line()})")
    return {"runs": {k: {"summary": v["summary"], "wall_s": v["wall_s"],
                         "predictor": v["predictor"]}
                     for k, v in runs.items()},
            "improvement": imp}


def scale_cell(profile, overhead_s: float, n: int, policy: str,
               predictor: str, n_nodes: int = 1, head: int = 0) -> dict:
    """Phase 15 (d), one run, in a worker process: the scale fast path over
    ``n`` flash_crowd requests at 1x ``profile``'s AVG.RequestRate (batch
    ``SIM_SCALE_BATCH``); with ``head``, the first ``head`` requests
    through the fast path and the exact event loop, compared trace for
    trace."""
    import numpy as np

    from repro_torch.data.workload import build_scale_workload
    from repro_torch.simulate import (ScaleSimConfig, ScaleSimulator,
                                      avg_request_rate, run_exact_reference)

    rate = avg_request_rate(profile, SIM_SCALE_BATCH)
    w = build_scale_workload("flash_crowd", n, rate,
                             np.random.RandomState(SEED))
    cfg = ScaleSimConfig(model=profile, sched_overhead_s=overhead_s,
                         predictor=predictor, policy=policy,
                         n_nodes=n_nodes, batch_size=SIM_SCALE_BATCH,
                         seed=SEED)
    out = {"policy": policy, "predictor": predictor, "n_nodes": n_nodes,
           "rate": rate}
    if not head:
        res = ScaleSimulator(cfg).run(w)
        m = res.metrics()
        out.update({k: m[k] for k in ("n_finished", "jct_mean", "jct_p99",
                                      "fairness_jct", "n_windows",
                                      "n_coalesced_windows", "wall_s")},
                   n=w.n)
        return out
    w = w.head(head)
    fast = ScaleSimulator(cfg).run(w)
    t0 = time.perf_counter()
    exact = run_exact_reference(cfg, w)
    out.update(n=w.n, fast_s=fast.wall_s,
               exact_s=time.perf_counter() - t0,
               same_order=bool(np.array_equal(fast.finished_order,
                                              exact.finished_order)),
               same_finish=bool(np.array_equal(fast.finish, exact.finish,
                                               equal_nan=True)),
               n_finished=int(len(exact.finished_order)))
    return out


def sim_phase(pred, calibration) -> dict:
    """Phase 15 (c) and (d): Table 5's cell ranked by ``pred`` on the card
    while worker processes run the scale fast path over ``calibration``'s
    fitted profile (host code only)."""
    import concurrent.futures
    import multiprocessing

    t0 = time.perf_counter()
    cell = (calibration["profile"], calibration["overhead_s"], SIM_SCALE_N)
    jobs = {"fcfs": cell + ("fcfs", "noisy_oracle"),
            "isrtf": cell + ("isrtf", "noisy_oracle"),
            "exact isrtf": cell + ("isrtf", "oracle", 1, SIM_EXACT_HEAD),
            f"exact fcfs x{SIM_MULTI_NODE}": cell + (
                "fcfs", "oracle", SIM_MULTI_NODE, SIM_EXACT_HEAD)}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(jobs),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: pool.submit(scale_cell, *a) for k, a in jobs.items()}
        table5 = table5_cell(pred)
        scale = {k: f.result() for k, f in futures.items()}
    for k in ("fcfs", "isrtf"):
        r = scale[k]
        if r["n_finished"] != r["n"]:
            raise AssertionError(f"phase 15 (d): {k}: {r['n_finished']}/"
                                 f"{r['n']} finished")
        log(f"[sim] (d) scale fast path, {r['n']} flash_crowd requests at "
            f"{r['rate']:.4f} req/s (1x AVG.RequestRate of (a)'s profile at "
            f"batch {SIM_SCALE_BATCH}), 1 node, {k}, noisy oracle: JCT mean "
            f"{r['jct_mean']:.4f} s, p99 {r['jct_p99']:.4f} s, fairness "
            f"ratio {r['fairness_jct']:.4f}; {r['n_windows']} windows "
            f"({r['n_coalesced_windows']} coalesced) in {r['wall_s']:.2f} s "
            f"on the host")
    for k in ("exact isrtf", f"exact fcfs x{SIM_MULTI_NODE}"):
        r = scale[k]
        same = r["same_order"] and r["same_finish"]
        log(f"[sim] (d) head slice of {r['n']}, {r['policy']}, "
            f"{r['predictor']}, {r['n_nodes']} node(s): fast path "
            f"{'trace-identical to' if same else 'DIFFERS from'} the exact "
            f"loop (finished_order {r['same_order']}, finish times "
            f"{r['same_finish']}); fast {r['fast_s']:.2f} s, exact "
            f"{r['exact_s']:.2f} s on the host"
            + ("" if r["n_nodes"] == 1 else
               " (multi-node FCFS is a reference caveat: printed, not "
               "gated)"))
    r = scale["exact isrtf"]
    if not (r["same_order"] and r["same_finish"]
            and r["n_finished"] == SIM_EXACT_HEAD):
        raise AssertionError("phase 15 (d): the fast path is not "
                             "trace-identical to the exact loop on the "
                             "one-node ISRTF head slice")
    log(f"[sim] (c)+(d) in {time.perf_counter() - t0:.1f} s")
    return {"table5": table5, "scale": scale}


# --------------------------------------------------------------------------- #
# Phase 16: int8 pods, the dry run held against the card, pod training
# --------------------------------------------------------------------------- #

#: the depth of phase 16's fp32 checks (the int8 pod's tokens and logits,
#: the pod's gradients, the ZeRO-1 step): full width, as phase 5's
INT8_POD_DEPTH = 2
#: fp32 decode logits of the int8 pod against one device's, the largest
#: difference over the largest |logit|: the ranks' K/V projections sum in
#: another order than one device's, which could move a code by one step.
#: On the CPU at small widths the correct pods read 3e-7 to 4e-7 and the
#: planted per-rank scales 2.6e-3 to 3.0e-3 (tests/test_torch_mesh_steps.py);
#: the reduced qwen2-1.5b at 2 layers read 1.2e-5 and 3.0e-3
INT8_POD_RTOL = 3e-4
#: bf16 logits of the int8 pod's first decode step at full depth against
#: one device's int8 step: the limit ``POD_LOGIT_TOL`` sets for the other
#: families' pods
INT8_POD_LOGIT_TOL_BF16 = 0.1
#: the dry run's peak against ``max_memory_allocated`` over the card's
#: step, as a share of the card's, signed: the meta run sees neither the
#: allocator's rounding nor a kernel's scratch, which only add on the
#: card, so the dry run may lie under the card's peak by this share and
#: never over it.  On an H100 the four cases read 0.01% to 0.20% under
#: it; a dry run that left out the int8 serve step's cache reads 3.65%
#: to 3.78% under it, and one that left out the train step's largest
#: leaf's moments 3.52% to 6.63% (printed beside each case)
DRY_PEAK_MARGIN = 0.01
#: ``memory_allocated`` of the card's inputs against the blocks of their
#: bytes rounded to 512, as a share: the caching allocator also leaves a
#: large block's remainder of up to 1 MiB unsplit (on an H100: 2.0 MiB of
#: 14.4 GiB on one device, 19.1 MiB at TP=2)
ALLOC_MARGIN = 0.002
#: phase 16 (b)'s serve step: the int8-small cache's 512 rows at 16 slots,
#: the least batch the reference lays out without a context-parallel
#: cache (``global_batch < 16``, which the dry run skips: item 8.5)
DRY_SERVE_B = 16
#: phase 16 (b)'s widest pod: the dry-serve shape of qwen2-1.5b at mesh
#: (1, 16), the production mesh's model axis, where ranks 12-15 hold no
#: heads (all 16 ranks on one card)
DRY_WIDE_TP = 16
#: phase 16 (c)'s ZeRO-1 step: AdamW at a constant lr from the first step,
#: so that one step moves every param by about lr (the train step's
#: default warmup moves it by lr / 100, under any absolute limit a fault
#: would read); its two gates, as tests/test_torch_mesh_steps.py defines
#: and reads them on the CPU: the moments' largest leaf gap over the
#: leaf's largest |value|, and the params' gap norm over the norm of one
#: device's update (Adam's first step is lr * g / (|g| + eps): a gradient
#: within its rounding of zero may flip an element's step)
ZERO1_LR = 1e-3
ZERO1_MOMENT_RTOL = 1e-4
ZERO1_PARAM_RTOL = 1e-3
#: the hand bounds of chip_smoke's earlier phases that phase 16 sets the
#: dry run's roofline beside (PERF.md section 2): decode_32k's bytes
#: bound (phase 4) and train-dense's flop bound (phase 14), ms
HAND_BOUND_MS = {"decode_32k": 19.15, "train": 51.88}


def int8_pod_run(cfg, params, mesh, n_steps: int):
    """Prefill ``step_prompts`` into a fresh int8 cache of ``STEP_SLOTS``
    x ``MAX_LEN`` rows (one per rank with ``mesh``) through
    ``make_prefill_step``, one ``transformer.decode_step`` for the first
    step's logits, then ``make_serve_step``: (tokens (B, 1 + n_steps),
    the first step's logits in fp32, the serve steps' wall seconds)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T

    prompts = torch.as_tensor(step_prompts(), device=DEVICE)
    cache = (small_cache(cfg) if mesh is None else T.init_cache(
        cfg, STEP_SLOTS, MAX_LEN, mesh=mesh, kv_dtype="int8"))
    logits, cache = make_prefill_step(cfg, mesh=mesh)(
        params, {"tokens": prompts, "cache": cache})
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    first, cache = T.decode_step(params, cfg, tok[:, None], cache,
                                 moe_impl="dense", mesh=mesh)
    first = first[:, -1].float()
    toks = [tok, first.argmax(-1).to(torch.int32)]
    serve, walls = make_serve_step(cfg, mesh=mesh), []
    for _ in range(n_steps - 1):
        synchronize_all()
        t0 = time.perf_counter()
        tok, cache = serve(params, toks[-1][:, None], cache)
        synchronize_all()
        walls.append(time.perf_counter() - t0)
        toks.append(tok)
    return torch.stack(toks, dim=1), first, walls


def rel_gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def int8_pod_phase(cfg) -> tuple:
    """Phase 16 (a): qwen2-1.5b served as a TP=2 pod over int8 caches at
    full width and depth, bf16: prefill and ``STEPS`` serve steps with
    the launch counts set to 0 just before and read just after
    (``flash_attention`` layers x 2 a prefill, ``flash_decode_int8_sharded``
    layers x 2 a step), the first step's logits against one device's;
    then in fp32 at ``INT8_POD_DEPTH`` layers the pod's greedy tokens and
    logits against one device's, and the planted per-rank scales, which
    must fail that check.  Returns (launch counts, failures)."""
    import statistics

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import shard_params
    from repro_torch.models import layers as L

    failures = []
    mesh = tp_mesh()
    params = random_params(cfg)
    one_toks, one_first, _ = int8_pod_run(cfg, params, None, 2)
    shards = shard_params(params, cfg, mesh)
    del params
    ops.reset_launches()
    toks, first, walls = int8_pod_run(cfg, shards, mesh, STEPS)
    synchronize_all()
    launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    n = cfg.n_layers
    check_launches(launches, {
        "flash_attention": (n * TP, f"{n} layers x {TP} ranks x 1 prefill"),
        "flash_decode_int8_sharded": (n * TP * STEPS, f"{n} layers x {TP} "
                                      f"ranks x {STEPS} steps")})
    gap = float((first - one_first).abs().max())
    med = statistics.median(walls) * 1e3
    log(f"[int8-pod] {describe(cfg, mesh)} over int8 caches ({STEP_SLOTS} "
        f"slots x {MAX_LEN} rows a rank): {STEPS} steps, step wall median "
        f"{med:.2f} ms; launches flash_attention "
        f"{launches['flash_attention']} = {n} x {TP} x 1 prefill, "
        f"flash_decode_int8_sharded "
        f"{launches['flash_decode_int8_sharded']} = {n} x {TP} x {STEPS}; "
        f"bf16 first-step logits vs one device: {gap:.4e} (limit "
        f"{INT8_POD_LOGIT_TOL_BF16}); first 3 tokens equal one device's "
        f"on {int((toks[:, :3] == one_toks).all(1).sum())}/{STEP_SLOTS} "
        "slots")
    if not gap <= INT8_POD_LOGIT_TOL_BF16:
        failures.append(f"int8 pod: bf16 logits {gap:.4e} off one device")
    cost = op_dispatch_cost(cfg)
    log(f"[int8-pod] flash_decode_int8_sharded at the pod's per-rank "
        f"shapes, host wall a call over 200 back-to-back calls: direct "
        f"{cost['direct']:.1f} us, through its custom op "
        f"{cost['custom op']:.1f} us; {n} calls a step: "
        f"{(cost['custom op'] - cost['direct']) * n / 1e3:+.3f} ms a step "
        f"beside the step's wall median {med:.2f} ms")
    del shards
    torch.cuda.empty_cache()
    cfg2, params = fp32_model(cfg, INT8_POD_DEPTH)
    shards = shard_params(params, cfg2, mesh)
    want, want_first, _ = int8_pod_run(cfg2, params, None, 8)
    got, got_first, _ = int8_pod_run(cfg2, shards, mesh, 8)
    right = L.quantize_kv_shared
    L.quantize_kv_shared = lambda xs: [L.quantize_kv(x) for x in xs]
    try:
        _, bad_first, _ = int8_pod_run(cfg2, shards, mesh, 1)
    finally:
        L.quantize_kv_shared = right
    same, g, bad = (bool(torch.equal(got, want)),
                    rel_gap(got_first, want_first),
                    rel_gap(bad_first, want_first))
    log(f"[int8-pod] fp32 at {cfg2.n_layers} layers: pod vs one device "
        f"greedy tokens over 8 steps {'identical' if same else 'DIFFER'}, "
        f"first-step logits gap {g:.3e} of the largest (gate "
        f"{INT8_POD_RTOL:g}); planted per-rank scales: {bad:.3e}, "
        f"{'caught' if bad > INT8_POD_RTOL else 'MISSED'}")
    if not (same and g <= INT8_POD_RTOL):
        failures.append(f"int8 pod: fp32 tokens or logits ({g:.3e}) differ "
                        "from one device")
    if not bad > INT8_POD_RTOL:
        failures.append("int8 pod: the per-rank-scale fault passed")
    del params, shards
    torch.cuda.empty_cache()
    return launches, failures


def op_dispatch_cost(cfg, calls: int = 200) -> dict:
    """Host microseconds a call of ``flash_decode_int8_sharded`` takes at
    the int8 pod's per-rank shapes (``STEP_SLOTS`` x ``MAX_LEN``, TP=2),
    launched directly as the serving path launches it, and through its
    custom op, as the wrapper calls it while a dispatch mode counts:
    ``calls`` back-to-back calls each, synchronized once, alternated
    twice, the smaller of each (the launches count; call it outside a
    counted window)."""
    import torch

    from repro_torch.kernels import ops

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    h, kh, d = cfg.n_heads // TP, cfg.n_kv_heads // TP, cfg.head_dim
    qs = [torch.randn((STEP_SLOTS, 1, h, d), generator=g, device=DEVICE,
                      dtype=torch.bfloat16) for _ in range(TP)]
    ks = [torch.randint(-127, 128, (STEP_SLOTS, MAX_LEN, kh, d), generator=g,
                        device=DEVICE, dtype=torch.int8) for _ in range(2 * TP)]
    sc = [torch.rand((STEP_SLOTS, MAX_LEN), generator=g, device=DEVICE)
          for _ in range(2 * TP)]
    kv_len = torch.full((STEP_SLOTS,), MAX_LEN, dtype=torch.int32,
                        device=DEVICE)
    q_off = kv_len - 1
    paths = {
        "direct": lambda: ops._flash_decode_int8_sharded(
            qs, ks[:TP], ks[TP:], sc[:TP], sc[TP:], kv_len, q_off, None),
        "custom op": lambda: torch.ops.repro_torch.flash_decode_int8_sharded(
            qs, ks[:TP], ks[TP:], sc[:TP], sc[TP:], kv_len, q_off, 0, [], 0)}
    best = {}
    for _ in range(2):
        for name, fn in paths.items():
            for _ in range(10):
                fn()
            synchronize_all()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            synchronize_all()
            us = (time.perf_counter() - t0) / calls * 1e6
            best[name] = min(best.get(name, us), us)
    return best


def round_block(nbytes: int) -> int:
    """The bytes the caching allocator holds for a tensor of ``nbytes``:
    a multiple of 512, and none for an empty one (a rank of a pod that
    holds no heads)."""
    return max(-(-nbytes // 512) * 512, 512) if nbytes else 0


def dry_vs_card(cfg, shape, mesh_shape, kv_dtype, kv_shard="auto",
                moe_scheme="tensor") -> list:
    """Phase 16 (b), one case (phase 18 (c) with ``kv_shard="seq"``,
    phase 19 (b) with ``moe_scheme="expert"``): the
    dry run's record on the meta device against the same rank program on
    the card (``dryrun.rank_program``): the pod's flops (``pod flops``)
    against ``FlopCounterMode`` over the card's step (exact), and the
    busiest rank's (the record's ``flops``) against ``dryrun.measure``
    over the card's step (exact); the pod's argument bytes against the
    card inputs' (exact), and ``memory_allocated`` of those inputs
    against their 512-byte blocks within ``ALLOC_MARGIN``; the pod's
    peak at most ``DRY_PEAK_MARGIN`` under ``max_memory_allocated`` over
    the step and never over it, and a planted miss outside that; its
    roofline beside the step's time.  Returns failures."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun, make_mesh

    failures = []
    tag = f"{shape.name} {shape.global_batch}x{shape.seq_len} {mesh_shape}"
    rec = dryrun.lower_one(cfg.arch_id, shape.name, False, input_shape=shape,
                           cfg_override=cfg, mesh_shape=mesh_shape,
                           kv_dtype=kv_dtype, kv_shard=kv_shard,
                           moe_scheme=moe_scheme)
    if rec["status"] != "ok":
        return [f"dry run {tag}: {rec}"]
    tag += f" kv_shard={rec['kv_shard']} moe_scheme={moe_scheme}"
    mesh = make_mesh(mesh_shape, ("data", "model"),
                     devices=[DEVICE] * mesh_shape[0] * mesh_shape[1])
    gc.collect()
    torch.cuda.empty_cache()
    synchronize_all()
    base = torch.cuda.memory_allocated()
    step, inputs, tp = dryrun.rank_program(cfg, shape, mesh,
                                           kv_dtype=kv_dtype,
                                           kv_shard=kv_shard,
                                           moe_scheme=moe_scheme)
    synchronize_all()
    held = torch.cuda.memory_allocated() - base
    sizes = dryrun._storages(inputs).values()
    raw, blocks = sum(sizes), sum(round_block(b) for b in sizes)
    ma = rec["memory_analysis"]
    grad = (torch.no_grad() if shape.kind != "train"
            else contextlib.nullcontext())
    torch.cuda.reset_peak_memory_stats()
    with grad, FlopCounterMode(display=False) as fc:
        out = step(*inputs)
    synchronize_all()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    with grad:
        busiest = dryrun.measure(step, *inputs, owners=dryrun.rank_owners(
            inputs, shape.kind))["flops"]
    ms = []
    for _ in range(3):
        with grad:
            ms.append(event_ms(lambda: step(*inputs), reps=1, warmup=0))
    t = sorted(ms)[1]
    flops, dry_peak = fc.get_total_flops(), ma["pod_peak_memory_in_bytes"]
    pod_flops = rec["cost_analysis"]["pod flops"]
    # the planted miss: a dry run that left out the serve step's cache, or
    # the train step's largest leaf's two moments
    if shape.kind == "train":
        what = "the largest leaf's moments"
        miss = 2 * max(x.nbytes for x in dryrun._tensors(inputs[1].mu))
    else:
        what = "the cache"
        miss = sum(dryrun._storages(inputs[-1]).values())

    def peak_ok(dry):
        return 0 <= peak - dry <= DRY_PEAK_MARGIN * peak

    missed = (dry_peak - miss - peak) / peak
    dt = "bfloat16" if cfg.dtype == "bfloat16" else "float32"
    t_f = rec["flops"] / PEAK_FLOPS[dt] * 1e3
    t_b = rec["bytes_accessed"] / HBM_BYTES_S * 1e3
    log(f"[dryrun] {cfg.arch_id} {tag}, {tp} rank(s) on one card: pod "
        f"flops dry {pod_flops:.6e} vs card {flops:.6e}, busiest rank's dry "
        f"{rec['flops']:.6e} vs card {busiest:.6e}; pod argument bytes "
        f"dry {ma['pod_argument_size_in_bytes']:.0f} vs card inputs {raw} "
        f"(memory_allocated {held} vs their 512-byte blocks {blocks}); peak "
        f"dry {dry_peak / 1e9:.4f} GB vs max_memory_allocated "
        f"{peak / 1e9:.4f} GB ({(dry_peak - peak) / peak:+.2%}, gate 0 to "
        f"-{DRY_PEAK_MARGIN:.0%}; without {what}: {missed:+.2%}, "
        f"{'MISSED' if peak_ok(dry_peak - miss) else 'caught'}); "
        f"collectives {rec['collectives']['count']}"
        f" ({rec['collectives']['total']:.4e} B a device); roofline of the "
        f"busiest rank at {PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s and "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s: flops {t_f:.3f} ms, bytes "
        f"{t_b:.3f} ms; the step on the card {t:.3f} ms (median of 3)")
    if flops != pod_flops or busiest != rec["flops"]:
        failures.append(f"dry run {tag}: flops differ from the card's")
    if raw != ma["pod_argument_size_in_bytes"]:
        failures.append(f"dry run {tag}: argument bytes differ")
    if not 0 <= held - blocks <= ALLOC_MARGIN * blocks:
        failures.append(f"dry run {tag}: memory_allocated {held} vs "
                        f"{blocks}")
    if not peak_ok(dry_peak):
        failures.append(f"dry run {tag}: peak {dry_peak} vs {peak}")
    if peak_ok(dry_peak - miss):
        failures.append(f"dry run {tag}: the peak's gate passed a dry run "
                        f"without {what}")
    del step, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def dry_roofline(cfg, shape_name: str, shape=None, kv_dtype=None) -> None:
    """The dry run's roofline of one device's step beside a hand bound."""
    from repro_torch.launch import dryrun

    rec = dryrun.lower_one(cfg.arch_id, shape_name, False, input_shape=shape,
                           cfg_override=cfg, mesh_shape=(1, 1),
                           kv_dtype=kv_dtype)
    dt = "bfloat16" if cfg.dtype == "bfloat16" else "float32"
    t_f = rec["flops"] / PEAK_FLOPS[dt] * 1e3
    t_b = rec["bytes_accessed"] / HBM_BYTES_S * 1e3
    key = "train" if shape is not None else shape_name
    log(f"[dryrun] {cfg.arch_id} {shape_name} on one device, dry-run "
        f"roofline: flops {rec['flops']:.4e} -> {t_f:.3f} ms, bytes "
        f"accessed {rec['bytes_accessed']:.4e} -> {t_b:.3f} ms, bound "
        f"{max(t_f, t_b):.3f} ms; the hand bound {HAND_BOUND_MS[key]} ms "
        f"(trace {rec['lower_s']} s)")


def zero1_gaps(cfg, params, batch, mesh, pod_grads=None) -> tuple:
    """One AdamW step at ``ZERO1_LR`` on one device and one ZeRO-1 step on
    ``mesh`` from the same params: (the moments' gap, the params' gap, as
    ``ZERO1_*_RTOL`` define them).  ``pod_grads`` replaces
    ``steps._pod_grads`` in the ZeRO-1 step (the planted fault)."""
    import torch

    from repro_torch.launch import partition as PT
    from repro_torch.launch import steps
    from repro_torch.training import AdamWConfig, adamw_init
    from repro_torch.training.tree import leaves

    opt = AdamWConfig(lr=ZERO1_LR, schedule="constant", warmup_steps=1)
    p1, s1, _ = steps.make_train_step(cfg, opt_cfg=opt)(
        params, adamw_init(params), batch)
    pods = steps.shard_pods(params, cfg, mesh)
    right = steps._pod_grads
    steps._pod_grads = pod_grads or right
    try:
        p2, s2, _ = steps.make_train_step(cfg, mesh=mesh, opt_cfg=opt)(
            pods, steps.zero1_init(pods, cfg, mesh), batch)
    finally:
        steps._pod_grads = right
    moment = 0.0
    for got, want in ((s2.mu, s1.mu), (s2.nu, s1.nu)):
        for g, w in zip(leaves(steps.zero1_gather(got, pods, cfg, mesh)),
                        leaves(want)):
            moment = max(moment, rel_gap(g, w))
    update = torch.cat([(a - b).flatten()
                        for a, b in zip(leaves(p1), leaves(params))]).norm()
    param = max(float(torch.cat([
        (a - w).flatten() for a, w in zip(
            leaves(PT.gather_shards(pp, cfg, pod)), leaves(p1))]).norm()
        / update) for pod, pp in zip(steps._pod_list(mesh)[0], p2))
    return moment, param


def pod_train_phase(cfg) -> list:
    """Phase 16 (c): qwen2-1.5b's training step as a TP=2 pod, fp32 at
    full width and ``INT8_POD_DEPTH`` layers: the pod's loss and its
    gradients gathered (``partition.gather_shards``) against one
    device's within phase 14's gates; then one ZeRO-1 step on a (2, 1)
    mesh against the unsliced step within ``ZERO1_MOMENT_RTOL`` and
    ``ZERO1_PARAM_RTOL``, and the planted fault, the first pod's
    gradients alone in place of the pods' sum, which must fail both.
    Returns failures."""
    import torch

    from repro_torch.launch import make_mesh, shard_params, steps, train
    from repro_torch.launch import partition as PT
    from repro_torch.models import loss_fn
    from repro_torch.training.loop import to_device
    from repro_torch.training.tree import leaves, tree_map, unflatten

    failures = []
    cfg2, params = fp32_model(cfg, INT8_POD_DEPTH)
    batch = next(train.batches(cfg2, TRAIN_CHECK_B, TRAIN_CHECK_S, SEED))
    one = loss_and_grads(cfg2, params, batch)
    mesh = tp_mesh()
    shards = shard_params(params, cfg2, mesh)
    flat = [[t.detach().requires_grad_(True) for t in leaves(s)]
            for s in shards]
    loss, _ = loss_fn([unflatten(s, f) for s, f in zip(shards, flat)], cfg2,
                      to_device(batch, mesh.ranks[0]), remat=True, mesh=mesh)
    every = [t for f in flat for t in f]
    grads = iter(torch.autograd.grad(loss, every))
    gathered = PT.gather_shards([unflatten(s, [next(grads) for _ in f])
                                 for s, f in zip(shards, flat)], cfg2, mesh,
                                add=True)
    dl, dg = grad_gap((loss.item(), leaves(gathered)), one)
    del shards, flat, every, gathered
    dmesh = make_mesh((2, 1), ("data", "model"), devices=[DEVICE] * 2)
    moment, param = zero1_gaps(cfg2, params, batch, dmesh)
    calls = [0]

    def first_pod_only(*args, **kwargs):
        g, m = right(*args, **kwargs)
        calls[0] += 1
        return (g if calls[0] % 2 else tree_map(torch.zeros_like, g)), m

    right = steps._pod_grads
    bad_moment, bad_param = zero1_gaps(cfg2, params, batch, dmesh,
                                       first_pod_only)
    caught = bad_moment > ZERO1_MOMENT_RTOL and bad_param > ZERO1_PARAM_RTOL
    log(f"[pod-train] {cfg.arch_id} fp32 at {cfg2.n_layers} layers, B="
        f"{TRAIN_CHECK_B} x S={TRAIN_CHECK_S}: TP=2 pod vs one device loss "
        f"gap {dl:.3e} (gate {TRAIN_LOSS_RTOL:g}), gathered gradients' "
        f"largest leaf gap {dg:.3e} (gate {TRAIN_GRAD_RTOL:g}); ZeRO-1 on a "
        f"(2, 1) mesh at a constant lr {ZERO1_LR:g}, one step vs the "
        f"unsliced step: moments {moment:.3e} (gate "
        f"{ZERO1_MOMENT_RTOL:g}), params {param:.3e} of the update's norm "
        f"(gate {ZERO1_PARAM_RTOL:g}); planted first pod's gradients "
        f"alone: {bad_moment:.3e} and {bad_param:.3e}, "
        f"{'caught' if caught else 'MISSED'}")
    if not (dl <= TRAIN_LOSS_RTOL and dg <= TRAIN_GRAD_RTOL):
        failures.append(f"pod training: loss {dl:.3e} / gradients {dg:.3e}")
    if not (moment <= ZERO1_MOMENT_RTOL and param <= ZERO1_PARAM_RTOL):
        failures.append(f"ZeRO-1 step differs from the unsliced: moments "
                        f"{moment:.3e}, params {param:.3e}")
    if not caught:
        failures.append("ZeRO-1: the unsummed-gradient fault passed")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def dryrun_phase() -> dict:
    """Phase 16 (module docstring).  Returns (a)'s launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import InputShape

    t0 = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    launches, failures = int8_pod_phase(cfg)
    t_a = time.perf_counter() - t0
    serve = InputShape("serve_512", MAX_LEN, DRY_SERVE_B, "decode")
    trainer = InputShape("train_8x512", TRAIN_S, TRAIN_B, "train")
    for shape, kv in ((serve, "int8"), (trainer, None)):
        for mesh_shape in ((1, 1), (1, TP)):
            failures += dry_vs_card(cfg, shape, mesh_shape, kv)
    # the production mesh's model axis: 12 query heads over 16 ranks, four
    # of which hold none, in the head layout ("auto" is phase 18's
    # sequence-sharded one there)
    failures += dry_vs_card(cfg, serve, (1, DRY_WIDE_TP), "int8",
                            kv_shard="heads")
    dry_roofline(cfg, "decode_32k", kv_dtype="int8")
    dry_roofline(cfg, "train_8x512", trainer)
    t_b = time.perf_counter() - t0 - t_a
    failures += pod_train_phase(cfg)
    torch.cuda.empty_cache()
    log(f"[dryrun] phase 16 in {time.perf_counter() - t0:.1f} s ((a) "
        f"{t_a:.1f}, (b) {t_b:.1f})")
    if failures:
        raise AssertionError("phase 16: " + "; ".join(failures))
    return launches


# --------------------------------------------------------------------------- #
# Phase 17: pods whose ranks do not divide the heads, groups or widths
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def segment_kv_offset():
    """The planted fault of phase 17, in memory: every uniform GQA segment
    of a rank whose heads cut a group reads its KV heads from the first of
    the rank's cache (query head j of the segment reads KV head j // G of
    the rank, without the offset of the segment's first KV head).  A rank
    of one segment is unchanged, so only the cut ranks go wrong."""
    from repro_torch.kernels import ops

    right = ops._segments

    def faulty(name, q, k, q0, group):
        return [(a, b, 0, d - c) for a, b, c, d in right(name, q, k, q0,
                                                          group)]

    ops._segments = faulty
    try:
        yield
    finally:
        ops._segments = right


def uneven_phase() -> dict:
    """Phase 17: pods whose ranks do not divide the heads, the GQA groups
    or the widths, every rank on one card, bf16 at full width and depth
    from random weights.  (a) llama3.2-3b as a TP=3 pod (8 query heads a
    rank over GQA groups of 3: a rank cuts a group and launches each
    attention kernel as up to three uniform segments; d_ff and vocab
    split as whole columns, the first ranks one more): first in fp32 at
    2 layers its greedy tokens against the single-device kernel and plain
    engines through evictions and a swap (:func:`pod_parity`) and its
    first prefill logits against one device's within ``POD_LOGIT_TOL``,
    then the planted ``segment_kv_offset``, which that logit check must
    catch; at 28 layers phase 4's served path on the pod (launch counts
    reset before and read after, :func:`path_launches` with its segment
    launches), the bf16 prefill logits against one device's, and
    ``UNEVEN_INT8_STEPS`` steps over int8 caches
    (``flash_decode_int8_sharded`` in segments).  (b) whisper-large-v3 as
    a TP=4 pod (its vocab 51866 split unevenly) through the step
    functions: fp32 at the parity depth and bf16 at full depth against one
    device (:func:`pod_step_parity`), and the step path through the
    kernels (:func:`pod_step_path`).  Returns each pod's launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import shard_params
    from repro_torch.launch.partition import vocab_range

    t_phase = time.perf_counter()
    failures, launches = [], {}
    cfg = get_config(UNEVEN_ARCH)
    if DEVICE == "cpu":  # the rehearsal: 6 / 2 heads, so ranks cut groups
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16",
                                  n_heads=6, n_kv_heads=2)
    mesh = tp_mesh(UNEVEN_TP)
    requests = make_requests(12, SEED)
    cfg32, params32 = fp32_model(cfg, 2)
    failures += pod_parity(cfg32, params32, requests, [mesh], "uneven")
    bad, gap32 = pod_logit_gap(cfg32, params32, requests, mesh, "uneven")
    failures += bad
    with segment_kv_offset():
        caught, gap_f = pod_logit_gap(cfg32, params32, requests, mesh,
                                      "uneven, planted segment_kv_offset")
    log(f"[uneven] planted segment_kv_offset: fp32 logit gap {gap_f:.4e} "
        f"against the correct pod's {gap32:.4e}: "
        + ("caught" if caught else "MISSED"))
    if not caught:
        failures.append("the planted segment_kv_offset passed the fp32 "
                        "logit check")
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    params = random_params(cfg)
    launches[UNEVEN_TAG] = dict(served_path(cfg, params, requests, mesh))
    gc.collect()
    failures += pod_logit_gap(cfg, params, requests, mesh, "uneven")[0]
    shards = shard_params(params, cfg, mesh)
    ops.reset_launches()
    toks, first, walls = int8_pod_run(cfg, shards, mesh, UNEVEN_INT8_STEPS)
    counts = {name: fn.launches for name, fn in ops.KERNELS.items()}
    n, segs = cfg.n_layers, rank_launches(cfg, UNEVEN_TP)
    check_launches(counts, {
        "flash_attention": (n * segs, f"{n} layers x {segs} segment "
                                      "launches x 1 prefill"),
        "flash_decode_int8_sharded": (
            n * segs * UNEVEN_INT8_STEPS,
            f"{n} layers x {segs} segment launches x {UNEVEN_INT8_STEPS} "
            "steps")})
    finite = bool(torch.isfinite(first).all())
    if not finite or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        failures.append(f"{UNEVEN_TAG} int8 steps: logits finite={finite}, "
                        "or a token outside the vocabulary")
    launches[UNEVEN_TAG]["flash_decode_int8_sharded"] = counts[
        "flash_decode_int8_sharded"]
    log(f"[uneven] {UNEVEN_TAG} over int8 caches of {STEP_SLOTS} x "
        f"{MAX_LEN} rows: {UNEVEN_INT8_STEPS} steps, wall median "
        f"{sorted(walls)[len(walls) // 2] * 1e3:.2f} ms; launches "
        f"flash_attention {counts['flash_attention']}, "
        f"flash_decode_int8_sharded {counts['flash_decode_int8_sharded']} "
        f"= {n} x {segs} x {UNEVEN_INT8_STEPS}; first-step logits "
        f"finite={finite}")
    del shards, params
    gc.collect()
    torch.cuda.empty_cache()
    mesh4, tag = tp_mesh(AU_UNEVEN_TP), "uneven-audio"
    cfg, (cfg32, params32), make_batch, rows = pod_arch(AU_ARCH)
    if DEVICE == "cpu":  # the rehearsal: a vocab 4 does not divide
        from repro_torch.models import transformer as T

        cfg, cfg32 = (dataclasses.replace(c, vocab_size=509)
                      for c in (cfg, cfg32))
        params32 = T.init_params(cfg32, torch.Generator(
            device=DEVICE).manual_seed(SEED + 1))
    rows_of = [hi - lo for lo, hi in (vocab_range(cfg, AU_UNEVEN_TP, r)
                                      for r in range(AU_UNEVEN_TP))]
    log(f"[{tag}] vocab {cfg.vocab_size} over {AU_UNEVEN_TP} ranks: "
        f"{rows_of} rows")
    failures += pod_step_parity(cfg32, params32, make_batch(cfg32), rows,
                                mesh4, tag)[0]
    del params32
    gc.collect()
    params = random_params(cfg)
    batch = make_batch(cfg)
    launches[AU_UNEVEN_TAG] = pod_step_path(cfg, params, batch, rows, mesh4,
                                            tag)
    gc.collect()
    failures += pod_step_parity(cfg, params, batch, rows, mesh4, tag)[0]
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[uneven] phase 17 in {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("phase 17: " + "; ".join(failures))
    return launches


# --------------------------------------------------------------------------- #
# Phase 18: caches a pod splits other than by head, read as split-KV
# --------------------------------------------------------------------------- #

#: phase 18 (a): qwen2-1.5b's sequence-sharded pod at (1, TP), 4 slots
#: over 32768 rows (16384 a rank: 3.76 GB of bf16 K/V at 28 layers),
#: prompts of ``SEQ_PROMPT`` tokens, then ``SEQ_STEPS`` decode steps.  The
#: prompts lie on rank 0 alone (rank 1 holds no visible row: the
#: empty-rank rule); slot 3 is filled with random rows up to
#: ``SEQ_CROSS`` first, so that its rows lie on both ranks
SEQ_SLOTS, SEQ_ROWS, SEQ_PROMPT, SEQ_STEPS = 4, 32768, 300, 8
SEQ_CROSS = 16500
#: (a) at full width in bf16: the sequence-sharded pod's logits against
#: the head layout's pod's, both fed one device's tokens, every step, by
#: slot.  Slots 0-2 lie on rank 0 alone, within the first key split of
#: both layouts, so the two compute the same sums (the same bits on an
#: H100; rank 0's rows read one position off move them 0.047-0.051);
#: slot 3's rows lie on both ranks and merge in another order, so its gap
#: is bf16's own: 0.1445 (int8 0.1367) on an H100, about as far as one
#: device lies from a plain fp32 run of the same weights there (0.140)
SEQ_BF16_TOL = {"rank 0 alone": 1e-2, "both ranks": 0.25}
#: (a)'s parity pod: fp32 at ``SEQ_PARITY_DEPTH`` layers, against one
#: device within ``POD_LOGIT_TOL`` fp32 (1e-3: the ranks' states merge in
#: another order than one softmax sums), greedy tokens equal
SEQ_PARITY_DEPTH = 2
#: (b): the context-parallel decode at (2, 1), batch 1, fp32 at
#: ``SEQ_PARITY_DEPTH`` layers, over a linear cache of 32768 rows (16384
#: a data index, read by the partials kernel) and over long_500k's ring of
#: 8192 rows (4096 a data index, read plain), each after a prompt that
#: crosses the data indices' boundary, ``CP_STEPS`` steps
CP_CASES = {"linear": (32768, None, 16400), "ring": (524288, 8192, 9000)}
CP_STEPS = 4


def seq_fill(cfg, one, pods, slot: int, lo: int, hi: int, gen) -> None:
    """Write the same random K/V rows ``[lo, hi)`` of ``slot`` into the
    one-device cache ``one`` and, row by owner and KV head by owner, into
    each pod's rank list of ``pods`` (the sequence-sharded layout: every
    KV head over the rank's rows from ``row0``; the head layout: the
    rank's KV heads over every row), int8 codes and scales where the
    caches are int8.  Dense rows are drawn in bf16, so that a bf16 and an
    fp32 cache hold the same values."""
    import torch

    from repro_torch.launch.partition import kv_head_range

    kv = one["kv"]
    for name in ("k", "v", "k_scale", "v_scale"):
        buf = getattr(kv, name)
        if buf is None:
            continue
        shape = (buf.shape[0], hi - lo) + tuple(buf.shape[3:])
        if buf.dtype == torch.int8:
            rows = torch.empty(shape, dtype=torch.int8, device=buf.device
                               ).random_(-127, 128, generator=gen)
        elif name.endswith("scale"):
            rows = torch.empty(shape, device=buf.device).uniform_(
                0.005, 0.025, generator=gen)
        else:
            rows = torch.randn(shape, generator=gen, device=buf.device
                               ).to(torch.bfloat16)
        buf[:, slot, lo:hi] = rows.to(buf.dtype)
        for pod in pods:
            for r, c in enumerate(pod):
                piece = c["kv"]
                a = max(lo, piece.row0)
                b = min(hi, piece.row0 + piece.k.shape[2])
                part = rows[:, a - lo:b - lo]
                if not name.endswith("scale") and (
                        piece.k.shape[3] != cfg.n_kv_heads):
                    h0, h1 = kv_head_range(cfg, len(pod), r)
                    part = part[:, :, h0:h1]
                if b > a:
                    dst = getattr(piece, name)
                    dst[:, slot, a - piece.row0:b - piece.row0] = part.to(
                        device=dst.device, dtype=dst.dtype)


def seq_run(cfg, params, cache, mesh, prompts, n_steps: int, fill=None,
            forced=None, attn_impl: str = "kernel"):
    """Prefill ``prompts`` into ``cache`` through ``make_prefill_step``,
    ``fill()`` (random rows) if given, then ``n_steps`` decode steps
    through ``transformer.decode_step``, each fed the last step's greedy
    token, or with ``forced`` (B, n_steps) those tokens in turn: (greedy
    tokens (B, n_steps), the steps' logits in fp32, the tokens fed (B,
    n_steps))."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    logits, cache = make_prefill_step(cfg, mesh=mesh, attn_impl=attn_impl)(
        params, {"tokens": prompts, "cache": cache})
    if fill is not None:
        fill()
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    toks, outs, fed = [], [], []
    for i in range(n_steps):
        if forced is not None:
            tok = forced[:, i]
        fed.append(tok)
        lg, cache = T.decode_step(params, cfg, tok[:, None], cache,
                                  mesh=mesh, attn_impl=attn_impl)
        outs.append(lg[:, -1].float())
        tok = outs[-1].argmax(-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, 1), torch.stack(outs, 1), torch.stack(fed, 1)


def seq_prompts(cfg):
    """(a)'s ``SEQ_SLOTS`` prompts of ``SEQ_PROMPT`` tokens (9 in the CPU
    rehearsal), on ``DEVICE``."""
    import torch

    prompt = SEQ_PROMPT if DEVICE != "cpu" else 9
    return torch.as_tensor(
        [[t % cfg.vocab_size for t in (r.prompt_tokens * prompt)[:prompt]]
         for r in make_requests(SEQ_SLOTS, SEED)], device=DEVICE)


def seq_runs(cfg, params, kv_dtype, mesh, layouts=("seq",),
             forced: bool = False, ref=None):
    """(a)'s runs from the same prompts and random rows (slot 3 filled to
    ``SEQ_CROSS``): one device's greedy run first, then a pod of each
    ``kv_shard`` of ``layouts``, greedy or, with ``forced``, fed one
    device's tokens (so that a token another run rounds differently does
    not change the next step's input).  The layout "planted" is "seq"
    with the fault the gates must catch: rank 0 reads its rows one
    position off (its ``row0`` + 1).  ``ref``: (cfg, params) of one
    device's plain fp32 run (an fp32 cache, ``attn_impl="torch"``) fed
    one device's tokens too.  Returns {"one", each layout, "ref"}:
    (greedy tokens, logits)."""
    import torch

    from repro_torch.launch import shard_params
    from repro_torch.models import transformer as T

    rows = SEQ_ROWS if DEVICE != "cpu" else 64
    cross = SEQ_CROSS if DEVICE != "cpu" else 40
    prompts = seq_prompts(cfg)
    prompt = prompts.shape[1]
    runs = [("one", cfg, params, None, "kernel",
             T.init_cache(cfg, SEQ_SLOTS, rows, DEVICE, kv_dtype=kv_dtype))]
    shards = shard_params(params, cfg, mesh)
    runs += [(lay, cfg, shards, mesh, "kernel",
              T.init_cache(cfg, SEQ_SLOTS, rows, mesh=mesh,
                           kv_dtype=kv_dtype,
                           kv_shard="seq" if lay == "planted" else lay))
             for lay in layouts]
    if ref is not None:
        runs.append(("ref", *ref, None, "torch",
                      T.init_cache(ref[0], SEQ_SLOTS, rows, DEVICE,
                                   kv_dtype=kv_dtype)))
    # rows no prompt writes: the prefills leave them, and set every len
    for one, pods in ((runs[0][-1], [r[-1] for r in runs[1:]
                                     if r[3] is not None]),
                      (runs[-1][-1] if ref is not None else None, [])):
        if one is not None:
            seq_fill(cfg, one, pods, 3, prompt, cross,
                     torch.Generator(device=DEVICE).manual_seed(SEED + 7))
    out, fed = {}, None
    while runs:
        name, c, p, m, impl, cache = runs.pop(0)

        def fill(cache=cache, m=m, name=name):
            for x in (cache if m is not None else [cache]):
                x["len"][3] = cross
            if name == "planted":
                cache[0]["kv"].row0 += 1

        tok, lg, f = seq_run(c, p, cache, m, prompts, SEQ_STEPS, fill,
                             forced=fed, attn_impl=impl)
        if forced and name == "one":
            fed = f
        out[name] = (tok, lg)
        del cache
    del shards
    return out


def seq_phase() -> dict:
    """Phase 18: caches a pod splits other than by head, every rank on
    one card.  (a) qwen2-1.5b's sequence-sharded pod (``kv_shard="seq"``)
    at (1, TP): in fp32 at ``SEQ_PARITY_DEPTH`` layers its decode tokens
    and logits against one device's over the same prompts and random
    rows, bf16 and int8, and the planted ``row0`` fault, which the fp32
    gate must catch; at full width and depth (28 layers, bf16, 4 x 32768
    rows) one device, the sequence-sharded pod, the head layout's pod and
    the planted pod over the same prompts and rows, the pods fed one
    device's tokens, with launch counts reset before and read after
    (``flash_decode_partials`` and ``flash_decode_combine``): the
    sequence-sharded pod's logits against the head layout's on every
    slot and step within ``SEQ_BF16_TOL``, the planted pod's outside it,
    finite logits, tokens in the vocabulary; each run's gap from a plain
    fp32 run of the same weights reported (where bf16's own error lies);
    the same over an int8 cache (``flash_decode_int8_partials``, the
    scales split with the rows).  (b) the context-parallel decode at (2,
    1) (``CP_CASES``), fp32, against one device.  (c) the dry run of the
    serve step at (1, TP) with ``kv_shard="seq"`` against the card
    (:func:`dry_vs_card`).  Returns the launch counts of (a)'s full-width
    bf16 and int8 runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import make_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import pod_meshes
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import transformer as T
    from repro_torch.training.tree import tree_map

    t_phase = time.perf_counter()
    failures, launches = [], {}
    cfg = get_config("qwen2-1.5b")
    if DEVICE == "cpu":
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16")
    mesh = tp_mesh(TP)
    tol32 = POD_LOGIT_TOL["dense", "float32"]
    # (a) fp32 parity, the planted fault
    cfg32, params32 = fp32_model(cfg, SEQ_PARITY_DEPTH)
    for kv_dtype in (None, "int8"):
        r = seq_runs(cfg32, params32, kv_dtype, mesh)
        (tp_tok, tp_lg), (one_tok, one_lg) = r["seq"], r["one"]
        gap = float((tp_lg - one_lg).abs().max())
        same = bool(torch.equal(tp_tok, one_tok))
        log(f"[seq] {cfg.arch_id} fp32, {SEQ_PARITY_DEPTH} layers, "
            f"kv_shard='seq' at (1, {TP}), {kv_dtype or 'dense'} cache of "
            f"{SEQ_SLOTS} x {SEQ_ROWS} rows: {SEQ_STEPS} decode steps, "
            f"tokens equal to one device's: {same}; max |logit gap| "
            f"{gap:.4e} (tol {tol32}), max |logit| "
            f"{float(one_lg.abs().max()):.3f}")
        if not same or not gap <= tol32:
            failures.append(f"seq pod fp32 {kv_dtype}: tokens equal {same},"
                            f" logit gap {gap:.4e}")
    r = seq_runs(cfg32, params32, None, mesh, layouts=("planted",))
    gap_f = float((r["planted"][1] - r["one"][1]).abs().max())
    caught = not gap_f <= tol32
    log(f"[seq] planted row0 + 1 on rank 0: fp32 logit gap {gap_f:.4e}: "
        + ("caught" if caught else "MISSED"))
    if not caught:
        failures.append("the planted row0 fault passed the fp32 gate")
    del params32, r
    gc.collect()
    torch.cuda.empty_cache() if DEVICE != "cpu" else None
    # (a) full width and depth, bf16 then int8: the main path's launches
    params = random_params(cfg)
    ref = (dataclasses.replace(cfg, dtype="float32"),
           tree_map(lambda x: x.float(), params))
    for kv_dtype, name in ((None, "flash_decode_partials"),
                           ("int8", "flash_decode_int8_partials")):
        ops.reset_launches()
        t0 = time.perf_counter()
        r = seq_runs(cfg, params, kv_dtype, mesh, forced=True,
                     layouts=("seq", "heads", "planted"),
                     ref=ref if kv_dtype is None else None)
        counts = {n: fn.launches for n, fn in ops.KERNELS.items()}
        n = cfg.n_layers
        # the prefills (flash_attention: one device and each pod's ranks);
        # the seq and planted pods' steps (partials a rank, one combine),
        # the head layout's (one launch a rank) and one device's; the
        # plain fp32 run launches nothing
        one = "flash_decode" if kv_dtype is None else "flash_decode_int8"
        check_launches(counts, {
            "flash_attention": (n * (3 * TP + 1), f"{n} layers x (3 pods "
                                                  f"x {TP} ranks + one "
                                                  "device) x 1 prefill"),
            name: (2 * n * TP * SEQ_STEPS, f"2 pods x {n} layers x {TP} "
                                           f"ranks x {SEQ_STEPS} steps"),
            "flash_decode_combine": (2 * n * SEQ_STEPS, f"2 pods x {n} "
                                                        f"layers x "
                                                        f"{SEQ_STEPS} steps"),
            one + "_sharded": (n * TP * SEQ_STEPS, f"{n} layers x {TP} "
                                                   f"ranks x {SEQ_STEPS} "
                                                   "steps, head layout"),
            one: (n * SEQ_STEPS, f"{n} layers x {SEQ_STEPS} steps, one "
                                 "device")})
        def by_slot(a, b):
            return [float(f"{x:.4e}") for x in
                    (r[a][1] - r[b][1]).abs().amax(dim=(1, 2))]

        # the gate: the two pods hold the same rows in two layouts and are
        # fed the same tokens
        gaps = {k: by_slot(k, "heads") for k in ("seq", "planted")}
        limits = [SEQ_BF16_TOL["rank 0 alone"]] * 3 + [
            SEQ_BF16_TOL["both ranks"]]
        ok = all(g <= t for g, t in zip(gaps["seq"], limits))
        caught = any(g > t for g, t in zip(gaps["planted"], limits))
        finite = bool(torch.isfinite(r["seq"][1]).all()) and bool(
            ((r["seq"][0] >= 0) & (r["seq"][0] < cfg.vocab_size)).all())
        vs_ref = ({k: by_slot(k, "ref") for k in ("one", "seq", "heads")}
                  if "ref" in r else {})
        agree = {k: int((r[k][0] == r["one"][0]).sum())
                 for k in ("seq", "heads")}
        log(f"[seq] {cfg.arch_id} bf16, {n} layers, (1, {TP}), "
            f"{kv_dtype or 'bf16'} cache of {SEQ_SLOTS} x {SEQ_ROWS} rows, "
            f"prompts of {SEQ_PROMPT}, slot 3 filled to {SEQ_CROSS}: "
            f"{SEQ_STEPS} steps of one device, the seq, head and planted "
            f"pods{' and a plain fp32 run' if vs_ref else ''} in "
            f"{time.perf_counter() - t0:.1f} s, the pods fed one device's "
            f"tokens; launches {name} {counts[name]}, flash_decode_combine "
            f"{counts['flash_decode_combine']}; max |logit gap| by slot: "
            f"seq vs heads {gaps['seq']} (gate {limits}: "
            f"{'ok' if ok else 'FAILED'}), planted vs heads "
            f"{gaps['planted']} ({'caught' if caught else 'MISSED'}); seq "
            f"vs one device {by_slot('seq', 'one')}, heads vs one device "
            f"{by_slot('heads', 'one')}"
            + ("; vs the plain fp32 run: " + ", ".join(
                f"{k} {v}" for k, v in vs_ref.items()) if vs_ref else "")
            + f"; greedy tokens equal to one device's: seq {agree['seq']}, "
            f"heads {agree['heads']} of {r['one'][0].numel()}; logits "
            f"finite and tokens in the vocabulary: {finite}")
        if not ok:
            failures.append(f"seq pod bf16 {kv_dtype}: logits {gaps['seq']}"
                            f" from the head layout's pod's (gate {limits})")
        if not caught:
            failures.append(f"seq pod bf16 {kv_dtype}: the planted row0 "
                            f"passed the gate ({gaps['planted']})")
        if not finite:
            failures.append(f"seq pod bf16 {kv_dtype}: logits not finite "
                            "or a token outside the vocabulary")
        launches[kv_dtype or "bf16"] = counts
        del r
        gc.collect()
    del params, ref
    gc.collect()
    torch.cuda.empty_cache() if DEVICE != "cpu" else None
    # (b) context-parallel, fp32
    cp = make_mesh((2, 1), ("data", "model"), devices=tp_devices(2))
    pod = pod_meshes(cp)[0]
    cfg32, params32 = fp32_model(cfg, SEQ_PARITY_DEPTH)
    for kind, (max_len, window, plen) in CP_CASES.items():
        if DEVICE == "cpu":
            max_len, window, plen = (64, None, 40) if window is None else (
                128, 16, 24)
        prompt = torch.as_tensor([[8 + (97 * i) % 8000 for i in range(
            plen)]], device=DEVICE) % cfg.vocab_size
        ops.reset_launches()
        runs = []
        for m, p, c in (
                (pod, ST.shard_pods(params32, cfg32, cp)[0],
                 ST.init_pod_caches(cfg32, 1, max_len, cp,
                                    context_parallel=True,
                                    sliding_window=window)),
                (None, params32, T.init_cache(cfg32, 1, max_len, DEVICE,
                                              sliding_window=window))):
            runs.append(seq_run(cfg32, p, c, m, prompt, CP_STEPS)[:2])
            del c
        (cp_tok, cp_lg), (one_tok, one_lg) = runs
        gap = float((cp_lg - one_lg).abs().max())
        same = bool(torch.equal(cp_tok, one_tok))
        part = ops.flash_decode_partials.launches
        log(f"[seq] context-parallel at (2, 1), fp32, {SEQ_PARITY_DEPTH} "
            f"layers, {kind} cache of {window or max_len} rows, a prompt of "
            f"{plen}: {CP_STEPS} steps, tokens equal {same}, max |logit "
            f"gap| {gap:.4e} (tol {tol32}); flash_decode_partials "
            f"{part} launches")
        want_part = (SEQ_PARITY_DEPTH * 2 * CP_STEPS if window is None
                     else 0)
        if not same or not gap <= tol32 or (DEVICE != "cpu"
                                            and part != want_part):
            failures.append(f"context-parallel {kind}: tokens {same}, gap "
                            f"{gap:.4e}, partials launches {part} (want "
                            f"{want_part})")
    del params32
    gc.collect()
    # (c) the dry run of the sequence-sharded serve step against the card
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
        serve = InputShape("serve_512", MAX_LEN, DRY_SERVE_B, "decode")
        failures += dry_vs_card(cfg, serve, (1, TP), "int8", kv_shard="seq")
    log(f"[seq] phase 18 in {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("phase 18: " + "; ".join(failures))
    return launches


def seq_kernel_rows() -> dict:
    """Phase 18 (d): the partials and combine kernels at (a)'s shapes, B=4
    slots of 12 / 2 heads of dim 128 over 32768 rows split at 16384 as
    (1, TP) splits them, ``kv_len`` 300 (rank 1 empty), 16383, 16500 and
    32768: each launch against its plain version on the same inputs
    (``ref.flash_decode_partials`` with the launch's splits, on rank 0's
    rows; ``ref.flash_decode_combine`` on the scratch both ranks wrote),
    the two ranks' merged output against ``ref.flash_decode`` over the
    unsharded cache, and the times of each launch, its plain version and
    ``sdpa`` over the unsharded cache (GQA, masked by ``kv_len``), with
    the bound.  Returns the rows by kernel name."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    B, L, h, kh, d = SEQ_SLOTS, SEQ_ROWS, HEADS, KV_HEADS, HEAD_DIM
    cut = L // TP
    dt = torch.bfloat16
    q = torch.randn((B, 1, h, d), generator=gen, device="cuda", dtype=dt)
    kv_len = torch.tensor([SEQ_PROMPT, cut - 1, SEQ_CROSS, L],
                          dtype=torch.int32, device="cuda")
    q_off = kv_len - 1
    pos = torch.arange(L, device="cuda")
    mask = ((pos[None] < kv_len[:, None]) & (pos[None] <= q_off[:, None])
            )[:, None, None, :]
    n = [ops.partial_splits(B, cut, q.device)[0]] * TP
    rows, failures = {}, []
    for name in ("flash_decode_partials", "flash_decode_int8_partials"):
        if name == "flash_decode_partials":
            k, v = (torch.randn((B, L, kh, d), generator=gen, device="cuda",
                                dtype=dt) for _ in range(2))
            scales = []
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            row_bytes = 2 * kh * d * 2
        else:
            k, v, ks, vs = int8_kv(B, L, kh, d, gen)
            scales = [ks, vs]
            kt, vt = (ref.dequantize(c, sc).to(dt).transpose(1, 2)
                      .contiguous() for c, sc in ((k, ks), (v, vs)))
            row_bytes = 2 * kh * d + 8
        fn, plain = getattr(ops, name), getattr(ref, name)
        shard = [[x[:, r * cut:(r + 1) * cut].contiguous() for r in
                  range(TP)] for x in [k, v] + scales]
        part = ops.Partials(B, h, sum(n), d, q.device)
        kw = dict(kv_len=kv_len, q_offset=q_off)

        def pod_partials():
            for r in range(TP):
                fn(q, *(x[r] for x in shard), out=part, row0=r * cut,
                   split0=r * n[0], **kw)

        def rank0():
            return fn(q, *(x[0] for x in shard), **kw)

        n_split, s_len = ops.partial_splits(B, cut, q.device)

        def rank0_plain():
            return plain(q, *(x[0] for x in shard), n_split=n_split,
                         s_len=s_len, **kw)

        pod_partials()
        got = part.acc.clone(), part.ml.clone()
        want = [torch.cat(t, dim=2) for t in zip(*(plain(
            q, *(x[r] for x in shard), row0=r * cut, n_split=n_split,
            s_len=s_len, **kw) for r in range(TP)))]
        err, share = max_err(tuple(got), tuple(want), "float32")
        merged = ops.flash_decode_combine(part.acc, part.ml, dtype=dt)
        whole = (ref.flash_decode(q, k, v, **kw) if not scales else
                 ref.flash_decode_int8(q, k, v, *scales, **kw))
        e2e, e2e_share = max_err(merged, whole, "bfloat16")
        vis = [min(int(x), cut) for x in kv_len.tolist()]
        keys0 = sum(vis)
        b_ms, b_by = bound(q.numel() * 2 + 8 * B + keys0 * row_bytes
                           + B * h * n_split * (d + 2) * 4,
                           4 * h * d * keys0, "bfloat16")
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), kt, vt, attn_mask=mask, enable_gqa=True)
        rows[name] = dict(
            dtype="bfloat16", B=B, L=cut, heads=f"{h}/{kh}", D=d,
            kv_len=kv_len.tolist(), n_split=n_split, max_abs_err=err,
            tol_share=share, merged_err=e2e, ms=cuda_ms(rank0, 50),
            plain_ms=cuda_ms(rank0_plain, 5), library_ms=cuda_ms(lib, 50),
            bound_ms=b_ms, bound_by=b_by)
        if not share <= 1.0 or not e2e_share <= 1.0:
            failures.append(f"{name}: partials err {err:.3e}, merged vs "
                            f"one device's decode {e2e:.3e}")
        if name == "flash_decode_partials":  # the combine on this scratch
            c_out = ops.flash_decode_combine(part.acc, part.ml, dtype=dt)
            c_err, c_share = max_err(c_out, ref.flash_decode_combine(
                part.acc, part.ml, dtype=dt), "bfloat16")
            cb_ms, cb_by = bound(part.buf.numel() * 4 + c_out.numel() * 2,
                                 2 * B * h * sum(n) * (d + 1), "bfloat16")
            rows["flash_decode_combine"] = dict(
                dtype="bfloat16", B=B, L=L, heads=f"{h}/{kh}", D=d,
                n_split=sum(n), max_abs_err=c_err, tol_share=c_share,
                ms=cuda_ms(lambda: ops.flash_decode_combine(
                    part.acc, part.ml, dtype=dt), 50),
                plain_ms=cuda_ms(lambda: ref.flash_decode_combine(
                    part.acc, part.ml, dtype=dt), 5),
                library_ms=None, bound_ms=cb_ms,
                bound_by=cb_by)
            if not c_share <= 1.0:
                failures.append(f"flash_decode_combine: err {c_err:.3e}")
        r = rows[name]
        log(f"[seq] {name} bf16 B={B}, rank 0's {cut} of {L} rows, heads "
            f"{h}/{kh}, D={d}, kv_len {r['kv_len']}, {n_split} splits a "
            f"rank: max |err| {err:.3e} vs its plain version, merged vs "
            f"one device's decode {e2e:.3e}; {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, sdpa over the unsharded cache "
            f"{r['library_ms']:.4f}, bound {b_ms:.4f} by {b_by})")
        del k, v, kt, vt, shard, part
        torch.cuda.empty_cache()
    c = rows["flash_decode_combine"]
    log(f"[seq] flash_decode_combine bf16 B={B}, {c['n_split']} splits of "
        f"{TP} ranks, {h} heads of {d}: max |err| {c['max_abs_err']:.3e}; "
        f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, bound "
        f"{c['bound_ms']:.4f} by {c['bound_by']}); the combine's share of "
        f"the split pass: "
        f"{c['ms'] / (TP * rows['flash_decode_partials']['ms']):.3f}")
    if failures:
        raise AssertionError("phase 18 (d): " + "; ".join(failures))
    return rows


def seq_kernel_json(rows: dict, launches: dict) -> list:
    """The ``kernels`` line's rows of phase 18's launches: (d)'s
    measurements (:func:`seq_kernel_rows`) beside the launch counts of
    (a)'s full-width bf16 and int8 runs (:func:`seq_phase`)."""
    out = []
    for name, counts in (("flash_decode_partials", launches["bf16"]),
                         ("flash_decode_int8_partials", launches["int8"]),
                         ("flash_decode_combine", launches["bf16"])):
        r = rows[name]
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": ("src/repro/kernels/decode_attention.py:81"
                         if "int8" in name else
                         "src/repro/kernels/decode_attention.py:35"),
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": f"qwen2-1.5b (1, {TP}) kv_shard=seq: {r['dtype']} "
                     f"B={r['B']} L={r['L']} heads {r['heads']} D={r['D']}"
                     f" n_split={r['n_split']}"})
    return out


# --------------------------------------------------------------------------- #
# Phase 19: the expert-parallel MoE scheme, whisper's split cross K/V, the
# examples
# --------------------------------------------------------------------------- #

#: (a): qwen2-moe-a2.7b's expert-parallel pod, ``EXPERT_TP`` ranks of 15
#: whole experts on one card, bf16 at full width and depth: a prefill of
#: ``EXPERT_SLOTS`` prompts of ``EXPERT_PROMPT`` tokens through
#: ``make_prefill_step``, then ``EXPERT_STEPS`` ``make_serve_step`` steps
#: over a ``EXPERT_SLOTS`` x ``MAX_LEN`` cache, fed one device's tokens
EXPERT_ARCH, EXPERT_TP = "qwen2-moe-a2.7b", 4
EXPERT_SLOTS, EXPERT_PROMPT, EXPERT_STEPS = 4, 64, 8
EXPERT_TAG = f"{EXPERT_ARCH} expert TP={EXPERT_TP}"
#: (a)'s fp32 parity pod at ``EXPERT_PARITY_DEPTH`` layers against one
#: device, within ``POD_LOGIT_TOL`` fp32 (1e-3: each rank's partial rounds
#: once before the ranks add); the planted fault (rank 1's expert range
#: shifted by one) must break it
EXPERT_PARITY_DEPTH = 2
#: (c): whisper-large-v3 at (1, ``AU_SEQ_TP``) under ``kv_shard="seq"``
#: (its cross K/V 750 of 1500 frames a rank), ``AU_SEQ_STEPS`` decode
#: steps after prompts of ``STEP_PROMPT`` over ``STEP_SLOTS`` slots; in
#: fp32 at 2 + 2 layers within ``AU_SEQ_TOL_FP32`` of one device (the
#: ranks' partial states merge in another order than one softmax sums:
#: the CPU reads 1e-7 to 1e-6), the planted frame offset (rank 1's
#: frames one earlier) outside it
AU_SEQ_TP, AU_SEQ_STEPS = 2, 4
AU_SEQ_TOL_FP32 = 1e-5
#: (d): the examples run on the card, each request to its own budget
EXAMPLE_JOBS = 8


def expert_rows(cfg, params, mesh, prompts, forced=None):
    """(a)'s run of one device (``mesh`` None) or a pod (``params`` its
    rank trees, under the scheme they were laid out by):
    the prefill logits through ``make_prefill_step`` and ``EXPERT_STEPS``
    tokens of ``make_serve_step``, each step fed ``forced[:, i]`` when it
    is given, else its own last token.  Returns (prefill logits in fp32,
    the tokens (B, 1 + EXPERT_STEPS): the prefill's and each step's)."""
    import torch

    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    kw = {} if mesh is None else dict(mesh=mesh)
    cache = (T.init_cache(cfg, EXPERT_SLOTS, MAX_LEN, DEVICE) if mesh is None
             else T.init_cache(cfg, EXPERT_SLOTS, MAX_LEN, mesh=mesh))
    logits, cache = ST.make_prefill_step(cfg, **kw)(
        params, {"tokens": prompts, "cache": cache})
    toks = [logits[:, -1].argmax(-1).to(torch.int32)]
    serve = ST.make_serve_step(cfg, **kw)
    for i in range(EXPERT_STEPS):
        fed = toks[-1] if forced is None else forced[:, i]
        tok, cache = serve(params, fed[:, None], cache)
        toks.append(tok.to(toks[0].device))
    synchronize_all()
    return logits[:, -1].float(), torch.stack(toks, 1)


def expert_parity(cfg, prompts) -> list:
    """(a)'s fp32 gate: one device and the expert pod at
    ``EXPERT_PARITY_DEPTH`` layers, prefill then ``EXPERT_STEPS`` decode
    steps fed one device's tokens, the pod's logits within ``POD_LOGIT_TOL``
    fp32 of one device's at every step; the planted fault (rank 1 computes
    the routing of the experts one past its own, so it reads rank 2's
    first expert with its own last expert's weights) outside it.
    Returns failures."""
    import torch

    from repro_torch.launch import shard_params
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg32, params32 = fp32_model(cfg, EXPERT_PARITY_DEPTH)
    tol = POD_LOGIT_TOL["dense", "float32"]
    mesh = tp_mesh(EXPERT_TP)

    def run(params, m):
        kw = {} if m is None else dict(mesh=m)
        cache = (T.init_cache(cfg32, EXPERT_SLOTS, MAX_LEN, DEVICE)
                 if m is None else T.init_cache(cfg32, EXPERT_SLOTS,
                                                MAX_LEN, mesh=m))
        lg, cache = T.prefill(params, cfg32, {"tokens": prompts}, cache,
                              **kw)
        out = [lg[:, -1].float()]
        for i in range(EXPERT_STEPS):
            lg, cache = T.decode_step(params, cfg32, fed[:, i:i + 1], cache,
                                      **kw)
            out.append(lg[:, -1].float())
        return torch.stack(out, 1)

    _, fed = expert_rows(cfg32, params32, None, prompts)
    fed = fed[:, :EXPERT_STEPS]
    one = run(params32, None)
    shards = shard_params(params32, cfg32, mesh, moe_scheme="expert")
    del params32
    pod = run(shards, mesh)
    rank_experts = M.rank_experts

    def shifted(c, tp, rank):
        e0, e1 = rank_experts(c, tp, rank)
        return (e0 + 1, e1 + 1) if rank == 1 else (e0, e1)

    M.rank_experts = shifted
    try:
        planted = run(shards, mesh)
    finally:
        M.rank_experts = rank_experts
    gap = float((pod - one).abs().max())
    gap_p = float((planted - one).abs().max())
    log(f"[expert] {cfg.arch_id} fp32, {EXPERT_PARITY_DEPTH} layers, "
        f"moe_scheme='expert' at (1, {EXPERT_TP}): prefill and "
        f"{EXPERT_STEPS} decode steps fed one device's tokens, max |logit "
        f"gap| {gap:.4e} (tol {tol}), max |logit| "
        f"{float(one.abs().max()):.3f}; planted expert range + 1 on rank 1: "
        f"{gap_p:.4e}, {'caught' if gap_p > tol else 'MISSED'}")
    failures = []
    if not gap <= tol:
        failures.append(f"expert pod fp32 logit gap {gap:.4e} > {tol}")
    if not gap_p > tol:
        failures.append(f"the planted expert range passed the fp32 gate "
                        f"({gap_p:.4e})")
    return failures


def expert_pod_phase(cfg) -> tuple:
    """Phase 19 (a): qwen2-moe-a2.7b's expert-parallel pod at full width
    and depth in bf16 (``EXPERT_TP`` ranks of 15 whole experts, all on one
    card), after the fp32 gate (:func:`expert_parity`).  One device runs
    first and is freed (one copy of the weights is 28.6 GB); the expert
    pod and then the tensor-scheme pod run from the same weights, fed one
    device's tokens, the expert pod with the launch counts reset before
    and read after (``flash_attention`` layers x ranks a prefill,
    ``flash_decode_sharded`` layers x ranks a step).  Reports the pods'
    prefill logits against one device's and each other's, and the tokens
    that agree.  Returns (launches, failures)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import shard_params
    from repro_torch.launch.partition import expert_range

    prompts = torch.as_tensor(
        [[t % cfg.vocab_size for t in (r.prompt_tokens * EXPERT_PROMPT)
          [:EXPERT_PROMPT]] for r in make_requests(EXPERT_SLOTS, SEED)],
        device=DEVICE)
    failures = expert_parity(cfg, prompts)
    gc.collect()
    torch.cuda.empty_cache() if DEVICE != "cpu" else None
    mesh = tp_mesh(EXPERT_TP)
    params = random_params(cfg)
    one_lg, one_tok = expert_rows(cfg, params, None, prompts)
    del params
    gc.collect()
    torch.cuda.empty_cache() if DEVICE != "cpu" else None
    out, launches = {}, {}
    for scheme in ("expert", "tensor"):
        params = random_params(cfg)
        shards = shard_params(params, cfg, mesh, moe_scheme=scheme)
        del params
        gc.collect()
        torch.cuda.empty_cache() if DEVICE != "cpu" else None
        held = [r["layers"]["moe"]["w_up"].shape[1] for r in shards]
        if scheme == "expert":
            want = [expert_range(cfg, EXPERT_TP, r)[1]
                    - expert_range(cfg, EXPERT_TP, r)[0]
                    for r in range(EXPERT_TP)]
            if held != want:
                failures.append(f"expert shards hold {held} experts, want "
                                f"{want}")
            ops.reset_launches()
        t0 = time.perf_counter()
        out[scheme] = expert_rows(cfg, shards, mesh, prompts,
                                  forced=one_tok)
        wall = time.perf_counter() - t0
        if scheme == "expert":
            launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
            n = cfg.n_layers
            check_launches(launches, {
                "flash_attention": (n * EXPERT_TP, f"{n} layers x "
                                                   f"{EXPERT_TP} ranks x 1 "
                                                   "prefill"),
                "flash_decode_sharded": (
                    n * EXPERT_TP * EXPERT_STEPS,
                    f"{n} layers x {EXPERT_TP} ranks x {EXPERT_STEPS} "
                    "steps")})
        log(f"[expert] {cfg.arch_id} bf16, {cfg.n_layers} layers, "
            f"moe_scheme={scheme!r} at (1, {EXPERT_TP}), experts a rank "
            f"{held}: prefill of {EXPERT_SLOTS} x {EXPERT_PROMPT} and "
            f"{EXPERT_STEPS} serve steps over {EXPERT_SLOTS} x {MAX_LEN} in "
            f"{wall:.1f} s"
            + (f"; launches flash_attention "
               f"{launches['flash_attention']}, flash_decode_sharded "
               f"{launches['flash_decode_sharded']}"
               if scheme == "expert" else ""))
        del shards
        gc.collect()
        torch.cuda.empty_cache() if DEVICE != "cpu" else None
    (ex_lg, ex_tok), (tn_lg, tn_tok) = out["expert"], out["tensor"]
    gaps = {"expert vs one device": float((ex_lg - one_lg).abs().max()),
            "tensor vs one device": float((tn_lg - one_lg).abs().max()),
            "expert vs tensor": float((ex_lg - tn_lg).abs().max())}
    agree = {k: int((t == one_tok).sum()) for k, t in (("expert", ex_tok),
                                                       ("tensor", tn_tok))}
    finite = bool(torch.isfinite(ex_lg).all()) and bool(
        ((ex_tok >= 0) & (ex_tok < cfg.vocab_size)).all())
    log(f"[expert] bf16 prefill logits, max |gap|: "
        + ", ".join(f"{k} {v:.4e}" for k, v in gaps.items())
        + f" (max |logit| {float(one_lg.abs().max()):.3f}); tokens equal to "
        f"one device's of {one_tok.numel()}: expert {agree['expert']}, "
        f"tensor {agree['tensor']}; finite, in the vocabulary: {finite}")
    if not finite:
        failures.append("expert pod: logits not finite or a token outside "
                        "the vocabulary")
    return launches, failures


def audio_seq_phase() -> tuple:
    """Phase 19 (c): whisper-large-v3 at (1, ``AU_SEQ_TP``) under
    ``kv_shard="seq"``: its self-attention cache split by rows and its
    cross K/V by frames (750 of 1500 a rank).  fp32 at 2 + 2 layers: the
    pod's prefill and ``AU_SEQ_STEPS`` decode logits, fed one device's
    tokens, within ``AU_SEQ_TOL_FP32`` of one device's, and the planted
    frame offset (rank 1's cross K/V written and read one frame early)
    outside it.  Then bf16 at full width and depth (32 + 32 layers), one
    device and the pod through the step functions, the pod's launch
    counts reset before and read after (``flash_attention`` layers x
    ranks, ``flash_decode_partials`` layers x ranks a step,
    ``flash_decode_combine`` layers a step).  Returns (launches,
    failures)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import shard_params
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    cfg = get_config(AU_ARCH)
    if DEVICE == "cpu":
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16")
    mesh = tp_mesh(AU_SEQ_TP)
    failures = []

    def run(c, params, m, batch, forced=None, plant=None, steps=True):
        kw = {} if m is None else dict(mesh=m)
        cache = (T.init_cache(c, STEP_SLOTS, AU_ROWS, DEVICE) if m is None
                 else T.init_cache(c, STEP_SLOTS, AU_ROWS, mesh=m,
                                   kv_shard="seq"))
        if plant is not None:
            plant(cache)
        lg, cache = ST.make_prefill_step(c, **kw)(params,
                                                  {**batch, "cache": cache})
        out, toks = [lg[:, -1].float()], [lg[:, -1].argmax(-1)]
        for i in range(AU_SEQ_STEPS):
            fed = toks[-1] if forced is None else forced[:, i]
            lg, cache = T.decode_step(params, c, fed[:, None].to(torch.int32),
                                      cache, **kw)
            out.append(lg[:, -1].float())
            toks.append(lg[:, -1].argmax(-1))
        synchronize_all()
        return torch.stack(out, 1), torch.stack(toks, 1)

    # fp32 at 2 + 2 layers, and the planted frame offset
    cfg32 = dataclasses.replace(audio_depth(cfg, 2), dtype="float32")
    params32 = T.init_params(cfg32, torch.Generator(device=DEVICE)
                             .manual_seed(SEED + 1))
    batch32 = audio_batch(cfg32, STEP_SLOTS, STEP_PROMPT, SEED + 3)
    one, fed = run(cfg32, params32, None, batch32)
    shards = shard_params(params32, cfg32, mesh)

    def shift(cache):
        cache[1]["cross_kv"].row0 -= 1

    pod, _ = run(cfg32, shards, mesh, batch32, forced=fed)
    planted, _ = run(cfg32, shards, mesh, batch32, forced=fed, plant=shift)
    gap = float((pod - one).abs().max())
    gap_p = float((planted - one).abs().max())
    log(f"[audio-seq] {AU_ARCH} fp32, 2 + 2 layers, kv_shard='seq' at (1, "
        f"{AU_SEQ_TP}) (cross K/V {cfg.encoder.n_frames // AU_SEQ_TP} "
        f"frames a rank): prefill and {AU_SEQ_STEPS} steps fed one device's "
        f"tokens, max |logit gap| {gap:.4e} (tol {AU_SEQ_TOL_FP32}), max "
        f"|logit| {float(one.abs().max()):.3f}; planted frame offset - 1 on "
        f"rank 1: {gap_p:.4e}, "
        f"{'caught' if gap_p > AU_SEQ_TOL_FP32 else 'MISSED'}")
    if not gap <= AU_SEQ_TOL_FP32:
        failures.append(f"audio seq pod fp32 gap {gap:.4e}")
    if not gap_p > AU_SEQ_TOL_FP32:
        failures.append(f"the planted frame offset passed the fp32 gate "
                        f"({gap_p:.4e})")
    del params32, shards
    gc.collect()
    # bf16 at full width and depth: one device, then the pod
    params = random_params(cfg)
    batch = audio_batch(cfg, STEP_SLOTS, STEP_PROMPT, SEED + 3)
    one, fed = run(cfg, params, None, batch)
    shards = shard_params(params, cfg, mesh)
    ops.reset_launches()
    t0 = time.perf_counter()
    pod, tok = run(cfg, shards, mesh, batch, forced=fed)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    n = cfg.n_layers
    check_launches(launches, {
        "flash_attention": (n * AU_SEQ_TP, f"{n} layers x {AU_SEQ_TP} ranks "
                                           "x 1 prefill"),
        "flash_decode_partials": (n * AU_SEQ_TP * AU_SEQ_STEPS,
                                  f"{n} layers x {AU_SEQ_TP} ranks x "
                                  f"{AU_SEQ_STEPS} steps"),
        "flash_decode_combine": (n * AU_SEQ_STEPS, f"{n} layers x "
                                                   f"{AU_SEQ_STEPS} steps")})
    gap = float((pod - one).abs().max())
    finite = bool(torch.isfinite(pod).all())
    agree = int((tok == fed).sum())
    log(f"[audio-seq] {AU_ARCH} bf16, {cfg.encoder.n_layers} + {n} layers, "
        f"(1, {AU_SEQ_TP}) kv_shard='seq' in {wall:.1f} s: launches "
        f"flash_attention {launches['flash_attention']}, "
        f"flash_decode_partials {launches['flash_decode_partials']}, "
        f"flash_decode_combine {launches['flash_decode_combine']}; max "
        f"|logit gap| from one device {gap:.4e} (bf16, reported), greedy "
        f"tokens equal {agree} of {fed.numel()}; finite {finite}")
    if not finite:
        failures.append("audio seq pod: bf16 logits not finite")
    del params, shards
    gc.collect()
    torch.cuda.empty_cache() if DEVICE != "cpu" else None
    return launches, failures


def examples_phase() -> tuple:
    """Phase 19 (d): ``repro_torch.examples.quickstart`` and
    ``serve_isrtf --jobs EXAMPLE_JOBS`` on the card, in-process, with the
    launch counts reset before and read after: every request finishes
    with its own token budget.  Returns (launches, failures)."""
    import contextlib
    import io

    from repro_torch.examples import quickstart, serve_isrtf
    from repro_torch.kernels import ops

    argv = [] if DEVICE != "cpu" else ["--device", "cpu"]
    failures = []
    ops.reset_launches()
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        quick = quickstart.main(argv)
        served = serve_isrtf.main(argv + ["--jobs", str(EXAMPLE_JOBS)])
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    got = sorted(r.n_tokens for r in quick)
    want = sorted(n for _, n in quickstart.PROMPTS)
    if got != want or not all(r.ok for r in quick):
        failures.append(f"quickstart: tokens {got}, want {want}")
    want_j = sorted(r.true_output_len
                    for r in serve_isrtf.make_requests(EXAMPLE_JOBS))
    for policy, (_, responses) in served.items():
        got_j = sorted(r.n_tokens for r in responses)
        if got_j != want_j or not all(r.ok for r in responses):
            failures.append(f"serve_isrtf {policy}: tokens {got_j}, want "
                            f"{want_j}")
    if DEVICE != "cpu" and not (launches["flash_attention"]
                                and launches["flash_decode"]):
        failures.append(f"the examples launched no kernel: {launches}")
    lines = [ln for ln in text.getvalue().splitlines()
             if "mean JCT" in ln or " vs fcfs" in ln]
    log(f"[examples] quickstart and serve_isrtf --jobs {EXAMPLE_JOBS} in "
        f"{wall:.1f} s: {len(quick)} + {EXAMPLE_JOBS} x 3 requests finished "
        f"with their tokens: {not failures}; launches flash_attention "
        f"{launches['flash_attention']}, flash_decode "
        f"{launches['flash_decode']}; " + " | ".join(lines))
    return launches, failures


def expert_phase() -> dict:
    """Phase 19: (a) the expert-parallel pod (:func:`expert_pod_phase`),
    (b) the dry run of ``serve 16 x 512 int8`` at (1, ``EXPERT_TP``)
    under ``moe_scheme="expert"`` against the card (:func:`dry_vs_card`),
    (c) whisper's split cross K/V (:func:`audio_seq_phase`), (d) the
    examples on the card (:func:`examples_phase`).  Returns each part's
    launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import InputShape

    t_phase = time.perf_counter()
    cfg = get_config(EXPERT_ARCH)
    if DEVICE == "cpu":
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16")
    out = {}
    out["expert"], failures = expert_pod_phase(cfg)
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
        serve = InputShape("serve_512", MAX_LEN, DRY_SERVE_B, "decode")
        failures += dry_vs_card(cfg, serve, (1, EXPERT_TP), "int8",
                                moe_scheme="expert")
    out["audio-seq"], more = audio_seq_phase()
    failures += more
    out["examples"], more = examples_phase()
    failures += more
    log(f"[expert] phase 19 in {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("phase 19: " + "; ".join(failures))
    return out


# --------------------------------------------------------------------------- #
# Phase 20: make_prefill_step at prefill_32k on one card, and the engine's
# two reference baselines
# --------------------------------------------------------------------------- #

#: phase 20 (a)'s arch: the prefill_32k step (B=32 x 32768) over an int8
#: cache, at full width and depth on one card
PREFILL_ARCH = "qwen2-1.5b"
#: the most of the card's memory (``torch.cuda.mem_get_info()[1]``) the
#: dry run's peak of that step may take
PREFILL_PEAK_SHARE = 0.8
#: (a)'s fp32 check at full width: ``PREFILL_PARITY_DEPTH`` layers over
#: ``PREFILL_PARITY_B`` prompts of 32768 ids, chunked by
#: ``PREFILL_PARITY_ROWS`` rows, which divides neither prompt: the chunks
#: are rows [0, 24576), [24576, 49152) and [49152, 65536), the second
#: straddling the boundary between the prompts
PREFILL_PARITY_DEPTH, PREFILL_PARITY_B, PREFILL_PARITY_ROWS = 2, 2, 24576
#: phase 20 (b): ``EngineConfig``'s two baselines, both off the fast path
BASELINE_OPTS = dict(batched_prefill=False, masked_decode=False)


def chunk_drops_last_row(fn, x, rows):
    """The planted fault of phase 20 (a): ``transformer._in_rows`` with
    each chunk leaving its last row's MLP out (zero); the last chunk ends
    at the last prompt's last position, whose logits it moves."""
    import torch

    flat = x.reshape(-1, x.shape[-1])
    out = torch.zeros_like(flat)
    for a in range(0, flat.shape[0], rows):
        b = min(a + rows, flat.shape[0]) - 1
        out[a:b] = fn(flat[a:b])
    return out.view_as(x)


def int8_row_gap(kv, kv1, i: int, j: int = 0) -> tuple:
    """Slot ``i`` of the int8 cache ``kv`` against slot ``j`` of ``kv1``,
    every layer and row: (the largest code difference, the share of
    codes that differ, the largest scale gap relative to the scales'
    largest value)."""
    worst, off, n, rel = 0, 0, 0, 0.0
    for a, b in ((kv.k, kv1.k), (kv.v, kv1.v)):
        d = (a[:, i].int() - b[:, j].int()).abs()
        worst = max(worst, int(d.max()))
        off += int((d > 0).sum())
        n += d.numel()
    for a, b in ((kv.k_scale, kv1.k_scale), (kv.v_scale, kv1.v_scale)):
        rel = max(rel, float((a[:, i] - b[:, j]).abs().max()
                             / b[:, j].abs().max()))
    return worst, off / n, rel


def prefill_step_run(cfg, params, shape, tokens, rows=None, fault=False):
    """``make_prefill_step(cfg)`` over a fresh ``input_specs`` int8 cache
    of ``shape`` fed ``tokens``, under ``torch.no_grad()``; ``rows``
    replaces ``transformer.PREFILL_MLP_ROWS`` for the run, ``fault`` plants
    :func:`chunk_drops_last_row`.  Returns (logits, cache)."""
    import torch

    from repro_torch.launch.shapes import input_specs
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    batch = input_specs(cfg, shape, kv_dtype="int8", device=DEVICE)
    batch["tokens"] = tokens
    old = T.PREFILL_MLP_ROWS, T._in_rows
    if rows is not None:
        T.PREFILL_MLP_ROWS = rows
    if fault:
        T._in_rows = chunk_drops_last_row
    try:
        with torch.no_grad():
            logits, cache = make_prefill_step(cfg)(params, batch)
    finally:
        T.PREFILL_MLP_ROWS, T._in_rows = old
    return logits, cache["kv"]


def prefill_chunk_parity(cfg, shape) -> list:
    """Phase 20 (a), fp32: the step at full width and
    ``PREFILL_PARITY_DEPTH`` layers over ``PREFILL_PARITY_B`` prompts,
    chunked by ``PREFILL_PARITY_ROWS`` against one piece: logits within
    ``POD_LOGIT_TOL``'s fp32 limit (1e-3), cache codes at most one step
    apart and scales within that limit of their largest; the planted
    :func:`chunk_drops_last_row` must break the logits' gate.  Returns
    failures."""
    import torch

    from repro_torch.launch.shapes import InputShape

    cfg2, params = fp32_model(cfg, PREFILL_PARITY_DEPTH)
    two = InputShape(shape.name, shape.seq_len, PREFILL_PARITY_B, "prefill")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    tokens = torch.randint(8, cfg.vocab_size, (two.global_batch, two.seq_len),
                           generator=gen, device=DEVICE, dtype=torch.int32)
    n = two.global_batch * two.seq_len
    tol = POD_LOGIT_TOL[("dense", "float32")]
    whole_l, whole_kv = prefill_step_run(cfg2, params, two, tokens, rows=n)
    out, failures = {}, []
    for name, fault in (("chunked", False), ("planted", True)):
        logits, kv = prefill_step_run(cfg2, params, two, tokens,
                                      rows=PREFILL_PARITY_ROWS, fault=fault)
        gap = float((logits - whole_l).abs().max())
        codes = [int8_row_gap(kv, whole_kv, i, i)
                 for i in range(two.global_batch)]
        worst = max(c[0] for c in codes)
        share = sum(c[1] for c in codes) / len(codes)
        rel = max(c[2] for c in codes)
        out[name] = (gap, worst, share, rel)
        log(f"[prefill32k] fp32, {cfg2.n_layers} layers, B={two.global_batch}"
            f" x {two.seq_len}, rows by {PREFILL_PARITY_ROWS} "
            f"({-(-n // PREFILL_PARITY_ROWS)} chunks, one across the "
            f"prompts' boundary){' with the planted chunk_drops_last_row' if fault else ''}"
            f" against one piece: logits max gap {gap:.3e} (gate {tol}), "
            f"cache codes largest difference {worst}, share differing "
            f"{share:.3e}, scales' largest relative gap {rel:.3e}")
    gap, worst, _, rel = out["chunked"]
    if not (gap <= tol and worst <= 1 and rel <= tol):
        failures.append(f"fp32 chunked prefill against one piece: logits "
                        f"{gap:.3e}, codes {worst}, scales {rel:.3e}")
    if out["planted"][0] <= tol:
        failures.append(f"the planted chunk_drops_last_row passed the "
                        f"logits' gate ({out['planted'][0]:.3e})")
    else:
        log(f"[prefill32k] planted chunk_drops_last_row caught: logits gap "
            f"{out['planted'][0]:.3e} = {out['planted'][0] / tol:.0f} x the "
            f"gate")
    return failures


def prefill_32k_phase(attn_ms=None, cfg=None, shape=None) -> dict:
    """Phase 20 (a): ``make_prefill_step`` of ``PREFILL_ARCH`` at the
    reference's prefill_32k shape over an ``input_specs`` int8 cache, bf16
    at full width and depth, after every earlier tensor is freed.  One
    step under ``FlopCounterMode``, then one timed (devices
    synchronised), launch counts reset before the first and read after
    the second (``flash_attention`` once a layer and step: the MLP's row
    chunks add no launch); the dry run's record (``dryrun.lower_one`` at
    (1, 1)) against the card: flops and argument bytes exact, the peak at
    most ``DRY_PEAK_MARGIN`` under ``max_memory_allocated`` and never over
    it, and at most ``PREFILL_PEAK_SHARE`` of the card's memory; the
    first and the last prompt run alone at B=1 (one chunk): their logits
    within ``LOGIT_TOL_BF16`` of the batch's, their int8 cache rows at
    most one code apart (the share printed) and their scales within
    ``2 ** -7`` relative; then :func:`prefill_chunk_parity`.  Prints the
    step's wall time, prompt tokens/s, its bound (the record's flops at
    the bf16 peak and its bytes at HBM's rate, the larger),
    ``flash_attention``'s share of the wall at phase 3's time of one
    launch at this shape (``attn_ms``), and the peak against the card's
    memory.  ``cfg`` and ``shape`` replace the published config and the
    shape (a CPU rehearsal).  Returns the launch counts."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES, InputShape, input_specs
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = cfg or get_config(PREFILL_ARCH)
    shape = shape or SHAPES["prefill_32k"]
    b, s, n = shape.global_batch, shape.seq_len, cfg.n_layers
    rec = dryrun.lower_one(cfg.arch_id, shape.name, False, input_shape=shape,
                           cfg_override=cfg, mesh_shape=(1, 1),
                           kv_dtype="int8")
    ma = rec["memory_analysis"]
    gc.collect()
    torch.cuda.empty_cache()
    synchronize_all()
    total = torch.cuda.mem_get_info()[1]
    base = torch.cuda.memory_allocated()
    params = T.init_params(cfg, torch.Generator(device=DEVICE)
                           .manual_seed(SEED))
    batch = input_specs(cfg, shape, kv_dtype="int8", device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    batch["tokens"] = torch.randint(8, cfg.vocab_size, (b, s), generator=gen,
                                    device=DEVICE, dtype=torch.int32)
    args = sum(dryrun._storages((params, batch)).values())
    step = make_prefill_step(cfg)
    synchronize_all()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        logits, _ = step(params, batch)
    synchronize_all()
    peak = torch.cuda.max_memory_allocated() - base
    del logits
    with torch.no_grad():
        synchronize_all()
        t0 = time.perf_counter()
        logits, cache = step(params, batch)
        synchronize_all()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    check_launches(launches, {"flash_attention": (
        2 * n, f"{n} layers x 2 steps (the MLP's chunks add none)")})
    failures = []
    if tuple(logits.shape) != (b, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        failures.append(f"logits {tuple(logits.shape)} not finite or not "
                        f"({b}, 1, {cfg.vocab_size})")
    flops = fc.get_total_flops()
    dry_peak = ma["pod_peak_memory_in_bytes"]
    if flops != rec["flops"] or flops != rec["cost_analysis"]["pod flops"]:
        failures.append(f"flops: dry {rec['flops']:.6e} vs card {flops:.6e}")
    if args != ma["argument_size_in_bytes"]:
        failures.append(f"argument bytes: dry "
                        f"{ma['argument_size_in_bytes']:.0f} vs card {args}")
    if not 0 <= peak - dry_peak <= DRY_PEAK_MARGIN * peak:
        failures.append(f"peak: dry {dry_peak:.0f} vs card {peak}")
    if dry_peak > PREFILL_PEAK_SHARE * total:
        failures.append(f"dry peak {dry_peak / 1e9:.2f} GB over "
                        f"{PREFILL_PEAK_SHARE:.0%} of {total / 1e9:.2f} GB")
    t_f = rec["flops"] / PEAK_FLOPS["bfloat16"]
    t_b = rec["bytes_accessed"] / HBM_BYTES_S
    attn = ("not measured" if attn_ms is None else
            f"{n} x {attn_ms:.2f} ms (phase 3, B={b} x {s}) = "
            f"{n * attn_ms / 1e3:.2f} s, {n * attn_ms / 1e3 / wall:.1%} of "
            f"the wall")
    log(f"[prefill32k] make_prefill_step, {describe(cfg)}, B={b} x {s} over "
        f"an int8 cache, row budget {T.PREFILL_MLP_ROWS} "
        f"({-(-b * s // T.PREFILL_MLP_ROWS)} MLP chunks a layer): step wall "
        f"{wall:.3f} s, {b * s / wall:.0f} prompt tokens/s; bound "
        f"{max(t_f, t_b):.3f} s (dry-run flops {rec['flops']:.4e} at "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s = {t_f:.3f} s, bytes "
        f"{rec['bytes_accessed']:.4e} at {HBM_BYTES_S / 1e12:.2f} TB/s = "
        f"{t_b:.3f} s), {max(t_f, t_b) / wall:.1%} of the wall; "
        f"flash_attention {attn}; launches {json.dumps(launches)}")
    log(f"[prefill32k] dry run against the card: flops dry {rec['flops']:.6e}"
        f" vs card {flops:.6e}; argument bytes dry "
        f"{ma['argument_size_in_bytes']:.0f} vs card {args}; peak dry "
        f"{dry_peak / 1e9:.4f} GB vs max_memory_allocated {peak / 1e9:.4f} "
        f"GB ({(dry_peak - peak) / max(peak, 1):+.3%}, gate 0 to "
        f"-{DRY_PEAK_MARGIN:.0%}); peak {peak / 1e9:.2f} GB of the card's "
        f"{total / 1e9:.2f} GB ({peak / total:.1%}; the dry run's limit "
        f"{PREFILL_PEAK_SHARE:.0%}); trace {rec['lower_s']} s; "
        f"{nvidia_smi_line()}")
    one = InputShape(shape.name, s, 1, "prefill")
    for i in (0, b - 1):
        l1, kv1 = prefill_step_run(cfg, params, one,
                                   batch["tokens"][i:i + 1].clone())
        gap = float((l1[0].float() - logits[i].float()).abs().max())
        worst, share, rel = int8_row_gap(cache["kv"], kv1, i)
        log(f"[prefill32k] prompt {i} alone (B=1 x {s}, one chunk) against "
            f"its row of the batch: logits max gap {gap:.4e} (gate "
            f"{LOGIT_TOL_BF16}); int8 cache codes largest difference "
            f"{worst}, share differing {share:.3e}; scales' largest "
            f"relative gap {rel:.3e}")
        if not (gap <= LOGIT_TOL_BF16 and worst <= 1 and rel <= 2.0 ** -7):
            failures.append(f"prompt {i} alone: logits {gap:.4e}, codes "
                            f"{worst}, scales {rel:.3e}")
        del l1, kv1
    del params, batch, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    failures += prefill_chunk_parity(cfg, shape)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[prefill32k] phase 20 (a) in {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("phase 20 (a): " + "; ".join(failures))
    return launches


def baseline_parity(cfg, requests) -> list:
    """Phase 20 (b), fp32 at full width and 2 layers: four jobs in one
    window on the fast engine and on the baseline one
    (``BASELINE_OPTS``), as the reference's
    ``test_batched_prefill_matches_serial``: identical tokens, finished
    flags and ``len`` vectors, 1 prefill dispatch against 4.  Returns
    failures."""
    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine

    cfg2, params = fp32_model(cfg, 2)
    out = {}
    for name, opts in (("fast", {}), ("baseline", BASELINE_OPTS)):
        eng = InferenceEngine(cfg2, params, EngineConfig(
            max_slots=4, max_len=MAX_LEN, max_output=64, eos_id=-1, **opts),
            device=DEVICE)
        jobs = [Job(job_id=r.request_id, prompt="",
                    prompt_tokens=list(r.prompt_tokens), arrival_time=0.0)
                for r in requests[:4]]
        toks, fin = eng.run_window(jobs, 8)
        out[name] = (toks, fin, eng.cache["len"].tolist(),
                     eng.num_prefill_dispatches)
    same = out["fast"][:3] == out["baseline"][:3]
    log(f"[baseline] fp32, {cfg2.n_layers} layers, 4 jobs in one window of "
        f"8: tokens, finished flags and lens of the baseline engine "
        f"{'equal to' if same else 'DIFFER from'} the fast engine's; prefill "
        f"dispatches {out['fast'][3]} against {out['baseline'][3]}")
    if not same or (out["fast"][3], out["baseline"][3]) != (1, 4):
        return [f"fp32 baseline against fast engine: {out}"]
    return []


def baseline_phase(cfg, params, requests, dense=None) -> dict:
    """Phase 20 (b): phase 4's served path (``requests``, bf16 at full
    width and depth) on an engine with both baselines off the fast path
    (``BASELINE_OPTS``), launch counts reset before and read after
    (:func:`served_path`: every request with its expected token count,
    ``flash_attention`` once a layer and prefill dispatch,
    ``flash_decode`` once a layer and decode step); the prefill
    dispatches must equal the admissions (the requests and their
    recompute resumes) and every decode dispatch must run at the
    ``max_slots`` batch; then :func:`baseline_parity`.  Prints tokens/s
    and mean JCT beside ``dense``, phase 4's fast run (host clock).
    Returns the launch counts."""
    from repro_torch.core import summarize

    t_phase = time.perf_counter()
    keep = {}
    launches = served_path(cfg, params, requests, keep=keep, **BASELINE_OPTS)
    eng = keep["executor"].engines[0]
    responses, wall = keep["responses"], keep["wall"]
    counters = keep["executor"].counters()
    admissions = len(requests) + sum(r.n_preemptions for r in responses)
    widths = sorted({batch for _, batch in eng._decode_shapes})
    failures = []
    if counters["prefill_dispatches"] != admissions or counters["swapins"]:
        failures.append(f"prefill dispatches {counters['prefill_dispatches']}"
                        f" vs {admissions} admissions")
    if widths != [eng.cfg.max_slots]:
        failures.append(f"decode batches {widths}, want only "
                        f"{eng.cfg.max_slots}")
    n_tok = sum(r.n_tokens for r in responses)
    m = summarize(responses)
    fast = ("not run in this call" if dense is None else
            f"{dense['tokens_s']:.1f} tokens/s, JCT mean "
            f"{dense['jct_mean']:.3f} s")
    log(f"[baseline] {BASELINE_OPTS}: {counters['prefill_dispatches']} "
        f"prefill dispatches = {len(requests)} requests + "
        f"{admissions - len(requests)} recompute resumes; decode batches "
        f"{widths}; {n_tok / wall:.1f} tokens/s, JCT mean "
        f"{m['jct_mean']:.3f} s; phase 4's fast engine: {fast} (host "
        f"clock)")
    failures += baseline_parity(cfg, requests)
    log(f"[baseline] phase 20 (b) in {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("phase 20 (b): " + "; ".join(failures))
    return launches


def random_params(cfg):
    """``transformer.init_params`` on the card from ``SEED``."""
    import torch

    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=DEVICE)
                           .manual_seed(SEED))
    synchronize_all()
    log(f"[serve] {cfg.arch_id}: random {cfg.dtype} weights from seed "
        f"{SEED} in {time.perf_counter() - t0:.1f} s")
    return params


# --------------------------------------------------------------------------- #


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--planted-fault", nargs="+",
                    choices=sorted(PLANTED_FAULTS) + ["drop_rank_partial",
                                                      "rank_local_norm"]
                    + sorted(POD_FAULTS),
                    help="check the checks against these deliberate "
                         "kernel (or TP) faults instead of running the "
                         "smoke")
    ap.add_argument("--rounding-scan", type=int, metavar="N",
                    help="hold the decode kernel's cut GQA segments against "
                         "one device over N fp32 draws, as built and with "
                         "its denominator update left to the compiler, "
                         "instead of running the smoke")
    ap.add_argument("--window-bench", type=int, metavar="N",
                    help="time N decode windows of the dense cell's engine "
                         "instead of running the smoke")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA card")
    from repro_torch.configs import get_config
    from repro_torch.core import summarize
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi name, power.limit: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    models = [(get_config("qwen2-1.5b"), make_requests(12, SEED)),
              (get_config("mamba2-130m"),
               make_requests(12, SEED, max_prompt=400, vocab=50280))]

    if args.rounding_scan:
        build.build_all()
        print(json.dumps(rounding_scan(args.rounding_scan)), flush=True)
        print(smi, flush=True)
        return
    if args.window_bench:
        build.build_all()
        window_bench(models[0][0], random_params(models[0][0]),
                     args.window_bench)
        return
    if args.planted_fault == ["rank_local_norm"]:
        build.build_all()
        print(json.dumps(ssm_tp_planted_fault()), flush=True)
        return
    if args.planted_fault and set(args.planted_fault) <= set(POD_FAULTS):
        build.build_all()
        print(json.dumps(pod_planted_fault(args.planted_fault)), flush=True)
        return
    if args.planted_fault:
        if "rank_local_norm" in args.planted_fault:
            sys.exit("--planted-fault rank_local_norm runs alone")
        if set(args.planted_fault) & set(POD_FAULTS):
            sys.exit(f"--planted-fault {' / '.join(sorted(POD_FAULTS))} run "
                     "without the kernel faults")
        hy = get_config(HY_ARCH)
        with_params = [(cfg, random_params(cfg), reqs) for cfg, reqs in
                       models + [(hy, hybrid_requests(hy)),
                                 (get_config(AU_ARCH), None)]]
        for kind in args.planted_fault:
            result = (tp_planted_fault(*with_params[0])
                      if kind == "drop_rank_partial"
                      else planted_fault(kind, with_params))
            print(json.dumps(result), flush=True)
        return

    phase_s, last = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        """Record the seconds since the last lap as phase ``name``'s."""
        now = time.perf_counter()
        phase_s[name], last[0] = now - last[0], now

    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {', '.join(f'csrc/{n}.cu' for n in build.SOURCES)} -> "
        f"{build.BUILD_DIR.name}/ in {time.perf_counter() - t0:.1f} s")
    build_report()
    lap("1-2 device, build")

    rows, failures = check_kernels()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    lap("3 kernels")

    launches = {}
    # the served cells: each model on one engine, then qwen2-1.5b on one
    # tensor-parallel pod
    cells = [(cfg, requests, None) for cfg, requests in models]
    cells.append((models[0][0], models[0][1], tp_mesh()))
    calibration = dense = None
    for cfg, requests, mesh in cells:
        name = cfg.arch_id + ("" if mesh is None else f" TP={TP}")
        params = random_params(cfg)
        served = {}
        path = served_path(cfg, params, requests, mesh, keep=served)
        for n, c in path.items():
            if c:
                launches.setdefault(n, c)
        if calibration is None and mesh is None and cfg.family == "dense":
            # phase 15 (a) and (b): calibrate the simulator on this run
            calibration = sim_calibrate(cfg, requests, served)
            dense = {"tokens_s": sum(r.n_tokens for r in served["responses"])
                     / served["wall"],
                     "jct_mean": summarize(served["responses"])["jct_mean"]}
        del served
        profile_window(cfg, params, requests, mesh)
        if not greedy_parity(cfg, requests,
                             () if mesh is None else (mesh, tp_mesh(4))):
            raise AssertionError(f"{name}: fp32 greedy tokens differ "
                                 "between the kernel and plain engines, or "
                                 "no eviction was driven")
        if cfg.family == "ssm":
            bad = recurrent_logit_failures(
                cfg, *ssm_prefill_logit_gaps(cfg, params, requests))
        else:
            gap, finite = prefill_logit_gap(cfg, params, requests, mesh)
            tol = LOGIT_TOL_BF16 if mesh is None else TP_LOGIT_TOL_BF16
            bad = [] if finite and gap <= tol else [f"{gap:.4e} > {tol}"]
        if bad:
            raise AssertionError(f"{name}: bf16 prefill logits disagree "
                                 f"with the reference path: {bad}")
        del params
        torch.cuda.empty_cache()
    lap("4-5 served cells")

    # phase 6: the serve CLI at full width (it makes its own weights)
    t0 = time.perf_counter()
    cfg, requests = models[0]
    params = random_params(cfg)
    swap_roundtrip(cfg, params, requests)
    del params
    chunk_parity(cfg, requests)
    cli_phase = serve_cli_phase()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[cli] phase 6 in {time.perf_counter() - t0:.1f} s")
    lap("6 serve CLI")

    # phase 7: the BGE predictor, its training, ISRTF ranked by it
    pred = predictor_phase(cli_phase["isrtf_jct"])["pred"]
    lap("7 predictor")

    # phase 15 (c) and (d): Table 5's cell ranked by phase 7's predictor,
    # and the scale fast path over (a)'s profile
    sim_phase(pred, calibration)
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    lap("15 simulator (c), (d)")

    # the step entry points over int8 caches (launch/steps.py), qwen2-1.5b
    params = random_params(cfg)
    launches["flash_decode_int8"] = int8_step_path(cfg, params)
    ring_step(cfg, params)
    if not int8_greedy_parity(cfg):
        raise AssertionError("int8 step path: fp32 greedy tokens differ "
                             "between the kernel and plain paths")
    gap, _, finite = int8_logit_gaps(cfg, params)
    if not finite or not gap <= INT8_LOGIT_TOL_BF16:
        raise AssertionError("int8 step path: bf16 decode logits of the "
                             "kernel path disagree with the plain path")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    decode_32k_steps(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    lap("4-5 int8 step path")

    # phase 8: the other archs at full width, qwen1.5-32b last
    t0 = time.perf_counter()
    archs = other_archs_phase()
    log(f"[archs] phase 8 in {time.perf_counter() - t0:.1f} s ({smi})")
    lap("8 other archs")

    # phase 9: the hybrid family, zamba2-7b at full width and depth
    hybrid = hybrid_phase()
    lap("9 hybrid")

    # phase 10: the audio family, whisper-large-v3 at full width and depth
    audio = audio_phase()
    lap("10 audio")

    # phase 11: the MoE family on TP pods; chunked prefill and swap under a
    # mesh
    moe_tp = moe_tp_phase()
    lap("11 MoE pods")

    # phase 12: the SSM and hybrid families on TP pods
    ssm_tp = ssm_tp_phase()
    lap("12 SSM/hybrid pods")

    # phase 13: the vlm and audio families on TP pods
    vlm_audio_tp = vlm_audio_tp_phase()
    lap("13 vlm/audio pods")

    # phase 14: the LM training step
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_phase()
    lap("14 training")

    # phase 16: int8 pods, the dry run held against the card, pod training
    pod16 = dryrun_phase()
    lap("16 dry run, int8 pods")

    # phase 17: pods whose ranks do not divide the heads, groups or widths
    uneven = uneven_phase()
    lap("17 uneven pods")

    # phase 18: sequence-sharded and context-parallel caches, the partials
    # and combine kernels
    seq_rows = seq_kernel_rows()
    seq = seq_phase()
    lap("18 split caches")

    # phase 19: the expert-parallel MoE scheme, whisper's split cross K/V,
    # the examples on the card
    expert = expert_phase()
    lap("19 expert pods, audio seq, examples")

    # phase 20: the prefill_32k step on one card, then phase 4's traffic on
    # the engine's two baselines
    attn_ms = next(r["ms"] for r in rows["flash_attention"]
                   if r.get("arch", "") == "" and (r["B"], r["S"])
                   == LONG_PREFILL[-1])
    prefill32k = prefill_32k_phase(attn_ms)
    cfg, requests = models[0]
    params = random_params(cfg)
    baseline = baseline_phase(cfg, params, requests, dense)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lap("20 prefill_32k, baselines")
    log("[time] each phase, s: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}) + f"; in all "
        f"{sum(phase_s.values()):.1f} s after the imports")

    served = {"flash_decode": dict(dtype="bfloat16", B=4, window=None),
              "flash_decode_int8": dict(dtype="bfloat16", B=4, D=HEAD_DIM,
                                        window=None, note=""),
              "flash_attention": dict(dtype="bfloat16", B=4, S=512,
                                      window=None),
              "ssd_scan": dict(dtype="bfloat16", S=512, chunk=256, pad=0),
              "flash_decode_sharded": dict(dtype="bfloat16", B=4, tp=TP)}
    meta = {
        "flash_decode_sharded": ("src/repro_torch/csrc/decode_attention.cu",
                                 "src/repro/kernels/decode_attention.py:244"),
        "flash_decode": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:35"),
        "flash_decode_int8": ("src/repro_torch/csrc/decode_attention.cu",
                              "src/repro/kernels/decode_attention.py:81"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:28"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssm_scan.py:25"),
    }
    # zamba2-7b's shapes, with phase 9's launches
    hy_rows = {"flash_decode": dict(dtype="bfloat16", B=4, L=MAX_LEN),
               "flash_attention": dict(dtype="bfloat16", B=1, S=MAX_LEN),
               "ssd_scan": dict(dtype="bfloat16", S=512, chunk=256, pad=0)}
    # qwen2-vl-7b's shapes with phase 8's launches, whisper's with phase
    # 10's
    vl_rows = {"flash_decode": dict(dtype="bfloat16", B=4, L=MAX_LEN),
               "flash_attention": dict(dtype="bfloat16", B=4, S=MAX_LEN)}
    au_rows = {"flash_decode": dict(dtype="bfloat16", B=4, L=AU_ROWS),
               "flash_attention": dict(dtype="bfloat16", B=STEP_SLOTS,
                                       S=STEP_PROMPT)}
    # the MoE pods' ranks, with phase 11's launches
    tp_row = dict(dtype="bfloat16", B=4, tp=TP)
    meta["flash_decode_int8_sharded"] = (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:81")
    kernels = []
    for name, key, counts, arch, *label in (
            [(n, k, launches, "") for n, k in served.items()]
            + [(n, k, hybrid, HY_ARCH) for n, k in hy_rows.items()]
            + [(n, k, archs[VL_ARCH], VL_ARCH) for n, k in vl_rows.items()]
            + [(n, k, audio, AU_ARCH) for n, k in au_rows.items()]
            + [("flash_decode_sharded", tp_row, moe_tp[a], a)
               for a, _, _ in MOE_TP_SHAPES]
            # the SSM and hybrid pods' ranks, with phase 12's launches
            + [("ssd_scan", served["ssd_scan"], ssm_tp["mamba2-130m"],
                SSM_TP_TAG)]
            + [(n, k, ssm_tp[HY_ARCH], HY_TP_TAG) for n, k in (
                ("ssd_scan", served["ssd_scan"]),
                ("flash_attention", hy_rows["flash_attention"]),
                ("flash_decode_sharded", tp_row))]
            # the vlm and audio pods' ranks, with phase 13's launches
            + [(n, k, vlm_audio_tp[a], tag) for a, tag, k0 in (
                (VL_ARCH, VL_TP_TAG, dict(dtype="bfloat16", B=4,
                                          S=VL_PATCHES + VL_TEXT)),
                (AU_ARCH, AU_TP_TAG, au_rows["flash_attention"]))
               for n, k in (("flash_attention", k0),
                            ("flash_decode_sharded", tp_row))]
            # the int8 pod's ranks, with phase 16's launches
            + [("flash_decode_int8_sharded", tp_row, pod16,
                f"qwen2-1.5b TP={TP}")]
            # the uneven pods' ranks, with phase 17's launches
            + [(n, k, uneven[UNEVEN_TAG], UNEVEN_TAG) for n, k in (
                ("flash_decode_sharded", dict(tp_row, tp=UNEVEN_TP)),
                ("flash_decode_int8_sharded", dict(tp_row, tp=UNEVEN_TP)),
                ("flash_attention", dict(dtype="bfloat16", B=4,
                                         S=MAX_LEN)))]
            + [(n, k, uneven[AU_UNEVEN_TAG], AU_UNEVEN_TAG) for n, k in (
                ("flash_decode_sharded", dict(tp_row, tp=AU_UNEVEN_TP)),
                ("flash_attention", au_rows["flash_attention"]))]
            # the expert pod's ranks, with phase 19's launches
            + [(n, k, expert["expert"], EXPERT_TAG) for n, k in (
                ("flash_decode_sharded", dict(tp_row, tp=EXPERT_TP)),
                ("flash_attention", dict(dtype="bfloat16", B=EXPERT_SLOTS,
                                         S=EXPERT_PROMPT)))]
            # the training batch, with phase 14's evaluation forwards
            + [(n, dict(dtype="bfloat16", B=TRAIN_B, S=TRAIN_S),
                trained[a]["launches"], TRAIN_TAG) for n, a in (
                ("flash_attention", "qwen2-1.5b"),
                ("ssd_scan", "mamba2-130m"))]
            # the prefill_32k step and the baseline engine, with phase 20's
            # launches
            + [("flash_attention", dict(dtype="bfloat16", B=LONG_PREFILL[-1][0],
                                        S=LONG_PREFILL[-1][1], window=None),
                prefill32k, "", "prefill_32k step")]
            + [(n, served[n], baseline, "", "dense-baseline")
               for n in ("flash_attention", "flash_decode")]):
        r = next(r for r in rows[name]
                 if r.get("arch", "") == arch
                 and all(r[k] == v for k, v in key.items()))
        if name == "ssd_scan":
            shape = f"B={r['B']} S={r['S']} H={r['H']} P={r['P']} N={r['N']}"
        elif name == "flash_attention":
            shape = f"B={r['B']} S={r['S']} heads {r['heads']} D={r['D']}"
        else:  # the decode wrappers (heads per rank when sharded)
            shape = (f"B={r['B']} L={r['L']} heads {r['heads']} "
                     f"D={r.get('D', HEAD_DIM)}")
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"{(label or [arch])[0] + ': ' if label or arch else ''}"
                     f"{r['dtype']} {shape}"})
    kernels += seq_kernel_json(seq_rows, seq)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
