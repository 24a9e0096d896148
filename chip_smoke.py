#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints the build seconds;
3. prints the host's CPU and launch rate (so runs on different hosts can
   be told apart), then holds every kernel against its plain PyTorch
   version at the main path's shapes, on the same inputs, with the
   tolerance printed (the Mini-App kernels through their ``torch.library``
   ops, ``torch.ops.repro_torch.kmeans_assign`` and the others, as the main
   path calls them; for the attention kernels per element, and shown to
   fail a mask off by one; ``kmeans_assign`` in each regime its plan
   chooses, narrow 80 000 x 3 x 10 and wide 65 536 x 128 x 1024, f32 and
   bf16, and the chunked regime at 4096 x 20 000 x 2 and 15, with the
   regime and the least kernel's time printed; ``kmeans_update`` at the
   wide stream's shape, masked and with every row on one label, against a
   float64 sum and bitwise across repeats; decode
   also, untimed, at the edges of the
   chunks it splits the cache into and bitwise across repeated calls and
   CUDA-graph replays, while its timed inputs have fixed positions and a
   generator of their own; for ``tomo_project`` also on sparse images and for
   ``tomo_backproject`` on sparse sinograms, where a dropped pixel or bin
   shows; flash attention also at B=1 S=2048, where the work is
   operations; flash and decode also at kimi-k2's serving shapes and head
   dim of 112 (64 query heads over 8 KV heads: the prefill of one prompt of
   128, decode at B=4 S=256 and at its chunk edges); the flash backward
   kernels at the training shape, B=8 S=128, at B=1 S=2048, and at the
   MoE models' layouts at B=1 S=512 (kimi-k2's 64 query heads over 8 KV
   heads of 112, phi3.5-moe's 32 over 8 of 128) and at the four
   families' training attention (llava's S = 704, seamless's non-causal
   encoder, its causal decoder and its cross-attention of 128 rows over 256
   keys, zamba2's 32 over 32 heads), on the
   log-sum-exp-writing forward's output, per element, with a mask off by
   one (causal) or a key dropped and a zero key added (non-causal) shown to
   fail and a second launch bitwise equal, timed beside that
   forward and SDPA's forward plus backward), and times kernel, plain
   version and (where one
   exists) a single PyTorch library call that computes the same function:
   by device time, replaying a CUDA graph of many calls, where a call is
   short (K-Means, attention at B = 1, 4 and 64; the host's per-call time
   is printed beside it as ``call_ms``, and beside decode's bound the
   device time of the least kernel, ``launch_floor_ms``), by CUDA events
   around calls for the projectors; then every bf16 matrix product of the
   families' 1-layer train step and of a 4-row decode step on unit-normal
   operands, with ``allow_bf16_reduced_precision_reduction`` as torch set it
   and off: the share of elements more than one bf16 ulp from the f32
   product rounded once (a ``bf16_products`` line; none may be in either state);
4. drives the main paths through the port's entry points: a
   ``PilotComputeService`` on the card with a ``kafka`` pilot (2 broker
   nodes) and a ``spark`` pilot, then (a) a K-Means cluster stream of
   5000 x 3 points per message into ``StreamingKMeans(10, 3)`` and a wide
   one, 4096 x 128 points per message, 16 messages per batch, into
   ``StreamingKMeans(1024, 128)``, (b) a
   light-source stream of 360 x 1448 sinograms reconstructed at n = 1448 by
   GridRec and by ML-EM, and (c) the LM serving stream: 16 messages of 4
   prompts of 128 tokens into ``LMServeApp`` on ``smollm-135m`` at full
   width (random weights from the seed), continuous batching over paged
   KV, 32 greedy tokens per request; then (d) the MoE family at its
   published widths, depth cut to fit one card: phi3.5-moe at 8 of 32
   layers, then kimi-k2 at 1 of 61 (its weights drawn after phi3.5's are
   freed), each served 2 messages of 4 prompts of 128 tokens, 16 greedy
   tokens each, at the published capacity factor, then 1 message at
   capacity_factor = E / K (no token drops) that is re-scored as (c) is,
   near-tied routes reported; and one phi3.5-moe MoE layer at full width in
   f32 on the card against the CPU, routes compared token by token; then
   (e) the families phase: llava-next-mistral-7b (VLM), seamless-m4t-medium
   (enc-dec), rwkv6-3b and zamba2-1.2b at full width and full depth, bf16,
   one at a time: llava and seamless through the model's prefill and decode
   (4 prompts of 128 tokens behind 576 patch embeddings, or beside 256
   frame embeddings; 16 greedy tokens, each re-scored by a prefill of its
   context), rwkv6 and zamba2 through ``LMServeApp(mode="lockstep")`` (2
   messages of 4 x 128 tokens, 65 greedy tokens, the serving replayed
   bitwise and the last token re-scored by a prefill of 192 tokens), with a
   ``path`` line each (wall, tokens/s, peak memory, launches: flash and
   decode for all but rwkv6, which has no attention), and each family at 2
   layers in f32 on the card against the CPU; the attention kernels are
   checked at the phase's shapes first (non-causal, Sq != Skv, G = 1, S =
   704 and 720), beside SDPA; every kernel's launch count is set to 0 just
   before a path and read just after it;
5. re-scores every served sequence with the model's prefill and holds each
   generated token against that forward's argmax, then saves the served
   model's parameters (f32, and cast to bf16) with the port's
   ``CheckpointManager`` and restores them onto the card, bitwise, printing
   the write and read seconds; then runs the training stream as
   ``launch/train.py`` does: a TokenSource of 8 x 128 zipf tokens a message
   into ``LMTrainApp`` on smollm-135m at full width (adamw, lr 3e-4, 5
   warm-up steps, one message a step, 20 steps, remat "full"), a checkpoint
   every 10 steps restored bitwise; checks the losses finite and falling,
   60 flash forwards and 30 of each backward kernel per step, the state on
   the card, and two steps at full width but 2 layers against the same
   steps on the CPU, then two steps of kimi-k2 reduced but at its head dim
   of 112 (16 query heads over 2 KV heads, bf16 compute, the MoE aux loss)
   the same way (a ``train_moe`` line); prints one ``path train`` line (step
   p50/p99, tokens/s, the card's peak memory, the losses); then trains the
   four families at full width, bf16 params and f32 moments, one at a time
   (rwkv6-3b and zamba2-1.2b at full depth through the launcher on token
   messages, seamless-m4t at full depth and llava-next at 16 of 32 layers
   through ``build_train_step`` on stub embeddings), checks the losses
   finite, the loss falling on one batch repeated from the drawn state, the
   state on the card and the
   flash launches a step the model gives, prints a ``path`` line each
   (tokens/s, step p50, first step, peak memory) and what indexing
   llava's stacked layer leaves costs a step; then each family at 1 layer, card
   against CPU (a ``train_card_vs_cpu`` line each); then trains llava-next,
   rwkv6-3b and zamba2-1.2b at full width, 1 layer and f32 for 100 steps on
   the card (llava through ``build_train_step``, the other two from the
   broker into ``LMTrainApp``; a ``trained`` line each with the loss curve
   and a digest of the weights) and from those weights runs the bf16 check
   card against CPU (a ``train_card_vs_cpu`` line with ``"weights":
   "trained"``; read, C13) and serves rwkv6
   and zamba2 in bf16 through ``LMServeApp(mode="lockstep")``, each served
   token held to its re-score by the top-2-gap rule;
6. runs the pipeline phase: a ``PipelineSpec`` built by the port's ``Pipeline``
   (one kafka node; light-source frames at a stepped rate into an elastic
   ML-EM stage, the cluster stream into a K-Means stage) through
   ``spec.run(devices=4)``, four device slots of the card, until both
   streams have drained and the ML-EM stage has scaled up and back down;
   checks every message processed, the arbiter within the pool, every
   kernel of the stages launched, the apps on the card, K-Means inertia
   falling, the last reconstruction against the plain version, reverse-order
   teardown, and the CLI (``python -m repro_torch.pipeline validate``, in a
   fresh interpreter) accepting the spec and three variants: a continuous
   K-Means stage, that stage on worker processes, and the shared-memory
   transport; prints one ``path pipeline`` line;
7. runs the continuous phase: a ``PipelineSpec`` with one continuous stage
   (tumbling event-time windows over a keyed stream of K-Means messages,
   crash checkpoints) three times on two slots of the card — fault-free;
   with its pilot killed by a ``FaultInjector`` and recovered by the
   runner's ``StageReconciler``; grown to two slots and back by an
   extension pilot — and holds the second and third runs to the first
   bitwise on every (key, window), with no firing lost, duplicated or
   late, at least one recovery, partitions moved between the slots, both
   K-Means kernels launched per firing, and sampled firings against the
   plain versions on the CPU; prints one ``path continuous`` line. Then the
   same spec with ``executor="mp"``: each slot's partitions in a worker
   process spawned on the card (the window processor is a module-level
   class that pickles), run fault-free, with a worker SIGKILLed (its
   supervisor respawns it and replays), with the pilot killed (recovered
   and rehomed onto the new pilot's slots) and grown and shrunk (a worker
   spawned on the grow, 32 of 64 partitions moved each way), each held to
   the inline fault-free run bitwise, the kernels' launches counted in the
   workers; prints one ``path continuous-mp`` line with the workers' start
   and respawn-to-resumed seconds and the card's most used memory;
8. runs the transport phase: a detector source's 360 x 1448 f32 frames, 8
   per slot of a shared-memory ring, into an ML-EM stage on the card that
   reads them as views, and the same spec on the log; checks every frame
   processed, none copied out, each frame's reconstruction over the ring
   against the log run's, the last against the plain versions, both
   projectors launched and no segment left in ``/dev/shm``; prints one
   ``path transport`` line, and one ``host_transport`` line (host only) for
   the JAX package's transport benchmark configuration through the port;
9. runs the mesh phase (``mesh_path``): one bf16 step of smollm-135m (2
   layers) through the mesh train step on a world-of-one NCCL mesh in this
   process, bitwise against the one-device step; then one spawn of a 4-rank
   gloo group on ``cuda:0`` as a (2, 2) ("data", "model") mesh, its
   collectives staged through host memory, within 240 s, whose ranks load
   the kernels built here and hold sharded attention (forward and
   backward) and ring prefill at llava's S = 704 to the one-device flash
   kernel, smollm-135m's f32 mesh step (5 of its 30 layers) to the
   one-device step under the ``TRAIN_*`` limits, then take 2 counted bf16
   steps (losses,
   step p50, tokens/s, each rank's peak memory), the vocab-parallel loss
   and embedding at smollm's vocabulary against the dense ones, the
   sequence-parallel WKV6 (rwkv6-3b's width) and SSD and conv (zamba2's)
   against the chunked cores, the int8 ``quantized_psum`` over "data", and
   a save from a (4,) mesh restored onto the (2, 2) one bitwise, and the
   serving steps on the mesh: smollm-135m at full width and depth in f32, 4
   prompts of 120 tokens prefilled into a 256-entry cache whose sequence is
   split over "model" (the second rank's tile empty for the first 8 steps,
   written and merged from position 128 on), 16 greedy decode steps, the
   one-device steps fed the mesh's tokens, every call's logits held to
   theirs; (i') the same in bf16 (C16), every served token the one-device
   bf16 argmax wherever its top-2 gap exceeds 0.05 (a ``check mesh serve
   bf16`` line), its row-parallel products' shapes kept; then, in this
   process on the card alone, what those products' f32 copies of their
   inputs and tiles cost a decode step (A18: an ``a18 row_product`` line
   with the card's name and power limit); and the families case:
   phi3.5-moe (groups across the sequence shards and, in decode, across
   the "data" ranks; trained under kimi-k2's Adafactor; expert-parallel, 8
   of its 16 experts a rank, tokens moved by all-to-all), llava-next (a rank
   of patches only) and seamless-m4t (frames and tokens split, the memory's
   tiles) at full width and one layer in f32, a train step and serving
   each, against the one-device steps; prints a ``check mesh`` line each, a
   ``check mesh family`` line a families part and one ``path mesh`` line
   (backend, staging, seconds). Step 3 also checks the flash kernel
   (non-causal, at the encoder shard's offset and the decoder's
   cross-attention over the gathered memory) and the decode kernel over an
   enc-dec memory tile at the families case's f32 shapes. Before the main paths, step 3 also checks the flash forward
   and the backward pair at a causal query offset (a sequence shard's rows)
   at smollm's and llava's shard shapes, per element, with an offset one
   off shown to fail, timed beside SDPA with an equal boolean mask;
9'. runs the train group phase (``train_group_path``, ROADMAP A16's app
   part): smollm-135m at full width and 5 of its 30 layers in f32 through
   ``LMTrainApp(mesh=...)``, fed from the broker through the micro-batch
   engine on a rank group of the app's own: a (2, 2) gloo group on
   ``cuda:0`` x 4 for 3 batches, then ``stream.rescale`` onto a (4, 1)
   group, a (2, 1) group and back to ``cuda:0`` alone (a world-of-one NCCL
   group: the app keeps a group), 2 batches each, the live state gathered
   into host memory at each move (no checkpoint file); every loss and the
   final params and moments held to a one-device ``LMTrainApp`` fed the same
   batches from the same seed, the NCCL group's steps bitwise against the
   one-device app's from the state it was handed, every rank of every
   group launching the flash forward and backward kernels; prints one
   ``path train_group`` line (each group's start seconds, backend, step
   p50 and launches a rank; each rescale's seconds and host bytes);
10. runs the dry-run phase (``dryrun_path``, within 60 s): the decode kernel
   on a cache shard (its start and log-sum-exp) at qwen3-14b's decode_32k
   rank shard against its plain version, its 16 shards merged against the
   whole-cache kernel, empty rows 0 and -inf, a start one off shown to fail;
   smollm-135m's training, prefill and decode steps traced under fake
   tensors (``runtime/cost_analysis.py``) and run on the card, the FLOPs
   equal and the traced peak within 10 % of the card's, with wall p50 and
   ``mfu``; the dry run's four Mini-App cells (a K-Means batch narrow and
   wide, a GridRec and an ML-EM batch of 8 frames of 360 x 1448 into
   1448 x 1448) traced and run on the card, the FLOPs equal to
   ``FlopCounterMode``'s and to the kernels' formulas, the peaks side by
   side (``estimate miniapp`` lines); and one production cell (qwen3-14b x
   decode_32k on the 16 x 16 mesh) through ``python -m
   repro_torch.launch.dryrun`` in a process of its own; prints ``check
   decode_attention shard``, ``estimate``, ``dryrun cell`` and ``path
   dryrun`` lines;
11. prints one JSON line ``{"kernels": [...]}`` and, last, one JSON line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without printing the
last line. It refuses to run without CUDA or without the port's sources
beside it.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# published H100 SXM peaks (NVIDIA data sheet), from the port's roofline
# (launch/roofline.py, their one source): HBM3 rate, f32 rate outside the
# tensor cores, and the TF32 and bf16 tensor-core rates (dense). A kernel's
# operations are held against the peak for its inputs' type: f32 for
# K-Means and the projectors, bf16 for the attention kernels at the serving
# path's width and the bf16 K-Means checks; the wide f32 K-Means check also
# against the TF32 rate for the 3 products its design issues. Without the
# repo beside this script the import fails and nothing runs.
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch.roofline import H100, H100_F32_FLOPS, H100_TF32_FLOPS  # noqa: E402

HBM_BYTES_PER_S, BF16_OPS_PER_S = H100.hbm, H100.flops
F32_OPS_PER_S, TF32_OPS_PER_S = H100_F32_FLOPS, H100_TF32_FLOPS
F32_EPS = 2.0 ** -23
BF16_STEP = 2.0 ** -7  # one bf16 step, relative (8 significant bits)
# the f32 sums of an attention kernel and its plain version, in two orders:
# the card tests hold them to 1e-5 on unit-scale f32 inputs; twice 2^-16 of
# the largest |v| covers that
ATTN_SUM_REL = 2.0 ** -15
# rows with at least this many live keys are where a mask off by one moves
# the output least; the checks show that it still fails them there
LONG_ROW = 64

# the light-source stream: one 360 x 1448 f32 sinogram per message,
# reconstructed at one pixel per detector bin; ML-EM at the app's default
FRAME_ANGLES, FRAME_BINS, RECON_N, MLEM_ITERS = 360, 1448, 1448, 4

# the wide K-Means stream: 1024 centres in 128 dimensions, 4096 points per
# message (f64, 4 MB), 16 messages per batch (N = 65 536, the wide check's
# shape), WIDE_BATCHES batches
WIDE_K, WIDE_D, WIDE_POINTS_PER_MSG, WIDE_MSGS_PER_BATCH, WIDE_BATCHES = 1024, 128, 4096, 16, 4

# the pipeline phase (a PipelineSpec built by the port's Pipeline and run
# by its runner): one kafka node; an elastic ML-EM stage on the light-source frames,
# whose source steps its rate (seconds, msgs/s) to about twice what the
# stage sustains and back to a sixth of it, and ends with the schedule (or
# as much later as its producer fell behind in the burst: near 225 of 250
# msgs/s of these 2.1 MB frames, while the stages run); a K-Means stage on the
# cluster stream; PIPE_SLOTS device slots of the one card. The ML-EM stage
# takes batches of 8 frames with the engine's rate control off, as the
# reference's elastic pipelines run: about 123 frames/s on the H100
# (tools/pipeline_capacity.py, PERF.md §4)
PIPE_SLOTS = 4
PIPE_RECON_BATCH, PIPE_RECON_RATE_CONTROL = 8, False
PIPE_FRAME_SCHEDULE = ((2.0, 10), (2.5, 250), (4.0, 20))
PIPE_FRAMES = int(sum(t * r for t, r in PIPE_FRAME_SCHEDULE))  # 725
PIPE_POINTS_RATE, PIPE_POINTS = 200, 2000
PIPE_TIMEOUT_S = 45  # the phase fails if it is not done by then (it takes 10-14 s)

# the continuous phase (a PipelineSpec with one continuous stage, run three
# times): the K-Means stream's messages of 5000 x 3 f64 points, pure
# functions of the message index i (points from a generator seeded with
# (SEED, i), event time CONT_BASE_TS + CONT_DT * i, key i mod CONT_KEYS),
# one producer at CONT_RATE msgs/s into one topic partition, tumbling
# CONT_WINDOW s event-time windows (about 25 messages, 125 000 points, per
# key and window), a crash checkpoint every CONT_CKPT records. Each firing
# runs kmeans_assign against CONT_K centroids per key (fixed from SEED) and
# kmeans_update on the card. Run 2 kills the stage's pilot at CONT_KILL_AT
# records (recovered by the runner's StageReconciler); run 3 grows the
# stage from one slot of the card to two at CONT_GROW_AT records and back
# at CONT_SHRINK_AT
CONT_MSGS, CONT_RATE, CONT_KEYS, CONT_POINTS, CONT_K = 3000, 500, 4, 5000, 10
CONT_BASE_TS, CONT_DT, CONT_WINDOW, CONT_CKPT = 1000.0, 0.01, 1.0, 500
CONT_KILL_AT, CONT_GROW_AT, CONT_SHRINK_AT = 1200, 1000, 2000
# every window but the last closes: 29 x 4 = 116 firings
CONT_FIRINGS = (round(CONT_MSGS * CONT_DT / CONT_WINDOW) - 1) * CONT_KEYS
CONT_TIMEOUT_S = 60  # per run; a run takes 6-7 s, the kill run 2 s more
# the same phase with executor="mp": the stage's partitions in worker
# processes, spawned (the slots are on the card); run 2 SIGKILLs a worker
# at CONT_KILL_AT records, which its supervisor respawns and replays
CONT_MP_TIMEOUT_S = 90  # per run: a worker's spawn takes seconds

# the transport phase: a beamline detector's frames (360 x 1448 f32, 2.1 MB)
# written once into a shared-memory ring, 8 per slot, and reconstructed by
# ML-EM at n = 1448 on the card; one producer at TRANS_RATE frames/s, about
# 80 % of what the stage drains at 8-frame batches (PERF.md §4), TRANS_FRAMES
# frames from a cache of TRANS_CACHED; run again on the log plane
TRANS_RING = {"slot_bytes": 1 << 25, "n_slots": 16}
TRANS_FRAMES, TRANS_RATE, TRANS_BATCH, TRANS_CACHED = 400, 100, 8, 16
TRANS_TIMEOUT_S = 60  # per run; the source alone takes 4 s
# beside it, on the host only: the JAX package's own transport benchmark
# configuration (benchmarks/transport.py): 128 x 128 uint16 frames, trains of
# 32, 8000 messages, 1 and 4 consumer groups, through the port's modules
HOST_TRANS_NY, HOST_TRANS_NX, HOST_TRANS_BATCH, HOST_TRANS_MSGS = 128, 128, 32, 8000

# the serving stream: messages of SERVE_BATCH prompts, one message per
# micro-batch, as launch/serve.py runs it; smollm-135m's attention is
# 9 query heads over 3 KV heads of 64
SERVE_MSGS, SERVE_BATCH, PROMPT_LEN, GEN_TOKENS, PAGE_SIZE = 16, 4, 128, 32, 16
HEADS, KV_HEADS, HEAD_DIM = 9, 3, 64
SERVE_HEADS = (HEADS, KV_HEADS, HEAD_DIM)
KIMI_HEADS = (64, 8, 112)  # kimi-k2's attention: no multiple of 32 in its head dim
PHI_HEADS = (32, 8, 128)  # phi3.5-moe's: 4 query heads a KV head
# the training stream, as launch/train.py runs it: messages of TRAIN_BATCH
# sequences of TRAIN_SEQ zipf tokens, one message a step, smollm-135m at full
# width (f32 params and AdamW moments, bf16 compute, remat="full"), adamw at
# lr 3e-4 with 5 warm-up steps, TRAIN_STEPS steps, a checkpoint every
# TRAIN_CKPT_EVERY; then TRAIN_CHECK_STEPS steps at full width but
# TRAIN_CHECK_LAYERS layers on the card and on the CPU from the same weights
# and batches (bf16 activations rounded at other places on the two devices),
# held to: each step's loss and grad norm relative, each leaf's change over
# the steps (||card - cpu|| / ||cpu - start||: Adam's first step alone is
# lr sign(g), so the second step is taken) and each first moment (0.1 x the
# clipped grads) to its leaf's largest |value|; each limit is 5-7x the
# H100's reading (PERF.md: 1.68e-5, 1.51e-4, 0.0296, 0.00377)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 128, 20, 10
TRAIN_LR, TRAIN_WARMUP, TRAIN_CHECK_LAYERS, TRAIN_CHECK_STEPS = 3e-4, 5, 2, 2
TRAIN_LOSS_REL, TRAIN_NORM_REL, TRAIN_UPDATE_REL, TRAIN_MOMENT_REL = 1e-4, 1e-3, 0.15, 0.02
# the MoE family's training on the card: the backward kernels checked at
# kimi-k2's and phi3.5-moe's attention layouts at B=1 and MOE_TRAIN_SEQ,
# and TRAIN_CHECK_STEPS steps of kimi-k2 reduced to MOE_TRAIN_ARCH's
# overrides (2 layers, d 128, 4 experts top-2 and a shared one) but with
# its head dim of 112 and bf16 compute, card against CPU as above
MOE_TRAIN_SEQ = 512
MOE_TRAIN_ARCH = ("kimi-k2-1t-a32b", {"head_dim": 112, "n_heads": 16, "n_kv_heads": 2,
                                      "compute_dtype": "bfloat16"})

# the MoE serving phase: the MoE family at its published widths on one card,
# depth cut to fit (PERF.md §4): phi3.5-moe at 8 of 32 layers (about 21 GB of
# bf16 weights; the 32 layers' 84 GB do not fit), kimi-k2 at 1 of 61 (about
# 39 GB, 34 of them its 384 experts). MOE_MSGS messages of SERVE_BATCH
# prompts of PROMPT_LEN tokens, MOE_GEN_TOKENS greedy tokens each, at the
# published capacity factor (tokens past an expert's capacity fall through,
# as users see it); then MOE_NODROP_MSGS at capacity_factor = E / K, where
# no token drops and prefill routes as decode does, re-scored. The
# re-score's prefills are cut so that the experts' dispatch buffer (every
# expert's capacity at E / K) stays below MOE_DISPATCH_BYTES. A route whose
# margin (the K-th chosen router logit less the best unchosen one) is at
# most MOE_ROUTE_TIE is a near-tie: one or two bf16 steps of these logits
# (of order 0.1 from the router's std 1e-3; a step is 2^-11 in [1/16, 1/8),
# 2^-10 in [1/8, 1/4)) that the prefill and decode paths round differently
# can flip. The flips seen on the H100 (PERF.md §5) had own margins 0,
# 1.2e-4, 4.9e-4, 7.3e-4 and 9.8e-4 (2^-10): the tie is the largest of them
MOE_MODELS = (("phi3.5-moe-42b-a6.6b", 8), ("kimi-k2-1t-a32b", 1))
MOE_MSGS, MOE_NODROP_MSGS, MOE_GEN_TOKENS = 2, 1, 16
MOE_DISPATCH_BYTES, MOE_ROUTE_TIE = 4e9, 2.0 ** -10
# the card-vs-CPU MoE layer (f32): router logits differ by their f32 sums'
# order, about 1e-8 at these sizes, so a flip needs a margin below
# MOE_F32_TIE; outputs of tokens routed alike, products over 4096 and 6400
# terms in other orders, agree to MOE_LAYER_REL of the largest |y|
MOE_F32_TIE, MOE_LAYER_REL = 1e-5, 1e-4
# the flash kernels' causal query offset (a sequence shard's rows against the
# whole sequence's keys), bf16: smollm's training shape cut into two shards
# (the second: B = 8, 64 rows at offset 64 over 128 keys, 9 over 3 heads of
# 64) and llava's S = 704 cut into four (176 rows at each shard's offset over
# 704 keys, 32 over 8 heads of 128)
OFFSET_CASES = ((TRAIN_BATCH, 64, 128, (64,), SERVE_HEADS),
                (TRAIN_BATCH, 176, 704, (0, 176, 352, 528), (32, 8, 128)))
# the mesh phase: 4 gloo ranks on the one card as a (2, 2) ("data",
# "model") mesh, within MESH_TIMEOUT_S; llava's attention at B =
# MESH_ATTN_BATCH in f32 to MESH_F32_TOL; the sequence cores at T =
# MESH_SEQ_T to MESH_SEQ_TOL (x max(1, max|ref|)); smollm-135m at full
# width and MESH_TRAIN_LAYERS of its 30 layers, one f32 step against one
# device, then MESH_BF16_STEPS bf16 steps (3 at full depth until the
# dry-run phase joined the run, 15 layers until the families case did:
# PERF.md §4-5)
MESH_SHAPE, MESH_TIMEOUT_S, MESH_ATTN_BATCH = (2, 2), 240, 2
MESH_F32_TOL, MESH_SEQ_T, MESH_BF16_STEPS, MESH_TRAIN_LAYERS = 2e-5, 512, 2, 5
MESH_SEQ_TOL = {"wkv6": 2e-4, "ssd": 2e-4, "conv1d": 3e-4}
# the mesh phase's serving check, in the same 4 ranks: smollm-135m at full
# width and depth in f32, MESH_SERVE_PROMPTS prompts of MESH_SERVE_PROMPT_LEN
# tokens prefilled into a cache of MESH_SERVE_CACHE positions (rows over
# "data", the prompts' and the cache's sequence over "model": tiles of 128
# positions), then MESH_SERVE_STEPS decode steps on the one-device steps'
# greedy tokens, at positions 120-135: for the first 8 the second "model"
# rank's tile holds no valid entry, from position 128 on that rank writes
# the new entry and both tiles' partials merge; every call's logits within
# MESH_SERVE_REL x max|logit| of the one-device steps', the mesh's argmax
# the one-device one's wherever the one-device top-2 gap exceeds RESCORE_GAP
MESH_SERVE_PROMPTS, MESH_SERVE_PROMPT_LEN, MESH_SERVE_CACHE = 4, 120, 256
MESH_SERVE_STEPS, MESH_SERVE_REL = 16, 1e-4
# the mesh phase's families case, in the same 4 ranks, one family at a time:
# phi3.5-moe and llava-next at 1 layer, seamless-m4t at 1 encoder and 1
# decoder layer, each at full width with f32 params and compute, weights
# drawn alike on every rank from SEED (phi's router x MESH_FAM_ROUTER, as the
# MoE parity tests scale it, so that no top-k set hangs on the two layouts'
# f32 rounding). Train: one step on MESH_FAM_TRAIN_B rows: phi at
# MESH_FAM_PHI_SEQ tokens (groups of 256 over sequence shards of 128, so
# each group spans both "model" ranks, at the config's capacity factor,
# drops counted) under kimi-k2's optimizer config (Adafactor, factored, no
# first moment), llava at its 576 patches and MESH_FAM_TOKENS text tokens
# (S = 704, shards of 352: the first "model" rank holds only patches) and
# seamless at FAM_FRAMES frames and MESH_FAM_TOKENS tokens, each split over
# "model", under SGD at MESH_FAM_SGD_LR: the update is the clipped gradient,
# of norm 1 over the model, so its rounding into the f32 params stays near
# 1e-5 of it (at lr 3e-4 the rounding alone reached 6.6e-4 of the update on
# the H100: PERF.md §6). Each against the
# one-device step from the same weights on rank 0, run first and alone (its
# results kept on the host, its card memory freed; each rank compares its
# tiles with its tiles of the results, scattered from rank 0):
# the loss and grad norm to TRAIN_LOSS_REL / TRAIN_NORM_REL relative, each
# leaf's update to MESH_FAM_UPDATE_REL of its norm, Adafactor's factored
# moments to MESH_FAM_UPDATE_REL of their leaf's largest |value|. Serve: the
# serving check's MESH_SERVE_PROMPTS prompts and MESH_SERVE_STEPS decode
# steps (phi: MESH_SERVE_PROMPT_LEN tokens into MESH_SERVE_CACHE entries,
# its 4 decode rows one group across both "data" ranks; llava: 576 patches
# and MESH_FAM_TOKENS tokens into MESH_FAM_VLM_CACHE entries, whose tiles
# meet at 712, inside the decode; seamless: FAM_FRAMES frames, whose K/V
# tiles of 128 each decode step's cross-attention reads, and
# MESH_SERVE_PROMPT_LEN tokens into MESH_SERVE_CACHE entries), held as the
# serving check holds smollm. phi is expert-parallel in both: each rank keeps
# and computes 8 of its 16 experts, its train step and prefill move tokens by
# all-to-all, its decode moves none (each line reads the rank's expert-tile
# bytes, the expert bytes gathered a layer and the all-to-all bytes)
MESH_FAMILIES = ("phi3.5-moe-42b-a6.6b", "llava-next-mistral-7b", "seamless-m4t-medium")
MESH_FAM_ROUTER, MESH_FAM_TRAIN_B, MESH_FAM_PHI_SEQ, MESH_FAM_TOKENS = 100.0, 2, 256, 128
MESH_FAM_VLM_CACHE, MESH_FAM_UPDATE_REL, MESH_FAM_SGD_LR = 1424, 1e-3, 1.0
MESH_FAM_TOKENS_HALF = MESH_FAM_TOKENS // 2
# the train group phase (ROADMAP A16's app part): smollm-135m at full width
# and MESH_TRAIN_LAYERS layers in f32 through LMTrainApp(mesh=...), a rank
# group of the app's own, fed from the broker through the micro-batch engine
# (one message of TRAIN_BATCH x TRAIN_SEQ zipf tokens a batch). GROUP_STAGES:
# each group's shape and the batches it takes before the next
# ``stream.rescale``: a (2, 2) gloo group on cuda:0 x 4, then (4, 1), then
# (2, 1), then back to cuda:0 alone, which for an app built with a mesh is a
# (1, 1) group: a world-of-one NCCL group. Every batch's loss and the final
# params and moments held to a one-device LMTrainApp fed the same batches
# from the same seed (TRAIN_*); the NCCL group's steps bitwise against the
# one-device app's from the state handed to it; each group's ranks must
# launch the flash forward and backward pair; within GROUP_TIMEOUT_S
GROUP_STAGES = (((2, 2), 3), ((4, 1), 2), ((2, 1), 2), ((1, 1), 2))
GROUP_TIMEOUT_S = 180
# the dry-run phase (DRY_TIMEOUT_S at most): the decode kernel at qwen3-14b's
# decode_32k rank shard (DRY_SHARD: 128 / 16 rows, 32 768 / 16 entries, 40
# over 8 heads of 128, bf16), the 16 shards merged against the whole-cache
# kernel; smollm-135m's training step (TRAIN_BATCH x TRAIN_SEQ), a prefill of
# SERVE_BATCH x PROMPT_LEN into a DRY_CACHE-entry cache and a decode step on
# it, each traced under fake tensors and run on the card: FLOPs
# equal, the traced peak (less the inputs) within DRY_PEAK_REL of the card's,
# DRY_REPS timed runs; one production cell, DRY_CELL, through the dry run
DRY_SHARD = (8, 2048, 16, (40, 8, 128))  # rows, entries a shard, shards, heads
DRY_PEAK_REL, DRY_TIMEOUT_S, DRY_REPS, DRY_CACHE = 0.10, 60, 5, 512
DRY_CELL = ("qwen3-14b", "decode_32k")

# a served token must be the re-scoring forward's argmax wherever the top-2
# logit gap exceeds this: the decode path (decode kernel, cache written one
# token at a time) and the prefill path (flash kernel) round their bf16
# residual streams at different places over 30 layers
RESCORE_GAP = 0.05


# the families phase: the four families that are not decoder-only token
# models, at full width and full depth, bf16, random weights drawn on the
# card from SEED, one model at a time (each freed before the next is drawn).
# llava-next (VLM) and seamless-m4t (enc-dec) take stub embeddings beside
# their prompts, which a token stream does not carry, so they are driven
# through the model API as the JAX package's tests drive them: one batch of
# SERVE_BATCH prompts of PROMPT_LEN tokens (llava: behind its 576 patch
# embeddings; seamless: with FAM_FRAMES frame embeddings) and FAM_STUB_GEN
# greedy tokens, each token re-scored by a prefill of its context. rwkv6-3b
# and zamba2-1.2b serve through LMServeApp(mode="lockstep"): FAM_STATE_MSGS
# messages of SERVE_BATCH x PROMPT_LEN tokens, FAM_STATE_GEN greedy tokens,
# so that the last one is checked against a prefill of PROMPT_LEN + 64 = 192
# tokens, which their chunked scans (chunks of 32 and 64) take whole
# (``state_replay``: the rule is held in f32, its bf16 reading printed). Then
# each family at full width but FAM_CHECK_LAYERS layers in f32 (llava's
# patches cut to FAM_CHECK_PATCHES), prefill and FAM_CHECK_DECODES decode
# steps on the card against the CPU from the same weights and inputs, and
# the card's decode path against its prefill of the longer prompt (32 + 32
# tokens: whole chunks of the RWKV6 and Mamba2 scans): the logits held to
# FAM_F32_REL of their largest |value| (products over up to 14 336 terms
# summed in other orders, and the card's f32 attention kernels against the
# plain versions)
FAMILIES = ("llava-next-mistral-7b", "seamless-m4t-medium", "rwkv6-3b", "zamba2-1.2b")
FAM_FRAMES, FAM_STUB_GEN, FAM_STATE_MSGS, FAM_STATE_GEN = 256, 16, 2, 65
FAM_CHECK_LAYERS, FAM_CHECK_PATCHES, FAM_CHECK_TOKENS, FAM_CHECK_DECODES = 2, 64, 32, 32
FAM_F32_REL = 1e-4
# the state families' decode path (64 recurrent steps) against their prefill
# (a chunked scan over 192 tokens) at full depth, in f32: random weights
# amplify the two paths' f32 rounding differences with depth (at 2 layers
# they agree to FAM_F32_REL). PERF.md's families findings hold the H100's
# sound readings beside those of the faults tools/state_faults.py plants
FAM_F32_DEPTH_REL = 2e-3
# the share of an f32 state's elements that may equal their bf16 rounding: a
# random f32 value does with odds of about 2^-16, a state rounded on the way
# always does
FAM_STATE_BF16_EXACT = 0.01
# the attention shapes the families phase gives the kernels, none of them run
# on the card before it: (name, B, Sq, Skv, (H, KV, hd), causal) for flash,
# (name, B, S, (H, KV, hd)) for decode at the cache lengths served
FAM_FLASH = (("llava prefill", SERVE_BATCH, 704, 704, (32, 8, 128), True),
             ("seamless encoder", SERVE_BATCH, FAM_FRAMES, FAM_FRAMES, (16, 16, 64), False),
             ("seamless cross", SERVE_BATCH, PROMPT_LEN, FAM_FRAMES, (16, 16, 64), False),
             ("seamless decoder", SERVE_BATCH, PROMPT_LEN, PROMPT_LEN, (16, 16, 64), True),
             ("zamba site", SERVE_BATCH, PROMPT_LEN, PROMPT_LEN, (32, 32, 64), True))
FAM_DECODE = (("llava", SERVE_BATCH, 704 + FAM_STUB_GEN, (32, 8, 128)),
              ("seamless", SERVE_BATCH, PROMPT_LEN + FAM_STUB_GEN, (16, 16, 64)),
              ("zamba", SERVE_BATCH, PROMPT_LEN + FAM_STATE_GEN, (32, 32, 64)))

# the families training phase, after the training path. The backward kernels
# are checked first at each family's training attention, FAM_BWD: (name, B,
# Sq, Skv, (H, KV, hd), causal), TRAIN_BATCH rows of TRAIN_SEQ tokens (llava:
# behind its 576 patches; seamless: beside FAM_FRAMES frames). Then each
# family at full width, bf16 params (the configs' own) and AdamW with f32
# moments, one model at a time, FAM_TRAIN_STEPS steps: rwkv6-3b and
# zamba2-1.2b at full depth through launch/train.py's run on the training
# stream's token messages (no checkpoint written: rwkv6's state of 3.1B
# params is 31 GB); seamless-m4t-medium at full depth and llava-next at
# FAM_LLAVA_LAYERS of its 32 layers (12 bytes a param: bf16 param and grad,
# two f32 moments; 16 layers hold 3.77B params, 45 GB, the 32 layers' 87 GB
# do not fit) through build_train_step on stub embeddings drawn on the card
# from SEED; the first two steps from the drawn state on one batch, the
# second's loss below the first's (for rwkv6 and zamba2 through the app's
# step before the launcher's run). Then each family at full width but FAM_TCHECK_LAYERS layer
# (seamless: as many encoder and decoder layers; zamba2: one Mamba2 layer
# behind one shared site; 1, not TRAIN_CHECK_LAYERS' 2, so that the run fits
# its time with the mesh phase: the host CPU's side of these steps is most
# of the phase, PERF.md §5), f32 params, TRAIN_CHECK_STEPS steps on the card
# against the CPU from the same weights and batches, held to the TRAIN_*
# tolerances, on FAM_TCHECK_BATCH rows of FAM_TCHECK_TOKENS tokens (llava:
# behind FAM_TCHECK_PATCHES patches; seamless: beside twice as many frames,
# so that its cross-attention runs at Sq != Skv; the CPU's products at full
# width take seconds a step). seamless computes in bf16, so that the bf16
# kernels run at its G = 1, non-causal and Sq != Skv shapes; llava, rwkv6 and
# zamba2 in f32 at these random weights (the f32 kernels; the bf16 kernels are
# held at their shapes by the FAM_BWD checks), since this step is
# ill-conditioned there: moving the weights by 2^-12 of themselves moves
# rwkv6's f32 gradient norm 0.77-1.7x, and its bf16 gradients lie 0.62x (CPU)
# and 2.15x (card) a leaf from f32 (the median; the JAX package's 0.50x). In
# f32 card and CPU agree to 9e-8 in the loss and to 4e-6, 1.2e-5 and 3.2e-4 of
# a leaf's gradient at the first step. Their bf16 step runs card against CPU
# in the trained phase instead (trained_path), from weights trained on the
# card in f32, where it is well-conditioned: bf16 lies about 1-1.7 % of a leaf
# (the median) from f32 on both devices alike. It is read there, not held,
# for all three families, by decision (ROADMAP C13):
# the TRAIN_* limits sit at or below what bf16 departs from f32 on either
# device (tools/train_precision.py --trained, PERF.md §6: the first step's
# loss 3e-5 to 4e-4 of itself on either device, the limit 1e-4; over copies
# of the weights moved by 2^-12 the card's distances lie within the CPU's),
# and the second step starts from updates that already part by 8-13 %.
# llava's check met the limits after 300 steps and missed them after 200 and
# 100. No bf16 product of these steps rounds twice on the card, with torch's
# allow_bf16_reduced_precision_reduction as it is or off
# (BF16_PRODUCT_MODELS), so the port leaves that flag alone. FAM_TCHECK_F32:
# the families whose random-weight check runs in f32 and whose bf16 check
# runs in the trained phase
FAM_BWD = (("llava self", TRAIN_BATCH, 576 + TRAIN_SEQ, 576 + TRAIN_SEQ, (32, 8, 128), True),
           ("seamless encoder", TRAIN_BATCH, FAM_FRAMES, FAM_FRAMES, (16, 16, 64), False),
           ("seamless decoder", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, (16, 16, 64), True),
           ("seamless cross", TRAIN_BATCH, TRAIN_SEQ, FAM_FRAMES, (16, 16, 64), False),
           ("zamba2 site", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, (32, 32, 64), True))
FAM_TRAIN_STEPS, FAM_LLAVA_LAYERS = 6, 16
FAM_TCHECK_BATCH, FAM_TCHECK_TOKENS, FAM_TCHECK_PATCHES, FAM_TCHECK_LAYERS = 2, 64, 64, 1
FAM_TCHECK_F32 = ("llava-next-mistral-7b", "rwkv6-3b", "zamba2-1.2b")
# the trained phase (C13, C14): FAM_TCHECK_F32 at family_check's size
# (full width, FAM_TCHECK_LAYERS layer, f32 params and compute) trained on
# the card for TRAINED_STEPS steps of TRAIN_BATCH x TRAIN_SEQ zipf tokens from
# SEED (llava through family_train_stub, behind FAM_TCHECK_PATCHES stub
# patches; rwkv6 and zamba2 from the broker into LMTrainApp), adamw at
# TRAINED_LR (TRAIN_LR's 3e-4 raises llava's loss on the repeated first
# batch), TRAIN_WARMUP warm-up steps, cosine over the run; the loss has
# flattened at the first step from which the mean of TRAINED_WINDOW losses
# stays within TRAINED_FLAT_REL of the last TRAINED_WINDOW's mean. From those
# weights, the bf16 train check card against CPU (read, not held: see
# above), and the state families served in bf16 with their served tokens
# re-scored under the dense rule, held (C14): every served token whose
# context (the prompt and the tokens served before it) a prefill takes,
# a whole number of the scan's chunks (FAM_STATE_CHUNK: wkv6_chunked's 32,
# ssd_chunked's 64; the reference's scans assert it too), so rwkv6's after
# 0, 32 and 64 served tokens and zamba2's after 0 and 64
FAM_STATE_CHUNK = {"ssm": 32, "hybrid": 64}
TRAINED_STEPS, TRAINED_WINDOW, TRAINED_FLAT_REL, TRAINED_LR = 100, 20, 0.05, 3e-5
# the bf16 products on the card (C13): every bf16 matrix product that the
# families' card-against-CPU train step (family_check at FAM_TCHECK_LAYERS
# layer, the loss and its backward) and a decode step at SERVE_BATCH rows of
# smollm-135m and of each family run, by (batch, M, K, N) and operand layout,
# on unit-normal operands with torch.backends.cuda.matmul's
# allow_bf16_reduced_precision_reduction as torch sets it and off: the share
# of output elements more than one bf16 ulp from the f32 product rounded once
# to bf16, the reference's single rounding (a bf16 jnp.dot accumulates in
# f32 and rounds once); in neither state may any be. Counted over the elements
# of at least BF16_PRODUCT_FLOOR of the output's rms: where a sum cancels to
# less, two f32 summation orders alone can part by more than a bf16 ulp of it
# (the f32 error grows with the terms, the ulp shrinks with the result)
BF16_PRODUCT_MODELS = ("smollm-135m",) + FAMILIES
BF16_PRODUCT_FLOOR = 1 / 16
# the new attention shapes the mesh phase's families case gives the kernels, checked in
# f32 (its dtype) against the plain versions before the paths, at seamless's
# 16 heads of 64 (G = 1): (name, B, Sq, Skv, q_offset) for flash, non-causal
# (the encoder's second "model" shard: its rows at offset FAM_FRAMES / 2
# against every frame's keys, the offset ignored; a decoder shard's
# cross-attention over the gathered memory), and (name, B, entries, start)
# for the decode kernel over the second memory tile, every row at the
# memory's last position FAM_FRAMES - 1
MESH_FAM_FLASH = (("seamless encoder shard", 1, FAM_FRAMES // 2, FAM_FRAMES, FAM_FRAMES // 2),
                  ("seamless cross shard", 1, MESH_FAM_TOKENS_HALF, FAM_FRAMES, 0))
MESH_FAM_DECODE = ("seamless memory tile", 2, FAM_FRAMES // 2, FAM_FRAMES // 2)
MESH_FAM_HEADS = (16, 16, 64)


# what the backward kernels' plain_ms and library_ms in the kernels line time
BWD_SCOPE = ("ms and bound_ms: this kernel; plain_ms (flash_attention_bwd_plain) and library_ms "
             "(SDPA's backward alone): the whole backward, dq and dkdv together")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time on the card for the work (ms) and what sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls from the host
    (CUDA events, after ``warmup`` calls). For a call of well under a
    millisecond this is the host's rate of issuing it, not device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. The host issues
    one graph per replay, so a short call is timed by the card (its kernels
    plus the graph's gaps between them), not by the host's launch rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def host_probe(torch) -> dict:
    """What the host gives this run: its CPU model and cores, and the wall
    time per call of 2000 in-place adds to one CUDA float (the host's launch
    rate, with no device work to speak of). Runs on different hosts are
    told apart by these numbers."""
    model = platform.machine()  # x86 names its model; Arm cores give a part number
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():
        for line in cpuinfo.read_text().splitlines():
            if line.startswith(("model name", "CPU part")):
                model += " " + line.split(":", 1)[1].strip()
                break
    x = torch.zeros(1, device="cuda")
    for _ in range(200):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    torch.cuda.synchronize()
    launch_us = (time.perf_counter() - t0) / 2000 * 1e6
    t0 = time.perf_counter()
    sum(range(1_000_000))
    python_ms = (time.perf_counter() - t0) * 1e3
    return {"cpu": model, "cpus": os.cpu_count(), "launch_us": launch_us,
            "python_sum_1e6_ms": python_ms}


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def assign_inputs(torch, n: int, d: int, k: int, dtype, clustered: bool, gen):
    """Points (n, d) and centroids (k, d) on the card: standard normals, or
    the cluster source's data (centres in [-10, 10]^d, spread 0.5) with
    standard-normal centroids."""
    dev = torch.device("cuda", 0)
    if clustered:
        centers = torch.rand((k, d), generator=gen, device=dev) * 20 - 10
        idx = torch.randint(0, k, (n,), generator=gen, device=dev)
        points = centers[idx] + 0.5 * torch.randn((n, d), generator=gen, device=dev)
    else:
        points = torch.randn((n, d), generator=gen, device=dev)
    centroids = torch.randn((k, d), generator=gen, device=dev)
    return points.to(dtype).contiguous(), centroids.to(dtype).contiguous()


def assign_close(torch, kmeans, name: str, points, centroids, labels, dist) -> dict:
    """Hold (labels, dist) of ``points`` x ``centroids`` against the plain
    version; raises where they differ by more than f32 rounding allows."""
    n, d = points.shape
    k = centroids.shape[0]
    ref_labels, ref_dist = kmeans.assign_ref(points, centroids)
    torch.cuda.synchronize()
    # rounding of |p|^2 - 2 p.c + |c|^2 in f32, summed over D terms in two
    # orders: 8 (D + 2) eps_f32 (|p| + max|c|)^2 per point
    p, c = points.float(), centroids.float()
    scale = (p.norm(dim=1) + c.norm(dim=1).max()) ** 2
    tol = 8 * (d + 2) * 2.0 ** -24 * scale
    err = (dist - ref_dist).abs()
    if not bool(torch.isfinite(dist).all()) or bool((err > tol).any()):
        raise AssertionError(f"{name} {n}x{d}x{k} {points.dtype}: max err "
                             f"{float(err.max())}, worst err/tol {float((err / tol).max())}")
    # labels must agree wherever the best and second-best d^2 differ by
    # more than twice the tolerance
    d2 = (p * p).sum(1, keepdim=True) - 2 * p @ c.T + (c * c).sum(1)
    two = d2.topk(2, dim=1, largest=False).values if k > 1 else None
    clear = (two[:, 1] - two[:, 0] > 2 * tol) if two is not None else torch.ones_like(tol, dtype=torch.bool)
    bad = int(((labels != ref_labels) & clear).sum())
    if bad:
        raise AssertionError(f"{name} {n}x{d}x{k}: {bad} labels differ where the gap is clear")
    return {"max_abs_err": float(err.max()), "tol": "8 (D+2) 2^-24 (|p| + max|c|)^2 per point",
            "worst_err_over_tol": float((err / tol).max()),
            "labels_differing_in_near_ties": int((labels != ref_labels).sum())}


def check_assign(torch, kmeans, n: int, d: int, k: int, dtype, clustered: bool,
                 gen, timing: bool, floor_ms: float) -> dict:
    """The ``repro_torch::kmeans_assign`` op on CUDA tensors (the kernel, in
    the regime ``assign_plan`` chooses for the shape), held to
    :func:`assign_close`; timed, with its bound (wide f32: also the
    bound of the 3 TF32 products its design issues) and ``floor_ms``, the
    least kernel's device time, beside it."""
    op = torch.ops.repro_torch.kmeans_assign
    points, centroids = assign_inputs(torch, n, d, k, dtype, clustered, gen)
    labels, dist = op(points, centroids)
    plan = kmeans.assign_plan(d, k, dtype)
    out = {"regime": plan.regime, "launch_floor_ms": floor_ms,
           **assign_close(torch, kmeans, "kmeans_assign", points, centroids, labels, dist)}
    if timing:
        elem = points.element_size()
        n_bytes = n * d * elem + k * d * elem + n * 8
        n_ops = kmeans.assign_flops(n, d, k)
        out["bound_ms"], out["bound_by"] = bound(
            n_bytes, n_ops, BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S)
        if plan.regime == "wide" and dtype == torch.float32:
            out["tf32x3_bound_ms"], out["tf32x3_bound_by"] = bound(
                n_bytes, 3 * 2 * n * k * d, TF32_OPS_PER_S)
        out["ms"] = graph_ms(torch, lambda: op(points, centroids), 50)
        out["plain_ms"] = graph_ms(torch, lambda: kmeans.assign_ref(points, centroids), 20)
        out["library_ms"] = graph_ms(torch, lambda: torch.cdist(points, centroids).min(1), 20)
        out["call_ms"] = time_ms(torch, lambda: op(points, centroids), 50, 5)
    return out


def update_close(torch, name: str, run, points, labels, k: int, mask=None) -> dict:
    """``run()``, an update of ``points`` over ``labels`` (``mask``: rows of
    weight 0), against a float64 sum of the same (weighted) rows: every
    entry of its sums within 2^-20 of the sum of |x| over its rows, its
    counts exact, and bitwise the same over repeated calls and graph
    replays."""
    n, d = points.shape
    sums, counts = run()
    w = (torch.ones(n, dtype=torch.float64, device=points.device) if mask is None
         else mask.double())
    idx = torch.where(w > 0, labels.long(), 0)
    x = points.double() * w[:, None]
    ref = torch.zeros((k, d), dtype=torch.float64, device=points.device).index_add_(0, idx, x)
    mag = torch.zeros_like(ref).index_add_(0, idx, x.abs())
    ref_counts = torch.zeros(k, dtype=torch.float64, device=points.device).index_add_(0, idx, w)
    torch.cuda.synchronize()
    err = (sums.double() - ref).abs()
    tol = 2.0 ** -20 * mag
    if not bool(torch.isfinite(sums).all()) or bool((err > tol).any()):
        raise AssertionError(f"{name}: max err {float(err.max())}, worst err/tol "
                             f"{float((err / tol.clamp_min(1e-300)).max())}")
    if not torch.equal(counts.double(), ref_counts):
        raise AssertionError(f"{name}: counts differ from the rows' count")

    def joined():
        s, c = run()
        return torch.cat([s.flatten(), c])

    _bitwise_repeatable(torch, name, joined, torch.cat([sums.flatten(), counts]))
    return {"max_abs_err": float(err.max()), "tol_rule": "per entry 2^-20 sum|x| (float64 sum)",
            "worst_err_over_tol": float((err / tol.clamp_min(1e-300)).max()),
            "counts_exact": True, "bitwise_repeatable": True}


def update_phase_ms(torch, kmeans, points, labels, k: int) -> dict:
    """Device time of each launch of ``kmeans_update`` in the regime
    ``update_plan`` chooses: the call stopped after its first i launches
    (``stop_after=i``), each timed by ``graph_ms``, less the call stopped
    one launch before."""
    plan = kmeans.update_plan(points.shape[1], k, points.dtype)
    out, before = {}, 0.0
    for i, name in enumerate(kmeans.UPDATE_LAUNCHES[plan.regime], 1):
        ms = graph_ms(torch, lambda i=i: kmeans.update_launch(points, labels, k, plan=plan,
                                                              stop_after=i), 20)
        out[name], before = ms - before, ms
    return out


def check_update(torch, kmeans, n: int, d: int, k: int, gen, floor_ms: float) -> dict:
    """The ``repro_torch::kmeans_update`` op on CUDA tensors (the kernel) on
    N x D points with labels from ``kmeans_assign`` on clustered points
    (the cluster source's data), held to :func:`update_close` and timed,
    with its regime, its launches' times, ``floor_ms`` (the least kernel's
    time), its bound, the plain version (``index_add_`` twice) and one
    ``index_add_`` of the sums; also masked (70 % of the rows weigh 1) and
    with every row on one label (timed)."""
    op = torch.ops.repro_torch.kmeans_update
    points, centroids = assign_inputs(torch, n, d, k, torch.float32, True, gen)
    labels, _ = torch.ops.repro_torch.kmeans_assign(points, centroids)
    out = {"regime": kmeans.update_plan(d, k, points.dtype).regime, "launch_floor_ms": floor_ms,
           **update_close(torch, "kmeans_update", lambda: op(points, labels, k, None),
                          points, labels, k)}
    out["labels_used"] = int((torch.bincount(labels.long(), minlength=k) > 0).sum())
    out["bound_ms"], out["bound_by"] = bound(n * d * 4 + n * 4 + k * d * 4 + k * 4,
                                           kmeans.update_flops(n, d))
    out["ms"] = graph_ms(torch, lambda: op(points, labels, k, None), 20)
    out["phase_ms"] = update_phase_ms(torch, kmeans, points, labels, k)
    out["plain_ms"] = graph_ms(torch, lambda: kmeans.update_scatter_ref(points, labels, k), 20)
    idx = labels.long()
    zeros = torch.zeros((k, d), device=points.device)
    out["library_ms"] = graph_ms(torch, lambda: zeros.index_add_(0, idx, points), 20)
    out["call_ms"] = time_ms(torch, lambda: op(points, labels, k, None), 50, 5)
    mask = torch.rand(n, generator=gen, device=points.device) < 0.7
    out["masked"] = update_close(torch, "kmeans_update masked",
                                 lambda: op(points, labels, k, mask),
                                 points, labels, k, mask)
    one = torch.full_like(labels, k // 2)
    out["one_label"] = update_close(torch, "kmeans_update one label",
                                    lambda: op(points, one, k, None), points, one, k)
    out["one_label_ms"] = graph_ms(torch, lambda: op(points, one, k, None), 20)
    return out


def check_tomo(torch, tomo, gen) -> tuple[dict, dict]:
    """Both projector ops (``repro_torch::tomo_backproject``,
    ``tomo_project``) on CUDA tensors, the kernels, at the light-source
    path's shapes: 8 frames, 360 angles, 1448 bins, n = 1448."""
    dev = torch.device("cuda", 0)
    b, a, n_det, n = 8, FRAME_ANGLES, FRAME_BINS, RECON_N
    angles = torch.from_numpy(tomo.angle_grid(a)).to(dev)
    cos_t, sin_t = tomo.trig(angles)
    sinos = torch.rand((b, a, n_det), generator=gen, device=dev)
    imgs = torch.rand((b, n, n), generator=gen, device=dev)

    bp = torch.ops.repro_torch.tomo_backproject(sinos, cos_t, sin_t, n)
    bp_ref = tomo.backproject_plain(sinos, cos_t, sin_t, n)
    fp = torch.ops.repro_torch.tomo_project(imgs, cos_t, sin_t, n_det)
    fp_ref = tomo.project_plain(imgs, cos_t, sin_t, n_det)
    torch.cuda.synchronize()
    results = []
    # inputs are non-negative, so max|ref| bounds the sum of |terms|; a sum
    # of m f32 terms in two orders differs by at most ~m eps_f32 of it
    for name, out, ref, terms in (("tomo_backproject", bp, bp_ref, a),
                                  ("tomo_project", fp, fp_ref, 4 * n)):
        err = float((out - ref).abs().max())
        tol = terms * F32_EPS * float(ref.abs().max())
        if not bool(torch.isfinite(out).all()) or err > tol:
            raise AssertionError(f"{name}: max err {err} > tol {tol}")
        results.append({"max_abs_err": err, "tol": tol,
                        "tol_rule": f"{terms} eps_f32 max|ref| (sum of {terms} terms)"})

    # adjointness on the card: <P x, y> = <x, B y>
    lhs = float((fp.double() * sinos.double()).sum())
    rhs = float((imgs.double() * bp.double()).sum())
    rel = abs(lhs - rhs) / abs(lhs)
    if rel > 1e-4:
        raise AssertionError(f"projectors not adjoint: <Px,y>={lhs} <x,By>={rhs} rel {rel}")
    results[0]["adjoint_rel_err"] = results[1]["adjoint_rel_err"] = rel

    # one interpolation per (frame, pixel, angle): 4 f32 operations, and 6
    # per (pixel, angle) for s, floor(s) and the two weights
    n_ops = tomo.projector_flops(b, a, n)
    trig_bytes = 2 * a * 4
    bp_bytes = b * a * n_det * 4 + trig_bytes + b * n * n * 4
    fp_bytes = b * n * n * 4 + trig_bytes + b * a * n_det * 4
    ops = torch.ops.repro_torch
    for res, bytes_, kern, plain, x, size in (
            (results[0], bp_bytes, ops.tomo_backproject, tomo.backproject_plain, sinos, n),
            (results[1], fp_bytes, ops.tomo_project, tomo.project_plain, imgs, n_det)):
        res["bound_ms"], res["bound_by"] = bound(bytes_, n_ops)
        res["ms"] = time_ms(torch, lambda: kern(x, cos_t, sin_t, size), 5, 1)
        res["plain_ms"] = time_ms(torch, lambda: plain(x, cos_t, sin_t, size), 2, 1)
        res["library_ms"] = None  # no single PyTorch call computes a projector
    return results[0], results[1]


def check_project_sparse(torch, tomo, gen) -> dict:
    """``tomo_project`` at the path's shapes on images that are zero but
    for unit pixels: 64 seeded ones per frame, the four corners, the centre,
    and pixels beside both diagonals and beside the image edges, which at
    the angles around 45 and 135 degrees (where the walk switches between
    rows and columns) lie at the ends of a line's candidate window. Each
    bin then sums a few terms, so a window that drops a pixel shows as an
    error of that pixel's weight: the tolerance, (lit pixels) eps_f32
    max|ref| per element, is what two orders of such a sum allow."""
    dev = torch.device("cuda", 0)
    b, a, n_det, n = 8, FRAME_ANGLES, FRAME_BINS, RECON_N
    cos_t, sin_t = tomo.trig(torch.from_numpy(tomo.angle_grid(a)).to(dev))
    imgs = torch.zeros((b, n, n), device=dev)
    i = torch.arange(1, n - 1, 97, device=dev)
    one, inner = torch.ones_like(i), torch.full_like(i, n - 2)
    # corners, centre; beside the diagonal, the anti-diagonal and the edges
    rows = [torch.tensor([0, 0, n - 1, n - 1, n // 2], device=dev), i, i, i, i, i, i, one, inner]
    cols = [torch.tensor([0, n - 1, 0, n - 1, n // 2], device=dev),
            i - 1, i + 1, n - 2 - i, n - i, one, inner, i, i]
    imgs[:, torch.cat(rows), torch.cat(cols)] = 1.0
    for f in range(b):
        lit = torch.randint(0, n * n, (64,), generator=gen, device=dev)
        imgs[f].view(-1)[lit] = 1.0
    lit = int((imgs > 0).flatten(1).sum(1).max())
    out = torch.ops.repro_torch.tomo_project(imgs, cos_t, sin_t, n_det)
    ref = tomo.project_plain(imgs, cos_t, sin_t, n_det)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    tol = lit * F32_EPS * float(ref.abs().max())
    if not bool(torch.isfinite(out).all()) or float(err.max()) > tol:
        raise AssertionError(f"tomo_project sparse images: max err {float(err.max())} > tol {tol}")
    return {"lit_pixels_per_frame": lit, "max_abs_err": float(err.max()), "tol": tol,
            "tol_rule": "lit eps_f32 max|ref| per element",
            "nonzero_bins": int((ref != 0).sum())}


def check_backproject_sparse(torch, tomo, gen) -> dict:
    """``tomo_backproject`` at the path's shapes on sinograms that are zero
    but for unit bins: 0, 1, the centre, n_det - 2, n_det - 1 and 8 seeded
    bins per row. A pixel then sums a few non-zero terms of non-negative
    weight, so the tolerance is per element, 2 A eps_f32 |ref| (a sum of up
    to 2 A such terms in two orders), and zero where the plain version is
    zero: a bin dropped from a tile's window, or staged at the wrong offset
    or frame, shows as an error of its weight."""
    dev = torch.device("cuda", 0)
    b, a, n_det, n = 8, FRAME_ANGLES, FRAME_BINS, RECON_N
    cos_t, sin_t = tomo.trig(torch.from_numpy(tomo.angle_grid(a)).to(dev))
    sinos = torch.zeros((b, a, n_det), device=dev)
    sinos[..., [0, 1, n_det // 2, n_det - 2, n_det - 1]] = 1.0
    sinos.scatter_(2, torch.randint(0, n_det, (b, a, 8), generator=gen, device=dev), 1.0)
    out = torch.ops.repro_torch.tomo_backproject(sinos, cos_t, sin_t, n)
    ref = tomo.backproject_plain(sinos, cos_t, sin_t, n)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    tol = 2 * a * F32_EPS * ref.abs()
    if not bool(torch.isfinite(out).all()) or bool((err > tol).any()):
        raise AssertionError(f"tomo_backproject sparse sinograms: max err {float(err.max())}, "
                             f"{int((err > tol).sum())} pixels over 2 A eps_f32 |ref|")
    return {"lit_bins_per_row": int((sinos > 0).sum(-1).max()), "max_abs_err": float(err.max()),
            "worst_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
            "tol_rule": "per element 2 A eps_f32 |ref|", "nonzero_pixels": int((ref != 0).sum())}


def check_quality(torch, tomo) -> dict:
    """The repo's own reconstruction check, on the card and through the
    kernels: on a small phantom ML-EM beats GridRec and stays within half
    the image's RMS."""
    dev = torch.device("cuda", 0)
    n, a = 48, 60
    img = tomo.shepp_logan(n).to(dev)
    angles = torch.from_numpy(tomo.angle_grid(a)).to(dev)
    sino = tomo.project(img, angles, n + 16)
    e_grid = float(((tomo.gridrec(sino, angles, n) - img) ** 2).mean().sqrt())
    e_mlem = float(((tomo.mlem(sino, angles, n, iters=16) - img) ** 2).mean().sqrt())
    rms = float((img ** 2).mean().sqrt())
    if not (e_mlem < e_grid and e_mlem < 0.5 * rms):
        raise AssertionError(f"quality ordering broken: mlem {e_mlem}, gridrec {e_grid}, rms {rms}")
    return {"rmse_gridrec": e_grid, "rmse_mlem": e_mlem, "rms_image": rms}


def _bf16_tol(torch, ref, v):
    """Per-element tolerance of a bf16 attention output: kernel and plain
    version both compute in f32 and round once to bf16, so they differ by
    one bf16 step of that element, 2^-7 |ref|, plus the order of their f32
    sums, ATTN_SUM_REL max|v|."""
    return BF16_STEP * ref.float().abs() + ATTN_SUM_REL * float(v.float().abs().max())


def _bf16_close(torch, name: str, out, ref, v) -> dict:
    tol = _bf16_tol(torch, ref, v)
    err = (out.float() - ref.float()).abs()
    if out.shape != ref.shape or out.dtype != ref.dtype or not bool(out.isfinite().all()) \
            or bool((err > tol).any()):
        raise AssertionError(f"{name}: max err {float(err.max())}, worst err/tol "
                             f"{float((err / tol).max())} (shape {tuple(out.shape)})")
    return {"max_abs_err": float(err.max()), "worst_err_over_tol": float((err / tol).max()),
            "tol_rule": "per element 2^-7 |ref| + 2^-15 max|v|"}


def _off_by_one(torch, attn, name: str, out, q, k, v, rows, pos) -> dict:
    """The check must fail a mask off by one where it is hardest to see:
    on rows with at least LONG_ROW live keys. ``out`` (n, 1, H, hd) are
    kernel outputs for query rows ``q`` (n, 1, H, hd) over caches ``k``,
    ``v`` (n, S, KV, hd) at ``pos`` (n,); the plain decode version at
    ``pos`` must pass every row, at ``pos - 1`` (a key missing) and at
    ``pos + 1`` (one too many) it must fail every row."""
    def worst_per_row(p):
        ref = attn.decode_attention_plain(q, k, v, p)
        return ((out.float() - ref.float()).abs() / _bf16_tol(torch, ref, v)).flatten(1).amax(1)

    right = worst_per_row(pos)
    wrong = torch.minimum(worst_per_row(pos - 1), worst_per_row(pos + 1))
    if bool((right > 1).any()) or bool((wrong <= 1).any()):
        raise AssertionError(f"{name}: the mask check is blind on rows {rows.tolist()}: "
                             f"right {right.tolist()}, off by one {wrong.tolist()}")
    return {"long_rows": len(rows), "worst_right_over_tol": float(right.max()),
            "least_off_by_one_over_tol": float(wrong.min())}


def launch_floor_ms(torch) -> float:
    """Device time of the least kernel: a one-element in-place add, timed
    as ``graph_ms`` times the short kernels. A kernel's time cannot fall
    below it, however small its bound."""
    x = torch.zeros(1, device="cuda")
    return graph_ms(torch, lambda: x.add_(1), 100)


def _bitwise_repeatable(torch, name: str, fn, out) -> None:
    """``fn()`` called again, then captured in a CUDA graph that is replayed
    three times: every result bitwise equal to ``out``."""
    again = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(captured.clone())
    torch.cuda.synchronize()
    if not all(torch.equal(out, r) for r in (again, *replays)):
        raise AssertionError(f"{name}: repeated calls or graph replays differ bitwise")


def decode_inputs(torch, b: int, s: int, heads: tuple = SERVE_HEADS):
    """q, k, v (bf16, in the (query heads, KV heads, head dim) layout
    ``heads``: the serving path's by default) and positions of a timed
    decode case, from a generator of their own (seeded SEED + b), so
    that no other check's draws shift them: the first rows at the last
    entry, 0, 15, 16, 127 and 128, the rest scattered. They do not follow
    any kernel's own tiling, so a kernel retuned later is timed on the same
    work."""
    H, KV, hd = heads
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + b)
    q = torch.randn((b, 1, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, KV, hd), generator=gen, device=dev).bfloat16()
    pos = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
    edges = torch.tensor([s - 1, 0, 15, 16, 127, 128], dtype=torch.int32, device=dev)[:b]
    pos[: len(edges)] = edges
    return q, k, v, pos


def check_decode_split(torch, attn, b: int, s: int, gen, heads: tuple = SERVE_HEADS) -> dict:
    """``decode_attention`` (untimed) with rows at the edges of the chunks
    the split kernel takes at these sizes (C - 1, 2 C, C, C + 1 for its
    chunk C), the last entry, 0 and past the cache, the rest scattered:
    held to the per-element rule, a mask off by one must fail the check on
    the rows with LONG_ROW or more keys, and two more calls and three
    replays of a captured call must give bitwise the same output."""
    H, KV, hd = heads
    dev = torch.device("cuda", 0)
    q = torch.randn((b, 1, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, KV, hd), generator=gen, device=dev).bfloat16()
    pos = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
    chunk = attn.decode_chunk(attn.DECODE_LIB, dev, b, s, H, KV, hd, 1)
    edges = [min(p, s + 3) for p in (chunk - 1, 2 * chunk, chunk, chunk + 1, s - 1, 0, s + 3)]
    pos[: min(b, len(edges))] = torch.tensor(edges, dtype=torch.int32, device=dev)[:b]
    out = attn.decode_attention_cuda(q, k, v, pos)
    name = f"decode_attention split edges B={b} S={s} hd={hd}"
    res = _bf16_close(torch, name, out, attn.decode_attention_plain(q, k, v, pos), v)
    rows = torch.nonzero((pos >= LONG_ROW) & (pos <= s - 2)).flatten()
    if len(rows):
        res["off_by_one"] = _off_by_one(torch, attn, name, out[rows], q[rows], k[rows], v[rows],
                                        rows, pos[rows])
    _bitwise_repeatable(torch, name, lambda: attn.decode_attention_cuda(q, k, v, pos), out)
    return {"chunk": chunk, "positions": pos[: len(edges)].tolist(), "bitwise_repeatable": True,
            **res}


def check_decode(torch, attn, b: int, s: int, heads: tuple = SERVE_HEADS) -> dict:
    """``decode_attention`` on :func:`decode_inputs`, timed; where rows hold
    LONG_ROW or more keys, a mask off by one must fail the check."""
    H, KV, hd = heads
    dev = torch.device("cuda", 0)
    q, k, v, pos = decode_inputs(torch, b, s, heads)
    out = attn.decode_attention_cuda(q, k, v, pos)
    name = f"decode_attention B={b} S={s} hd={hd}"
    res = _bf16_close(torch, name, out, attn.decode_attention_plain(q, k, v, pos), v)
    rows = torch.nonzero((pos >= LONG_ROW) & (pos <= s - 2)).flatten()
    if len(rows):
        res["off_by_one"] = _off_by_one(torch, attn, name, out[rows], q[rows], k[rows], v[rows],
                                        rows, pos[rows])
    res["chunk"] = attn.decode_chunk(attn.DECODE_LIB, dev, b, s, H, KV, hd, 1)
    live = int(torch.clamp(pos + 1, max=s).sum())  # cache entries the rows attend to
    n_bytes = 2 * live * KV * hd * 2 + 2 * q.numel() * 2 + b * 4
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * live * H * hd, BF16_OPS_PER_S)
    res["ms"] = graph_ms(torch, lambda: attn.decode_attention_cuda(q, k, v, pos), 100)
    res["plain_ms"] = graph_ms(torch, lambda: attn.decode_attention_plain(q, k, v, pos), 20)
    # SDPA with a boolean mask: K/V repeated to the query heads and
    # everything put in (B, heads, S, hd) outside the timed call
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous() for x in (k, v))
    mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_ms"] = graph_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask), 100)
    res["call_ms"] = time_ms(torch, lambda: attn.decode_attention_cuda(q, k, v, pos), 200, 10)
    return res


def check_flash(torch, attn, b: int, s: int, gen, timing: bool,
                heads: tuple = SERVE_HEADS, skv: int | None = None, causal: bool = True) -> dict:
    """``flash_attention`` over ``s`` query rows and ``skv`` keys (``s`` by
    default), causal by default (then Sq = Skv), in the head layout
    ``heads`` (the serving path's by default), bf16, held per element to
    the plain version. The same rule must fail the plain version with the
    causal flag flipped (by more than 10x the tolerance somewhere) and a mask
    off by one: in a causal prefill query row i is a decode over keys
    0..i, so a sample of rows with LONG_ROW or more keys goes through the
    off-by-one check against the plain decode version; in a non-causal one
    the plain version over the keys less the last one must fail. ``timing``:
    the kernel, the plain version and SDPA from ``graph_ms``, and the bound."""
    H, KV, hd = heads
    skv = skv or s
    if causal and skv != s:
        raise ValueError("a causal check takes Sq = Skv")
    dev = torch.device("cuda", 0)
    q = torch.randn((b, s, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, skv, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, skv, KV, hd), generator=gen, device=dev).bfloat16()
    out = attn.flash_attention_cuda(q, k, v, causal=causal)
    name = (f"flash_attention B={b} Sq={s} Skv={skv} {H}/{KV} hd={hd} "
            f"{'causal' if causal else 'non-causal'}")
    res = _bf16_close(torch, name, out, attn.flash_attention_plain(q, k, v, causal=causal), v)

    def worst(ref):
        return float(((out.float() - ref.float()).abs() / _bf16_tol(torch, ref, v)).max())

    res["flipped_flag_over_tol"] = worst(attn.flash_attention_plain(q, k, v, causal=not causal))
    if res["flipped_flag_over_tol"] <= 10:
        raise AssertionError(f"{name}: the check is blind to the causal flag flipped "
                             f"({res['flipped_flag_over_tol']} of the tolerance)")
    if causal:
        rows = torch.arange(LONG_ROW, s - 1, 8, device=dev)  # query rows i, keys 0..i
        n = len(rows)

        def expand(x):  # (b, s, KV, hd) -> one cache per sampled row, (b * n, s, KV, hd)
            return x[:, None].expand(b, n, *x.shape[1:]).reshape(b * n, *x.shape[1:])

        res["off_by_one"] = _off_by_one(
            torch, attn, name, out[:, rows].reshape(b * n, 1, H, hd),
            q[:, rows].reshape(b * n, 1, H, hd), expand(k), expand(v),
            rows.repeat(b), rows.repeat(b).to(torch.int32))
    else:
        short = worst(attn.flash_attention_plain(q, k[:, :-1].contiguous(),
                                                 v[:, :-1].contiguous(), causal=False))
        if short <= 1:
            raise AssertionError(f"{name}: the check is blind to the last key dropped ({short})")
        res["last_key_dropped_over_tol"] = short
    if timing:
        pairs = s * (s + 1) // 2 if causal else s * skv  # (query, key) pairs per head
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * b * H * hd * pairs, BF16_OPS_PER_S)
        res["ms"] = graph_ms(torch, lambda: attn.flash_attention_cuda(q, k, v, causal=causal), 50)
        res["plain_ms"] = graph_ms(
            torch, lambda: attn.flash_attention_plain(q, k, v, causal=causal), 10)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
                  for x in (k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = graph_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal), 50)
        res["call_ms"] = time_ms(torch, lambda: attn.flash_attention_cuda(q, k, v, causal=causal),
                                 100, 5)
    return res


def _grad_tol(torch, ref):
    """Per-element tolerance of a bf16 gradient: kernel and plain version
    recompute S and P in f32 from the same operands and round each output
    once, so one bf16 step of the element, 2^-7 |ref|, plus the order of
    their f32 sums over up to G x S pairs, ATTN_SUM_REL of the largest
    |ref|."""
    return BF16_STEP * ref.float().abs() + ATTN_SUM_REL * float(ref.float().abs().max())


def _grads_worst(torch, got, ref) -> dict:
    return {n: float(((g.float() - r.float()).abs() / _grad_tol(torch, r)).max())
            for n, g, r in zip(("dq", "dk", "dv"), got, ref)}


def sdpa_bwd_ms(torch, q, k, v, dout, reps: int, replays: int = 5, causal: bool = True) -> float:
    """Device time of SDPA's backward alone (``is_causal``; ``enable_gqa``
    where K/V have fewer heads) on q, k, v (B, H, S, hd) that require grad:
    the forward runs once, then ``reps`` backwards of it (``retain_graph``)
    are captured in one CUDA graph and replayed ``replays`` times between
    CUDA events, as in ``graph_ms``. The forward runs on the capture stream,
    since autograd runs each backward op on its forward op's stream."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = q.shape[1] != k.shape[1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o = sdpa(q, k, v, is_causal=causal, enable_gqa=gqa)

        def backward():
            torch.autograd.grad(o, (q, k, v), dout, retain_graph=True)

        backward()  # warm-up outside the capture
        backward()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            backward()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _mask_faults(torch, attn, q, k, v, out, lse, dout, causal: bool) -> dict:
    """The plain backward under planted mask faults, gradients shaped as the
    kernels'. Causal (Sq = Skv): every query row one position later (a zero
    row in front: row i sees keys 0..i+1) and one earlier (row 0 dropped:
    row i sees 0..i-1), on the kernel's own output and log-sum-exp.
    Non-causal: the last key dropped, and a zero key added (a key past Skv
    counted as live, as a zero-filled tile row would be), each through the
    plain forward with its log-sum-exp as well: with the true ones a zero
    key moves no gradient of the live keys (its dS meets a zero K row)."""
    z = lambda x: torch.zeros_like(x[:, :1])  # noqa: E731  (one query row or key)
    plain = attn.flash_attention_bwd_plain
    if causal:
        zl = torch.zeros_like(lse[..., :1])
        plus = plain(torch.cat([z(q), q], 1), k, v, torch.cat([z(out), out], 1),
                     torch.cat([zl, lse], -1), torch.cat([z(dout), dout], 1), causal=True)
        minus = plain(q[:, 1:], k, v, out[:, 1:], lse[..., 1:], dout[:, 1:], causal=True)
        return {"plus_one": (plus[0][:, 1:], plus[1], plus[2]),
                "minus_one": (torch.cat([z(q), minus[0]], 1), minus[1], minus[2])}

    def through(k2, v2):
        o2, l2 = attn.flash_attention_plain_lse(q, k2, v2, causal=False)
        return plain(q, k2, v2, o2, l2, dout, causal=False)

    drop = through(k[:, :-1].contiguous(), v[:, :-1].contiguous())
    extra = through(torch.cat([k, z(k)], 1), torch.cat([v, z(v)], 1))
    skv = k.shape[1]
    return {"last_key_dropped": (drop[0], torch.cat([drop[1], z(k)], 1),
                                 torch.cat([drop[2], z(v)], 1)),
            "zero_key_added": (extra[0], extra[1][:, :skv], extra[2][:, :skv])}


def check_flash_bwd(torch, attn, b: int, s: int, gen, heads: tuple = SERVE_HEADS,
                    skv: int | None = None, causal: bool = True) -> dict:
    """The training attention over ``s`` query rows and ``skv`` keys (``s``
    by default), causal by default (then Sq = Skv), in the head layout
    ``heads`` (the training path's by default), bf16:
    ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkdv`` against
    ``flash_attention_bwd_plain`` per element, on the LSE-writing forward's
    output and log-sum-exp, and a second launch of the pair bitwise equal to
    the first; every planted mask fault of ``_mask_faults`` must fail the
    rule in each of dq, dk and dv. Times: each kernel alone, the LSE-writing
    forward, the plain backward and SDPA (``is_causal`` as the case,
    ``enable_gqa`` where G > 1), the PyTorch call that computes the same
    gradients, its backward alone and with its forward, all from replayed
    CUDA graphs. The LSE-writing forward's output is held to the plain
    version per element too. Bounds: the bytes each kernel must move, and
    6 hd flop per (query, key) pair for (a) (S, dP, dQ), 8 hd for (b) (S,
    dP, dV, dK), 10 hd for the pair, at the bf16 rate; the pairs are Sq (Sq
    + 1) / 2 a head when causal, Sq Skv when not."""
    H, KV, hd = heads
    skv = skv or s
    if causal and skv != s:
        raise ValueError("a causal check takes Sq = Skv")
    dev = torch.device("cuda", 0)
    q = torch.randn((b, s, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, skv, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, skv, KV, hd), generator=gen, device=dev).bfloat16()
    dout = torch.randn((b, s, H, hd), generator=gen, device=dev).bfloat16()
    lse = torch.empty((b, H, s), dtype=torch.float32, device=dev)
    out = attn.flash_attention_cuda(q, k, v, causal=causal, lse=lse)
    plain_out, plain_lse = attn.flash_attention_plain_lse(q, k, v, causal=causal)
    shape = (f"B={b} S={s} hd={hd}" if skv == s else f"B={b} Sq={s} Skv={skv} hd={hd}") + (
        "" if causal else " non-causal")
    name = f"flash_attention_bwd {shape}"
    fwd = _bf16_close(torch, f"flash_attention with lse {shape}", out, plain_out, v)
    lse_err = float((lse - plain_lse).abs().max())
    if lse_err > 1e-5:
        raise AssertionError(f"flash_attention lse {shape}: max err {lse_err} > 1e-5")
    got = attn.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal)
    again = attn.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{name}: a second launch differs bitwise")
    ref = attn.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal)
    right = _grads_worst(torch, got, ref)
    if any(w > 1 for w in right.values()) or not all(bool(g.isfinite().all()) for g in got):
        raise AssertionError(f"{name}: worst err/tol {right}")
    wrong = {m: _grads_worst(torch, got, f)
             for m, f in _mask_faults(torch, attn, q, k, v, out, lse, dout, causal).items()}
    blind = [f"{m} {n}" for m, w in wrong.items() for n, x in w.items() if x <= 1]
    if blind:
        raise AssertionError(f"{name}: a planted mask fault passes {blind}")
    res = {"max_abs_err": max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref)),
           "worst_err_over_tol": right, "mask_faults_least_over_tol": {
               m: min(w.values()) for m, w in wrong.items()},
           "fwd_out_max_abs_err": fwd["max_abs_err"],
           "fwd_out_worst_err_over_tol": fwd["worst_err_over_tol"], "lse_max_abs_err": lse_err,
           "bitwise_repeatable": True,
           "tol_rule": "per element 2^-7 |ref| + 2^-15 max|ref|; forward out 2^-7 |ref| + "
                       "2^-15 max|v|; lse 1e-5"}
    # (query, key) pairs over every head
    pairs = b * H * (s * (s + 1) // 2 if causal else s * skv)
    el = q.element_size()
    n_q, n_kv = q.numel(), k.numel()
    rows = b * H * s * 4  # one f32 per row (lse, delta)
    res["dq_bound_ms"], res["dq_bound_by"] = bound(
        (4 * n_q + 2 * n_kv) * el + 2 * rows, 6 * hd * pairs, BF16_OPS_PER_S)
    res["dkdv_bound_ms"], res["dkdv_bound_by"] = bound(
        (2 * n_q + 4 * n_kv) * el + 2 * rows, 8 * hd * pairs, BF16_OPS_PER_S)
    res["bwd_bound_ms"], res["bwd_bound_by"] = bound(
        (5 * n_q + 4 * n_kv) * el + rows, 10 * hd * pairs, BF16_OPS_PER_S)
    delta = torch.empty((b, H, s), dtype=torch.float32, device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sizes = (b, s, skv, H, KV, hd, int(causal), 0, 1)  # q_offset 0, bf16

    def run_dq():
        attn.FLASH_BWD_DQ.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                 *sizes, torch.cuda.current_stream().cuda_stream)

    def run_dkdv():
        attn.FLASH_BWD_DKDV.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                   *sizes, torch.cuda.current_stream().cuda_stream)

    run_dq()
    torch.cuda.synchronize()
    reps = 20 if s <= 512 else 10
    res["dq_ms"] = graph_ms(torch, run_dq, reps)
    res["dkdv_ms"] = graph_ms(torch, run_dkdv, reps)
    res["fwd_lse_ms"] = graph_ms(
        torch, lambda: attn.flash_attention_cuda(q, k, v, causal=causal, lse=lse), reps)
    res["fwd_ms"] = graph_ms(torch, lambda: attn.flash_attention_cuda(q, k, v, causal=causal), reps)
    res["plain_ms"] = graph_ms(
        torch, lambda: attn.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal),
        reps if s <= 512 else 1)
    qt, kt, vt, dot = (x.transpose(1, 2).detach().requires_grad_(x is not dout)
                       for x in (q, k, v, dout))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = H != KV
    res["library_ms"] = sdpa_bwd_ms(torch, qt, kt, vt, dot, reps, causal=causal)
    res["library_pair_ms"] = graph_ms(torch, lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=causal, enable_gqa=gqa), (qt, kt, vt), dot), reps)
    res["library_fwd_ms"] = graph_ms(
        torch, lambda: sdpa(qt.detach(), kt.detach(), vt.detach(), is_causal=causal,
                            enable_gqa=gqa), reps)
    res["library"] = (f"scaled_dot_product_attention(is_causal={causal}, enable_gqa={gqa}): "
                      "library_ms its backward alone, against the pair dq + dkdv; "
                      "library_pair_ms forward + backward, against fwd_lse_ms + dq_ms + dkdv_ms")
    return res


def sdpa_masked_ms(torch, q, k, v, mask, dout, reps: int) -> tuple[float, float]:
    """SDPA with a boolean ``mask`` (Sq, Skv) on (B, H, S, hd) inputs, K/V
    repeated to H heads: (forward ms, backward-alone ms), each from a
    replayed CUDA graph (the backward as ``sdpa_bwd_ms`` takes it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = graph_ms(torch, lambda: sdpa(q.detach(), k.detach(), v.detach(), attn_mask=mask), reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o = sdpa(q, k, v, attn_mask=mask)

        def backward():
            torch.autograd.grad(o, (q, k, v), dout, retain_graph=True)

        backward()
        backward()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            backward()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return fwd, start.elapsed_time(end) / (reps * 5)


def check_flash_offset(torch, attn, b: int, sq: int, skv: int, offset: int, heads: tuple,
                       gen) -> dict:
    """A sequence shard's causal attention, bf16: ``sq`` query rows at
    positions ``offset``.. against ``skv`` keys from position 0 (what
    ``runtime/sharded_attention.py`` runs). ``flash_attention`` with its
    log-sum-exp, and the backward pair on it, held per element to their
    plain versions at the same offset (the rules of ``check_flash`` and
    ``check_flash_bwd``); a second launch of each bitwise equal; the plain
    versions at ``offset + 1`` and, where it exists, ``offset - 1`` (a
    planted off-by-one) must fail the rule in the output and in each of dq,
    dk and dv. Times from replayed CUDA graphs: the forward, the pair, their
    plain versions, and SDPA with an equal boolean mask (forward, and
    backward alone); bounds as ``check_flash`` / ``check_flash_bwd`` count
    them, over this shard's (query, key) pairs, Sq offset + Sq (Sq + 1) / 2
    a head."""
    H, KV, hd = heads
    if offset + sq > skv:
        raise ValueError("a shard's rows lie inside the keys")
    dev = torch.device("cuda", 0)
    q = torch.randn((b, sq, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, skv, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, skv, KV, hd), generator=gen, device=dev).bfloat16()
    dout = torch.randn((b, sq, H, hd), generator=gen, device=dev).bfloat16()
    name = f"flash_attention q_offset={offset} B={b} Sq={sq} Skv={skv} {H}/{KV} hd={hd}"
    lse = torch.empty((b, H, sq), dtype=torch.float32, device=dev)
    out = attn.flash_attention_cuda(q, k, v, causal=True, q_offset=offset, lse=lse)
    plain_out, plain_lse = attn.flash_attention_plain_lse(q, k, v, causal=True, q_offset=offset)
    res = _bf16_close(torch, name, out, plain_out, v)
    res["lse_max_abs_err"] = float((lse - plain_lse).abs().max())
    if res["lse_max_abs_err"] > 1e-5:
        raise AssertionError(f"{name}: lse max err {res['lse_max_abs_err']} > 1e-5")
    _bitwise_repeatable(torch, name, lambda: attn.flash_attention_cuda(
        q, k, v, causal=True, q_offset=offset), out)
    got = attn.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=True, q_offset=offset)
    again = attn.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=True, q_offset=offset)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{name} backward: a second launch differs bitwise")
    ref = attn.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True, q_offset=offset)
    right = _grads_worst(torch, got, ref)
    if any(w > 1 for w in right.values()) or not all(bool(g.isfinite().all()) for g in got):
        raise AssertionError(f"{name} backward: worst err/tol {right}")
    res["bwd_max_abs_err"] = max(float((g.float() - r.float()).abs().max())
                                 for g, r in zip(got, ref))
    res["bwd_worst_err_over_tol"] = right
    planted = {}
    for wrong in (offset + 1, offset - 1):
        if wrong < 0:
            continue
        o2, l2 = attn.flash_attention_plain_lse(q, k, v, causal=True, q_offset=wrong)
        fwd = float(((out.float() - o2.float()).abs() / _bf16_tol(torch, o2, v)).max())
        bwd = _grads_worst(torch, got, attn.flash_attention_bwd_plain(
            q, k, v, o2, l2, dout, causal=True, q_offset=wrong))
        if fwd <= 1 or min(bwd.values()) <= 1:
            raise AssertionError(f"{name}: the rule is blind to q_offset {wrong} "
                                 f"(out {fwd}, grads {bwd})")
        planted[str(wrong)] = {"out": fwd, **bwd}
    res["planted_offset_least_over_tol"] = planted
    res["bitwise_repeatable"] = True
    pairs = b * H * (sq * offset + sq * (sq + 1) // 2)  # (query, key) pairs over every head
    el = q.element_size()
    n_q, n_kv, rows = q.numel(), k.numel(), b * H * sq * 4
    res["bound_ms"], res["bound_by"] = bound((2 * n_q + 2 * n_kv) * el, 4 * hd * pairs,
                                             BF16_OPS_PER_S)
    res["bwd_bound_ms"], res["bwd_bound_by"] = bound((5 * n_q + 4 * n_kv) * el + rows,
                                                     10 * hd * pairs, BF16_OPS_PER_S)
    reps = 20
    res["ms"] = graph_ms(torch, lambda: attn.flash_attention_cuda(
        q, k, v, causal=True, q_offset=offset), reps)
    res["bwd_ms"] = graph_ms(torch, lambda: attn.flash_attention_bwd_cuda(
        q, k, v, out, lse, dout, causal=True, q_offset=offset), reps)
    res["plain_ms"] = graph_ms(torch, lambda: attn.flash_attention_plain(
        q, k, v, causal=True, q_offset=offset), 5)
    res["bwd_plain_ms"] = graph_ms(torch, lambda: attn.flash_attention_bwd_plain(
        q, k, v, out, lse, dout, causal=True, q_offset=offset), 5)
    mask = (torch.arange(offset, offset + sq, device=dev)[:, None]
            >= torch.arange(skv, device=dev)[None, :])
    qt, kt, vt = (x.transpose(1, 2).repeat_interleave(H // x.shape[2], dim=1).contiguous()
                  .requires_grad_(True) for x in (q, k, v))
    res["library_ms"], res["library_bwd_ms"] = sdpa_masked_ms(
        torch, qt, kt, vt, mask, dout.transpose(1, 2).contiguous(), reps)
    res["library"] = ("scaled_dot_product_attention(attn_mask=bool (Sq, Skv) mask at the "
                      "offset), K/V repeated to every head; library_bwd_ms its backward alone")
    return res


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def drive(stream, source, n_batches: int, timeout: float) -> float:
    t0 = time.monotonic()
    stream.start()
    source.start()
    try:
        stream.await_batches(n_batches, timeout=timeout)
    finally:
        stream.stop()
        source.stop()
    return time.monotonic() - t0


def report(name: str, app, stream, wall: float) -> dict:
    lat = app.stats.latency
    out = {"path": name, "batches": stream.stats.batches, "messages": app.stats.messages,
           "wall_s": wall, "msgs_per_s": app.stats.messages / wall,
           "latency_p50_s": lat.p50, "latency_p99_s": lat.p99}
    print("path " + json.dumps(out))
    return out


def kmeans_path(torch, kernels, miniapps, cluster, ctx, device) -> dict:
    inertias: list[float] = []

    class TracedKMeans(miniapps.StreamingKMeans):
        def _on_complete(self, result, meta, dt):
            super()._on_complete(result, meta, dt)
            inertias.append(self._inertia)

    cluster.create_topic("points", 8)
    source = miniapps.KMeansClusterSource(
        cluster, miniapps.SourceConfig("points", total_messages=640, n_producers=4, seed=SEED),
        n_clusters=10, dim=3, points_per_msg=5000)
    app = TracedKMeans(10, 3, seed=SEED, device=device)
    stream = ctx.stream(cluster, "points", group="kmeans", process_fn=app.process,
                        batch_interval=0.05, max_batch_records=16)
    kernels.reset_launches()
    wall = drive(stream, source, 20, 300)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    centroids = stream.state
    if not bool(torch.isfinite(centroids).all()) or centroids.shape != (10, 3):
        raise AssertionError(f"bad centroids {centroids}")
    if not inertias[-1] < inertias[0]:
        raise AssertionError(f"inertia did not fall: {inertias}")
    out = report("kmeans", app, stream, wall)
    out["inertia_first"], out["inertia_last"] = inertias[0], inertias[-1]
    return {"report": out, "launches": launches}


def kmeans_wide_path(torch, kernels, miniapps, cluster, ctx, device) -> dict:
    """The K-Means stream at 1024 centres in 128 dimensions: every message
    is in the log before the stream starts, so each batch takes
    WIDE_MSGS_PER_BATCH messages (N = 65 536, the wide regime)."""
    inertias: list[float] = []
    sizes: list[int] = []

    class TracedKMeans(miniapps.StreamingKMeans):
        def _on_complete(self, result, meta, dt):
            super()._on_complete(result, meta, dt)
            inertias.append(self._inertia)
            sizes.append(meta[1])

    n_msgs = WIDE_MSGS_PER_BATCH * WIDE_BATCHES
    cluster.create_topic("points_wide", 4)
    source = miniapps.KMeansClusterSource(
        cluster, miniapps.SourceConfig("points_wide", total_messages=n_msgs, n_producers=4,
                                       seed=SEED),
        n_clusters=WIDE_K, dim=WIDE_D, points_per_msg=WIDE_POINTS_PER_MSG)
    app = TracedKMeans(WIDE_K, WIDE_D, seed=SEED, device=device)
    stream = ctx.stream(cluster, "points_wide", group="kmeans_wide", process_fn=app.process,
                        batch_interval=0.5, max_batch_records=WIDE_MSGS_PER_BATCH,
                        backpressure=False)
    source.start()
    source.join(300)
    if source.sent_records != n_msgs:
        raise AssertionError(f"wide source sent {source.sent_records} of {n_msgs} messages")
    kernels.reset_launches()
    t0 = time.monotonic()
    stream.start()
    try:
        stream.await_batches(WIDE_BATCHES, timeout=300)
    finally:
        stream.stop()
        source.stop()
    wall = time.monotonic() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    centroids = stream.state
    if not bool(torch.isfinite(centroids).all()) or centroids.shape != (WIDE_K, WIDE_D):
        raise AssertionError(f"wide K-Means: bad centroids {tuple(centroids.shape)}")
    if sizes != [WIDE_MSGS_PER_BATCH * WIDE_POINTS_PER_MSG] * WIDE_BATCHES:
        raise AssertionError(f"wide K-Means batch sizes {sizes}")
    if not inertias[-1] < inertias[0]:
        raise AssertionError(f"wide K-Means inertia did not fall: {inertias}")
    if launches["kmeans_assign"] != stream.stats.batches:
        raise AssertionError(f"kmeans_assign launched {launches['kmeans_assign']} times for "
                             f"{stream.stats.batches} batches")
    out = report("kmeans_wide", app, stream, wall)
    out["inertia_first"], out["inertia_last"] = inertias[0], inertias[-1]
    return {"report": out, "launches": launches}


def recon_path(torch, kernels, miniapps, tomo, cluster, ctx, device) -> dict:
    a, n_det, n = FRAME_ANGLES, FRAME_BINS, RECON_N
    kernels.reset_launches()
    reports, states = [], {}
    payload = None
    for algo in ("gridrec", "mlem"):
        topic = f"frames_{algo}"
        cluster.create_topic(topic, 4)
        source = miniapps.LightsourceTemplateSource(
            cluster, miniapps.SourceConfig(topic, total_messages=32, n_producers=2, seed=SEED),
            n_angles=a, n_det=n_det)
        payload = source._payload
        app = miniapps.ReconstructionApp(algo, n=n, mlem_iters=MLEM_ITERS, device=device)
        # backpressure off: every micro-batch fills to 8 frames
        stream = ctx.stream(cluster, topic, group=algo, process_fn=app.process,
                            batch_interval=0.5, max_batch_records=8, backpressure=False)
        wall = drive(stream, source, 4, 600)
        state = stream.state
        if state.shape != (n, n) or not bool(torch.isfinite(state).all()):
            raise AssertionError(f"{algo}: bad reconstruction {tuple(state.shape)}")
        states[algo] = state
        reports.append(report(algo, app, stream, wall))
    launches = {k.name: k.launches for k in kernels.KERNELS}

    # hold the last reconstructions (every frame is the template payload)
    # against the plain versions on the same frame
    checks = {algo: recon_vs_plain(torch, tomo, algo, states[algo], payload, device)
              for algo in ("gridrec", "mlem")}
    print("recon_vs_plain " + json.dumps(checks))
    return {"reports": reports, "launches": launches}


def recon_vs_plain(torch, tomo, algo: str, state, payload, device) -> dict:
    """Hold a reconstruction of the template frame ``payload`` at n =
    RECON_N against the plain versions' reconstruction of the same frame;
    raises past the tolerance."""
    a, n_det, n = FRAME_ANGLES, FRAME_BINS, RECON_N
    sino = torch.from_numpy(payload).to(device)[None]
    angles = torch.from_numpy(tomo.angle_grid(a)).to(device)
    cos_t, sin_t = tomo.trig(angles)
    if algo == "gridrec":
        # one backprojection of signed terms, one per angle
        filtered = tomo.ramp_filter(sino)
        scale = math.pi / (2 * a)
        ref = tomo.backproject_plain(filtered, cos_t, sin_t, n)[0] * scale
        grid_abs = tomo.backproject_plain(filtered.abs(), cos_t, sin_t, n)[0] * scale
        tol = a * F32_EPS * float(grid_abs.max())
    else:
        # ML-EM: its projections and backprojections of ratio updates
        # compound the per-pass rounding; 1e-3 of the peak
        x = torch.ones((1, n, n), device=device)
        norm = tomo.backproject_plain(torch.ones_like(sino), cos_t, sin_t, n) + 1e-6
        for _ in range(MLEM_ITERS):
            fp = tomo.project_plain(x, cos_t, sin_t, n_det)
            x = x * tomo.backproject_plain(sino / fp.clamp_min(1e-6), cos_t, sin_t, n) / norm
        ref, tol = x[0], 1e-3 * float(x.abs().max())
    if state.shape != (n, n) or not bool(torch.isfinite(state).all()):
        raise AssertionError(f"{algo}: bad reconstruction {tuple(state.shape)}")
    err = float((state - ref).abs().max())
    if err > tol:
        raise AssertionError(f"{algo} reconstruction vs plain: max err {err} > tol {tol}")
    return {"max_abs_err": err, "tol": tol}


def serve_path(torch, kernels, miniapps, cluster, ctx, device, n_msgs: int = SERVE_MSGS,
               cfg=None, gen_tokens: int = GEN_TOKENS, label: str = "serve",
               params=None) -> dict:
    """The LM serving stream, ``n_msgs`` messages of SERVE_BATCH prompts
    of ``gen_tokens`` greedy tokens each, at ``cfg`` (smollm-135m at full
    width by default; its own topic and consumer group per ``label``), on
    ``params`` (drawn from SEED on the card if None); returns the path's
    report and launches, the params and every served (prompts, tokens)."""
    from repro_torch.configs import get_arch

    served: list = []

    class TracedServe(miniapps.LMServeApp):
        def _serve_continuous(self, params, msgs):
            out = super()._serve_continuous(params, msgs)
            served.append((self._stack_requests(msgs), out))
            return out

    cfg = cfg or get_arch("smollm-135m")
    app = TracedServe(cfg, mode="continuous", prompt_len=PROMPT_LEN, gen_tokens=gen_tokens,
                      batch=SERVE_BATCH, page_size=PAGE_SIZE, device=device)
    if params is None:
        params = app.model.init(torch.Generator(device=device).manual_seed(SEED))
    topic = "requests" if label == "serve" else f"requests_{label}"
    cluster.create_topic(topic, 2)
    source = miniapps.TokenSource(
        cluster, miniapps.SourceConfig(topic, total_messages=n_msgs, seed=SEED),
        vocab_size=cfg.vocab_size, seq_len=PROMPT_LEN, seqs_per_msg=SERVE_BATCH)
    stream = ctx.stream(cluster, topic, group="server" if label == "serve" else label,
                        process_fn=app.process, state=params, batch_interval=0.1,
                        max_batch_records=1)
    kernels.reset_launches()
    wall = drive(stream, source, n_msgs, 600)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    requests = sum(len(out) for _, out in served)
    tokens = sum(out.size for _, out in served)
    # greedy tokens range over the head's padded vocabulary, as the JAX
    # package's do: with random weights the padding rows' logits are random
    # too (phi3.5-moe: 32064 ids padded to 32256)
    if requests != n_msgs * SERVE_BATCH or any(
            out.shape != (SERVE_BATCH, gen_tokens) or out.min() < 0
            or out.max() >= cfg.padded_vocab for _, out in served):
        raise AssertionError(f"served {requests} requests, shapes {[o.shape for _, o in served]}")
    lat = app.stats.latency
    out = {"path": label, "batches": stream.stats.batches, "requests": requests,
           "generated_tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "latency_p50_s": lat.p50, "latency_p99_s": lat.p99}
    if label != "serve":
        out.update(model=cfg.name, layers=cfg.n_layers, capacity_factor=cfg.capacity_factor,
                   gen_tokens=gen_tokens, launches={k: n for k, n in launches.items() if n})
    print("path " + json.dumps(out))
    return {"report": out, "launches": launches, "app": app, "params": params, "served": served,
            "stream": stream}


def _routes(moe, record):
    """A context in which every routing the MoE layers compute is handed to
    ``record`` (a ``Routing``)."""
    import contextlib

    @contextlib.contextmanager
    def recording():
        route = moe.moe_route

        def wrapped(*args, **kwargs):
            r = route(*args, **kwargs)
            record(r)
            return r

        moe.moe_route = wrapped
        try:
            yield
        finally:
            moe.moe_route = route

    return recording()


def _route_margins(moe, margins: list):
    """A context in which every routing appends its per-token margins
    (``Routing.margin``, G x gs) to ``margins``."""
    return _routes(moe, lambda r: margins.append(r.margin()))


def rescore(torch, model, params, served: list, *, steps=None, batch_for=None,
            rows_per_call: int | None = None, route_tie: float | None = None,
            enforce: bool = True) -> dict:
    """Served tokens against prefills of their contexts. ``served`` holds
    (prompts (B, P), tokens (B, T)) pairs, numpy or on the card; token t of
    every request, for each t in ``steps`` (all T by default), against a
    prefill of the prompt and the t tokens served before it. A model whose
    prefill honours ``last_pos`` (``SUPPORTS_PAGED``) takes rows of every t
    in one prefill (``rows_per_call`` rows a call) at their full length,
    ``last_pos = P - 1 + t`` (a VLM's counts its patches); any other takes one
    prefill per t of its rows cut to P + t tokens. ``batch_for(tokens,
    requests)`` adds the stub embeddings of each row's request. That prefill
    runs the flash kernel; the served tokens came through the decode
    kernel. The dense rule: a served token must be the prefill's argmax
    wherever the top-2 gap exceeds RESCORE_GAP, and at least a quarter of
    all positions must be clear (and not excusable) so that the rule binds.
    For a MoE model, ``route_tie`` given: a served token that differs where
    the gap is clear is excused only where its own position was routed, in
    some layer of the re-scoring prefill, by a margin of at most
    ``route_tie`` (a near-tie that the two paths' bf16 roundings can flip);
    such tokens are counted and printed, never dropped silently. The
    positions that could be excused so are counted too (``excusable``),
    with how many of the clear-gap positions have own margins of at most
    2^-11, 2^-10 and 2^-9. ``enforce`` False: the rule is read and printed
    (``met``, each clear-gap difference), not held."""
    from repro_torch.models import moe
    from repro_torch.models.common import first_argmax, tree_leaves

    cfg = model.cfg
    p = model.compute_params(params)
    device = tree_leaves(params)[0].device
    offset = cfg.n_patches if cfg.family == "vlm" else 0
    checked = agree = excusable = total = 0
    own_at_most = {f"2^{e}": 0 for e in (-11, -10, -9)}  # clear positions, own margin <= 2^e
    worst = 0.0  # the largest top-2 gap at which a served token differed
    excused: list = []  # (gap, own route margin) of each excused token
    differing: list = []  # (request, t, gap) of each clear-gap difference not excused
    own_margin_min = math.inf
    for i, (prompts, out) in enumerate(served):
        prompts = torch.as_tensor(prompts, device=device)
        out = torch.as_tensor(out, device=device).to(prompts.dtype)
        (B, P), T = prompts.shape, out.shape[1]
        ts = torch.arange(T, device=device) if steps is None else torch.tensor(steps, device=device)
        seqs = torch.cat([prompts, out], dim=1)
        req = torch.arange(B, device=device).repeat_interleave(len(ts))  # each row's request
        t_row = ts.repeat(B)
        if model.SUPPORTS_PAGED:
            step = rows_per_call or len(req)
            groups = [slice(r0, r0 + step) for r0 in range(0, len(req), step)]
        else:
            groups = [t_row == t for t in ts]
        parts, own, rows_t = [], [], []
        for g in groups:
            at = t_row[g]
            rows = seqs[req[g]] if model.SUPPORTS_PAGED else seqs[req[g], :P + int(at[0])]
            batch = batch_for(rows, req[g]) if batch_for else {"tokens": rows}
            if model.SUPPORTS_PAGED:
                batch["last_pos"] = offset + P - 1 + at
            margins: list = []
            with _route_margins(moe, margins):
                logits, _ = model.prefill(p, batch)
            parts.append(logits[:, 0])
            rows_t.append(torch.stack([req[g], at], dim=1))
            if route_tie is not None:  # each layer's margin at the rows' own positions
                last = P - 1 + at
                own.append(torch.stack([m.reshape(rows.shape)[torch.arange(len(rows)), last]
                                        for m in margins]).amin(0))
        logits, rows_t = torch.cat(parts), torch.cat(rows_t)
        top2 = logits.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = first_argmax(logits, dim=-1) == out[rows_t[:, 0], rows_t[:, 1]].long()
        clear = gap > RESCORE_GAP
        bad = clear & ~same
        if route_tie is not None:
            own = torch.cat(own)
            own_margin_min = min(own_margin_min, float(own.min()))
            near = own <= route_tie
            tie = bad & near
            excused += [(float(g), float(m)) for g, m in zip(gap[tie], own[tie])]
            bad = bad & ~tie
            excusable += int((clear & near).sum())
            for e in (-11, -10, -9):
                own_at_most[f"2^{e}"] += int((clear & (own <= 2.0 ** e)).sum())
        differing += [(i * B + int(r), int(t), float(g))
                      for (r, t), g in zip(rows_t[bad].tolist(), gap[bad])]
        if enforce and bool(bad.any()):
            raise AssertionError(f"{cfg.name}: {int(bad.sum())} served tokens differ from the "
                                 f"prefill argmax where the top-2 gap exceeds {RESCORE_GAP}")
        checked += int(clear.sum())
        agree += int(same.sum())
        total += len(same)
        if not bool((same | clear).all()):
            worst = max(worst, float(gap[~same & ~clear].max()))
    res = {"model": cfg.name, "positions": total, "checked": checked, "agree": agree,
           "largest_gap_where_differing": worst, "gap_tol": RESCORE_GAP}
    if steps is not None:
        res["prefix_tokens"] = [served[0][0].shape[1] + t for t in steps]
    if route_tie is not None:
        res.update(capacity_factor=cfg.capacity_factor,
                   rows_per_prefill=rows_per_call, route_tie=route_tie, excusable=excusable,
                   binding=checked - excusable, clear_with_own_margin_at_most=own_at_most,
                   own_route_margin_min=own_margin_min,
                   excused_route_ties=len(excused), excused_gap_and_margin=excused[:8])
    if not enforce:
        res.update(enforced=False, met=not differing and checked - excusable >= total // 4,
                   clear_gap_differences=differing)
    print("rescore " + json.dumps(res))
    if enforce and checked - excusable < total // 4:
        raise AssertionError(f"{cfg.name}: only {checked - excusable} of {total} positions had a "
                             f"clear top-2 gap and could not be excused ({excusable} could)")
    return res


def serve_moe_path(torch, kernels, miniapps, cluster, ctx, device) -> dict:
    """The MoE family served through ``LMServeApp(mode="continuous")`` at
    the published widths, depth cut (MOE_MODELS): per model, its weights
    drawn on the card from SEED, MOE_MSGS messages at the published
    capacity factor, then MOE_NODROP_MSGS at capacity_factor = E / K on the
    same weights, re-scored (``rescore``, with the routes' near-ties
    reported); the phi3.5 model's memory is freed before kimi-k2's is drawn.
    Checks both attention kernels launched on every run; prints a ``path``
    line per run and a ``moe_model`` line per model (draw seconds, the
    card's peak memory over the model's runs)."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    launches = {k.name: 0 for k in kernels.KERNELS}
    reports = []
    t_phase = time.perf_counter()
    for name, layers in MOE_MODELS:
        full = get_arch(name)
        cfg = full.replace(n_layers=layers)
        short = name.split("-")[0]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = build_model(cfg).init(torch.Generator(device=device).manual_seed(SEED))
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        n_bytes = sum(x.numel() * x.element_size() for x in
                      [*params["layers"].values()] + [v for k, v in params.items() if k != "layers"])
        nodrop = full.n_experts / full.experts_per_token
        for cf, n_msgs, kind in ((full.capacity_factor, MOE_MSGS, "published"),
                                 (nodrop, MOE_NODROP_MSGS, "nodrop")):
            sv = serve_path(torch, kernels, miniapps, cluster, ctx, device, n_msgs,
                            cfg=cfg.replace(capacity_factor=cf), gen_tokens=MOE_GEN_TOKENS,
                            label=f"serve_moe_{short}_{kind}", params=params)
            run = sv["launches"]
            for k in ("flash_attention", "decode_attention"):
                if run[k] < 1:
                    raise AssertionError(f"{name} ({kind}): {k} was not launched")
            for k, n in run.items():
                launches[k] += n
            reports.append(sv["report"])
            if kind == "nodrop":
                seq = PROMPT_LEN + MOE_GEN_TOKENS
                per_row = seq * full.experts_per_token * cf * full.d_model * 2  # dispatch bytes
                rescore(torch, sv["app"].model, sv["params"], sv["served"],
                        rows_per_call=max(1, int(MOE_DISPATCH_BYTES // per_row)),
                        route_tie=MOE_ROUTE_TIE)
            ctx.streams.remove(sv["stream"])  # the stopped stream held the params as its state
            del sv
        peak = torch.cuda.max_memory_allocated()
        del params
        print("moe_model " + json.dumps({
            "model": name, "layers": f"{layers} of {full.n_layers}", "d_model": full.d_model,
            "heads": f"{full.n_heads} over {full.n_kv_heads} KV of {full.resolved_head_dim}",
            "experts": f"{full.n_experts} top-{full.experts_per_token} + "
                       f"{full.n_shared_experts} shared", "d_ff": full.d_ff,
            "vocab": full.vocab_size, "param_bytes": n_bytes, "draw_s": draw_s,
            "peak_allocated_gib": peak / 2 ** 30,
            "allocated_before_gib": before / 2 ** 30}))
    gc.collect()
    torch.cuda.empty_cache()
    layer = moe_layer_check(torch, device)
    seconds = time.perf_counter() - t_phase
    print("path " + json.dumps({"path": "serve_moe", "seconds": seconds,
                                "runs": [r["path"] for r in reports],
                                "launches": {k: n for k, n in launches.items() if n}}))
    return {"reports": reports, "launches": launches, "layer": layer, "seconds": seconds}


def moe_layer_check(torch, device) -> dict:
    """One MoE layer of phi3.5-moe at full width (d 4096, 16 experts of
    d_ff 6400, top-2) at its published capacity factor, a prefill of B=1
    S=128 in f32 compute, on the card (f32 products, TF32 off) against the
    same layer on the CPU: the same weights (bf16 storage, as served; drawn
    on the card from SEED) and inputs. Routes are compared token by token;
    a token whose set of experts differs is a flip, excused only where its
    margin is below MOE_F32_TIE, and a token that keeps its experts but
    loses or gains a slot is excused only behind such a flip (capacity is
    counted in token order). The other tokens' outputs are held to
    MOE_LAYER_REL of the largest |y|, the aux loss to 1e-6 relative."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.models.common import init_params

    cfg = get_arch("phi3.5-moe-42b-a6.6b")
    gen = torch.Generator(device=device).manual_seed(SEED)
    p_card = init_params(moe.moe_specs(cfg, None, torch.bfloat16), gen)
    x_card = torch.randn((1, PROMPT_LEN, cfg.d_model), generator=gen, device=device)
    p_cpu = {k: v.cpu() for k, v in p_card.items()}
    x_cpu = x_card.cpu()
    t0 = time.perf_counter()
    y_card, aux_card = moe.moe_apply(p_card, x_card, cfg, torch.float32)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    y_cpu, aux_cpu = moe.moe_apply(p_cpu, x_cpu, cfg, torch.float32)
    cpu_s = time.perf_counter() - t0
    xt = (1, PROMPT_LEN, cfg.d_model)  # one group: S = 128 tokens <= the group size
    r_card = moe.moe_route(p_card["router"], x_card.reshape(xt), cfg, torch.float32)
    r_cpu = moe.moe_route(p_cpu["router"], x_cpu.reshape(xt), cfg, torch.float32)
    margin = r_cpu.margin()[0]
    sets_differ = (r_card.experts.cpu().sort(-1).values != r_cpu.experts.sort(-1).values).any(-1)[0]
    keep_differs = (r_card.keep.cpu() != r_cpu.keep).any(-1)[0]
    flips = torch.nonzero(sets_differ).flatten().tolist()
    unexplained = [i for i in flips if float(margin[i]) >= MOE_F32_TIE]
    first_flip = min(flips, default=PROMPT_LEN)
    slot_only = torch.nonzero(keep_differs & ~sets_differ).flatten().tolist()
    unexplained += [i for i in slot_only if i < first_flip]
    alike = ~(sets_differ | keep_differs)
    if not bool(alike.any()):
        raise AssertionError("MoE layer on the card vs the CPU: no token routed alike")
    err = (y_card.cpu() - y_cpu)[0].abs().amax(-1)  # per token
    scale = float(y_cpu.abs().max())
    worst = float(err[alike].max()) / scale
    aux_rel = abs(float(aux_card) - float(aux_cpu)) / abs(float(aux_cpu))
    res = {"model": cfg.name, "shape": f"B=1 S={PROMPT_LEN} d={cfg.d_model} f32",
           "capacity_factor": cfg.capacity_factor, "capacity": r_cpu.capacity,
           "kept": int(r_cpu.keep.sum()), "routed": PROMPT_LEN * cfg.experts_per_token,
           "worst_err_over_max_y": worst, "tol": MOE_LAYER_REL, "aux_rel_err": aux_rel,
           "smallest_route_margin": float(margin.min()), "route_tie": MOE_F32_TIE,
           "route_flips": [(i, float(margin[i])) for i in flips], "slot_only_changes": slot_only,
           "card_s": card_s, "cpu_s": cpu_s}
    print("moe_layer " + json.dumps(res))
    if unexplained or worst > MOE_LAYER_REL or aux_rel > 1e-6 or not bool(y_card.isfinite().all()):
        raise AssertionError(f"MoE layer on the card vs the CPU: {res}; unexplained {unexplained}")
    return res


def state_replay(torch, model, params, served: list) -> dict:
    """rwkv6-3b's or zamba2-1.2b's serving held against itself and its
    prefill, per message of ``served`` [(prompts, tokens)]:

    * bf16, the app's run repeated: the prefill of the prompt and the decode
      loop fed the served tokens must pick every served token again;
    * f32 compute (the same stored bf16 weights; the f32 attention
      kernels): the replay, fed the served tokens, against a prefill of the
      prompt and every served token but the last (PROMPT_LEN + FAM_STATE_GEN
      - 1 = 192 tokens: whole chunks of both scans). Their last logits must
      agree to FAM_F32_DEPTH_REL of the prefill's largest |logit|, and their
      argmaxes wherever the prefill's top-2 gap exceeds RESCORE_GAP (the
      dense rule), which must be clear on a quarter of the rows or more;
    * the f32 leaves of the bf16 replay's cache (the WKV or SSD states,
      which the reference keeps in f32 under bf16 compute) must carry f32
      precision: at most FAM_STATE_BF16_EXACT of their elements may equal
      their own bf16 rounding (a state rounded to the compute dtype on the
      way is all such elements);
    * read, not held: how far bf16 moves each path from its f32 run (the
      bf16 prefill from the f32 prefill, the bf16 replay from the f32
      replay) and the two bf16 paths from each other, each over the f32
      prefill's largest |logit|. Random weights at full depth amplify
      rounding until the bf16 paths part by about as much as each parts from
      its own f32 run, so here the served tokens' bf16 re-score is read
      beside this (``rescore``, ``enforce=False``), not held. It is held at
      trained weights (C14): ``trained_path`` serves each model at 1 layer
      from the weights it trained and re-scores every served token whose
      context a prefill takes (a whole number of the scan's chunks) with
      ``rescore`` enforced, the dense rule unchanged. At full depth the
      re-score stays read: bf16 serving at full depth is held only by the
      rules above (a decision, ROADMAP C14).

    Returns the readings and ``failed``, the rules broken: none in a sound
    run; ``tools/state_faults.py`` plants faults and reads which rule each
    one breaks."""
    from repro_torch.models import build_model
    from repro_torch.models.common import first_argmax, tree_leaves

    cfg = model.cfg
    model32 = build_model(cfg.replace(compute_dtype="float32"))
    p = model.compute_params(params)
    P, T = served[0][0].shape[1], served[0][1].shape[1]

    def replay(m, prompts, out):
        logits, cache = m.prefill(p, {"tokens": prompts}, cache_len=P + T)
        picks = [first_argmax(logits[:, -1], dim=-1)]
        pos = torch.full((len(out),), P - 1, dtype=torch.int32, device=out.device)
        for j in range(1, T):
            pos = pos + 1
            logits, cache = m.decode(p, cache, {"tokens": out[:, j - 1:j], "positions": pos})
            picks.append(first_argmax(logits[:, 0], dim=-1))
        return logits[:, 0], torch.stack(picks, dim=1), cache

    failed = []
    rel = {"f32_decode_vs_prefill": 0.0, "bf16_vs_f32_prefill": 0.0, "bf16_vs_f32_decode": 0.0,
           "bf16_decode_vs_prefill": 0.0}
    clear = agree = total = 0
    differing, scales = [], []
    exact = n_state = 0
    for prompts, out in served:
        dec, picks, cache = replay(model, prompts, out)
        for leaf in tree_leaves(cache):
            if leaf.dtype == torch.float32:
                exact += int((leaf.to(torch.bfloat16).float() == leaf).sum())
                n_state += leaf.numel()
        del cache
        if not torch.equal(picks, out.long()):
            failed.append(f"the bf16 replay picks other tokens than the served ones at "
                          f"{int((picks != out.long()).sum())} places")
        seq = torch.cat([prompts, out[:, :-1]], dim=1)
        pre = model.prefill(p, {"tokens": seq})[0][:, 0]
        dec32 = replay(model32, prompts, out)[0]
        pre32 = model32.prefill(p, {"tokens": seq})[0][:, 0]
        scale = float(pre32.abs().max())
        scales.append(scale)
        for key, (a, b) in {"f32_decode_vs_prefill": (dec32, pre32),
                            "bf16_vs_f32_prefill": (pre, pre32),
                            "bf16_vs_f32_decode": (dec, dec32),
                            "bf16_decode_vs_prefill": (dec, pre)}.items():
            rel[key] = max(rel[key], float((a - b).abs().max()) / scale)
        top2 = pre32.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = first_argmax(dec32, dim=-1) == first_argmax(pre32, dim=-1)
        differing += gap[(gap > RESCORE_GAP) & ~same].tolist()
        clear += int((gap > RESCORE_GAP).sum())
        agree += int(same.sum())
        total += len(same)
    if rel["f32_decode_vs_prefill"] > FAM_F32_DEPTH_REL:
        failed.append(f"f32 decode and prefill differ by {rel['f32_decode_vs_prefill']} of the "
                      f"largest logit (limit {FAM_F32_DEPTH_REL})")
    if differing:
        failed.append(f"f32 decode and prefill argmaxes differ at top-2 gaps {differing}")
    if clear < total // 4:
        failed.append(f"only {clear} of {total} f32 rows had a clear top-2 gap")
    exact_share = exact / n_state
    if exact_share > FAM_STATE_BF16_EXACT:
        failed.append(f"{exact_share} of the f32 states' elements are bf16 values")
    return {"positions": total, "prefix_tokens": [P + T - 1], "f32_clear": clear,
            "f32_agree": agree, "gap_tol": RESCORE_GAP, "f32_tol": FAM_F32_DEPTH_REL,
            "f32_max_logit": max(scales), **rel, "state_elements": n_state,
            "state_bf16_exact_share": exact_share, "state_bf16_exact_tol": FAM_STATE_BF16_EXACT,
            "failed": failed}


def _stub_batch(cfg, tokens, extra):
    """A VLM's or enc-dec model's batch: the tokens and its stub embeddings."""
    if cfg.family == "vlm":
        return {"tokens": tokens, "patch_embeds": extra}
    return {"tokens": tokens, "frame_embeds": extra}


def family_stub_serve(torch, kernels, model, params, device) -> dict:
    """llava-next or seamless-m4t through the model API: SERVE_BATCH prompts
    of PROMPT_LEN tokens and their stub embeddings (llava: n_patches patch
    embeddings; seamless: FAM_FRAMES frame embeddings), drawn on the card
    from SEED; a prefill with the cache grown for FAM_STUB_GEN tokens, then
    the greedy decode loop as ``LMServeApp`` runs it. Positions count a
    VLM's patches: its decode starts at n_patches + PROMPT_LEN. The kernels'
    launch counts are read when the loop has run, before the same prefill
    is timed again."""
    from repro_torch.models.common import first_argmax

    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN), generator=gen,
                            device=device, dtype=torch.int32)
    n_stub = cfg.n_patches if cfg.family == "vlm" else FAM_FRAMES
    extra = torch.randn((SERVE_BATCH, n_stub, cfg.d_model), generator=gen, device=device,
                        dtype=torch.float32).to(model.compute_dtype)
    s = PROMPT_LEN + (cfg.n_patches if cfg.family == "vlm" else 0)  # positions of the prompt
    p = model.compute_params(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(p, _stub_batch(cfg, prompts, extra),
                                  cache_len=s + FAM_STUB_GEN)
    tok = first_argmax(logits[:, -1:], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pos = torch.full((SERVE_BATCH,), s - 1, dtype=torch.int32, device=device)
    seq = [tok]
    for _ in range(FAM_STUB_GEN - 1):
        pos = pos + 1
        logits, cache = model.decode(p, cache, {"tokens": tok, "positions": pos})
        tok = first_argmax(logits, dim=-1).to(torch.int32)
        seq.append(tok)
    out = torch.cat(seq, dim=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    del cache
    t0 = time.perf_counter()  # the same prefill again: what of the first one was one-time
    model.prefill(p, _stub_batch(cfg, prompts, extra), cache_len=s + FAM_STUB_GEN)
    torch.cuda.synchronize()
    prefill_again_s = time.perf_counter() - t0
    return {"wall_s": wall, "prefill_s": prefill_s, "prefill_again_s": prefill_again_s,
            "launches": launches, "served": [(prompts, out)], "extra": extra}


def family_stream_serve(torch, kernels, miniapps, cluster, ctx, device, model, params) -> dict:
    """rwkv6-3b or zamba2-1.2b through ``LMServeApp(mode="lockstep")`` on a
    token stream of FAM_STATE_MSGS messages of SERVE_BATCH x PROMPT_LEN,
    FAM_STATE_GEN greedy tokens each; the kernels' launch counts are read
    when the stream has run and the app has synced. Returns every served
    (prompts, tokens) on the card."""
    cfg = model.cfg
    served: list = []

    class TracedServe(miniapps.LMServeApp):
        def _serve_batch(self, params, msgs):
            seq, n_req = super()._serve_batch(params, msgs)
            served.append((self._stack_requests(msgs), seq[:, :n_req, 0].T))
            return seq, n_req

    app = TracedServe(cfg, mode="lockstep", prompt_len=PROMPT_LEN, gen_tokens=FAM_STATE_GEN,
                      batch=SERVE_BATCH, device=device)
    topic = f"requests_{cfg.name}"
    cluster.create_topic(topic, 2)
    source = miniapps.TokenSource(
        cluster, miniapps.SourceConfig(topic, total_messages=FAM_STATE_MSGS, seed=SEED),
        vocab_size=cfg.vocab_size, seq_len=PROMPT_LEN, seqs_per_msg=SERVE_BATCH)
    stream = ctx.stream(cluster, topic, group=cfg.name, process_fn=app.process, state=params,
                        batch_interval=0.1, max_batch_records=1)
    wall = drive(stream, source, FAM_STATE_MSGS, 600)
    app.sync()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    ctx.streams.remove(stream)  # the stopped stream holds the params as its state
    if len(served) != FAM_STATE_MSGS or any(o.shape != (SERVE_BATCH, FAM_STATE_GEN)
                                            for _, o in served):
        raise AssertionError(f"{cfg.name}: served {[tuple(o.shape) for _, o in served]}")
    lat = app.stats.latency
    return {"wall_s": wall, "launches": launches, "latency_p50_s": lat.p50,
            "latency_p99_s": lat.p99,
            "served": [(torch.from_numpy(pr).to(device), o) for pr, o in served]}


def family_card_vs_cpu(torch, name: str, device) -> dict:
    """``name`` at full width but FAM_CHECK_LAYERS layers (llava also
    FAM_CHECK_PATCHES patches), f32 params and compute, weights drawn on the
    card from SEED and copied to the CPU: a prefill of 2 x FAM_CHECK_TOKENS
    tokens (and stub embeddings) and FAM_CHECK_DECODES decode steps fed
    random tokens, on both devices, every step's logits held to FAM_F32_REL
    of the CPU's largest |logit|; and on the card, the last decode step's
    logits against a prefill of the tokens and the fed ones (the decode
    path and the prefill path compute one function), to the same rule."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    over = {"n_layers": FAM_CHECK_LAYERS, "param_dtype": "float32", "compute_dtype": "float32"}
    full = get_arch(name)
    if full.n_enc_layers:
        over["n_enc_layers"] = FAM_CHECK_LAYERS
    if full.n_patches:
        over["n_patches"] = FAM_CHECK_PATCHES
    cfg = full.replace(**over)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    p_card = model.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, FAM_CHECK_TOKENS), generator=gen,
                           device=device, dtype=torch.int32)
    batch = {"tokens": tokens}
    if cfg.family in ("vlm", "encdec"):
        n = cfg.n_patches if cfg.family == "vlm" else FAM_CHECK_TOKENS
        batch = _stub_batch(cfg, tokens, torch.randn((2, n, cfg.d_model), generator=gen,
                                                     device=device))
    steps = torch.randint(0, cfg.vocab_size, (FAM_CHECK_DECODES, 2, 1), generator=gen,
                          device=device, dtype=torch.int32)

    def run(params, batch, steps):
        s = batch["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
        logits, cache = model.prefill(params, batch, cache_len=s + FAM_CHECK_DECODES)
        outs = [logits]
        for i, tok in enumerate(steps):
            pos = torch.full((2,), s + i, dtype=torch.int32, device=tok.device)
            logits, cache = model.decode(params, cache, {"tokens": tok, "positions": pos})
            outs.append(logits)
        return torch.stack(outs)

    def to_cpu(tree):
        return {k: to_cpu(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cpu()

    t0 = time.perf_counter()
    card = run(p_card, batch, steps)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    longer = dict(batch, tokens=torch.cat([tokens, steps[:, :, 0].T], dim=1))
    pre = model.prefill(p_card, longer)[0]
    paths = float((card[-1] - pre).abs().max()) / float(pre.abs().max())
    p_cpu, b_cpu, s_cpu = to_cpu(p_card), to_cpu(batch), steps.cpu()
    del p_card
    t0 = time.perf_counter()
    cpu = run(p_cpu, b_cpu, s_cpu)
    cpu_s = time.perf_counter() - t0
    scale = float(cpu.abs().max())
    err = float((card.cpu() - cpu).abs().max()) / scale
    res = {"model": name, "layers": FAM_CHECK_LAYERS, "tokens": FAM_CHECK_TOKENS,
           "decode_steps": FAM_CHECK_DECODES, "worst_err_over_max_logit": err,
           "decode_vs_prefill_on_card": paths, "tol": FAM_F32_REL, "card_s": card_s,
           "cpu_s": cpu_s, "argmax_equal": bool((card.cpu().argmax(-1) == cpu.argmax(-1)).all())}
    if not bool(card.isfinite().all()) or err > FAM_F32_REL or paths > FAM_F32_REL:
        raise AssertionError(f"{name}: card vs CPU in f32: {res}")
    return res


def families_path(torch, kernels, miniapps, cluster, ctx, device) -> dict:
    """The families phase (FAMILIES, one model at a time, each freed before
    the next is drawn): serving at full width and depth, bf16, every
    kernel's launch count set to 0 before a model's serving and read when
    it has served, before any check runs (flash and decode must launch for
    llava, seamless and zamba, neither for rwkv6, which has no attention);
    then the checks: llava's and seamless's served tokens re-scored under
    the dense rule (``rescore``), rwkv6's and zamba2's replayed and held to
    their f32 runs (``state_replay``), their bf16 re-score read beside it;
    then the f32 card-vs-CPU check. Prints a ``path`` and a ``card_vs_cpu``
    line per family and one ``path families`` summary."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    launches = {k.name: 0 for k in kernels.KERNELS}
    t_phase = time.perf_counter()
    reports = []
    for name in FAMILIES:
        cfg = get_arch(name)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=device).manual_seed(SEED))
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in tree_leaves(params))
        kernels.reset_launches()
        if cfg.family in ("vlm", "encdec"):
            res = family_stub_serve(torch, kernels, model, params, device)
        else:
            res = family_stream_serve(torch, kernels, miniapps, cluster, ctx, device, model, params)
        peak = torch.cuda.max_memory_allocated()
        run = res["launches"]
        attn = {k: run[k] for k in ("flash_attention", "decode_attention")}
        if cfg.family == "ssm":
            if any(attn.values()):
                raise AssertionError(f"{name} has no attention but launched {attn}")
        elif not all(attn.values()):
            raise AssertionError(f"{name}: an attention kernel was not launched: {attn}")
        for k, n in run.items():
            launches[k] += n
        out = torch.cat([o for _, o in res["served"]])
        if out.min() < 0 or out.max() >= cfg.padded_vocab:
            raise AssertionError(f"{name}: served tokens out of the vocabulary")
        if cfg.family in ("vlm", "encdec"):
            extra = res["extra"]
            check = rescore(torch, model, params, res["served"], rows_per_call=FAM_STUB_GEN,
                            batch_for=lambda t, r: _stub_batch(cfg, t, extra[r]))
        else:
            check = state_replay(torch, model, params, res["served"])
            check["bf16_rescore"] = rescore(torch, model, params, res["served"],
                                            steps=[FAM_STATE_GEN - 1], enforce=False)
        del params, model, res["served"]
        report = {"path": f"family_{cfg.family}", "model": name, "layers": cfg.n_layers,
                  "d_model": cfg.d_model, "params": n_params, "draw_s": draw_s,
                  "requests": out.shape[0], "generated_tokens": out.numel(),
                  "wall_s": res["wall_s"], "tokens_per_s": out.numel() / res["wall_s"],
                  "peak_allocated_gib": peak / 2 ** 30, "launches": attn,
                  **{k: res[k] for k in ("prefill_s", "prefill_again_s", "latency_p50_s",
                                         "latency_p99_s") if k in res},
                  "torch_dynamo_imported": "torch._dynamo" in sys.modules, "check": check}
        print("path " + json.dumps(report))
        if check.get("failed"):
            raise AssertionError(f"{name}: {check['failed']}")
        reports.append(report)
    gc.collect()
    torch.cuda.empty_cache()
    checks = []
    for name in FAMILIES:
        checks.append(family_card_vs_cpu(torch, name, device))
        print("card_vs_cpu " + json.dumps(checks[-1]))
        gc.collect()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print("path " + json.dumps({"path": "families", "seconds": seconds,
                                "models": [r["model"] for r in reports],
                                "launches": {k: n for k, n in launches.items() if n}}))
    return {"reports": reports, "checks": checks, "launches": launches, "seconds": seconds}


def flash_per_step(cfg) -> tuple[int, int]:
    """Flash forward launches, and launches of each backward kernel, in one
    train step of ``cfg``: an attention per layer (dense, MoE, VLM), per
    encoder layer and two per decoder layer (self and cross: enc-dec), per
    shared site (Zamba2), none in RWKV6; under remat each forward runs
    again in the backward."""
    if cfg.family == "ssm":
        n = 0
    elif cfg.family == "encdec":
        n = cfg.n_enc_layers + 2 * cfg.n_layers
    elif cfg.family == "hybrid":
        n = math.ceil(cfg.n_layers / cfg.shared_block_every)
    else:
        n = cfg.n_layers
    return (1 if cfg.remat == "none" else 2) * n, n


def train_batches(cfg, rows: int, seq: int, n: int, n_stub: int = 0, seed: int = SEED) -> list:
    """``n`` host batches of ``rows`` x ``seq`` zipf tokens (the training
    stream's), with a VLM's or enc-dec model's ``n_stub`` unit-normal f32
    patch or frame embeddings, from a numpy generator seeded ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = np.minimum(rng.zipf(1.3, size=(n, rows, seq)) - 1, cfg.vocab_size - 1)
    batches = []
    for t in tokens.astype(np.int32):
        if cfg.family in ("vlm", "encdec"):
            batches.append(_stub_batch(cfg, t, rng.standard_normal(
                (rows, n_stub, cfg.d_model), dtype=np.float32)))
        else:
            batches.append({"tokens": t})
    return batches


def train_check_step(torch, device, cfg=None, batches=None, params=None,
                     enforce: bool = True) -> dict:
    """TRAIN_CHECK_STEPS train steps of ``cfg`` (smollm-135m's full width but
    TRAIN_CHECK_LAYERS layers by default) on ``batches`` (TRAIN_BATCH x
    TRAIN_SEQ zipf tokens by default; one host batch a step), from the same
    weights (``params``, or drawn on the CPU from SEED) and the same batches,
    on the card (the flash kernels forward, remat recompute and backward) and
    on the CPU (their plain versions), held to the tolerances above; also the
    backward kernels' launches on the card (``flash_per_step`` of each a
    step). ``enforce`` False: the readings are returned with ``met``, not
    held."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels import attention
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_train_step
    from repro_torch.utils import tree_flatten_with_paths, tree_map_with_paths

    if cfg is None:
        cfg = get_arch("smollm-135m").replace(n_layers=TRAIN_CHECK_LAYERS)
    if batches is None:
        batches = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CHECK_STEPS)
    model = build_model(cfg)
    opt_cfg = OptimizerConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                              total_steps=TRAIN_STEPS)
    rows, seq = batches[0]["tokens"].shape
    shape = ShapeConfig("stream", seq, rows, "train")
    if params is None:
        params = model.init(torch.Generator().manual_seed(SEED))
    params = tree_map_with_paths(lambda _, x: x.cpu(), params)
    out = {}
    for side, where in (("cpu", torch.device("cpu")), ("card", device)):
        p = tree_map_with_paths(lambda _, x: x.to(where, copy=True), params)
        opt = Optimizer(opt_cfg).init(p)
        step = build_train_step(model, shape, opt_cfg, device=where)
        losses, norms = [], []
        before = attention.FLASH_BWD_DQ.launches, attention.FLASH_BWD_DKDV.launches
        t0 = time.perf_counter()
        for batch in batches:
            p, opt, met = step(p, opt, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        launched = (attention.FLASH_BWD_DQ.launches - before[0],
                    attention.FLASH_BWD_DKDV.launches - before[1])
        out[side] = (p, opt, losses, norms, time.perf_counter() - t0, launched)
    (cp, co, closs, cnorm, cs, _), (gp, go, gloss, gnorm, gs, launched) = out["cpu"], out["card"]

    def leaves(tree):
        return [x.cpu() for _, x in tree_flatten_with_paths(tree)]

    # per leaf: the card's change of the leaf over the steps against the
    # CPU's, ||card - cpu|| / ||cpu - start||
    update = {path: float((a - b).norm() / (b - p0).norm()) for (path, _), a, b, p0 in
              zip(tree_flatten_with_paths(params), leaves(gp), leaves(cp), leaves(params))}
    # per leaf: the first moments' largest difference over the CPU's largest |m|
    moment = {path: float((a - b).abs().max() / b.abs().max()) for (path, b), a in
              zip(tree_flatten_with_paths(co["m"]), leaves(go["m"]))}

    res = {"arch": cfg.name, "layers": cfg.n_layers, "head_dim": cfg.resolved_head_dim,
           "compute_dtype": cfg.compute_dtype, "steps": len(batches),
           "batch": {k: list(v.shape) for k, v in batches[0].items()}, "loss_cpu": closs,
           "loss_card": gloss, "grad_norm_cpu": cnorm, "grad_norm_card": gnorm,
           "steps_s_cpu": cs, "steps_s_card": gs, "bwd_launches_card": launched,
           "loss_rel_err": max(abs(g - c) / abs(c) for g, c in zip(gloss, closs)),
           "grad_norm_rel_err": max(abs(g - c) / abs(c) for g, c in zip(gnorm, cnorm)),
           "update_rel_err": max(update.values()),
           "update_worst_leaf": max(update, key=update.get),
           "m_worst_err_over_leaf_max": max(moment.values()),
           "m_worst_leaf": max(moment, key=moment.get),
           "tol": {"loss_rel": TRAIN_LOSS_REL, "grad_norm_rel": TRAIN_NORM_REL,
                   "update_rel": TRAIN_UPDATE_REL, "m_over_leaf_max": TRAIN_MOMENT_REL}}
    want = (flash_per_step(cfg)[1] * len(batches),) * 2
    met = (all(math.isfinite(x) for x in gloss) and res["loss_rel_err"] <= TRAIN_LOSS_REL
           and res["grad_norm_rel_err"] <= TRAIN_NORM_REL
           and res["update_rel_err"] <= TRAIN_UPDATE_REL
           and res["m_worst_err_over_leaf_max"] <= TRAIN_MOMENT_REL)
    if launched != want or (enforce and not met):
        raise AssertionError(f"train steps on the card vs the CPU: {res}; backward launches "
                             f"want {want}")
    if not enforce:
        res.update(enforced=False, met=met)
    return res


def train_check_moe(torch, device) -> dict:
    """``train_check_step`` on kimi-k2 reduced to MOE_TRAIN_ARCH: its
    attention at head dim 112 (16 query heads over 2 KV heads) through the
    flash forward and backward kernels on the card, its MoE layers (the aux
    loss in the loss) in plain PyTorch; printed as one line."""
    from repro_torch.configs import get_arch

    name, overrides = MOE_TRAIN_ARCH
    res = train_check_step(torch, device, get_arch(name).reduced(**overrides))
    print("train_moe " + json.dumps(res))
    return res


def train_path(torch, kernels) -> dict:
    """The training stream through the launcher users run,
    ``repro_torch.launch.train``'s ``run`` with ``--steps TRAIN_STEPS
    --checkpoint-every TRAIN_CKPT_EVERY`` and its defaults otherwise: a
    service on the card, a kafka pilot (2 broker nodes, 4 partitions) and a
    spark pilot whose devices are filed with the arbiter, a TokenSource of
    TRAIN_BATCH x TRAIN_SEQ zipf tokens a message into ``LMTrainApp`` on
    full-width smollm-135m (adamw, lr TRAIN_LR, TRAIN_WARMUP warm-up steps),
    a checkpoint every TRAIN_CKPT_EVERY steps (async, with the offsets).
    Checks: every loss finite and the last five below the first five on
    average, per step 2 x 30 flash forwards (remat runs each layer again) and
    30 of each backward kernel, params and moments on the card, the last
    checkpoint restored bitwise against the state as it was saved, two
    steps at TRAIN_CHECK_LAYERS layers against the CPU, and two of the
    reduced kimi-k2 at head dim 112 (``train_check_moe``)."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.utils import tree_flatten_with_paths, tree_map_with_paths

    directory = ROOT / "build" / "train_smoke"
    shutil.rmtree(directory, ignore_errors=True)
    args = train.parse_args(["--arch", "smollm-135m", "--steps", str(TRAIN_STEPS),
                             "--seq-len", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
                             "--lr", str(TRAIN_LR), "--checkpoint-dir", str(directory),
                             "--checkpoint-every", str(TRAIN_CKPT_EVERY)])
    saved: dict = {}

    def on_save(step, state):  # a host copy, so the card's peak is training's own
        saved["step"] = step
        saved["state"] = tree_map_with_paths(lambda _, x: x.to("cpu", copy=True), state)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    kernels.reset_launches()
    run = train.run(args, on_save=on_save)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    app, stream, state = run.app, run.stream, run.stream.state
    losses = app.losses
    steps = int(state["opt"]["step"])
    if steps != app.stats.batches or steps < TRAIN_STEPS or len(losses) != steps:
        raise AssertionError(f"{steps} optimizer steps, {app.stats.batches} batches, "
                             f"{len(losses)} losses")
    if not all(math.isfinite(x) for x in losses) or \
            not sum(losses[-5:]) / 5 < sum(losses[:5]) / 5:
        raise AssertionError(f"train losses: {losses}")
    n = app.cfg.n_layers
    want = {"flash_attention": 2 * n * steps, "flash_attention_bwd_dq": n * steps,
            "flash_attention_bwd_dkdv": n * steps}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"train launches {launches}, want {want} for {steps} steps")
    off = [p for p, x in tree_flatten_with_paths(state) if x.device.type != "cuda"]
    if off:
        raise AssertionError(f"train state off the card: {off}")
    restored, meta = CheckpointManager(str(directory)).restore(saved["state"])
    for (p, a), (_, b) in zip(tree_flatten_with_paths(saved["state"]),
                              tree_flatten_with_paths(restored)):
        bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
        if a.dtype != b.dtype or b.device != a.device or not torch.equal(a.view(bits),
                                                                         b.view(bits)):
            raise AssertionError(f"train checkpoint step {saved['step']}: leaf {p} differs")
    shutil.rmtree(directory, ignore_errors=True)
    lat = app.stats.latency
    tokens = app.stats.items
    wall = run.wall
    step_s = [b.processing_delay for b in stream.stats.history]
    # a step's wall: process() of its batch, which waits for the step two
    # before it (the app's async window), so in steady state the step period
    out = {"path": "train", "steps": steps, "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "step_wall_p50_s": stream.latency.p50,
           "step_wall_p99_s": stream.latency.p99, "first_step_s": step_s[0],
           "batch_latency_p50_s": lat.p50, "batch_latency_p99_s": lat.p99,
           "peak_memory_gib": peak / 2 ** 30, "memory_before_gib": baseline / 2 ** 30,
           "losses": losses,
           "checkpoint": {"step": saved["step"], "offsets": meta["offsets"], "bitwise": True},
           "launches_per_step": {k: launches[k] / steps for k in want},
           "card_vs_cpu": train_check_step(torch, state["params"]["embed"].device),
           "card_vs_cpu_moe": train_check_moe(torch, state["params"]["embed"].device)}
    print("path " + json.dumps(out))
    return {"report": out, "launches": launches}


def falls_on_one_batch(losses: list) -> list:
    """The losses of two steps on one batch from the state as drawn: the
    second must be lower, as ``tests/test_models.py`` holds every arch
    after one step from its init (later in a run, at these models' lr the
    loss on a batch seen before may rise again)."""
    if not (all(math.isfinite(x) for x in losses) and losses[1] < losses[0]):
        raise AssertionError(f"one batch repeated: losses {losses}")
    return losses


def family_train_stub(torch, kernels, name: str, device, lr: float = TRAIN_LR, cfg=None,
                      steps: int = FAM_TRAIN_STEPS) -> dict:
    """llava-next (FAM_LLAVA_LAYERS layers) or seamless-m4t (full depth) at
    full width, bf16 params, or ``cfg`` where given, through
    ``build_train_step`` (adamw, lr ``lr``, TRAIN_WARMUP warm-up steps,
    cosine over at least 10 steps, f32 moments): ``steps`` steps of
    TRAIN_BATCH x TRAIN_SEQ zipf tokens and stub embeddings drawn on the card
    (the config's patches, or FAM_FRAMES frames), the first two on one batch
    (``falls_on_one_batch``), each step timed to its loss on the host; the
    launch counts are read when the steps are done."""
    import numpy as np

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_train_step

    if cfg is None:
        cfg = get_arch(name)
        if cfg.family == "vlm":
            cfg = cfg.replace(n_layers=FAM_LLAVA_LAYERS)
    model = build_model(cfg)
    n_stub = cfg.n_patches if cfg.family == "vlm" else FAM_FRAMES
    opt_cfg = OptimizerConfig(name=cfg.optimizer, learning_rate=lr,
                              warmup_steps=TRAIN_WARMUP, total_steps=max(steps, 10))
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = model.init(gen)
    state = {"params": params, "opt": Optimizer(opt_cfg).init(params)}
    step = build_train_step(model, ShapeConfig("stream", TRAIN_SEQ, TRAIN_BATCH, "train"),
                            opt_cfg, device=device)
    tokens = np.minimum(np.random.default_rng(SEED).zipf(
        1.3, size=(steps - 1, TRAIN_BATCH, TRAIN_SEQ)) - 1, cfg.vocab_size - 1)

    def batch(i):
        stub = torch.randn((TRAIN_BATCH, n_stub, cfg.d_model), generator=gen, device=device,
                           dtype=torch.float32).to(model.compute_dtype)
        return _stub_batch(cfg, tokens[i].astype(np.int32), stub)

    kernels.reset_launches()
    losses, walls = [], []
    first = batch(0)
    for i in range(steps):  # steps 1 and 2 on one batch; each later batch drawn in turn
        b = first if i < 2 else batch(i - 1)
        t0 = time.perf_counter()
        params, opt, met = step(state["params"], state["opt"], b)
        losses.append(float(met["loss"]))  # waits for the step
        walls.append(time.perf_counter() - t0)
        state = {"params": params, "opt": opt}
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    res = {"model": name, "route": "build_train_step", "layers": cfg.n_layers,
           "steps": steps, "losses": losses, "launches": launches,
           "tokens": steps * TRAIN_BATCH * TRAIN_SEQ,
           "positions": steps * TRAIN_BATCH * (TRAIN_SEQ + n_stub),
           "wall_s": sum(walls), "first_step_s": walls[0],
           "step_wall_p50_s": float(np.median(walls[1:])),
           "repeated_batch_losses": falls_on_one_batch(losses[:2]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    res["state"] = state
    return res


def family_train_stream(torch, kernels, name: str, lr: float = TRAIN_LR) -> dict:
    """rwkv6-3b or zamba2-1.2b at full width and depth, bf16 params, through
    the launcher users run: ``launch/train.py``'s ``run`` with ``--steps
    FAM_TRAIN_STEPS``, TRAIN_BATCH x TRAIN_SEQ token messages, lr ``lr``
    and ``--checkpoint-every`` past the last step (no 31 GB write); the
    launch counts are read when the stream has stopped. Before it, the
    app's step on one batch twice from the state the launcher draws
    (``falls_on_one_batch``: its messages are all different)."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.miniapps import LMTrainApp
    from repro_torch.runtime.optimizer import OptimizerConfig

    # first, the app's own step on one batch twice from the state the
    # launcher draws (its optimizer settings: lr, 5 warm-up steps)
    cfg = get_arch(name)
    app = LMTrainApp(cfg, opt_cfg=OptimizerConfig(
        name=cfg.optimizer, learning_rate=lr, warmup_steps=TRAIN_WARMUP,
        total_steps=max(FAM_TRAIN_STEPS, 10)), seqs_per_step=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    batch = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1)[0]
    state, first = app.init_state(), []
    for _ in range(2):
        params, opt, met = app.step_fn(state["params"], state["opt"], batch)
        state = {"params": params, "opt": opt}
        first.append(float(met["loss"]))
    del app, state, params, opt
    falls_on_one_batch(first)
    gc.collect()
    torch.cuda.empty_cache()
    directory = ROOT / "build" / "train_families"
    args = train.parse_args(["--arch", name, "--steps", str(FAM_TRAIN_STEPS),
                             "--seq-len", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
                             "--lr", str(lr), "--checkpoint-dir", str(directory),
                             "--checkpoint-every", str(10 ** 6)])
    kernels.reset_launches()
    run = train.run(args)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    app, stream, state = run.app, run.stream, run.stream.state
    losses = app.losses
    steps = int(state["opt"]["step"])
    if steps != app.stats.batches or steps < FAM_TRAIN_STEPS or len(losses) != steps:
        raise AssertionError(f"{name}: {steps} optimizer steps, {app.stats.batches} batches, "
                             f"{len(losses)} losses")
    if any(directory.glob("step_*")):
        raise AssertionError(f"{name}: a checkpoint was written under {directory}")
    return {"model": name, "route": "launch/train.py run", "layers": app.cfg.n_layers,
            "steps": steps, "losses": losses, "launches": launches, "tokens": app.stats.items,
            "positions": app.stats.items, "wall_s": run.wall,
            "first_step_s": stream.stats.history[0].processing_delay,
            "step_wall_p50_s": stream.latency.p50, "step_wall_p99_s": stream.latency.p99,
            "repeated_batch_losses": first,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "state": state}


def family_check(name: str, compute_dtype: str | None = None,
                 layers: int = TRAIN_CHECK_LAYERS) -> tuple:
    """``name`` at full width but ``layers`` layers (and as many
    encoder layers), f32 params, computing in ``compute_dtype`` (the
    config's own by default), and its TRAIN_CHECK_STEPS batches of
    FAM_TCHECK_BATCH x FAM_TCHECK_TOKENS tokens (llava behind
    FAM_TCHECK_PATCHES patches, seamless beside twice as many frames)."""
    from repro_torch.configs import get_arch

    full = get_arch(name)
    over = {"n_layers": layers, "param_dtype": "float32"}
    if full.n_enc_layers:
        over["n_enc_layers"] = layers
    if full.n_patches:
        over["n_patches"] = FAM_TCHECK_PATCHES
    if compute_dtype:
        over["compute_dtype"] = compute_dtype
    cfg = full.replace(**over)
    n_stub = cfg.n_patches if cfg.family == "vlm" else 2 * FAM_TCHECK_TOKENS
    return cfg, train_batches(cfg, FAM_TCHECK_BATCH, FAM_TCHECK_TOKENS, TRAIN_CHECK_STEPS, n_stub)


def families_train_path(torch, kernels, device) -> dict:
    """The families training phase (see FAM_BWD's comment): each family at
    full width, one at a time, freed before the next is drawn, every
    kernel's launch count set to 0 before its steps and read when they are
    done; checks: every loss finite, the repeated batch's second loss below
    its first, params and moments on the card, flash launches a step as
    ``flash_per_step`` gives them (none for rwkv6). Prints a ``path`` line
    per family (tokens/s over the steps' wall, step wall p50, the first
    step apart, peak memory, launches a step, the card and its power limit).
    Then each family at
    ``family_check``'s size, card against CPU (a ``train_card_vs_cpu`` line
    each), and one ``path families_train`` summary with the phase's wall."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.utils import tree_flatten_with_paths

    card = card_line()
    t_phase = time.perf_counter()
    dynamo_before = "torch._dynamo" in sys.modules
    launches = {k.name: 0 for k in kernels.KERNELS}
    reports = []
    for name in FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if get_arch(name).family in ("vlm", "encdec"):
            res = family_train_stub(torch, kernels, name, device)
        else:
            res = family_train_stream(torch, kernels, name)
        state = res.pop("state")
        flat = tree_flatten_with_paths(state)
        off = [p for p, x in flat if x.device.type != "cuda"]
        res["state_gib"] = sum(x.numel() * x.element_size() for _, x in flat) / 2 ** 30
        del state, flat
        cfg = get_arch(name).replace(n_layers=res["layers"])
        fwd, bwd = flash_per_step(cfg)
        steps, run = res["steps"], res["launches"]
        want = {"flash_attention": fwd * steps, "flash_attention_bwd_dq": bwd * steps,
                "flash_attention_bwd_dkdv": bwd * steps}
        got = {k: run[k] for k in want}
        for k, n in run.items():
            launches[k] += n
        report = {"path": f"train_{cfg.family}", **{k: v for k, v in res.items() if k != "launches"},
                  "tokens_per_s": res["tokens"] / res["wall_s"],
                  "positions_per_s": res["positions"] / res["wall_s"],
                  "launches_per_step": {k: n / steps for k, n in got.items()},
                  "torch_dynamo_imported_before": dynamo_before, "card": card}
        print("path " + json.dumps(report))
        if off:
            raise AssertionError(f"{name}: train state off the card: {off}")
        if got != want or any(not math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"{name}: launches {got}, want {want}; losses {res['losses']}")
        reports.append(report)
    gc.collect()
    torch.cuda.empty_cache()
    checks = []
    for name in FAMILIES:
        cfg, batches = family_check(name, "float32" if name in FAM_TCHECK_F32 else None,
                                    FAM_TCHECK_LAYERS)
        checks.append({"model": name, **train_check_step(torch, device, cfg, batches)})
        print("train_card_vs_cpu " + json.dumps(checks[-1]))
        gc.collect()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print("path " + json.dumps({"path": "families_train", "seconds": seconds,
                                "models": [r["model"] for r in reports],
                                "launches": {k: n for k, n in launches.items() if n}}))
    return {"reports": reports, "checks": checks, "launches": launches, "seconds": seconds}


def stream_train(torch, kernels, miniapps, cluster, ctx, cfg, device, steps: int) -> dict:
    """``cfg`` trained from the broker into ``LMTrainApp`` as
    ``launch/train.py`` wires the two (adamw at TRAINED_LR, TRAIN_WARMUP
    warm-up steps, cosine over the run; one message of TRAIN_BATCH x
    TRAIN_SEQ zipf tokens a step, state drawn by ``init_state(SEED)``), but
    from one producer into a topic of one partition, so that the messages
    arrive in the order the source's generator (seeded SEED) drew them and
    the weights come out the same from the same seed. The launch counts are
    read when the stream has stopped and the app has synced."""
    from repro_torch.runtime.optimizer import OptimizerConfig

    topic = f"train_{cfg.name}"
    cluster.create_topic(topic, 1)
    app = miniapps.LMTrainApp(cfg, opt_cfg=OptimizerConfig(
        name=cfg.optimizer, learning_rate=TRAINED_LR, warmup_steps=TRAIN_WARMUP,
        total_steps=steps), seqs_per_step=TRAIN_BATCH, seq_len=TRAIN_SEQ, device=device)
    source = miniapps.TokenSource(
        cluster, miniapps.SourceConfig(topic, total_messages=steps, seed=SEED),
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, seqs_per_msg=TRAIN_BATCH)
    stream = ctx.stream(cluster, topic, group=topic, process_fn=app.process,
                        state=app.init_state(SEED), batch_interval=0.2, max_batch_records=1)
    kernels.reset_launches()
    wall = drive(stream, source, steps, 600)
    app.sync()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    ctx.streams.remove(stream)  # the stopped stream holds the state
    losses = app.losses
    if not (app.stats.batches == len(losses) == int(stream.state["opt"]["step"]) == steps):
        raise AssertionError(f"{cfg.name}: {app.stats.batches} batches, {len(losses)} losses "
                             f"for {steps} messages")
    return {"model": cfg.name, "route": "broker -> LMTrainApp", "layers": cfg.n_layers,
            "steps": steps, "losses": losses, "launches": launches, "wall_s": wall,
            "first_step_s": stream.stats.history[0].processing_delay,
            "step_wall_p50_s": stream.latency.p50,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "state": stream.state}


def loss_curve(losses: list) -> dict:
    """A training run's loss curve: the first and last loss, the mean of
    every TRAINED_WINDOW steps, and the step (from 1) from which the mean of
    TRAINED_WINDOW losses stays within TRAINED_FLAT_REL of the last window's
    mean."""
    w = TRAINED_WINDOW
    means = [sum(losses[i:i + w]) / w for i in range(len(losses) - w + 1)]
    last = means[-1]
    flat = len(means) - 1
    while flat > 0 and abs(means[flat - 1] - last) <= TRAINED_FLAT_REL * last:
        flat -= 1
    return {"first": losses[0], "last": losses[-1], "window": w,
            "window_means": means[::w], "last_window_mean": last,
            "flattened_at_step": flat + 1, "flat_rel": TRAINED_FLAT_REL}


def weights_digest(torch, params) -> str:
    """A digest of every leaf's path and bytes: two runs that trained alike
    bit for bit print the same one."""
    import hashlib

    from repro_torch.utils import tree_flatten_with_paths

    h = hashlib.sha256()
    for path, x in tree_flatten_with_paths(params):
        bits = x.detach().contiguous().view({4: torch.int32, 2: torch.int16}[x.element_size()])
        h.update(path.encode())
        h.update(bits.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def train_family(torch, kernels, miniapps, cluster, ctx, name: str, device) -> tuple:
    """``name`` at family_check's size in f32 (FAM_TCHECK_LAYERS layer)
    trained on the card for TRAINED_STEPS steps: llava through
    ``family_train_stub``, rwkv6 and zamba2 through ``stream_train`` on
    ``cluster`` and ``ctx``. Holds every loss finite, the last window's mean
    below the first's and the flash launches a step ``flash_per_step``
    gives. Returns the trained params, the run's report (the loss curve,
    the weights' digest, the wall, the flash launches) and every kernel's
    launches."""
    cfg = family_check(name, "float32", FAM_TCHECK_LAYERS)[0]
    if cfg.family == "vlm":
        res = family_train_stub(torch, kernels, name, device, TRAINED_LR, cfg, TRAINED_STEPS)
    else:
        res = stream_train(torch, kernels, miniapps, cluster, ctx, cfg, device, TRAINED_STEPS)
    params = res.pop("state")["params"]
    fwd, bwd = flash_per_step(cfg)
    want = {"flash_attention": fwd * TRAINED_STEPS, "flash_attention_bwd_dq": bwd * TRAINED_STEPS,
            "flash_attention_bwd_dkdv": bwd * TRAINED_STEPS}
    got = {k: res["launches"][k] for k in want}
    curve = loss_curve(res["losses"])
    report = {"model": name, "route": res["route"], "layers": cfg.n_layers,
              "steps": TRAINED_STEPS, "curve": curve, "wall_s": res["wall_s"],
              "step_wall_p50_s": res["step_wall_p50_s"], "peak_gib": res["peak_gib"],
              "launches": got, "weights_digest": weights_digest(torch, params)}
    if got != want or not all(math.isfinite(x) for x in res["losses"]) or \
            not curve["last_window_mean"] < curve["window_means"][0]:
        raise AssertionError(f"{name}: trained launches {got}, want {want}; curve {curve}")
    return params, report, res["launches"]


def trained_path(torch, kernels, miniapps, device) -> dict:
    """The trained phase (see the comment above TRAINED_STEPS), one family at a
    time, each freed before the next is drawn: its training on the card
    (every loss finite, the last window's mean below the first's, the flash
    launches a step ``flash_per_step`` gives; a ``trained`` line with the
    loss curve and the weights' digest), then from those weights the bf16
    train check card against CPU (a ``train_card_vs_cpu`` line with
    ``"weights": "trained"``; read, not held, by decision: ROADMAP C13), then,
    for rwkv6 and zamba2, serving in bf16 through ``family_stream_serve``
    (LMServeApp lockstep from the broker) with every served token re-scored
    whose context a prefill takes (a whole number of FAM_STATE_CHUNK), held
    (``rescore``). Every kernel's
    launch count is set to 0 before a training or serving run and read when
    it is done. Prints one ``path trained`` line."""
    import gc

    from repro_torch.core import PilotComputeService
    from repro_torch.models import build_model

    card = card_line()
    t_phase = time.perf_counter()
    launches = {k.name: 0 for k in kernels.KERNELS}
    checks, rescores, seconds = [], [], {}
    svc = PilotComputeService(devices=[device])
    try:
        cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
        ctx = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"}).get_context()
        for name in FAM_TCHECK_F32:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cfg = family_check(name, "float32", FAM_TCHECK_LAYERS)[0]
            params, report, run = train_family(torch, kernels, miniapps, cluster, ctx, name,
                                               device)
            for k, n in run.items():
                launches[k] += n
            print("trained " + json.dumps({**report, "card": card}))
            t1 = time.perf_counter()
            bcfg, batches = family_check(name, "bfloat16", FAM_TCHECK_LAYERS)
            # read, not held: every family of FAM_TCHECK_F32 stays there (C13)
            checks.append({"model": name, "weights": "trained",
                           **train_check_step(torch, device, bcfg, batches, params,
                                              enforce=False)})
            print("train_card_vs_cpu " + json.dumps(checks[-1]))
            t2 = time.perf_counter()
            if cfg.family in ("ssm", "hybrid"):
                model = build_model(cfg.replace(compute_dtype="bfloat16"))
                kernels.reset_launches()
                served = family_stream_serve(torch, kernels, miniapps, cluster, ctx, device,
                                             model, params)
                for k, n in served["launches"].items():
                    launches[k] += n
                P = served["served"][0][0].shape[1]
                steps = [t for t in range(FAM_STATE_GEN)
                         if (P + t) % FAM_STATE_CHUNK[cfg.family] == 0]
                rescores.append(rescore(torch, model, params, served["served"], steps=steps))
                del model, served
            seconds[name] = {"train": t1 - t0, "check": t2 - t1,
                             "serve": time.perf_counter() - t2}
            del params
    finally:
        svc.cancel()
    gc.collect()
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_phase
    print("path " + json.dumps({"path": "trained", "seconds": total, "by_model": seconds,
                                "launches": {k: n for k, n in launches.items() if n},
                                "card": card}))
    return {"checks": checks, "rescores": rescores, "launches": launches, "seconds": total}


def bf16_product_shapes(torch, device) -> dict:
    """Every bf16 matrix product (``aten`` mm, addmm, bmm, baddbmm) of
    BF16_PRODUCT_MODELS at FAM_TCHECK_LAYERS layer (f32 params drawn on
    ``device`` from SEED, bf16 compute, no remat): each family's loss and
    backward on family_check's first batch, and each model's decode step at
    SERVE_BATCH rows after a prefill of FAM_TCHECK_TOKENS tokens (and stub
    embeddings). Returns {(batch, M, K, N, a transposed, b transposed): the
    sorted "model part" labels that ran it}."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.utils import tree_map_with_paths

    aten = torch.ops.aten
    pairs = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
             aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2)}
    seen: dict = {}

    class Record(TorchDispatchMode):
        def __init__(self, label: str):
            super().__init__()
            self.label = label

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in pairs:
                a, b = (args[i] for i in pairs[func])
                if a.dtype == torch.bfloat16:
                    key = (a.shape[0] if a.dim() == 3 else 1, a.shape[-2], a.shape[-1],
                           b.shape[-1], a.stride(-1) != 1, b.stride(-1) != 1)
                    seen.setdefault(key, set()).add(self.label)
            return func(*args, **(kwargs or {}))

    for name in BF16_PRODUCT_MODELS:
        if name in FAMILIES:
            cfg, batches = family_check(name, "bfloat16", FAM_TCHECK_LAYERS)
        else:
            cfg, batches = get_arch(name).replace(n_layers=FAM_TCHECK_LAYERS,
                                                  compute_dtype="bfloat16"), None
        model = build_model(cfg.replace(remat="none"))
        gen = torch.Generator(device=device).manual_seed(SEED)
        params = model.init(gen)
        if batches is not None:
            p = tree_map_with_paths(lambda _, x: x.detach().requires_grad_(True), params)
            with Record(f"{name} train"):
                loss, _ = model.loss(p, {k: torch.as_tensor(v).to(device)
                                         for k, v in batches[0].items()})
                torch.autograd.grad(loss, tree_leaves(p))
            del p, loss
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, FAM_TCHECK_TOKENS),
                               generator=gen, device=device, dtype=torch.int32)
        batch = {"tokens": tokens}
        if cfg.family in ("vlm", "encdec"):
            n = cfg.n_patches if cfg.family == "vlm" else FAM_TCHECK_TOKENS
            batch = _stub_batch(cfg, tokens, torch.randn(
                (SERVE_BATCH, n, cfg.d_model), generator=gen, device=device).to(torch.bfloat16))
        s = FAM_TCHECK_TOKENS + (cfg.n_patches if cfg.family == "vlm" else 0)
        cp = model.compute_params(params)
        with torch.no_grad():
            logits, cache = model.prefill(cp, batch, cache_len=s + 1)
            with Record(f"{name} decode"):
                model.decode(cp, cache, {"tokens": tokens[:, -1:],
                                         "positions": torch.full((SERVE_BATCH,), s,
                                                                 dtype=torch.int32, device=device)})
        del params, cp, cache, logits
        torch.cuda.empty_cache()
    return {k: sorted(v) for k, v in seen.items()}


@contextlib.contextmanager
def reduction(torch, allow: bool):
    """``allow_bf16_reduced_precision_reduction`` set to ``allow`` (read
    back) for the block, restored after it."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = allow
    try:
        if matmul.allow_bf16_reduced_precision_reduction != allow:
            raise AssertionError(f"allow_bf16_reduced_precision_reduction did not take {allow}")
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved


def bf16_products(torch, device, torch_default: bool) -> dict:
    """The bf16 products of ``bf16_product_shapes`` on the card, each on
    unit-normal operands (its layouts kept), under
    ``allow_bf16_reduced_precision_reduction`` = ``torch_default`` (the value
    torch set before this run changed anything) and False, the flag read back
    each time and restored after it (``reduction``): per product, the share of elements of
    ``a @ b`` (bf16 in and out) more than one bf16 ulp (of the f32 product
    rounded once, 2^(e - 8) for a value in [2^(e-1), 2^e)) from that
    rounding, the share that differ at all and the most ulps (each over the
    elements of at least BF16_PRODUCT_FLOOR of the output's rms), and the
    product's device time. Printed as one ``bf16_products`` line. Fails if any product
    rounds twice in either state: the port leaves the flag as torch sets it
    because none does."""
    port_flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    states = {"torch_default": torch_default, "off": False}
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows, worst = [], {s: 0.0 for s in states}
    shapes = bf16_product_shapes(torch, device)
    for (nb, m, k, n, a_t, b_t), labels in sorted(shapes.items()):
        lead = (nb,) if nb > 1 else ()

        def operand(r: int, c: int, transposed: bool):
            x = torch.randn(lead + ((c, r) if transposed else (r, c)), generator=gen,
                            device=device).to(torch.bfloat16)
            return x.transpose(-1, -2) if transposed else x

        a, b = operand(m, k, a_t), operand(k, n, b_t)
        once = (a.float() @ b.float()).to(torch.bfloat16).float()
        ulp = torch.ldexp(torch.ones_like(once), torch.frexp(once).exponent - 8)
        held = once.abs() >= BF16_PRODUCT_FLOOR * once.square().mean().sqrt()
        row = {"batch": nb, "M": m, "K": k, "N": n, "a_transposed": a_t,
               "b_transposed": b_t, "from": labels}
        for state, value in states.items():
            with reduction(torch, value):
                got = (a @ b).float()
                ms = graph_ms(torch, lambda: a @ b, 10, 3)
            off = (got - once).abs()
            row[state] = {"flag": value,
                          "share_over_1ulp": float((off > ulp)[held].float().mean()),
                          "share_differing": float((off > 0)[held].float().mean()),
                          "max_ulps": float((off / ulp)[held].max()), "ms": ms}
            worst[state] = max(worst[state], row[state]["share_over_1ulp"])
        rows.append(row)
        del a, b, once, ulp, held, got, off
    res = {"products": len(rows), "torch_default_flag": torch_default,
           "port_flag": port_flag, "worst_share_over_1ulp": worst,
           "rounding_twice": [f"{r['batch']}x{r['M']}x{r['K']}x{r['N']}" for r in rows
                              if r["torch_default"]["share_over_1ulp"] > 0],
           "rows": rows}
    print("bf16_products " + json.dumps(res))
    if any(worst.values()):
        raise AssertionError(f"bf16 products round twice: {worst}; with the flag as the port "
                             f"runs it: {res['rounding_twice']}")
    return res


def pipeline_spec(pipeline):
    """The pipeline phase's spec, built by the port's ``Pipeline``."""
    return (pipeline.Pipeline.named("smoke")
            .broker(nodes=1)
            .topic("frames", partitions=4).topic("points", partitions=8)
            .source("frames", kind="lightsource", seed=SEED, total_messages=PIPE_FRAMES,
                    rate_msgs_per_s=PIPE_FRAME_SCHEDULE[0][1],
                    rate_schedule=list(PIPE_FRAME_SCHEDULE),
                    n_angles=FRAME_ANGLES, n_det=FRAME_BINS)
            .source("points", kind="cluster", seed=SEED, total_messages=PIPE_POINTS,
                    rate_msgs_per_s=PIPE_POINTS_RATE, n_clusters=10, dim=3, points_per_msg=5000)
            .stage("recon", topic="frames", processor="mlem", n=RECON_N, mlem_iters=MLEM_ITERS,
                   max_batch_records=PIPE_RECON_BATCH, batch_interval=0.05,
                   backpressure=PIPE_RECON_RATE_CONTROL)
            .stage("kmeans", topic="points", processor="kmeans", n_clusters=10, dim=3, seed=SEED,
                   max_batch_records=16, batch_interval=0.05)
            .elastic("recon", policy="threshold", high_lag=24, low_lag=4, min_devices=1,
                     max_devices=4, interval=0.2, cooldown=1.0)
            .build())


def pipeline_cli(pipeline) -> dict:
    """``python -m repro_torch.pipeline validate`` in a fresh interpreter
    on the phase's spec written as JSON and on three variants: its K-Means
    stage as a continuous stage with crash checkpoints, that stage on worker
    processes (``executor="mp"``), and the broker and the ML-EM stage on the
    shared-memory transport (``transport="shm"``). Each must exit 0."""
    import dataclasses

    spec = pipeline_spec(pipeline)

    def continuous(**kw):
        return dataclasses.replace(spec, stages=tuple(
            dataclasses.replace(st, engine="continuous", checkpoint_every=CONT_CKPT,
                                window={"window": "tumbling", "size": CONT_WINDOW}, **kw)
            if st.name == "kmeans" else st for st in spec.stages))
    shm = dataclasses.replace(
        spec, broker=dataclasses.replace(spec.broker, transport="shm",
                                         transport_options=dict(TRANS_RING)),
        stages=tuple(dataclasses.replace(st, transport="shm") if st.name == "recon" else st
                     for st in spec.stages))
    out_dir = ROOT / "build" / "pipeline_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}
    for name, sp in (("valid", spec), ("continuous", continuous()),
                     ("mp", continuous(executor="mp")), ("shm", shm)):
        path = out_dir / f"{name}.json"
        path.write_text(sp.to_json(indent=1))
        proc = subprocess.run([sys.executable, "-m", "repro_torch.pipeline", "validate", str(path)],
                              capture_output=True, text=True, timeout=300, cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        if proc.returncode != 0:
            raise AssertionError(f"pipeline CLI validate {name}: exit {proc.returncode}, want "
                                 f"0\n{proc.stdout}{proc.stderr}")
        res[name] = {"exit": proc.returncode,
                     "said": (proc.stdout + proc.stderr).strip().splitlines()[-1]}
    return res


def pipeline_path(torch, kernels, pipeline, kmeans, tomo) -> dict:
    """The pipeline phase: :func:`pipeline_spec` through ``spec.run(devices=
    PIPE_SLOTS)`` on the card until both streams have drained and the ML-EM
    stage has scaled up and down again (or PIPE_TIMEOUT_S, which fails the
    run). Checks every message processed, the arbiter within the pool, the
    kernels launched, the apps on the card, K-Means inertia falling, the
    last reconstruction against the plain version, and the teardown in
    reverse start order with no errors."""
    import numpy as np

    spec = pipeline_spec(pipeline)
    run = spec.run(devices=PIPE_SLOTS)
    kernels.reset_launches()
    t0 = time.monotonic()
    # every 0.25 s: [t, ML-EM slots, its lag, frames sent, frames processed]
    timeline: list[list] = []
    with run:
        ctl = run.controller("recon")
        frames, recon = run.source("frames"), run.stream("recon")
        while True:
            now = time.monotonic() - t0
            if not timeline or now - timeline[-1][0] >= 0.25:
                timeline.append([round(now, 3), ctl.devices, run.lag("recon"),
                                 frames.sent_records, recon.stats.records])
            drained = run.sources_finished and all(
                run.lag(st) == 0 and run.stream(st).stats.records
                == run.source(spec.stage(st).topic).sent_records for st in ("recon", "kmeans"))
            if drained and ctl.events.of("scale_up") and ctl.events.of("scale_down"):
                break
            if now > PIPE_TIMEOUT_S:
                print("pipeline_timeline " + json.dumps(timeline))
                raise AssertionError(
                    f"pipeline phase: not done after {PIPE_TIMEOUT_S} s: drained {drained}, "
                    f"events {[(e.action, e.devices_after) for e in ctl.events]}, lag "
                    f"{ {st: run.lag(st) for st in ('recon', 'kmeans')} }, controller error "
                    f"{ctl._last_error!r}")
            time.sleep(0.05)
        wall = time.monotonic() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if run.errors:
        raise AssertionError(f"pipeline teardown errors: {run.errors!r}")
    started = ["service", "arbiter"] + [f"stream:{st.name}" for st in spec.stages] + [
        "controller:recon", "source:frames", "scenario:frames", "source:points"]
    if run.teardown_log != started[::-1]:
        raise AssertionError(f"pipeline teardown order {run.teardown_log}, want {started[::-1]}")
    free = [v for _, v in run.bus.series("scheduler.free")]
    if not free or min(free) < 0:
        raise AssertionError(f"scheduler.free left the pool: {free}")
    if max(e.devices_after for e in ctl.events) > PIPE_SLOTS:
        raise AssertionError(f"recon held more slots than the pool: {list(ctl.events)}")
    for name in ("kmeans_assign", "kmeans_update", "tomo_project", "tomo_backproject"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched in the pipeline phase")
    km_app, rc_app = run.processor("kmeans"), run.processor("recon")
    km_state, rc_state = run.stream("kmeans").state, run.stream("recon").state
    for name, x in (("kmeans app", km_app.device), ("kmeans state", km_state.device),
                    ("recon app", rc_app.device), ("recon state", rc_state.device)):
        if x.type != "cuda":
            raise AssertionError(f"pipeline phase: {name} on {x}, not the card")

    # inertia of the initial and the final centroids on one fresh message
    # of the cluster stream: the stream's updates must have lowered it
    pts = torch.from_numpy(run.source("points").make_message(
        np.random.default_rng(SEED + 1), 0).astype(np.float32)).to(km_state.device)
    inertia = [float(kmeans.assign(pts, c.contiguous())[1].mean())
               for c in (km_app.centroids, km_state)]
    if not inertia[1] < inertia[0]:
        raise AssertionError(f"pipeline K-Means inertia did not fall: {inertia}")
    vs_plain = recon_vs_plain(torch, tomo, "mlem", rc_state, run.source("frames")._payload,
                              rc_state.device)

    stages = {}
    for st in ("recon", "kmeans"):
        lat = run.processor(st).stats.latency
        records = run.stream(st).stats.records
        stages[st] = {"records": records, "sent": run.source(spec.stage(st).topic).sent_records,
                      "batches": run.stream(st).stats.batches, "msgs_per_s": records / wall,
                      "latency_p50_s": lat.p50, "latency_p99_s": lat.p99}
    out = {"path": "pipeline", "slots": PIPE_SLOTS, "wall_s": wall, "stages": stages,
           "events": [[round(e.t - t0, 3), e.action, e.devices_after] for e in ctl.events],
           "scheduler_free_min": min(free), "inertia_first_last": inertia,
           "recon_vs_plain": vs_plain, "launches": launches,
           "timeline_t_slots_lag_sent_processed": timeline}
    print("path " + json.dumps(out))
    out["cli"] = pipeline_cli(pipeline)
    print("pipeline_cli " + json.dumps(out["cli"]))
    return {"report": out, "launches": launches}


def cont_message(i: int):
    """Message i of the continuous phase: CONT_POINTS points around the
    stream's CONT_K centres, from a generator seeded with (SEED, i)."""
    import numpy as np

    centers = np.random.default_rng((SEED, 1)).normal(size=(CONT_K, 3)) * 4.0
    g = np.random.default_rng((SEED, i))
    return centers[g.integers(CONT_K, size=CONT_POINTS)] + g.normal(size=(CONT_POINTS, 3))


def cont_centroids(key: int):
    """The CONT_K f32 starting centroids of one key, fixed from SEED."""
    import numpy as np

    centers = np.random.default_rng((SEED, 1)).normal(size=(CONT_K, 3)) * 4.0
    return (centers + np.random.default_rng((SEED, 2, key)).normal(size=(CONT_K, 3))).astype(
        np.float32)


class KMeansWindows:
    """The continuous phase's window processor, at module level so that a
    spawned worker (the mp runs' stage on the card) can unpickle it. Per
    (key, window): the window's points stacked onto the card,
    ``kmeans_assign`` against the key's centroids, ``kmeans_update``, and
    the window's centroids, inertia and message count back on the host —
    with the kernel launches the call made when it ran in a worker process,
    whose counts the parent's do not see. Records are keyed by their
    offset: on the phase's one-partition topic the offset is the message
    index. ``emit`` (in the parent) collects each delivered firing, counts
    duplicates and sums the workers' launches. It pickles without the card:
    a worker rebuilds the centroids on its own device and runs one warm-up
    window there before its first beat."""

    #: the mp stage's runtime knobs (the runner passes them through): a
    #: checkpoint every 16 polls keeps a killed worker's replay short
    worker_options = {"snapshot_every": 16}

    def __init__(self, device="cuda", metrics=None):
        import torch

        self.device = torch.device(device)
        self._home = os.getpid()
        self._reset()

    def _reset(self) -> None:
        self.outputs: dict = {}
        self.duplicates = 0
        self.worker_launches: dict = {}
        self._centroids: dict = {}

    def __getstate__(self):
        return {"device": self.device, "_home": self._home}

    def __setstate__(self, state):
        import torch

        from repro_torch.kernels import kmeans

        self.__dict__.update(state)
        self._reset()
        window_kmeans(torch, kmeans, torch.zeros((CONT_POINTS, 3), device=self.device),
                      self._key_centroids(0))

    def _key_centroids(self, key: int):
        import torch

        if key not in self._centroids:
            self._centroids[key] = torch.from_numpy(cont_centroids(key)).to(self.device)
        return self._centroids[key]

    def key_fn(self, msg):
        return msg.offset % CONT_KEYS

    def process(self, key, window, msgs):
        import numpy as np
        import torch

        from repro_torch import kernels
        from repro_torch.kernels import kmeans

        before = [k.launches for k in kernels.KERNELS]
        pts = torch.from_numpy(np.concatenate([m.value for m in msgs]).astype(np.float32))
        out = window_kmeans(torch, kmeans, pts.to(self.device), self._key_centroids(key))
        launched = {} if os.getpid() == self._home else {
            k.name: k.launches - n for k, n in zip(kernels.KERNELS, before)}
        return (key, window) + out + (len(msgs), launched)

    def emit(self, out):
        kw = out[:2]
        self.duplicates += kw in self.outputs
        self.outputs[kw] = out[2:5]
        for name, n in out[5].items():
            self.worker_launches[name] = self.worker_launches.get(name, 0) + n


def continuous_registry(pipeline, miniapps) -> None:
    """Register the continuous phase's source and window processor with the
    port's pipeline registry."""

    class KeyedPoints(miniapps.StreamSource):
        """The phase's messages (:func:`cont_message`); event time from i."""

        def make_message(self, rng, i):
            return cont_message(i)

        def make_timestamp(self, rng, i):
            return CONT_BASE_TS + CONT_DT * i

    pipeline.register_source("smoke_keyed_points", KeyedPoints)
    pipeline.register_processor("smoke_kmeans_windows", KMeansWindows)


def window_kmeans(torch, kmeans, points, centroids) -> tuple:
    """One window's K-Means step: (new centroids as host numpy, inertia).
    Empty clusters keep their centroid."""
    labels, dist = kmeans.assign(points, centroids)
    sums, counts = kmeans.update_scatter(points, labels, centroids.shape[0])
    new = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], centroids)
    return new.cpu().numpy(), float(dist.sum())


def continuous_spec(pipeline, name: str, executor: str = "inline"):
    """The continuous phase's spec, built by the port's ``Pipeline``."""
    return (pipeline.Pipeline.named(name)
            .broker(nodes=1)
            .topic("kpoints", partitions=1)
            .source("kpoints", kind="smoke_keyed_points", seed=SEED, total_messages=CONT_MSGS,
                    rate_msgs_per_s=CONT_RATE)
            .stage("kwin", topic="kpoints", processor="smoke_kmeans_windows", engine="continuous",
                   window={"window": "tumbling", "size": CONT_WINDOW},
                   checkpoint_every=CONT_CKPT, executor=executor)
            .build())


def continuous_run(torch, kernels, pipeline, faults, mode: str, executor: str = "inline") -> dict:
    """One run of :func:`continuous_spec` on two slots of the card until
    every firing is delivered: ``mode`` "clean", "worker" (a worker process
    SIGKILLed, mp only), "kill" (FaultInjector kills the stage's pilot, the
    runner's StageReconciler recovers it and rehomes the partitions onto the
    new pilot's slots) or "rescale" (an extension pilot joins and leaves).
    Returns the firings, counters, launches (the parent's plus the
    workers') and timings; for mp also the workers' start and
    respawn-to-resumed seconds and the card's most used memory."""
    import signal

    spec = continuous_spec(pipeline, f"cont-{executor}-{mode}", executor)
    run = spec.run(devices=2)
    kernels.reset_launches()
    injector, ext, migrations = None, None, []
    t_kill = t_resumed = None  # host clock, polled every 5 ms
    runtimes: dict = {}  # every worker runtime the stage had (a recovery makes a new one)
    used_mib, t_mem = 0.0, 0.0
    timeout = CONT_MP_TIMEOUT_S if executor == "mp" else CONT_TIMEOUT_S
    with run:
        stream, proc = run.stream("kwin"), run.processor("kwin")
        t0 = time.monotonic()
        if mode == "kill":
            injector = faults.FaultInjector(
                faults.FaultSchedule.parse(f"kill_pilot @records={CONT_KILL_AT}"),
                cluster=run.cluster, topic="kpoints", stream=stream, service=run.service,
                pilot=run.pilot("kwin")).start()
        while (stream.stats.fired_windows < CONT_FIRINGS or stream.stats.records < CONT_MSGS
               or not run.sources_finished):
            if stream._error is not None:
                raise AssertionError(f"continuous {executor} {mode}: stream failed: "
                                     f"{stream._error!r}")
            if time.monotonic() - t0 > timeout:
                raise AssertionError(
                    f"continuous {executor} {mode}: {stream.stats.fired_windows}/{CONT_FIRINGS} "
                    f"firings after {timeout} s; events "
                    f"{injector.events if injector else []}; recovery errors "
                    f"{run.reconciler.errors}")
            if stream.runtime is not None:
                runtimes[id(stream.runtime)] = stream.runtime
                if torch.cuda.is_available() and time.monotonic() - t_mem > 0.25:
                    free, total = torch.cuda.mem_get_info()
                    used_mib, t_mem = max(used_mib, (total - free) / 2**20), time.monotonic()
            if mode == "worker" and t_kill is None and stream.stats.records >= CONT_KILL_AT:
                os.kill(stream.runtime._sups[0].process.pid, signal.SIGKILL)
                t_kill = time.monotonic()
            if mode == "worker" and t_kill is not None and t_resumed is None \
                    and stream.runtime.recovery_seconds:
                t_resumed = time.monotonic()
            if injector is not None and t_kill is None and injector.events:
                t_kill = time.monotonic()
            if mode == "kill" and t_kill is not None and t_resumed is None and stream.recoveries:
                t_resumed = time.monotonic()
            if mode == "rescale" and ext is None and stream.stats.records >= CONT_GROW_AT:
                ext = run.service.submit_pilot({"number_of_nodes": 1, "cores_per_node": 1,
                                                "type": "flink", "parent": run.pilot("kwin")})
            if mode == "rescale" and ext is not None and not migrations \
                    and stream.stats.records >= CONT_SHRINK_AT:
                ext.cancel()
                migrations = list(stream.migrator.reports)
            time.sleep(0.005)
        wall = time.monotonic() - t0
        if injector is not None:
            injector.stop()
        launches = {k.name: k.launches + proc.worker_launches.get(k.name, 0)
                    for k in kernels.KERNELS}
        plugin = run.pilot("kwin").plugin
        info = {"mode": mode, "executor": executor, "wall_s": wall,
                "msgs_per_s": CONT_MSGS / wall,
                "firings": stream.stats.fired_windows, "records": stream.stats.records,
                "late": stream.stats.late_records, "duplicates": proc.duplicates,
                "recoveries": stream.recoveries, "stage_recoveries": run.reconciler.recoveries,
                "recovery_ms": stream.last_recovery_ms,
                "kill_to_resumed_s": None if t_resumed is None else t_resumed - t_kill,
                "stage_recovery_ms": [ms for _, ms in run.reconciler.log],
                "fault_events": [[e.kind, e.records, e.detail] for e in injector.events]
                if injector else [],
                "slots": plugin.slots, "devices": [str(d) for d in plugin.devices],
                "owners": list(stream.store.owners),
                "migrations": [{"from": list(r.from_owners), "to": list(r.to_owners),
                                "moved_partitions": len(r.moved), "bytes": r.bytes_moved,
                                "records": r.buffered_records_moved, "ms": r.duration_ms}
                               for r in migrations],
                "launches": {k: launches[k] for k in ("kmeans_assign", "kmeans_update")},
                "launches_in_workers": {k: proc.worker_launches.get(k, 0)
                                        for k in ("kmeans_assign", "kmeans_update")},
                "app_device": str(proc.device)}
        if executor == "mp":
            info.update({
                "workers_started": sum(len(rt.start_seconds) for rt in runtimes.values()),
                "worker_start_s": [t for rt in runtimes.values() for t in rt.start_seconds],
                "worker_restarts": sum(rt.restarts for rt in runtimes.values()),
                "respawn_to_resumed_s": [t for rt in runtimes.values()
                                         for t in rt.recovery_seconds],
                "card_used_mib_max": used_mib})
        outputs = dict(proc.outputs)
    if run.errors:
        raise AssertionError(f"continuous {executor} {mode}: teardown errors {run.errors!r}")
    return {"info": info, "outputs": outputs, "launches": launches}


def window_reference(torch, kmeans, key: int, window: tuple) -> tuple:
    """One firing recomputed from the phase's messages with the plain
    versions on the CPU: (centroids, inertia, message count)."""
    import numpy as np

    first = round((window[0] - CONT_BASE_TS) / CONT_DT)
    last = round((window[1] - CONT_BASE_TS) / CONT_DT)
    idx = [i for i in range(first, last) if i % CONT_KEYS == key]
    pts = torch.from_numpy(np.concatenate([cont_message(i) for i in idx]).astype(np.float32))
    cent = torch.from_numpy(cont_centroids(key))
    labels, dist = kmeans.assign_ref(pts, cent)
    sums, counts = kmeans.update_scatter_ref(pts, labels, CONT_K)
    new = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], cent)
    return new.numpy(), float(dist.sum()), len(idx)


def hold_to_base(runs: dict, base: dict, label: str) -> None:
    """Every run fired every (key, window) once, in time, bitwise equal to
    ``base`` (centroids by their bits, inertia and count exactly), and
    launched both K-Means kernels at least once per firing."""
    import numpy as np

    for mode, r in runs.items():
        info = r["info"]
        if (info["firings"], info["records"], info["late"], info["duplicates"]) != (
                CONT_FIRINGS, CONT_MSGS, 0, 0):
            raise AssertionError(f"{label} {mode}: {info}")
        if r["outputs"].keys() != base.keys():
            raise AssertionError(f"{label} {mode}: other (key, window) set than the clean run")
        for kw, (cent, inertia, count) in base.items():
            c2, i2, n2 = r["outputs"][kw]
            if not (cent.dtype == c2.dtype and np.array_equal(cent.view(np.uint32),
                                                              c2.view(np.uint32))
                    and inertia == i2 and count == n2):
                raise AssertionError(f"{label} {mode}: firing {kw} differs from the clean run")
        for name, n in info["launches"].items():
            if n < CONT_FIRINGS:
                raise AssertionError(f"{label} {mode}: {name} launched {n} times for "
                                     f"{CONT_FIRINGS} firings")


def continuous_path(torch, kernels, pipeline, miniapps, kmeans) -> dict:
    """The continuous phase: the fault-free run, the pilot kill and the
    slot grow/shrink (:func:`continuous_run`), held to the fault-free run
    bitwise on every (key, window), with no firing lost, duplicated or
    late; the kill recovered at least once; the grow and shrink moving
    partitions between the two slots of the one card; both kernels launched
    at least once per firing; and sampled firings against the plain
    versions on the CPU. Then the same spec with ``executor="mp"``
    (spawned worker processes on the card): fault-free, a worker SIGKILLed,
    the pilot killed, and the grow and shrink, each held to the inline
    fault-free run the same way, with a worker restart, the owners on the
    new pilot's slots after the recovery, 32 of 64 partitions moved each
    way, and the kernels' launches counted in the workers."""
    import numpy as np

    from repro_torch import faults

    continuous_registry(pipeline, miniapps)
    runs = {mode: continuous_run(torch, kernels, pipeline, faults, mode)
            for mode in ("clean", "kill", "rescale")}
    base = runs["clean"]["outputs"]
    if len(base) != CONT_FIRINGS:
        raise AssertionError(f"continuous: {len(base)} firings, want {CONT_FIRINGS}")
    hold_to_base(runs, base, "continuous")
    kill, rescale = runs["kill"]["info"], runs["rescale"]["info"]
    if kill["recoveries"] < 1 or kill["stage_recoveries"] < 1:
        raise AssertionError(f"continuous kill: no recovery: {kill}")
    moved = [m for m in rescale["migrations"] if m["moved_partitions"] > 0]
    if not moved or len({tuple(m["to"]) for m in moved}) < 2 or max(
            len(m["to"]) for m in moved) != 2:
        raise AssertionError(f"continuous rescale: no grow and shrink over two slots moved "
                             f"partitions: {rescale['migrations']}")
    # sampled firings against the plain versions on the CPU
    worst = {"centroids_max_abs_err": 0.0, "inertia_rel_err": 0.0}
    for kw in sorted(base)[:: max(len(base) // 6, 1)]:
        cent, inertia, count = base[kw]
        r_cent, r_inertia, r_count = window_reference(torch, kmeans, *kw)
        err = float(np.abs(cent - r_cent).max())
        rel = abs(inertia - r_inertia) / abs(r_inertia)
        if count != r_count or not np.all(np.isfinite(cent)) or err > 1e-4 or rel > 1e-5:
            raise AssertionError(f"continuous: firing {kw} against the plain versions: "
                                 f"count {count}/{r_count}, centroid err {err}, inertia rel {rel}")
        worst = {"centroids_max_abs_err": max(worst["centroids_max_abs_err"], err),
                 "inertia_rel_err": max(worst["inertia_rel_err"], rel)}
    for mode, r in runs.items():  # a CPU rehearsal of the phase gets this far
        if r["info"]["app_device"].split(":")[0] != "cuda":
            raise AssertionError(f"continuous {mode}: the window processor on "
                                 f"{r['info']['app_device']}, not the card")
    out = {"path": "continuous", "firings": CONT_FIRINGS, "messages": CONT_MSGS,
           "bytes_through_log": CONT_MSGS * CONT_POINTS * 3 * 8,
           "runs": [r["info"] for r in runs.values()], "vs_plain": worst}
    print("path " + json.dumps(out))

    # the same spec on worker processes, held to the inline fault-free run
    mp_runs = {mode: continuous_run(torch, kernels, pipeline, faults, mode, "mp")
               for mode in ("clean", "worker", "kill", "rescale")}
    hold_to_base(mp_runs, base, "continuous-mp")
    info = {mode: r["info"] for mode, r in mp_runs.items()}
    for mode, i in info.items():
        if i["workers_started"] < 1 or min(i["launches_in_workers"].values()) < CONT_FIRINGS:
            raise AssertionError(f"continuous-mp {mode}: the firings did not run in spawned "
                                 f"workers: {i}")
    if info["worker"]["worker_restarts"] < 1 or not info["worker"]["respawn_to_resumed_s"]:
        raise AssertionError(f"continuous-mp worker: no restart: {info['worker']}")
    kill = info["kill"]
    if kill["recoveries"] < 1 or kill["stage_recoveries"] < 1 or kill["owners"] != kill["slots"]:
        raise AssertionError(f"continuous-mp kill: no recovery onto the new pilot's slots: {kill}")
    grow_shrink = [(len(m["to"]), m["moved_partitions"]) for m in info["rescale"]["migrations"]]
    if grow_shrink != [(2, 32), (1, 32)]:
        raise AssertionError(f"continuous-mp rescale: want 32 of 64 partitions moved each way: "
                             f"{info['rescale']['migrations']}")
    mp_out = {"path": "continuous-mp", "firings": CONT_FIRINGS, "messages": CONT_MSGS,
              "held_to": "the inline fault-free run, bitwise", "runs": list(info.values())}
    print("path " + json.dumps(mp_out))
    launches = {k.name: sum(r["launches"][k.name] for r in [*runs.values(), *mp_runs.values()])
                for k in kernels.KERNELS}
    return {"report": out, "mp_report": mp_out, "launches": launches}


def transport_registry(pipeline, miniapps, ShmArrayView) -> None:
    """Register the transport phase's processor: the port's ML-EM app,
    keeping every frame's reconstruction on the card by the frame's offset
    (the frame index, on the phase's one-partition topic) and counting the
    frames that arrived as views into the ring."""

    class FrameRecons(miniapps.ReconstructionApp):
        def __init__(self, device="cuda", metrics=None):
            super().__init__("mlem", n=RECON_N, mlem_iters=MLEM_ITERS, metrics=metrics,
                             device=device)
            self.frames: dict = {}
            self.views = 0
            self._batch = None

        def _reconstruct(self, sinos, angles):
            self._batch = super()._reconstruct(sinos, angles)
            return self._batch

        def process(self, state, msgs):
            self.views += sum(isinstance(m.value, ShmArrayView) for m in msgs)
            out = super().process(state, msgs)  # one shape: one batch, all of msgs
            self.frames.update(zip((m.offset for m in msgs), self._batch))
            return out

    pipeline.register_processor("smoke_mlem_frames", FrameRecons)


def transport_spec(pipeline, transport: str):
    """The transport phase's spec, built by the port's ``Pipeline``: the
    detector source into an ML-EM stage, over the ring or the log."""
    return (pipeline.Pipeline.named(f"detector-{transport}")
            .broker(nodes=1, transport=transport,
                    transport_options=dict(TRANS_RING) if transport == "shm" else {})
            .topic("frames", partitions=1)
            .source("frames", kind="detector", seed=SEED, total_messages=TRANS_FRAMES,
                    rate_msgs_per_s=TRANS_RATE, ny=FRAME_ANGLES, nx=FRAME_BINS,
                    dtype="float32", frames_per_batch=TRANS_BATCH, n_cached=TRANS_CACHED)
            .stage("recon", topic="frames", processor="smoke_mlem_frames",
                   max_batch_records=TRANS_BATCH, batch_interval=0.05,
                   backpressure=PIPE_RECON_RATE_CONTROL,
                   transport="shm" if transport == "shm" else None)
            .build())


def shm_segments() -> set:
    return {p.name for p in Path("/dev/shm").glob("rring-*")} if Path("/dev/shm").is_dir() \
        else set()


def transport_run(torch, kernels, pipeline, transport: str) -> dict:
    """One run of :func:`transport_spec` on one slot of the card until the
    stage has processed every frame; checks records against frames sent,
    lag 0, no copy-out, and the ring's segment gone after the teardown."""
    spec = transport_spec(pipeline, transport)
    before = shm_segments()
    run = spec.run(devices=1)
    kernels.reset_launches()
    with run:
        stream, source, proc = run.stream("recon"), run.source("frames"), run.processor("recon")
        t0 = time.monotonic()
        while not (run.sources_finished and stream.stats.records == source.sent_records):
            if stream._error is not None:
                raise AssertionError(f"transport {transport}: stream failed: {stream._error!r}")
            if time.monotonic() - t0 > TRANS_TIMEOUT_S:
                raise AssertionError(f"transport {transport}: {stream.stats.records}/"
                                     f"{source.sent_records} frames after {TRANS_TIMEOUT_S} s")
            time.sleep(0.005)
        wall = time.monotonic() - t0
        stream.sync_fn()
        launches = {k.name: k.launches for k in kernels.KERNELS}
        ring = run.cluster.transport.ring_for("frames") if transport == "shm" else None
        lat = proc.stats.latency
        info = {"transport": transport, "wall_s": wall, "frames": stream.stats.records,
                "sent": source.sent_records, "lag": run.lag("recon"),
                "frames_per_s": stream.stats.records / wall, "batches": stream.stats.batches,
                "latency_p50_s": lat.p50, "latency_p99_s": lat.p99,
                "copied_out": sum(p.copied_out_records for p in source.producers),
                "views": proc.views,
                "ring": None if ring is None else {
                    "slots_written": ring.alloc_count, "slots_reclaimed": ring.reclaim_count,
                    "stall_s": ring.stall_seconds, "name": ring.name},
                "io_stall_s": run.cluster.io_stall_seconds(),
                "launches": {k: launches[k] for k in ("tomo_project", "tomo_backproject")},
                "app_device": str(proc.device)}
        frames, last = dict(proc.frames), stream.state
        payload = source._cache[(TRANS_FRAMES - 1) % TRANS_CACHED]
    if run.errors:
        raise AssertionError(f"transport {transport}: teardown errors {run.errors!r}")
    info["segments_left"] = sorted(shm_segments() - before)
    if (info["frames"], info["sent"], info["lag"]) != (TRANS_FRAMES, TRANS_FRAMES, 0):
        raise AssertionError(f"transport {transport}: frames processed, sent, lag: {info}")
    if transport == "shm" and (info["copied_out"] or info["views"] != TRANS_FRAMES
                               or info["ring"]["slots_written"] != TRANS_FRAMES // TRANS_BATCH):
        raise AssertionError(f"transport shm: not every frame crossed the ring: {info}")
    if info["segments_left"]:
        raise AssertionError(f"transport {transport}: segments left in /dev/shm: "
                             f"{info['segments_left']}")
    for name, n in info["launches"].items():
        if n < 1:
            raise AssertionError(f"transport {transport}: {name} was not launched")
    return {"info": info, "frames": frames, "last": last, "payload": payload,
            "launches": launches}


def host_transport(n_msgs: int = HOST_TRANS_MSGS) -> list:
    """On the host only: the JAX package's own transport benchmark
    configuration (benchmarks/transport.py) through the port's modules — a
    detector source of HOST_TRANS_NY x HOST_TRANS_NX uint16 frames in trains
    of HOST_TRANS_BATCH into one topic, drained by 1 and 4 consumer groups,
    on the log and on the ring; msgs/s, MB/s and records lost."""
    import threading

    from repro_torch.broker import BrokerCluster, Consumer, ConsumerGroup
    from repro_torch.miniapps import DetectorSimSource, SourceConfig
    from repro_torch.transport import ShmTransport

    def drain(consumer, counts, i):
        while counts[i] < n_msgs:
            msgs = consumer.poll(max_records=512, timeout=0.5)
            if msgs:
                counts[i] += len(msgs)
                consumer.commit()  # progress drives shm slot reclaim

    rows = []
    for transport in ("log", "shm"):
        for n_groups in (1, 4):
            cluster = BrokerCluster(1)
            try:
                if transport == "shm":
                    cluster.attach_transport(ShmTransport(slot_bytes=1 << 21, n_slots=64))
                cluster.create_topic("frames", 1)
                if transport == "shm":
                    cluster.transport.mount("frames")
                consumers = [Consumer(cluster, ConsumerGroup(cluster, f"g{i}", "frames"),
                                      f"m{i}", zero_copy=transport == "shm")
                             for i in range(n_groups)]
                counts = [0] * n_groups
                threads = [threading.Thread(target=drain, args=(c, counts, i), daemon=True)
                           for i, c in enumerate(consumers)]
                source = DetectorSimSource(
                    cluster, SourceConfig("frames", total_messages=n_msgs),
                    ny=HOST_TRANS_NY, nx=HOST_TRANS_NX, dtype="uint16",
                    frames_per_batch=HOST_TRANS_BATCH)
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                source.start()
                for t in threads:
                    t.join(timeout=300)
                wall = time.perf_counter() - t0
                source.stop()
                for c in consumers:
                    c.close()
                rows.append({"transport": transport, "consumer_groups": n_groups,
                             "msgs": n_msgs, "wall_s": wall, "msgs_per_s": n_msgs / wall,
                             "mb_per_s": n_msgs * source.frame_bytes * n_groups / wall / 1e6,
                             "lost": cluster.lost_records + sum(n_msgs - c for c in counts)})
            finally:
                cluster.close()
    if any(r["lost"] for r in rows):
        raise AssertionError(f"host transport: records lost: {rows}")
    return rows


def transport_path(torch, kernels, pipeline, miniapps, tomo) -> dict:
    """The transport phase: :func:`transport_spec` over the ring and over
    the log (:func:`transport_run`); every frame's reconstruction over the
    ring against the log run's for the same frame index, within the ML-EM
    tolerance of :func:`recon_vs_plain` (1e-3 of the frame's peak), the
    worst difference printed and whether it was bitwise; the last batch's
    reconstruction against the plain versions. Then, on the host only, the
    JAX package's transport configuration (:func:`host_transport`)."""
    from repro_torch.transport import ShmArrayView

    transport_registry(pipeline, miniapps, ShmArrayView)
    runs = {t: transport_run(torch, kernels, pipeline, t) for t in ("shm", "log")}
    shm, log = runs["shm"], runs["log"]
    if shm["frames"].keys() != log["frames"].keys() or len(shm["frames"]) != TRANS_FRAMES:
        raise AssertionError("transport: the runs reconstructed other frames")
    worst, bitwise = 0.0, True
    for i, rec in log["frames"].items():
        other = shm["frames"][i]
        err = float((other - rec).abs().max())
        if err > 1e-3 * float(rec.abs().max()) or not bool(torch.isfinite(other).all()):
            raise AssertionError(f"transport: frame {i} over the ring differs from the log run "
                                 f"by {err}")
        worst, bitwise = max(worst, err), bitwise and bool(torch.equal(other, rec))
    vs_plain = recon_vs_plain(torch, tomo, "mlem", shm["last"], shm["payload"],
                              shm["last"].device)
    for r in runs.values():  # a CPU rehearsal of the phase gets this far
        if r["info"]["app_device"].split(":")[0] != "cuda":
            raise AssertionError(f"transport: the ML-EM app on {r['info']['app_device']}")
    out = {"path": "transport", "frames": TRANS_FRAMES, "frame_bytes": FRAME_ANGLES * FRAME_BINS * 4,
           "ring": TRANS_RING, "runs": [r["info"] for r in runs.values()],
           "shm_vs_log_max_abs_diff": worst, "shm_vs_log_bitwise": bitwise,
           "last_vs_plain": vs_plain}
    print("path " + json.dumps(out))
    host = host_transport()
    print("host_transport (host only: no device work; the JAX package's transport "
          "configuration through the port) " + json.dumps(host))
    launches = {k.name: sum(r["launches"][k.name] for r in runs.values())
                for k in kernels.KERNELS}
    return {"report": out, "host": host, "launches": launches}


# ---------------------------------------------------------------------------
# the mesh phase (ROADMAP A9): torch.distributed ranks on the one card
# ---------------------------------------------------------------------------


def _mesh_leaves(tree) -> dict:
    from repro_torch.utils import tree_flatten_with_paths

    return dict(tree_flatten_with_paths(tree))


def _within(name: str, got, want, atol: float) -> float:
    err = float((got.detach().float() - want.float()).abs().max())
    if not err <= atol:
        raise AssertionError(f"{name}: max err {err} > {atol}")
    return err


def _mesh_attention(torch, mesh, gen) -> dict:
    """(b): llava's S = 704 attention (32 heads over 8 of 128), f32, B =
    MESH_ATTN_BATCH: sharded attention forward and backward (K/V gathered
    over "model", one flash call at the shard's offset; dK, dV
    reduce-scattered) and ring prefill on the rank's tile, against the
    one-device flash kernel (and its backward) on the whole sequence."""
    from repro_torch.kernels import attention as attn
    from repro_torch.runtime.ring_attention import ring_attention_shmap
    from repro_torch.runtime.sharded_attention import sharded_attention
    from repro_torch.runtime.sharding import ShardingRules

    B, S, (H, KV, hd) = MESH_ATTN_BATCH, 704, (32, 8, 128)
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device=mesh.device)
               for n in (H, KV, KV))
    tile = _mesh_tiler(mesh)
    rules = {kind: ShardingRules(mesh=mesh, batch_axes=("data",), kind=kind)
             for kind in ("train", "prefill")}
    ql, kl, vl = (tile(x).requires_grad_(True) for x in (q, k, v))
    out = sharded_attention(ql, kl, vl, rules["train"], causal=True, impl="flash")
    torch.sin(out).sum().backward()
    qf, kf, vf = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref = attn.flash_attention(qf, kf, vf, causal=True)
    torch.sin(ref).sum().backward()
    res = {"shape": f"B={B} S={S} {H}/{KV} hd={hd} f32, 2 x 2 mesh",
           "fwd_max_abs_err": _within("sharded attention", out, tile(ref), MESH_F32_TOL)}
    for n, a, b in (("dq", ql.grad, qf.grad), ("dk", kl.grad, kf.grad), ("dv", vl.grad, vf.grad)):
        scale = float(b.abs().max())
        res[f"{n}_max_abs_err"] = _within(f"sharded attention {n}", a, tile(b),
                                          MESH_F32_TOL * max(1.0, scale))
    with torch.no_grad():
        ring = ring_attention_shmap(tile(q), tile(k), tile(v), rules["prefill"], causal=True)
    res["ring_max_abs_err"] = _within("ring attention", ring, tile(ref), MESH_F32_TOL)
    res["tol"] = (f"outputs {MESH_F32_TOL} absolute, gradients {MESH_F32_TOL} of "
                  "max(1, max|ref|) (the f32 flash's 2e-5, tests/test_kernels.py)")
    return res


def _mesh_tiler(mesh, seq_dim: int = 1):
    """x -> this rank's rows (over "data") and sequence shard (over "model")."""
    d, m = mesh.axis_index("data"), mesh.axis_index("model")
    nd, nm = mesh.shape["data"], mesh.shape["model"]

    def tile(x):
        b, s = x.shape[0] // nd, x.shape[seq_dim] // nm
        x = x.detach()[d * b:(d + 1) * b]
        return x.narrow(seq_dim, m * s, s).contiguous()
    return tile


def _mesh_train(torch, mesh, kernels) -> dict:
    """(c): smollm-135m at full width and MESH_TRAIN_LAYERS layers, B =
    TRAIN_BATCH, S = TRAIN_SEQ, on the 2 x 2 mesh: one f32 step held to the same step on one
    device (rank 0, same weights and batch) under the TRAIN_* limits; then MESH_BF16_STEPS bf16 steps (the launch counts set
    to 0 before and read after): losses, step p50, tokens/s, peak memory."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels import attention as attn
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.sharding import flatten_specs, param_shardings, unshard
    from repro_torch.runtime.steps import build_train_step, mesh_train_state

    base = get_arch("smollm-135m").replace(n_layers=MESH_TRAIN_LAYERS)
    opt_cfg = OptimizerConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                              total_steps=TRAIN_STEPS)
    shape = ShapeConfig("mesh", TRAIN_SEQ, TRAIN_BATCH, "train")
    dev = mesh.device

    def fresh(model):
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
        return params, Optimizer(opt_cfg).init(params)

    # f32: the mesh step against the one-device step
    cfg = base.replace(compute_dtype="float32")
    model = build_model(cfg)
    batches = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1)
    step = build_train_step(model, shape, opt_cfg, mesh=mesh)
    params, opt = mesh_train_state(model, *fresh(model), mesh)
    mesh_met = [step(params, opt, b)[2] for b in batches]
    specs = flatten_specs(param_shardings(model, mesh))
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ]}
    if mesh.rank == 0:
        p1, o1 = fresh(model)
        start = {k: v.clone() for k, v in _mesh_leaves(p1).items()}
        one = build_train_step(model, shape, opt_cfg, device=dev)
        one_met = [one(p1, o1, b)[2] for b in batches]
        res["loss_rel_err"] = max(abs(float(a["loss"]) - float(b["loss"])) / abs(float(b["loss"]))
                                  for a, b in zip(mesh_met, one_met))
        res["grad_norm_rel_err"] = max(
            abs(float(a["grad_norm"]) - float(b["grad_norm"])) / abs(float(b["grad_norm"]))
            for a, b in zip(mesh_met, one_met))
    update, moment = {}, {}
    one_p = _mesh_leaves(p1) if mesh.rank == 0 else {}
    one_m = _mesh_leaves(o1["m"]) if mesh.rank == 0 else {}
    mesh_m = _mesh_leaves(opt["m"])
    for path, tile in _mesh_leaves(params).items():  # gathered leaf by leaf
        full = unshard(tile, specs[path], mesh)
        m_full = unshard(mesh_m[path], specs[path], mesh)
        if mesh.rank == 0:
            update[path] = float((full - one_p[path]).norm() / (one_p[path] - start[path]).norm())
            moment[path] = float((m_full - one_m[path]).abs().max() / one_m[path].abs().max())
    if mesh.rank == 0:
        res.update(update_rel_err=max(update.values()), update_worst_leaf=max(update, key=update.get),
                   m_worst_err_over_leaf_max=max(moment.values()),
                   tol={"loss_rel": TRAIN_LOSS_REL, "grad_norm_rel": TRAIN_NORM_REL,
                        "update_rel": TRAIN_UPDATE_REL, "m_over_leaf_max": TRAIN_MOMENT_REL})
        if not (res["loss_rel_err"] <= TRAIN_LOSS_REL and res["grad_norm_rel_err"] <= TRAIN_NORM_REL
                and res["update_rel_err"] <= TRAIN_UPDATE_REL
                and res["m_worst_err_over_leaf_max"] <= TRAIN_MOMENT_REL):
            raise AssertionError(f"mesh f32 steps vs one device: {res}")
        del p1, o1, one_p, one_m, start
    del params, opt, mesh_m
    # bf16 (the training path's compute dtype): the counted run
    model = build_model(base)
    step = build_train_step(model, shape, opt_cfg, mesh=mesh)
    params, opt = mesh_train_state(model, *fresh(model), mesh)
    batches = train_batches(base, TRAIN_BATCH, TRAIN_SEQ, MESH_BF16_STEPS, seed=SEED + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.launches = 0
    losses, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        met = step(params, opt, b)[2]
        losses.append(float(met["loss"]))  # synchronizes
        times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mesh bf16 losses {losses}")
    p50 = sorted(times)[len(times) // 2]
    res.update(bf16_losses=losses, bf16_step_s=times, bf16_step_p50_s=p50,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / p50,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               tile_bytes=sum(x.numel() * x.element_size() for x in _mesh_leaves(params).values()),
               launches=launches)
    want = attn.FLASH_ATTENTION.name
    if launches[want] < 1 or launches["flash_attention_bwd_dq"] < 1 \
            or launches["flash_attention_bwd_dkdv"] < 1:
        raise AssertionError(f"the mesh step launched no flash kernel: {launches}")
    return res


def _mesh_losses(torch, mesh, gen) -> dict:
    """(d): vocab-parallel embedding and cross-entropy at smollm's width and
    vocabulary (B = TRAIN_BATCH, S = TRAIN_SEQ, f32) against the dense loss
    on the whole batch: rtol 1e-5 on the summed loss, 1e-4 on the hidden
    states' gradient, 1e-6 on the embedding (tests/test_distributed.py)."""
    from repro_torch.runtime.losses import vocab_parallel_cross_entropy, vocab_parallel_embed
    from repro_torch.runtime.sharding import ShardingRules

    B, S, D, V = TRAIN_BATCH, TRAIN_SEQ, 576, 49152
    dev = mesh.device
    x = torch.randn((B, S, D), generator=gen, device=dev)
    head = torch.randn((V, D), generator=gen, device=dev) * 0.02
    targets = torch.randint(0, V, (B, S), generator=gen, device=dev)
    tokens = torch.randint(0, V, (B, S), generator=gen, device=dev)
    mask = torch.ones((B, S), device=dev)
    tile = _mesh_tiler(mesh)
    m, nm = mesh.axis_index("model"), mesh.shape["model"]
    hl = head[m * V // nm:(m + 1) * V // nm].contiguous()
    rules = ShardingRules(mesh=mesh, batch_axes=("data",), kind="train")
    xl = tile(x).requires_grad_(True)
    tot, cnt = vocab_parallel_cross_entropy(xl, hl, tile(targets), tile(mask), rules)
    (tot / mesh.size).backward()
    xf = x.clone().requires_grad_(True)
    logits = xf @ head.T
    dense = ((torch.logsumexp(logits, -1) - logits.gather(-1, targets[..., None])[..., 0])
             * mask).sum()
    dense.backward()
    rel = abs(float(tot.detach()) - float(dense.detach())) / abs(float(dense.detach()))
    if not rel <= 1e-5 or float(cnt) != float(mask.sum()):
        raise AssertionError(f"vocab-parallel loss {float(tot)} vs dense {float(dense)}")
    emb = vocab_parallel_embed(tile(tokens), hl, rules)
    return {"shape": f"B={B} S={S} d={D} V={V} f32", "loss_rel_err": rel,
            "grad_max_abs_err": _within("vocab-parallel grad", xl.grad, tile(xf.grad), 1e-4),
            "embed_max_abs_err": _within("vocab-parallel embed", emb, tile(head[tokens]), 1e-6)}


def _mesh_sequence(torch, mesh, gen) -> dict:
    """(e): the sequence-parallel cores at T = MESH_SEQ_T against the
    chunked cores on the whole sequence: WKV6 at rwkv6-3b's width (40 heads
    of 64), SSD and the conv at zamba2-1.2b's (64 heads of 64, state 64,
    4160 conv channels), f32, B = 2; each within its tolerance times
    max(1, max|ref|) (tests/test_sequence_parallel.py's 2e-4, 3e-4)."""
    import torch.nn.functional as F

    from repro_torch.models.mamba2 import conv1d_causal, ssd_chunked
    from repro_torch.models.rwkv6 import wkv6_chunked
    from repro_torch.runtime.sequence_parallel import conv1d_sharded, ssd_sharded, wkv6_sharded
    from repro_torch.runtime.sharding import ShardingRules

    dev, T = mesh.device, MESH_SEQ_T
    rules = ShardingRules(mesh=mesh, batch_axes=("data",), kind="train")
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    res = {}
    B, H, N = 2, 40, 64
    r, k, v = rn(B, H, T, N), rn(B, H, T, N), rn(B, H, T, N)
    w = torch.sigmoid(rn(B, H, T, N) - 1.0)
    u = rn(H, N) * 0.1
    tile2 = _mesh_tiler(mesh, seq_dim=2)
    ref, ref_s = wkv6_chunked(r, k, v, w, u, torch.zeros((B, H, N, N), device=dev))
    out, out_s = wkv6_sharded(*(tile2(x) for x in (r, k, v, w)), u, rules)
    d = mesh.axis_index("data")
    scale = lambda x: MESH_SEQ_TOL["wkv6"] * max(1.0, float(x.abs().max()))  # noqa: E731
    res["wkv6"] = {"shape": f"B={B} H={H} T={T} N={N}",
                   "max_abs_err": _within("wkv6_sharded", out, tile2(ref), scale(ref)),
                   "state_max_abs_err": _within("wkv6_sharded state", out_s, ref_s[d:d + 1],
                                                scale(ref_s))}
    Hs, P, Ns, conv_ch = 64, 64, 64, 2 * 2048 + 2 * 64
    x, dt = rn(B, T, Hs, P), F.softplus(rn(B, T, Hs))
    A, D = -torch.exp(rn(Hs) * 0.5), rn(Hs) * 0.1
    Bm, Cm = rn(B, T, 1, Ns), rn(B, T, 1, Ns)
    tile = _mesh_tiler(mesh)
    ref, ref_s = ssd_chunked(x, dt, A, Bm, Cm, D, torch.zeros((B, Hs, P, Ns), device=dev))
    out, out_s = ssd_sharded(tile(x), tile(dt), A, tile(Bm), tile(Cm), D, rules)
    scale = lambda x: MESH_SEQ_TOL["ssd"] * max(1.0, float(x.abs().max()))  # noqa: E731
    res["ssd"] = {"shape": f"B={B} T={T} H={Hs} P={P} N={Ns}",
                  "max_abs_err": _within("ssd_sharded", out, tile(ref), scale(ref)),
                  "state_max_abs_err": _within("ssd_sharded state", out_s, ref_s[d:d + 1],
                                               scale(ref_s))}
    xc, wc, bc = rn(B, T, conv_ch), rn(4, conv_ch) * 0.5, rn(conv_ch) * 0.1
    ref, _ = conv1d_causal(xc, wc, bc, None)
    out = conv1d_sharded(tile(xc), wc, bc, rules)
    res["conv1d"] = {"shape": f"B={B} T={T} channels={conv_ch} K=4",
                     "max_abs_err": _within("conv1d_sharded", out, tile(ref), MESH_SEQ_TOL["conv1d"]
                                            * max(1.0, float(ref.abs().max())))}
    res["tol"] = {k: f"{v} x max(1, max|ref|)" for k, v in MESH_SEQ_TOL.items()}
    return res


def _mesh_compress(torch, mesh, gen) -> dict:
    """(f): ``quantized_psum`` over "data" of a smollm wqkv-sized gradient
    tile a rank: int8 tiles (and f32 scales) on the wire, and the result
    within half an int8 step of every rank's block scale of the exact sum."""
    from repro_torch.runtime import collectives
    from repro_torch.runtime.grad_compress import BLOCK, quantized_psum, resid_len

    # independent partials, one per "data" rank (drawn alike on every rank)
    g = [torch.randn((30, 576, 1728 // 2), generator=gen, device=mesh.device)
         for _ in range(mesh.shape["data"])][mesh.axis_index("data")]
    sent = []
    real = collectives._all_gather

    def spy(mesh_, axes, x, dim):
        sent.append(str(x.dtype).replace("torch.", ""))
        return real(mesh_, axes, x, dim)

    collectives._all_gather = spy
    try:
        red, _ = quantized_psum(g, torch.zeros(resid_len(g.numel()), device=g.device), mesh,
                                "data")
    finally:
        collectives._all_gather = real
    every = collectives.all_gather_stack(g, mesh, "data")  # the exact partials
    exact = every.sum(0)
    blocks = every.reshape(every.shape[0], -1, BLOCK).abs().amax(-1)  # (ranks, blocks)
    bound = (blocks / 127.0 * 0.5).sum(0) * (1 + 1e-4)  # half a step of each rank's scale
    err = (red - exact).reshape(-1, BLOCK).abs().amax(-1)
    if sent != ["int8", "float32"] or bool((err > bound).any()):
        raise AssertionError(f"quantized_psum: wire {sent}, worst err/bound "
                             f"{float((err / bound).max())}")
    return {"n": g.numel(), "wire": sent, "worst_err_over_bound": float((err / bound).max()),
            "max_abs_err": float(err.max())}


def _mesh_restore(torch, mesh, directory: str, gen) -> dict:
    """(g): a leaf the size of smollm's wqkv stack, saved from a (4,)
    "model" mesh (tiles of its last dim, gathered, rank 0 writing) and
    restored onto the 2 x 2 mesh as P(None, ("data", "model")), each rank's
    tile bitwise."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.sharding import P, shard, unshard

    w = torch.randn((30, 576, 1728), generator=gen, device=mesh.device)
    mesh4 = make_mesh((4,), ("model",), device=mesh.device)
    saver = P(None, None, "model")
    full = unshard(shard(w, saver, mesh4), saver, mesh4)
    mgr = CheckpointManager(directory)
    t0 = time.perf_counter()
    if mesh.rank == 0:
        mgr.save(1, {"w": full})
    dist.barrier()
    saved = time.perf_counter() - t0
    spec = P(None, ("data", "model"))
    restored, _ = mgr.restore({"w": w}, shardings={"w": spec}, mesh=mesh)
    want = shard(w, spec, mesh)
    if not torch.equal(restored["w"], want) or restored["w"].device != w.device:
        raise AssertionError("the cross-mesh restore differs")
    return {"leaf": list(w.shape), "tile": list(want.shape), "save_s": saved,
            "restore_s": time.perf_counter() - t0 - saved, "bitwise": True}


def _worst_of(ranks: list, key: str) -> dict:
    """Rank 0's readings of ``key``, each error (a float under a key holding
    "err") replaced by its largest over the ranks: each rank checks its tile."""
    def errs(node, parts):
        for k, v in node.items():
            if isinstance(v, dict):
                errs(v, [p[k] for p in parts])
            elif "err" in k and isinstance(v, float):
                node[k] = max(p[k] for p in parts)
        return node
    return errs(copy.deepcopy(ranks[0][key]), [r[key] for r in ranks])


def _mesh_serve(torch, mesh, kernels, compute_dtype: str = "float32") -> dict:
    """(i): the serving steps on the 2 x 2 mesh (``runtime/steps.py``
    ``build_prefill_step`` and ``build_decode_step``): smollm-135m at full
    width and depth in ``compute_dtype``, weights drawn alike on every rank,
    cut to the rank's tiles (``bundle.load``); MESH_SERVE_PROMPTS prompts of
    MESH_SERVE_PROMPT_LEN tokens into a MESH_SERVE_CACHE-entry cache, then
    MESH_SERVE_STEPS greedy decode steps, across the cache tiles' boundary.
    The one-device prefill and decode steps (same weights) are then fed the
    mesh's tokens on the rank's rows: every served token must be the
    one-device argmax wherever the one-device top-2 gap exceeds RESCORE_GAP;
    in f32 every call's logits also within MESH_SERVE_REL x max|logit| (in
    bf16 their largest difference is a reading: C16). The launch counts of
    the mesh calls (set to 0 before, read after) must show the decode
    kernel on every rank. In bf16 the shapes and dtypes of every
    row-parallel product's input slice and weight tile in the first decode
    step are kept (``row_products``: A18's f32 copies, timed by
    ``row_product_copies``)."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import first_argmax
    from repro_torch.runtime.sharding import shard_tree
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step

    cfg = get_arch("smollm-135m").replace(compute_dtype=compute_dtype)
    model = build_model(cfg)
    dev = mesh.device
    B, T, C, n = MESH_SERVE_PROMPTS, MESH_SERVE_PROMPT_LEN, MESH_SERVE_CACHE, MESH_SERVE_STEPS
    gen = torch.Generator().manual_seed(SEED + 11)  # alike on every rank
    prompts = torch.randint(1, cfg.vocab_size, (B, T), generator=gen, dtype=torch.int32)
    pre = build_prefill_step(model, ShapeConfig("mesh_prefill", T, B, "prefill"), mesh=mesh,
                             cache_len=C)
    dec = build_decode_step(model, ShapeConfig("mesh_decode", C, B, "decode"), mesh=mesh)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    t0 = time.perf_counter()
    served = pre.load(shard_tree(params, pre.in_specs[0], mesh))  # the rank's tiles
    load_s = time.perf_counter() - t0
    b = B // mesh.shape["data"]
    rows = slice(mesh.axis_index("data") * b, (mesh.axis_index("data") + 1) * b)
    traffic: dict = {"row_products": [] if compute_dtype == "bfloat16" else None}
    torch.cuda.synchronize()
    for k in kernels.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    with _tp_traffic(traffic):
        logits, cache = pre.fn(served, {"tokens": prompts})
        got, toks = [logits], []
        for i in range(n):
            tok = first_argmax(got[-1][:, -1], dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            every = torch.zeros((B, 1), dtype=torch.int32, device=dev)
            every[rows] = tok  # this rank's rows; the others are other ranks'
            logits, cache = dec.fn(served, cache, {"tokens": every, "positions": torch.full(
                (B,), T + i, dtype=torch.int32)})
            got.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    cache_tile = list(cache["k"].shape)
    del cache
    # one device, the rank's rows, fed the mesh's tokens
    whole = model.compute_params(params)
    tp = _tp_weights(model, whole, served)
    one_pre = build_prefill_step(model, ShapeConfig("one_prefill", T, b, "prefill"), device=dev,
                                 cache_len=C)
    one_dec = build_decode_step(model, ShapeConfig("one_decode", C, b, "decode"), device=dev)
    logits, cache = one_pre.fn(whole, {"tokens": prompts[rows]})
    want = [logits]
    for i, tok in enumerate(toks):
        logits, cache = one_dec.fn(whole, cache, {"tokens": tok, "positions": torch.full(
            (b,), T + i, dtype=torch.int32, device=dev)})
        want.append(logits)
    del cache, whole, params
    errs, flips, gaps = [], 0, []
    for i, (g, w) in enumerate(zip(got, want)):
        errs.append(float((g - w).abs().max()) / float(w.abs().max()))
        if i == n:
            break  # no token served from the last call
        top2 = w[:, -1].float().topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = toks[i][:, 0] == first_argmax(w[:, -1], dim=-1)
        flips += int(((gap > RESCORE_GAP) & ~same).sum())
        gaps += [float(x) for x in gap[~same]]
    res = {"arch": cfg.name, "compute_dtype": compute_dtype, "prompts": [B, T], "cache": C,
           "steps": n, "rows": [rows.start, rows.stop], "cache_tile": cache_tile,
           "worst_logit_rel_err": max(errs), "sure_token_flips": flips,
           "tokens_served": n * b, "differing_tokens_gaps": gaps, "load_s": load_s,
           "wall_s": wall, "launches": launches,
           "tol": (f"logits {MESH_SERVE_REL} x max|logit|; " if compute_dtype == "float32"
                   else "") + f"tokens where the one-device top-2 gap > {RESCORE_GAP}",
           **_tp_readings(tp, traffic, n)}
    if traffic["row_products"] is not None:
        res["row_products"] = traffic["row_products"][:len(traffic["row_products"]) // n]
    if flips or (compute_dtype == "float32" and max(errs) > MESH_SERVE_REL):
        raise AssertionError(f"mesh serving vs one device: {res}")
    if launches["decode_attention"] < n * cfg.n_layers:
        raise AssertionError(f"mesh serving launched the decode kernel {launches} times")
    return res


def _tp_weights(model, whole: dict, served: dict) -> dict:
    """What tensor-parallel serving holds: the bytes of the whole served
    weights, of the rank's tiles of them, and of the leaves a decode step
    gathers whole over "model" (``model.GATHERED_IN_DECODE``, the small
    vectors)."""
    from repro_torch.utils import tree_flatten_with_paths

    def nbytes(tree, names=None):
        return sum(x.numel() * x.element_size() for p, x in tree_flatten_with_paths(tree)
                   if names is None or p.rsplit("/", 1)[-1] in names)
    return {"whole": nbytes(whole), "held": nbytes(served),
            "vectors": nbytes(whole, set(model.GATHERED_IN_DECODE))}


def _tp_traffic(into: dict):
    """A context that adds to ``into``, by step kind, the bytes of the
    weights ``unshard_many`` gathers over "model" and the ``psum``s over
    "model" of products' partial sums (``row_product``'s, a MoE layer's
    fold of its combine); where ``into["row_products"]`` is a list, each
    decode ``row_product``'s input slice and weight tile (shapes, dtypes)
    and compute dtype are appended to it."""
    import contextlib

    from repro_torch.runtime import collectives, sharding

    def kind() -> str:
        rules = sharding.current_rules()
        return "none" if rules is None else rules.kind

    @contextlib.contextmanager
    def recording():
        unshard, psum = sharding.unshard_many, collectives.psum

        def gather(tiles, specs, mesh):
            out = unshard(tiles, specs, mesh)
            for spec, o in zip(specs, out):
                if "model" in sharding.spec_axes(spec):
                    key = f"{kind()}_gathered"
                    into[key] = into.get(key, 0) + o.numel() * o.element_size()
            return out

        def psum_(x, mesh, axes):
            caller = sys._getframe(1)
            if axes == "model" and caller.f_code.co_name in ("row_product", "moe_apply"):
                into[f"{kind()}_psums"] = into.get(f"{kind()}_psums", 0) + 1
                if into.get("row_products") is not None and kind() == "decode" \
                        and caller.f_code.co_name == "row_product":
                    xs, w = caller.f_locals["x"], caller.f_locals["w"]
                    into["row_products"].append(
                        {"x": list(xs.shape), "x_dtype": str(xs.dtype).split(".")[-1],
                         "w": list(w.shape), "w_dtype": str(w.dtype).split(".")[-1],
                         "cd": str(caller.f_locals["cd"]).split(".")[-1]})
            return psum(x, mesh, axes)

        sharding.unshard_many, collectives.psum = gather, psum_
        try:
            yield
        finally:
            sharding.unshard_many, collectives.psum = unshard, psum

    return recording()


def _tp_readings(tp: dict, traffic: dict, steps: int) -> dict:
    """A serving case's tensor-parallel readings (a rank's): the weight
    bytes it holds (and the whole weights'), the weight bytes its decode
    steps gathered over "model" (which must be the small vectors' only, a
    step) and its prefill's, and the ``psum``s of partial products a decode
    step."""
    out = {"weight_bytes_held": tp["held"], "weight_bytes_whole": tp["whole"],
           "decode_weight_bytes_gathered_over_model": traffic.get("decode_gathered", 0),
           "decode_vector_bytes": steps * tp["vectors"],
           "prefill_weight_bytes_gathered_over_model": traffic.get("prefill_gathered", 0),
           "decode_psums_per_step": traffic.get("decode_psums", 0) / steps}
    if tp["held"] >= tp["whole"] or out["decode_weight_bytes_gathered_over_model"] \
            != out["decode_vector_bytes"] or not out["decode_psums_per_step"]:
        raise AssertionError(f"serving is not tensor-parallel: {out}")
    return out


def _fam_cfg(name: str):
    """A families-case config: full width, 1 layer (seamless: 1 encoder
    and 1 decoder layer), f32 params and compute, no remat."""
    from repro_torch.configs import get_arch

    over = {"n_layers": 1, "compute_dtype": "float32", "param_dtype": "float32", "remat": "none"}
    if name == "seamless-m4t-medium":
        over["n_enc_layers"] = 1
    return get_arch(name).replace(**over)


def _fam_params(torch, model, dev):
    """The case's weights, drawn alike on every rank (the router scaled)."""
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    if model.cfg.n_experts:
        params["layers"]["router"].mul_(MESH_FAM_ROUTER)
    return params


def _fam_batch(torch, cfg, rows: int, n_tokens: int, dev) -> dict:
    """A global batch, alike on every rank: tokens, and the patch or frame
    embeddings the family takes."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (rows, n_tokens), generator=gen,
                                     device=dev, dtype=torch.int32)}
    if cfg.n_patches:
        batch["patch_embeds"] = torch.randn((rows, cfg.n_patches, cfg.d_model), generator=gen,
                                            device=dev)
    if cfg.n_enc_layers:
        batch["frame_embeds"] = torch.randn((rows, FAM_FRAMES, cfg.d_model), generator=gen,
                                            device=dev)
    return batch


def _fam_routes(moe, seen: list):
    """A context in which each MoE routing appends its (routed, kept)."""
    return _routes(moe, lambda r: seen.append((int((r.gates > 0).sum()), int(r.keep.sum()))))


def _expert_traffic(experts: list, into: dict):
    """A context that adds to ``into`` the bytes of the expert leaves the
    step gathers (``unshard_many``'s results for ``experts``, the rank's
    stacked expert tiles, or their layer slices) and the bytes every
    all-to-all sends, forward and backward."""
    import contextlib

    from repro_torch.runtime import collectives, sharding

    into.update(expert_gathered_bytes=0, all_to_all_bytes=0)

    @contextlib.contextmanager
    def recording():
        unshard, a2a = sharding.unshard_many, collectives._all_to_all

        def gather(tiles, specs, mesh):
            out = unshard(tiles, specs, mesh)
            for t, o in zip(tiles, out):
                if any(t is e or t._base is e for e in experts):
                    into["expert_gathered_bytes"] += o.numel() * o.element_size()
            return out

        def all_to_all(mesh, axes, x, dim):
            into["all_to_all_bytes"] += x.numel() * x.element_size()
            return a2a(mesh, axes, x, dim)

        sharding.unshard_many, collectives._all_to_all = gather, all_to_all
        try:
            yield
        finally:
            sharding.unshard_many, collectives._all_to_all = unshard, a2a

    return recording()


def _expert_leaves(params: dict) -> list:
    """The stacked expert leaves of a MoE param tree (tiles or whole)."""
    return [params["layers"][k] for k in ("w_gate", "w_up", "w_down")]


def _rank_tile(torch, mesh, ref, spec, shape: tuple, dtype):
    """This rank's tile under ``spec`` of rank 0's host tensor ``ref`` (None
    on the other ranks), scattered from rank 0 over the host."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime.sharding import shard_slices

    def tile_of(rank):
        return shard_slices(spec, shape, Mesh(mesh.shape, rank, mesh.device, mesh.backend))
    buf = torch.empty([len(range(*s.indices(d))) for s, d in zip(tile_of(mesh.rank), shape)],
                      dtype=dtype)
    parts = [ref[tile_of(r)].contiguous() for r in range(mesh.size)] if mesh.rank == 0 else None
    dist.scatter(buf, parts, src=0)
    return buf


def _fam_train(torch, mesh, kernels, name: str) -> dict:
    """One mesh train step of the case ``name`` (phi3.5-moe: kimi-k2's
    Adafactor; the others: SGD) against the one-device step on rank 0, run
    first and alone, its results kept on the host: the metrics, each leaf's
    update (||mesh - one|| / ||one - start|| over the leaf, each rank
    comparing its tile with its tile of the reference, scattered from rank
    0) and the factored moments; the routed and kept choices of the mesh
    step (summed over this rank's tokens), its seconds, peak memory and
    launches (the counts set to 0 before, read after)."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model, moe
    from repro_torch.runtime.collectives import psum
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.sharding import flatten_specs, param_shardings, spec_axes
    from repro_torch.runtime.steps import build_train_step, mesh_train_state, opt_state_shardings
    from repro_torch.utils import tree_flatten_with_paths

    cfg = _fam_cfg(name)
    model, dev = build_model(cfg), mesh.device
    kimi = get_arch("kimi-k2-1t-a32b")
    opt_cfg = (OptimizerConfig(name=kimi.optimizer, moment_dtype=kimi.moment_dtype,
                               first_moment=kimi.first_moment, learning_rate=TRAIN_LR,
                               warmup_steps=0) if cfg.n_experts
               else OptimizerConfig(name="sgd", learning_rate=MESH_FAM_SGD_LR, warmup_steps=0))
    opt = Optimizer(opt_cfg)
    n_tok = MESH_FAM_PHI_SEQ if cfg.n_experts else MESH_FAM_TOKENS
    batch = _fam_batch(torch, cfg, MESH_FAM_TRAIN_B, n_tok, dev)
    seq = n_tok + cfg.n_patches if not cfg.n_enc_layers else 2 * n_tok
    shape = ShapeConfig("mesh_family", seq, MESH_FAM_TRAIN_B, "train")
    params = _fam_params(torch, model, dev)
    state = opt.init(params)
    tiles, tstate = mesh_train_state(model, params, state, mesh)
    host = lambda x: x.detach().to("cpu", copy=True)  # noqa: E731
    start = {k: host(v) for k, v in _mesh_leaves(tiles).items()}  # this rank's tiles
    res, ref, ref_state = {"optimizer": opt_cfg.name}, {}, {}
    if mesh.rank == 0:  # the one-device step first, alone; its results on the host
        t0 = time.perf_counter()
        params, state, one = build_train_step(model, shape, opt_cfg, device=dev)(
            params, state, batch)
        torch.cuda.synchronize()
        res["one_device_s"] = time.perf_counter() - t0
        ref = {k: host(v) for k, v in _mesh_leaves(params).items()}
        ref_state = {k: {p: host(x) for p, x in _mesh_leaves(v).items()}
                     for k, v in state.items() if k in ("v_row", "v_col")}
        one = {k: float(v) for k, v in one.items()}
    del params, state
    torch.cuda.empty_cache()
    dist.barrier()
    step = build_train_step(model, shape, opt_cfg, mesh=mesh)
    seen: list = []
    experts = _expert_leaves(tiles) if cfg.n_experts else []
    traffic: dict = {}
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _fam_routes(moe, seen), _expert_traffic(experts, traffic):
        tiles, tstate, met = step(tiles, tstate, batch)
    torch.cuda.synchronize()
    res["mesh_step_s"] = time.perf_counter() - t0
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if cfg.n_experts:  # expert parallelism: the rank's experts and what moved
        res.update(experts_per_rank=experts[0].shape[1], expert_tile_bytes=sum(
            e.numel() * e.element_size() for e in experts),
            expert_gathered_bytes_per_layer=traffic["expert_gathered_bytes"] // cfg.n_layers,
            all_to_all_bytes=traffic["all_to_all_bytes"])
        if experts[0].shape[1] * mesh.shape["model"] != cfg.n_experts \
                or not traffic["all_to_all_bytes"]:
            raise AssertionError(f"mesh {name} train step is not expert-parallel: {res}")
    res["launches"] = {k.name: k.launches for k in kernels.KERNELS}
    res["metrics"] = {k: float(v) for k, v in met.items()}
    if seen:
        res["routed"], res["kept"] = sum(r for r, _ in seen), sum(k for _, k in seen)
    # each leaf's update: its squares summed over the ranks' tiles, once a copy
    t0 = time.perf_counter()
    shapes = {p: tuple(x.shape) for p, x in tree_flatten_with_paths(model.param_struct())}
    specs = flatten_specs(param_shardings(model, mesh))
    sums = []
    for path, tile in _mesh_leaves(tiles).items():
        want = _rank_tile(torch, mesh, ref.get(path), specs[path], shapes[path], tile.dtype)
        du, dj = host(tile) - start[path], want - start[path]
        copies = mesh.size // mesh.axis_size(spec_axes(specs[path]))
        sums.append(torch.stack([(du - dj).square().sum(), dj.square().sum()]) / copies)
    total = psum(torch.stack(sums), mesh, mesh.axis_names)
    update = {p: float(e.sqrt() / n.sqrt()) for p, (e, n) in zip(_mesh_leaves(tiles), total)}
    if cfg.n_experts:  # Adafactor's factored moments: worst |mesh - one| / max|one| a leaf
        ospecs = opt_state_shardings(model, opt, mesh)
        struct = opt.state_struct(model.param_struct())
        worst = {}
        for which in ("v_row", "v_col"):
            wspecs, wshapes = flatten_specs(ospecs[which]), _mesh_leaves(struct[which])
            for path, tile in _mesh_leaves(tstate[which]).items():
                want = _rank_tile(torch, mesh, ref_state.get(which, {}).get(path), wspecs[path],
                                  tuple(wshapes[path].shape), tile.dtype)
                pair = torch.stack([(host(tile) - want).abs().max(), want.abs().max()])
                dist.all_reduce(pair, op=dist.ReduceOp.MAX)
                worst[f"{which}/{path}"] = float(pair[0] / pair[1].clamp(min=1e-30))
        res["factored_err_over_leaf_max"] = max(worst.values())
        res["factored_worst"] = max(worst, key=worst.get)
    res["compare_s"] = time.perf_counter() - t0
    res.update(update_rel_err=max(update.values()), update_worst_leaf=max(update, key=update.get))
    if mesh.rank == 0:
        rel = {k: abs(res["metrics"][k] - one[k]) / abs(one[k]) for k in one
               if k in ("loss", "ce_loss", "aux_loss", "grad_norm")}
        res["rel_err"] = rel
        bad = (rel["loss"] > TRAIN_LOSS_REL or rel["grad_norm"] > TRAIN_NORM_REL
               or res["update_rel_err"] > MESH_FAM_UPDATE_REL
               or res.get("factored_err_over_leaf_max", 0.0) > MESH_FAM_UPDATE_REL)
        if bad:
            raise AssertionError(f"mesh {name} {opt_cfg.name} step vs one device: {res}")
    return res


def _fam_serve(torch, mesh, kernels, name: str) -> dict:
    """The case ``name``'s mesh prefill and MESH_SERVE_STEPS decode steps
    against the one-device steps on the whole batch (a MoE group holds
    tokens of every row), the rank's rows compared as ``_mesh_serve``
    compares them (same weights, the one-device greedy tokens fed to
    both)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import build_model, moe
    from repro_torch.models.common import first_argmax
    from repro_torch.runtime.sharding import shard_tree
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step

    cfg = _fam_cfg(name)
    model, dev = build_model(cfg), mesh.device
    B, n = MESH_SERVE_PROMPTS, MESH_SERVE_STEPS
    T = MESH_FAM_TOKENS if cfg.n_patches else MESH_SERVE_PROMPT_LEN
    C = MESH_FAM_VLM_CACHE if cfg.n_patches else MESH_SERVE_CACHE
    S = T + cfg.n_patches  # the prompt's positions
    seq = 2 * T if cfg.n_enc_layers else S  # an enc-dec shape splits frames and tokens
    dlen = 2 * C if cfg.n_enc_layers else C
    batch = _fam_batch(torch, cfg, B, T, dev)
    pre = build_prefill_step(model, ShapeConfig("fam_prefill", seq, B, "prefill"), mesh=mesh,
                             cache_len=C)
    dec = build_decode_step(model, ShapeConfig("fam_decode", dlen, B, "decode"), mesh=mesh)
    if pre.rules.zero:
        raise AssertionError(f"the families case serves {name} from whole weights")
    # every rank drew the whole weights (the one-device steps'), and serves
    # its tiles of them, as ``pre.load`` keeps them
    params = _fam_params(torch, model, dev)
    served = pre.load(shard_tree(params, pre.in_specs[0], mesh))
    whole = model.compute_params(params)
    b = B // mesh.shape["data"]
    rows = slice(mesh.axis_index("data") * b, (mesh.axis_index("data") + 1) * b)
    # one device, the whole batch (a MoE group holds tokens of every row)
    one_pre = build_prefill_step(model, ShapeConfig("one_prefill", seq, B, "prefill"), device=dev,
                                 cache_len=C)
    one_dec = build_decode_step(model, ShapeConfig("one_decode", dlen, B, "decode"), device=dev)
    logits, cache = one_pre.fn(whole, batch)
    want, toks = [logits[rows]], []
    for i in range(n):
        tok = first_argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        toks.append(tok)
        logits, cache = one_dec.fn(whole, cache, {"tokens": tok, "positions": torch.full(
            (B,), S + i, dtype=torch.int32, device=dev)})
        want.append(logits[rows])
    tp = _tp_weights(model, whole, served)
    del cache, whole, params
    seen: list = []
    experts = _expert_leaves(served) if cfg.n_experts else []
    prefill_traffic: dict = {}
    decode_traffic: dict = {}
    traffic: dict = {}
    torch.cuda.synchronize()
    for k in kernels.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    with _fam_routes(moe, seen), _tp_traffic(traffic):
        with _expert_traffic(experts, prefill_traffic):
            logits, cache = pre.fn(served, batch)
        got = [logits]
        with _expert_traffic(experts, decode_traffic):
            for i, tok in enumerate(toks):
                logits, cache = dec.fn(served, cache, {"tokens": tok, "positions": torch.full(
                    (B,), S + i, dtype=torch.int32)})
                got.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    errs, flips = [], 0
    for g, w in zip(got, want):
        errs.append(float((g - w).abs().max()) / float(w.abs().max()))
        top2 = w[:, -1].topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > RESCORE_GAP
        same = first_argmax(g[:, -1], dim=-1) == first_argmax(w[:, -1], dim=-1)
        flips += int((sure & ~same).sum())
    res = {"prompts": [B, S], "cache": C, "steps": n,
           "cache_tiles": {k: list(v.shape) for k, v in cache.items()},
           "worst_logit_rel_err": max(errs), "sure_token_flips": flips, "wall_s": wall,
           "launches": launches, **_tp_readings(tp, traffic, n)}
    if seen:
        res["routed"], res["kept"] = sum(r for r, _ in seen), sum(k for _, k in seen)
    if cfg.n_experts:  # expert parallelism: tokens move in the prefill, none in decode
        res.update(experts_per_rank=experts[0].shape[1], expert_tile_bytes=sum(
            e.numel() * e.element_size() for e in experts),
            expert_gathered_bytes=prefill_traffic["expert_gathered_bytes"]
            + decode_traffic["expert_gathered_bytes"],
            all_to_all_bytes={"prefill": prefill_traffic["all_to_all_bytes"],
                              "decode": decode_traffic["all_to_all_bytes"]})
        if (experts[0].shape[1] * mesh.shape["model"] != cfg.n_experts
                or not prefill_traffic["all_to_all_bytes"] or decode_traffic["all_to_all_bytes"]):
            raise AssertionError(f"mesh {name} serving is not expert-parallel: {res}")
    if max(errs) > MESH_SERVE_REL or flips:
        raise AssertionError(f"mesh {name} serving vs one device: {res}")
    if launches["decode_attention"] < n * cfg.n_layers * (2 if cfg.n_enc_layers else 1):
        raise AssertionError(f"mesh {name} serving launched the decode kernel {launches} times")
    return res


def _mesh_families(torch, mesh, kernels) -> dict:
    """(j): the families case (MESH_FAMILIES), one family at a time, each
    freed before the next: its train step (phi3.5-moe's under kimi-k2's
    Adafactor, the others' SGD) and its serving; their seconds."""
    out = {}
    for name in MESH_FAMILIES:
        short = name.split("-")[0]
        for key, fn in (("train", lambda: _fam_train(torch, mesh, kernels, name)),
                        ("serve", lambda: _fam_serve(torch, mesh, kernels, name))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[f"{short}_{key}"] = fn()
            torch.cuda.empty_cache()
            out[f"{short}_{key}"]["s"] = time.perf_counter() - t0
    return out


def mesh_rank(rank: int, directory: str) -> dict:
    """One rank of the mesh phase: a process of the 4-rank gloo group on
    cuda:0, a (2, 2) ("data", "model") mesh. It loads the kernels the parent
    built (it never builds) and runs (b)-(g), (i), (i') and (j); returns its
    readings."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh

    _build.forbid_builds()
    torch.cuda.set_device(0)
    mesh = make_mesh(MESH_SHAPE, ("data", "model"), device="cuda:0")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)  # alike on every rank
    out = {"coords": mesh.coords(), "backend": mesh.backend, "staged": mesh.staged}
    for name, fn in (("attention", lambda: _mesh_attention(torch, mesh, gen)),
                     ("train", lambda: _mesh_train(torch, mesh, kernels)),
                     ("losses", lambda: _mesh_losses(torch, mesh, gen)),
                     ("sequence", lambda: _mesh_sequence(torch, mesh, gen)),
                     ("compress", lambda: _mesh_compress(torch, mesh, gen)),
                     ("restore", lambda: _mesh_restore(torch, mesh, directory, gen)),
                     ("serve", lambda: _mesh_serve(torch, mesh, kernels)),
                     ("serve_bf16", lambda: _mesh_serve(torch, mesh, kernels, "bfloat16")),
                     ("families", lambda: _mesh_families(torch, mesh, kernels))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        out[name]["s"] = time.perf_counter() - t0
    return out


def _tp_of(reading: dict) -> dict:
    """A serving reading's tensor-parallel part (``_tp_readings``)."""
    return {k: reading[k] for k in ("weight_bytes_held", "decode_weight_bytes_gathered_over_model",
                                    "decode_psums_per_step")}


def _family_parts(rank: dict) -> dict:
    """A rank's families-case readings by part (its "s" is the case's)."""
    return {k: v for k, v in rank["families"].items() if k != "s"}


def _families_report(ranks: list, kernels) -> dict:
    """The families case's readings over the ranks: one ``check mesh
    family`` line a part (its largest error against one device with its
    rule, the MoE's dropped share over every rank's tokens, each kernel's
    launches a rank, its seconds); each part must have launched an
    attention kernel on every rank."""
    families = {}
    for part, first in _family_parts(ranks[0]).items():
        every = [r["families"][part] for r in ranks]
        line = {k: v for k, v in first.items() if k not in ("launches", "metrics")}
        if "routed" in first:  # the MoE's choices dropped, over every rank's tokens
            routed, kept = (sum(e[k] for e in every) for k in ("routed", "kept"))
            line.update(routed=routed, kept=kept, dropped_share=1 - kept / routed)
        if "worst_logit_rel_err" in first:
            line["worst_logit_rel_err"] = max(e["worst_logit_rel_err"] for e in every)
            line["tensor_parallel_per_rank"] = [_tp_of(e) for e in every]
            line["tol"] = (f"logits {MESH_SERVE_REL} x max|logit|; tokens where the top-2 gap > "
                           f"{RESCORE_GAP}")
        else:
            line["metrics"] = first["metrics"]
            line["tol"] = {"loss_rel": TRAIN_LOSS_REL, "grad_norm_rel": TRAIN_NORM_REL,
                           "update_rel": MESH_FAM_UPDATE_REL,
                           "factored_over_leaf_max": MESH_FAM_UPDATE_REL}
        line["launches_per_rank"] = {k.name: [e["launches"][k.name] for e in every]
                                     for k in kernels.KERNELS
                                     if any(e["launches"][k.name] for e in every)}
        line["s"] = max(e["s"] for e in every)
        print(f"check mesh family {part} " + json.dumps(line))
        families[part] = line
    for part, line in families.items():
        runs = line["launches_per_rank"]
        fwd = [sum(runs.get(n, [0] * len(ranks))[i] for n in ("flash_attention",
                                                             "decode_attention"))
               for i in range(len(ranks))]
        if min(fwd) < 1:
            raise AssertionError(f"the mesh families case {part} launched no attention kernel "
                                 f"on a rank: {runs}")
    return families


def mesh_path(torch, kernels) -> dict:
    """The mesh phase: (h) a world-of-one NCCL mesh in this process, then
    one spawn of the 4-rank gloo group (``mesh_rank``), within
    MESH_TIMEOUT_S. Prints a ``check mesh`` line a check, a ``check mesh
    family`` line a families-case part and one ``path mesh`` line, and
    returns the ranks' launches (summed) of the bf16 mesh steps, the
    serving check and the families case."""
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks

    h = nccl_world_of_one(torch)
    print("check mesh world-of-one nccl " + json.dumps(h))
    d = tempfile.mkdtemp(prefix="mesh-")
    t0 = time.perf_counter()
    ranks = spawn_ranks(mesh_rank, 4, init_method=f"file://{d}/store", backend="gloo",
                        args=(d,), timeout=MESH_TIMEOUT_S, threads=2)
    wall = time.perf_counter() - t0
    if [r["coords"] for r in ranks] != [{"data": i, "model": j} for i in range(2) for j in range(2)]:
        raise AssertionError(f"mesh coordinates {[r['coords'] for r in ranks]}")
    for key in ("attention", "losses", "sequence", "compress", "restore"):
        print(f"check mesh {key} " + json.dumps(_worst_of(ranks, key)))
    rows = [r for r in ranks if r["coords"]["model"] == 0]  # one rank a block of rows
    for key, label in (("serve", "serve"), ("serve_bf16", "serve bf16")):
        serve = {**{k: v for k, v in ranks[0][key].items()
                    if k not in ("launches", "row_products", "differing_tokens_gaps")},
                 "worst_logit_rel_err": max(r[key]["worst_logit_rel_err"] for r in ranks),
                 "sure_token_flips": sum(r[key]["sure_token_flips"] for r in rows),
                 "tokens_served": sum(r[key]["tokens_served"] for r in rows),
                 "differing_tokens_gaps": sorted(g for r in rows
                                                 for g in r[key]["differing_tokens_gaps"]),
                 "decode_launches_per_rank": [r[key]["launches"]["decode_attention"]
                                              for r in ranks],
                 "cache_tiles": [r[key]["cache_tile"] for r in ranks],
                 "tensor_parallel_per_rank": [_tp_of(r[key]) for r in ranks]}
        print(f"check mesh {label} " + json.dumps(serve))
    families = _families_report(ranks, kernels)
    train = ranks[0]["train"]
    launches = {k.name: sum(r["train"]["launches"][k.name] + r["serve"]["launches"][k.name]
                            + r["serve_bf16"]["launches"][k.name]
                            + sum(f["launches"][k.name] for f in _family_parts(r).values())
                            for r in ranks) for k in kernels.KERNELS}
    report = {"mesh": dict(zip(("data", "model"), MESH_SHAPE)), "backend": ranks[0]["backend"],
              "staged_through_host": ranks[0]["staged"], "ranks_on": "cuda:0",
              "seconds": wall, "phase_s": {k: max(r[k]["s"] for r in ranks)
                                           for k in ("attention", "train", "losses",
                                                     "sequence", "compress", "restore",
                                                     "serve", "serve_bf16", "families")},
              "families_s": {part: line["s"] for part, line in families.items()},
              "train": {k: v for k, v in train.items() if k != "launches"},
              "peak_gb_per_rank": [r["train"]["peak_gb"] for r in ranks],
              "launches": launches, "world_of_one_nccl": h}
    print("path mesh " + json.dumps(report))
    return {"launches": launches, "report": report,
            "row_products": ranks[0]["serve_bf16"]["row_products"],
            "serve_bf16_wall_s": ranks[0]["serve_bf16"]["wall_s"]}


def row_product_copies(torch, products: list, serve_wall_s: float) -> dict:
    """A18: what ``row_product``'s f32 partial products cost a bf16 decode
    step, at the row-parallel products one rank's decode step ran in the
    mesh phase (``products``: each input slice's and weight tile's shape
    and dtype), on this process's card alone: device ms a step, from a
    replayed CUDA graph, of the f32 copies of the inputs and tiles
    (``x.to(cd).to(f32)``, ``w.to(cd).to(f32)``), of the f32 products on
    them, and of the same products in the compute dtype as one device runs
    them; the copies' bytes and their bound; beside the mesh serve's wall a
    call (its prefill and decode steps, host-staged gloo: not the
    device's)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)

    def tensor(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))

    pairs = [(tensor(p["x"], p["x_dtype"]), tensor(p["w"], p["w_dtype"]), getattr(torch, p["cd"]))
             for p in products]
    f32 = [(x.to(cd).to(torch.float32), w.to(cd).to(torch.float32)) for x, w, cd in pairs]

    def copies():
        for x, w, cd in pairs:
            x.to(cd).to(torch.float32)
            w.to(cd).to(torch.float32)

    def products_f32():
        for xf, wf in f32:
            xf @ wf

    def products_cd():
        for x, w, cd in pairs:
            x.to(cd) @ w.to(cd)

    copy_bytes = sum(x.numel() * (x.element_size() + 4) + w.numel() * (w.element_size() + 4)
                     for x, w, _ in pairs)
    return {"card": card_line(), "row_products_per_step": len(pairs),
            "shapes": sorted({(tuple(p["x"]), tuple(p["w"])) for p in products}),
            "f32_copy_bytes_per_step": copy_bytes,
            "f32_copies_ms_per_step": graph_ms(torch, copies, 5),
            "f32_products_ms_per_step": graph_ms(torch, products_f32, 5),
            "cd_products_ms_per_step": graph_ms(torch, products_cd, 5),
            "copies_bound_ms": copy_bytes / HBM_BYTES_PER_S * 1e3,
            "mesh_serve_wall_ms_per_call": serve_wall_s * 1e3 / (MESH_SERVE_STEPS + 1)}


def nccl_world_of_one(torch) -> dict:
    """(h): a (1, 1) mesh over a one-rank NCCL group in this process: one
    bf16 smollm-135m step (full width, TRAIN_CHECK_LAYERS layers) through the
    mesh step, bitwise equal to the one-device step from the same weights
    and batch (its collectives are NCCL calls on the card)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import build_train_step

    d = tempfile.mkdtemp(prefix="nccl-")
    dist.init_process_group("nccl", init_method=f"file://{d}/store", world_size=1, rank=0)
    try:
        dev = torch.device("cuda", 0)
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        cfg = get_arch("smollm-135m").replace(n_layers=TRAIN_CHECK_LAYERS)
        model = build_model(cfg)
        opt_cfg = OptimizerConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                                  total_steps=TRAIN_STEPS)
        shape = ShapeConfig("mesh", TRAIN_SEQ, TRAIN_BATCH, "train")
        batch = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1)[0]
        out = []
        for kw in ({"mesh": mesh}, {"device": dev}):
            params = model.init(torch.Generator(device=dev).manual_seed(SEED))
            opt = Optimizer(opt_cfg).init(params)
            params, opt, met = build_train_step(model, shape, opt_cfg, **kw)(params, opt, batch)
            out.append((params, opt, met))
        (pm, om, mm), (p1, o1, m1) = out
        same = all(torch.equal(a, b) for a, b in zip(
            _mesh_leaves({"p": pm, "m": om["m"], "v": om["v"]}).values(),
            _mesh_leaves({"p": p1, "m": o1["m"], "v": o1["v"]}).values()))
        same = same and all(torch.equal(mm[k], m1[k]) for k in m1)
        if not same:
            raise AssertionError("the world-of-one NCCL mesh step differs from the one-device step")
        return {"backend": mesh.backend, "layers": cfg.n_layers, "loss": float(mm["loss"]),
                "bitwise": True}
    finally:
        dist.destroy_process_group()


def _host_leaves(tree) -> dict:
    """{path: a host copy} of a tree of tensors."""
    return {p: x.detach().to("cpu", copy=True) for p, x in _mesh_leaves(tree).items()}


def train_group_path(torch, kernels, dev) -> dict:
    """The train group phase (GROUP_STAGES): a one-device ``LMTrainApp`` on
    ``dev`` takes every batch first (the reference; its state kept on the
    host, its card memory freed); then the group app, built with a (2, 2)
    mesh over ``dev`` x 4, draws the same state from SEED on ``dev`` and
    hands it to its group, and a stream on a kafka and a spark pilot feeds
    it the same batches, ``stream.rescale`` moving the live state onto each
    next group (gathered into host memory, no checkpoint file). Checks each
    loss and the final params and moments against the reference (TRAIN_*),
    the last group's steps bitwise against a one-device app given the state
    that group was handed, and every rank of every group launching the
    flash forward and both backward kernels. Prints one ``path
    train_group`` line: each group's start seconds, backend, step p50 and
    launches a rank, each rescale's seconds by part and host bytes."""
    import types

    from repro_torch.broker import Producer
    from repro_torch.configs import get_arch
    from repro_torch.core import PilotComputeService
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.miniapps import LMTrainApp
    from repro_torch.miniapps.masa import GroupState
    from repro_torch.runtime.optimizer import OptimizerConfig

    t0 = time.perf_counter()
    cfg = get_arch("smollm-135m").replace(n_layers=MESH_TRAIN_LAYERS, compute_dtype="float32")
    kw = dict(opt_cfg=OptimizerConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                                      total_steps=TRAIN_STEPS),
              seqs_per_step=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    n = sum(k for _, k in GROUP_STAGES)
    batches = [b["tokens"] for b in train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, n, seed=SEED + 3)]

    def msg(tokens):
        return [types.SimpleNamespace(value=tokens)]

    one = LMTrainApp(cfg, device=dev, **kw)
    state = one.init_state(SEED)
    start = _host_leaves(state["params"])
    for tokens in batches:
        state = one.process(state, msg(tokens))
    ref_losses, ref = one.losses, _host_leaves(state)
    del one, state

    (first, _), *_ = GROUP_STAGES
    app = LMTrainApp(cfg, mesh=MeshSpec(first, [dev] * math.prod(first)), **kw)
    svc = PilotComputeService(devices=[dev])
    try:
        cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
        cluster.create_topic("group-tokens", 1)
        ctx = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"}).get_context()
        stream = ctx.stream(cluster, "group-tokens", group="train-group",
                            process_fn=app.process, state=app.init_state(SEED),
                            batch_interval=0.05, max_batch_records=1, backpressure=False)
        stream.on_rescale = lambda devices: app.on_rescale(devices)(stream.state)
        producer = Producer(cluster, "group-tokens", serializer="npy")
        stream.start()
        done = 0
        for i, (shape, k) in enumerate(GROUP_STAGES):
            if i:
                if i == len(GROUP_STAGES) - 1:
                    handed = stream.state.gather()  # for the bitwise check
                stream.rescale([dev] * math.prod(shape))
            if not (isinstance(stream.state, GroupState) and stream.state.step == done
                    and app.mesh.shape == shape):
                raise AssertionError(f"after the rescale to {shape}: {stream.state}, {app.mesh}")
            for tokens in batches[done:done + k]:
                producer.send(tokens)
            done += k
            stream.await_batches(done, timeout=MESH_TIMEOUT_S)
        stream.stop()
        final = _host_leaves(stream.state.gather())
    finally:
        svc.cancel()
        app.close()
    losses = app.losses
    last = GROUP_STAGES[-1][1]
    solo = LMTrainApp(cfg, device=dev, **kw)
    state = solo.place_state(handed)
    for tokens in batches[-last:]:
        state = solo.process(state, msg(tokens))
    solo_losses, solo_state = solo.losses, _host_leaves(state)
    del solo, state, handed

    update = {p: float((final[f"params/{p}"] - ref[f"params/{p}"]).norm()
                       / (ref[f"params/{p}"] - start[p]).norm()) for p in start}
    moments = {k: max(float((final[f"opt/{k}/{p}"] - ref[f"opt/{k}/{p}"]).abs().max()
                            / ref[f"opt/{k}/{p}"].abs().max()) for p in start) for k in ("m", "v")}
    groups = [{"shape": g["shape"], "backend": g["backend"], "start_s": g["start_s"],
               "processes_spawned": g["spawned"], "steps": len(g["step_s"]), "step_s": g["step_s"],
               "step_p50_s": sorted(g["step_s"])[len(g["step_s"]) // 2],
               "launches_per_rank": {name: [r[name] for r in g["launches"]]
                                     for name in ("flash_attention", "flash_attention_bwd_dq",
                                                  "flash_attention_bwd_dkdv")}}
              for g in app.groups]
    res = {"path": "train_group", "card": card_line(), "arch": cfg.name, "layers": cfg.n_layers,
           "dtype": "float32", "batch": [TRAIN_BATCH, TRAIN_SEQ], "ranks_on": str(dev),
           "losses": losses, "one_device_losses": ref_losses,
           "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
           "update_rel_err": max(update.values()), "update_worst_leaf": max(update, key=update.get),
           "m_worst_err_over_leaf_max": moments["m"], "v_worst_err_over_leaf_max": moments["v"],
           "tol": {"loss_rel": TRAIN_LOSS_REL, "update_rel": TRAIN_UPDATE_REL,
                   "moments_over_leaf_max": TRAIN_MOMENT_REL},
           "last_group_bitwise": {
               "backend": app.groups[-1]["backend"], "steps": last,
               "losses": solo_losses == losses[-last:],
               "state": all(torch.equal(final[p], solo_state[p]) for p in final)},
           "groups": groups,
           "rescales": [{**r, "from": str(r["from"]), "to": str(r["to"])} for r in app.rescales],
           "state_bytes": sum(x.numel() * x.element_size() for x in final.values())}
    res["seconds"] = time.perf_counter() - t0
    print("path " + json.dumps(res))
    if len(losses) != n or not (res["loss_rel_err"] <= TRAIN_LOSS_REL
                                and res["update_rel_err"] <= TRAIN_UPDATE_REL
                                and max(moments.values()) <= TRAIN_MOMENT_REL):
        raise AssertionError("the train group's losses or state against one device: see the "
                             "path train_group line")
    if not (res["last_group_bitwise"]["losses"] and res["last_group_bitwise"]["state"]):
        raise AssertionError("the last group's steps differ from the one-device app's")
    backends = ["gloo"] * (len(GROUP_STAGES) - 1) + ["nccl" if dev.type == "cuda" else "gloo"]
    if [g["shape"] for g in app.groups] != [list(shape) for shape, _ in GROUP_STAGES] \
            or [g["backend"] for g in groups] != backends \
            or any(r["bytes"] != res["state_bytes"] for r in app.rescales):
        raise AssertionError("the groups, their backends or the bytes moved differ from "
                             "GROUP_STAGES")
    if res["seconds"] > GROUP_TIMEOUT_S:
        raise AssertionError(f"the train group phase took {res['seconds']:.1f} s")
    for g in groups:
        if min(min(v) for v in g["launches_per_rank"].values()) < 1:
            raise AssertionError(f"a rank of the {g['shape']} group launched no flash kernel: "
                                 f"{g['launches_per_rank']}")
    return {"report": res, "launches": {k.name: sum(r[k.name] for g in app.groups
                                                    for r in g["launches"])
                                        for k in kernels.KERNELS}}


def checkpoint_round_trip(torch, params) -> dict:
    """``CheckpointManager`` saves the serving phase's smollm-135m
    parameters on the card — as stored (f32) and cast to the serving
    path's bf16 compute dtype, one tree — and restores them onto the card;
    every leaf bitwise equal."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.utils import tree_bytes, tree_flatten_with_paths, tree_map_with_paths

    state = {"params": params,
             "params_bf16": tree_map_with_paths(lambda _, x: x.to(torch.bfloat16), params)}
    directory = ROOT / "build" / "checkpoint_smoke"
    shutil.rmtree(directory, ignore_errors=True)
    mgr = CheckpointManager(str(directory), keep_last=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, state, meta={"model": "smollm-135m"})
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, meta = mgr.restore(state)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    leaves = 0
    for (p, a), (q, b) in zip(tree_flatten_with_paths(state), tree_flatten_with_paths(restored)):
        bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
        if p != q or a.dtype != b.dtype or b.device != a.device or not torch.equal(
                a.view(bits), b.view(bits)):
            raise AssertionError(f"checkpoint round trip: leaf {p} differs")
        leaves += 1
    if meta != {"model": "smollm-135m"}:
        raise AssertionError(f"checkpoint round trip: meta {meta}")
    size = sum(f.stat().st_size for f in directory.rglob("*") if f.is_file())
    shutil.rmtree(directory, ignore_errors=True)
    res = {"leaves": leaves, "bytes": tree_bytes(state), "bytes_bf16": tree_bytes(
               state["params_bf16"]), "bytes_on_disk": size,
           "dtypes": sorted({str(a.dtype) for _, a in tree_flatten_with_paths(state)}),
           "write_s": write_s, "read_s": read_s, "bitwise": True}
    print("checkpoint " + json.dumps(res))
    return res


def check_decode_shard(torch, attn) -> dict:
    """``decode_attention`` on a cache shard (its ``start`` and its
    log-sum-exp) at qwen3-14b's decode_32k rank shard (DRY_SHARD), bf16,
    on shard 1 of 16: held to the per-element rule against the plain
    version (the LSE to 1e-5 x max(1, |lse|)), rows before the shard exactly
    0 and -inf, a start one off failing the rule on every row with
    LONG_ROW or more live keys in the shard, a second launch bitwise equal;
    the 16 shards, merged by their LSEs in f32, held to the rule against the
    whole-cache kernel. Timed (the shard launch with its LSE) beside the
    plain version and SDPA with the equal boolean mask."""
    b, n_ent, n_sh, (H, KV, hd) = DRY_SHARD
    S, dev = n_ent * n_sh, torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    q = torch.randn((b, 1, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, S, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, S, KV, hd), generator=gen, device=dev).bfloat16()
    start = n_ent  # shard 1
    # rows: the last entry, before the shard (two: empty), its first, inside,
    # its last, past it, inside
    pos = torch.tensor([S - 1, 0, start - 1, start, start + 700, start + n_ent - 1,
                        start + n_ent + 5000, start + 1500], dtype=torch.int32, device=dev)[:b]
    ks, vs = k[:, start:start + n_ent].contiguous(), v[:, start:start + n_ent].contiguous()
    name = f"decode_attention shard B={b} S={n_ent} start={start} hd={hd}"
    out, lse = attn.decode_attention_lse(q, ks, vs, pos, start=start)
    ref, ref_lse = attn.decode_attention_plain(q, ks, vs, pos, start=start, with_lse=True)
    empty = pos < start
    if not (bool((out[empty] == 0).all()) and bool((lse[empty] == -math.inf).all())):
        raise AssertionError(f"{name}: rows before the shard are not 0 and -inf")
    res = _bf16_close(torch, name, out[~empty], ref[~empty], vs)
    lse_err = (lse[~empty] - ref_lse[~empty]).abs()
    if bool((lse_err > 1e-5 * torch.clamp(ref_lse[~empty].abs(), min=1.0)).any()):
        raise AssertionError(f"{name}: lse max err {float(lse_err.max())}")
    res["lse_max_abs_err"] = float(lse_err.max())
    res["empty_rows"] = int(empty.sum())
    live = torch.clamp(pos.long() - start + 1, min=0, max=n_ent)
    rows = torch.nonzero((live >= LONG_ROW) & (live < n_ent)).flatten()
    bad = attn.decode_attention_lse(q[rows], ks[rows], vs[rows], pos[rows], start=start + 1)[0]
    worst = ((bad.float() - ref[rows].float()).abs() / _bf16_tol(torch, ref[rows], vs)
             ).flatten(1).amax(1)
    if bool((worst <= 1).any()):
        raise AssertionError(f"{name}: a start one off passes rows {rows.tolist()}: {worst}")
    res["start_one_off_least_over_tol"] = float(worst.min())
    again = attn.decode_attention_lse(q, ks, vs, pos, start=start)
    torch.cuda.synchronize()
    if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
        raise AssertionError(f"{name}: a second launch differs bitwise")
    # the 16 shards merged against the whole-cache kernel
    parts = [attn.decode_attention_lse(q, k[:, j * n_ent:(j + 1) * n_ent].contiguous(),
                                       v[:, j * n_ent:(j + 1) * n_ent].contiguous(), pos,
                                       start=j * n_ent) for j in range(n_sh)]
    ls = torch.stack([p[1] for p in parts])  # (n, b, H)
    w = torch.exp(ls - ls.max(dim=0).values)[..., None]  # (n, b, H, 1)
    os_ = torch.stack([p[0][:, 0].float() for p in parts])  # (n, b, H, hd), each rounded to bf16
    merged = ((os_ * w).sum(0) / w.sum(0))[:, None]
    whole = attn.decode_attention_cuda(q, k, v, pos)
    # the rule, plus one bf16 step of each partial (it was rounded before the merge)
    tol = _bf16_tol(torch, whole, v) + BF16_STEP * ((os_.abs() * w).sum(0) / w.sum(0))[:, None]
    err = (merged - whole.float()).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"{name}: {n_sh} shards merged against the whole cache: max err "
                             f"{float(err.max())}, worst err/tol {float((err / tol).max())}")
    res["merged"] = {"shards": n_sh, "max_abs_err": float(err.max()),
                     "worst_err_over_tol": float((err / tol).max()),
                     "tol_rule": "per element 2^-7 |ref| + 2^-15 max|v| + 2^-7 x the partials' "
                                 "weighted mean |o|"}
    n_live = int(live.sum())
    n_bytes = 2 * n_live * KV * hd * 2 + 2 * q.numel() * 2 + b * H * 4 + b * 4
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * n_live * H * hd, BF16_OPS_PER_S)
    res["ms"] = graph_ms(torch, lambda: attn.decode_attention_lse(q, ks, vs, pos, start=start), 50)
    res["plain_ms"] = graph_ms(torch, lambda: attn.decode_attention_plain(
        q, ks, vs, pos, start=start, with_lse=True), 10)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous() for x in (ks, vs))
    mask = (start + torch.arange(n_ent, device=dev)[None, :] <= pos[:, None].long())
    mask[empty] = True  # SDPA takes no empty row; these rows' work is not in the bound
    mask = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_ms"] = graph_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask), 50)
    res["shape"] = (f"qwen3-14b decode_32k rank shard: B={b}, {n_ent} entries from {start}, "
                    f"{H} heads over {KV} KV of {hd}, bf16, with the LSE")
    return res


def check_flash_mesh_family(torch, attn, label: str, b: int, sq: int, skv: int, offset: int,
                            gen) -> dict:
    """The flash kernel, non-causal, at a families-case shard's shape
    (MESH_FAM_FLASH; MESH_FAM_HEADS, f32): ``sq`` query rows at
    ``q_offset = offset`` against ``skv`` keys, held to the plain version
    (which takes no offset) within MESH_F32_TOL x max(1, max|ref|); bitwise
    the same call at offset 0 (a non-causal kernel ignores the offset); at
    an offset, the shard's rows of the whole sequence's call within the
    tolerance; the plain version made causal at the offset fails it (the
    check sees a mask). Timed beside the plain version and SDPA, with its
    bound."""
    H, KV, hd = MESH_FAM_HEADS
    dev = torch.device("cuda", 0)
    rows = skv if offset else sq  # the rows are a shard of the keys' sequence, or their own
    q_all = torch.randn((b, rows, H, hd), generator=gen, device=dev)
    q = q_all[:, offset:offset + sq].contiguous()
    k, v = (torch.randn((b, skv, KV, hd), generator=gen, device=dev) for _ in range(2))
    name = f"flash_attention {label} B={b} Sq={sq} Skv={skv} q_offset={offset} f32"
    out = attn.flash_attention_cuda(q, k, v, causal=False, q_offset=offset)
    ref = attn.flash_attention_plain(q, k, v, causal=False)
    tol = MESH_F32_TOL * max(1.0, float(ref.abs().max()))
    err = _within(name, out, ref, tol)
    res = {"shape": f"{label}: B={b} Sq={sq} Skv={skv} q_offset={offset}, {H} heads over {KV} "
                    f"KV of {hd}, non-causal, f32",
           "max_abs_err": err, "worst_err_over_tol": err / tol, "tol": tol}
    if not torch.equal(out, attn.flash_attention_cuda(q, k, v, causal=False, q_offset=0)):
        raise AssertionError(f"{name}: the offset changes a non-causal call")
    if offset:
        whole = attn.flash_attention_cuda(q_all, k, v, causal=False)
        res["whole_rows_max_abs_err"] = _within(name + " vs the whole sequence's rows", out,
                                                whole[:, offset:offset + sq], tol)
    masked = float((out - attn.flash_attention_plain(q, k, v, causal=True, q_offset=offset)
                    ).abs().max())
    if masked <= 10 * tol:
        raise AssertionError(f"{name}: the check is blind to a causal mask ({masked})")
    res["causal_mask_err_over_tol"] = masked / tol
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 4
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * b * H * hd * sq * skv)
    res["ms"] = graph_ms(torch, lambda: attn.flash_attention_cuda(q, k, v, causal=False,
                                                                  q_offset=offset), 50)
    res["plain_ms"] = graph_ms(torch, lambda: attn.flash_attention_plain(q, k, v, causal=False),
                               10)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # G = 1: no repeat
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_ms"] = graph_ms(torch, lambda: sdpa(qt, kt, vt), 50)
    return res


def check_decode_memory_tile(torch, attn, gen) -> dict:
    """The decode kernel over an enc-dec memory tile (MESH_FAM_DECODE,
    MESH_FAM_HEADS, f32): every row at the memory's last position, the
    tile's ``start`` and its log-sum-exp, held to the plain version within
    MESH_F32_TOL x max(1, max|ref|) (the LSE to 1e-5 x max(1, |lse|)); the
    two tiles merged by their LSEs against the plain attention over the
    whole memory (the one-device cross-attention); a start one off fails the
    rule. Timed beside the plain version and SDPA, with its bound."""
    label, b, n_ent, start = MESH_FAM_DECODE
    H, KV, hd = MESH_FAM_HEADS
    dev = torch.device("cuda", 0)
    S = start + n_ent  # the memory's frames; this tile is its last
    q = torch.randn((b, 1, H, hd), generator=gen, device=dev)
    k, v = (torch.randn((b, S, KV, hd), generator=gen, device=dev) for _ in range(2))
    ks, vs = k[:, start:].contiguous(), v[:, start:].contiguous()
    pos = torch.full((b,), S - 1, dtype=torch.int32, device=dev)
    name = f"decode_attention {label} B={b} entries={n_ent} start={start} f32"
    out, lse = attn.decode_attention_lse(q, ks, vs, pos, start=start)
    ref, ref_lse = attn.decode_attention_plain(q, ks, vs, pos, start=start, with_lse=True)
    tol = MESH_F32_TOL * max(1.0, float(ref.abs().max()))
    err = _within(name, out, ref, tol)
    res = {"shape": f"{label}: B={b}, {n_ent} entries from {start} of {S}, every row at {S - 1}, "
                    f"{H} heads over {KV} KV of {hd}, f32, with the LSE",
           "max_abs_err": err, "worst_err_over_tol": err / tol, "tol": tol,
           "lse_max_abs_err": _within(name + " lse", lse, ref_lse,
                                      1e-5 * max(1.0, float(ref_lse.abs().max())))}
    first = attn.decode_attention_lse(q, k[:, :start].contiguous(), v[:, :start].contiguous(),
                                      pos, start=0)
    ls = torch.stack([first[1], lse])  # (2, b, H)
    w = torch.exp(ls - ls.max(dim=0).values)[..., None]
    merged = ((torch.stack([first[0][:, 0], out[:, 0]]) * w).sum(0) / w.sum(0))[:, None]
    whole = attn.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=False).transpose(1, 2)
    res["merged_max_abs_err"] = _within(name + " merged vs the whole memory", merged, whole, tol)
    bad = attn.decode_attention_lse(q, ks, vs, pos, start=start + 1)[0]
    off = float((bad - ref).abs().max())
    if off <= tol:
        raise AssertionError(f"{name}: a start one off passes ({off})")
    res["start_one_off_err_over_tol"] = off / tol
    n_bytes = (2 * ks.numel() + 2 * q.numel()) * 4 + b * H * 4 + b * 4
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * b * n_ent * H * hd)
    res["ms"] = graph_ms(torch, lambda: attn.decode_attention_lse(q, ks, vs, pos, start=start), 50)
    res["plain_ms"] = graph_ms(torch, lambda: attn.decode_attention_plain(
        q, ks, vs, pos, start=start, with_lse=True), 10)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, ks, vs))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_ms"] = graph_ms(torch, lambda: sdpa(qt, kt, vt), 50)
    return res


def _card_run(torch, fn, args, reps: int) -> dict:
    """``fn(*args)`` on the card: its FLOPs under ``FlopCounterMode``, the
    most two back-to-back calls allocate beyond what was allocated before
    them (with the garbage collector off, so what a call leaves in a
    reference cycle shows in the next call's peak), and the wall of
    ``reps`` calls (the FLOP count's call is the warm-up)."""
    import gc

    from repro_torch.runtime.cost_analysis import count_flops

    flops = count_flops(fn, *args)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gc.disable()
    try:
        fn(*args)
        fn(*args)
        torch.cuda.synchronize()
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated() - before
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return {"flops": flops, "peak_bytes": peak, "wall_s": walls,
            "wall_p50_s": sorted(walls)[len(walls) // 2]}


def estimate_vs_card(torch, kernels) -> dict:
    """smollm-135m on one card: the training step (TRAIN_BATCH x TRAIN_SEQ,
    bf16 compute, f32 AdamW state), a prefill of SERVE_BATCH x PROMPT_LEN
    into a DRY_CACHE-entry cache and one decode step on it, each
    built by ``runtime/steps.py`` and traced under fake tensors
    (``StepBundle.trace``) on the same inputs as its run on the card: the
    traced FLOPs equal ``FlopCounterMode``'s over the card's step, the
    traced peak less the inputs within DRY_PEAK_REL of the card's most
    allocated less what was allocated before; the wall p50 of DRY_REPS
    runs, ``mfu`` (the roofline's model FLOPs over wall x the datasheet bf16
    peak) and the counted FLOPs' share (readings). The launch counts of the
    runs on the card are returned."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.roofline import H100, model_flops
    from repro_torch.models import build_model
    from repro_torch.runtime.optimizer import Optimizer, OptimizerConfig
    from repro_torch.runtime.steps import (
        build_decode_step,
        build_prefill_step,
        build_train_bundle,
    )

    dev = torch.device("cuda", 0)
    cfg = get_arch("smollm-135m")
    model = build_model(cfg)
    opt_cfg = OptimizerConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                              total_steps=TRAIN_STEPS)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    opt = Optimizer(opt_cfg).init(params)
    batch = {k: torch.as_tensor(x, device=dev)
             for k, x in train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1)[0].items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    prompts = torch.randint(1, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN), generator=gen,
                            device=dev, dtype=torch.int32)
    train = build_train_bundle(model, ShapeConfig("est_train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                               opt_cfg, device=dev)
    prefill = build_prefill_step(model, ShapeConfig("est_prefill", PROMPT_LEN, SERVE_BATCH,
                                                    "prefill"), device=dev,
                                 cache_len=DRY_CACHE)
    decode = build_decode_step(model, ShapeConfig("est_decode", DRY_CACHE, SERVE_BATCH,
                                                  "decode"), device=dev)
    served = model.compute_params(params)
    _, cache = prefill.fn(served, {"tokens": prompts})
    step = {"tokens": prompts[:, -1:].contiguous(),
            "positions": torch.full((SERVE_BATCH,), PROMPT_LEN, dtype=torch.int32, device=dev)}
    cases = {"train": (train, (params, opt, batch), "train", TRAIN_SEQ, TRAIN_BATCH),
             "prefill": (prefill, (served, {"tokens": prompts}), "prefill", PROMPT_LEN,
                         SERVE_BATCH),
             "decode": (decode, (served, cache, step), "decode", DRY_CACHE, SERVE_BATCH)}
    out, launches, faults = {}, {k.name: 0 for k in kernels.KERNELS}, []
    for name, (bundle, args, kind, seq, rows) in cases.items():
        _, cost = bundle.trace(*args)
        kernels.reset_launches()
        card = _card_run(torch, bundle.fn, args, DRY_REPS)
        for k in kernels.KERNELS:
            launches[k.name] += k.launches
        traced_peak = cost.peak_bytes - cost.input_bytes
        rel = abs(traced_peak - card["peak_bytes"]) / max(card["peak_bytes"], 1)
        mf = model_flops(cfg.name, kind, seq, rows, 1)
        p50 = card["wall_p50_s"]
        out[name] = {"flops_traced": cost.flops, "flops_card": card["flops"],
                     "peak_traced_bytes": traced_peak, "peak_card_bytes": card["peak_bytes"],
                     "peak_rel_err": rel, "input_bytes": cost.input_bytes,
                     "trace_s": cost.seconds, "wall_s": card["wall_s"], "wall_p50_s": p50,
                     "mfu": mf / (p50 * H100.flops), "counted_share": cost.flops / (p50 * H100.flops),
                     "model_flops": mf}
        if cost.flops != card["flops"]:
            faults.append(f"{name}: traced FLOPs {cost.flops} != the card's {card['flops']}")
        if rel > DRY_PEAK_REL:
            faults.append(f"{name}: traced peak {traced_peak} B against the card's "
                          f"{card['peak_bytes']} B ({rel:.3f} > {DRY_PEAK_REL})")
    if faults:
        raise AssertionError(f"estimate against the card: {faults}; {out}")
    if launches["decode_attention"] < 1 or launches["flash_attention"] < 1 \
            or launches["flash_attention_bwd_dq"] < 1:
        raise AssertionError(f"the estimate's steps launched no attention kernel: {launches}")
    return {"cases": out, "launches": launches, "peaks": H100.name}


def miniapp_estimate(torch, kernels) -> dict:
    """The dry run's Mini-App cells (``launch/dryrun.py`` ``MINIAPP_CELLS``)
    on the card: each cell's batch (``miniapp_batch``: a K-Means
    ``minibatch_update``, a GridRec or an ML-EM batch) traced under fake
    tensors (``runtime/cost_analysis.py``) and run on the card on inputs of
    its shapes (the cluster source's points, uniform sinograms): the traced
    FLOPs equal ``FlopCounterMode``'s over the card's call, and both the
    kernels' formulas; the traced peak less the inputs beside the card's
    most allocated less what was allocated before (a reading: a library
    call's workspace, cuFFT's, is not traced); the wall p50 of DRY_REPS
    runs. Returns the readings and the runs' launch counts."""
    from repro_torch.launch import dryrun
    from repro_torch.runtime.cost_analysis import trace_cost

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    out, launches, faults = {}, {k.name: 0 for k in kernels.KERNELS}, []
    for app, shape in dryrun.MINIAPP_CELLS:
        fn, args, kernel_flops = dryrun.miniapp_batch(app, shape)
        _, cost = trace_cost(fn, *args)
        if app == "kmeans":
            (n, d), k = args[0].shape, args[1].shape[0]
            real = assign_inputs(torch, n, d, k, torch.float32, True, gen)
        else:
            real = (torch.rand(args[0].shape, generator=gen, device=dev), args[1].to(dev),
                    args[2])
        kernels.reset_launches()
        card = _card_run(torch, fn, real, DRY_REPS)
        for k in kernels.KERNELS:
            launches[k.name] += k.launches
        traced_peak = cost.peak_bytes - cost.input_bytes
        out[f"{app} {shape}"] = {
            "flops_traced": cost.flops, "flops_card": card["flops"], "flops_kernels": kernel_flops,
            "bytes_fused_traced": cost.bytes_moved_fused, "peak_traced_bytes": traced_peak,
            "peak_card_bytes": card["peak_bytes"],
            "peak_rel_err": abs(traced_peak - card["peak_bytes"]) / max(card["peak_bytes"], 1),
            "input_bytes": cost.input_bytes, "trace_s": cost.seconds, "wall_s": card["wall_s"],
            "wall_p50_s": card["wall_p50_s"],
            "launches": {k.name: k.launches for k in kernels.KERNELS if k.launches}}
        if not cost.flops == card["flops"] == kernel_flops:
            faults.append(f"{app} {shape}: traced FLOPs {cost.flops}, the card's {card['flops']}, "
                          f"the kernels' formulas' {kernel_flops}")
    if faults:
        raise AssertionError(f"the Mini-App cells against the card: {faults}; {out}")
    for name in ("kmeans_assign", "kmeans_update", "tomo_backproject", "tomo_project"):
        if launches[name] < 1:
            raise AssertionError(f"the Mini-App cells' runs launched no {name}: {launches}")
    return {"cells": out, "launches": launches}


def production_cell() -> subprocess.Popen:
    """DRY_CELL on the single-pod 16 x 16 mesh through ``python -m
    repro_torch.launch.dryrun`` in a process of its own (its fake process
    group is process-wide). It needs no card: ``main`` starts it beside the
    kernels' build, and ``dryrun_path`` reads it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                             DRY_CELL[0], "--shape", DRY_CELL[1]], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def dryrun_path(torch, kernels, cell: subprocess.Popen) -> dict:
    """The dry-run phase, within DRY_TIMEOUT_S: the decode shard check; the
    estimate against the card; the Mini-App cells against the card; the
    record of the production cell, whose trace (``cell``, from
    ``production_cell``) ran in its own process meanwhile. Prints its lines
    and seconds."""
    from repro_torch.kernels import attention

    t0 = time.perf_counter()
    try:
        shard = check_decode_shard(torch, attention)
        print("check decode_attention shard " + json.dumps(shard))
        est = estimate_vs_card(torch, kernels)
        for name, r in est["cases"].items():
            print(f"estimate {name} " + json.dumps(r))
        streams = miniapp_estimate(torch, kernels)
        for name, r in streams["cells"].items():
            print(f"estimate miniapp {name} " + json.dumps(r))
        out, err = cell.communicate(timeout=max(1.0, DRY_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        if cell.poll() is None:
            cell.kill()
            cell.wait()
    if cell.returncode != 0:
        raise AssertionError(f"dry run of {DRY_CELL} exited {cell.returncode}: {err[-2000:]}")
    records = [line[len("[dryrun] record "):] for line in out.splitlines()
               if line.startswith("[dryrun] record ")]
    if len(records) != 1:
        raise AssertionError(f"dry run of {DRY_CELL} printed {len(records)} records: {out[-2000:]}")
    print("dryrun cell " + records[0])
    launches = {name: est["launches"][name] + streams["launches"][name]
                for name in est["launches"]}
    seconds = time.perf_counter() - t0
    print("path dryrun " + json.dumps({"seconds": seconds, "limit_s": DRY_TIMEOUT_S,
                                      "cell_trace_s": json.loads(records[0])["trace_s"],
                                      "peaks": est["peaks"], "launches": launches}))
    if seconds > DRY_TIMEOUT_S:
        raise AssertionError(f"the dry-run phase took {seconds:.1f} s > {DRY_TIMEOUT_S} s")
    return {"launches": launches, "shard": shard, "estimate": est["cases"],
            "miniapp_estimate": streams["cells"], "seconds": seconds}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout of the repo")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    # before the port places any work: the bf16 products are measured with
    # this value and with the reduction in f32
    torch_default = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print("host " + json.dumps(host_probe(torch)))

    cell = production_cell()  # the dry run's production cell needs no card
    try:
        run(torch, cell, torch_default)
    finally:
        if cell.poll() is None:
            cell.kill()
            cell.wait()


def run(torch, cell: subprocess.Popen, torch_default: bool) -> None:
    """Steps 2-11 of the module's docstring; ``cell`` is the dry run's
    production cell, started beside the build; ``torch_default`` torch's
    ``allow_bf16_reduced_precision_reduction`` before the port ran."""
    from repro_torch import kernels, miniapps, pipeline
    from repro_torch.core import PilotComputeService
    from repro_torch.kernels import attention, kmeans, tomo

    build_s = kernels.build_all()
    print(f"build: {build_s:.1f} s for {len(kernels.KERNELS)} kernels")
    for lib in dict.fromkeys(k.library for k in kernels.KERNELS):
        if lib.log_path.exists():  # per library: its kernels' most registers and all spills
            log = lib.log_path.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
            spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
            print(f"ptxas {lib.source.name}: {len(regs)} kernels, at most {max(regs, default=0)} "
                  f"registers, {spills} bytes of spill stores and loads")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the short kernels' bounds lie below any launch: the least kernel's time beside them
    floor = launch_floor_ms(torch)
    for n, d, k, dtype, clustered, timing in (
            (80_000, 3, 10, torch.float32, True, True), (65_536, 128, 1024, torch.float32, False, True),
            (80_000, 3, 10, torch.bfloat16, True, False),
            (65_536, 128, 1024, torch.bfloat16, False, True)):
        res = check_assign(torch, kmeans, n, d, k, dtype, clustered, gen, timing, floor)
        if (n, d, dtype) == (80_000, 3, torch.float32):
            assign_main = res
        name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
        print(f"check kmeans_assign {n}x{d}x{k} {name} " + json.dumps(res))
    # rows too long for one centroid in 48 KB, below wide's K = 16: the
    # chunked regime (K = 2 timed)
    for k in (2, 15):
        res = check_assign(torch, kmeans, 4096, 20_000, k, torch.float32, False, gen, k == 2, floor)
        print(f"check kmeans_assign 4096x20000x{k} f32 " + json.dumps(res))
    # the update at the K-Means streams' shape (batches of up to 16 messages
    # of 5000 points over 10 labels: nearly every launch on the main path)
    # and at the wide stream's, where the worst cases are checked too
    update_main = check_update(torch, kmeans, 80_000, 3, 10, gen, floor)
    print("check kmeans_update 80000x3x10 f32 " + json.dumps(update_main))
    print(f"check kmeans_update 65536x{WIDE_D}x{WIDE_K} f32 "
          + json.dumps(check_update(torch, kmeans, 65_536, WIDE_D, WIDE_K, gen, floor)))
    bp, fp = check_tomo(torch, tomo, gen)
    print("check tomo_backproject 8x360x1448 n=1448 " + json.dumps(bp))
    print("check tomo_project 8x1448x1448 A=360 " + json.dumps(fp))
    print("check tomo_backproject sparse 8x360x1448 n=1448 "
          + json.dumps(check_backproject_sparse(torch, tomo, gen)))
    print("check tomo_project sparse 8x1448x1448 A=360 "
          + json.dumps(check_project_sparse(torch, tomo, gen)))
    print("check quality " + json.dumps(check_quality(torch, tomo)))
    decode_main = check_decode(torch, attention, SERVE_BATCH, 256)
    decode_main["launch_floor_ms"] = floor
    print(f"check decode_attention B={SERVE_BATCH} S=256 bf16 " + json.dumps(decode_main))
    for b in (1, 64):
        print(f"check decode_attention B={b} S=256 bf16 "
              + json.dumps(check_decode(torch, attention, b, 256)))
    for b in (1, SERVE_BATCH, 64):
        print(f"check decode_attention split edges B={b} S=256 bf16 "
              + json.dumps(check_decode_split(torch, attention, b, 256, gen)))
    flash_main = check_flash(torch, attention, 1, PROMPT_LEN, gen, True)
    print(f"check flash_attention B=1 S={PROMPT_LEN} causal bf16 " + json.dumps(flash_main))
    # kimi-k2's serving shapes at its head dim of 112 (64 query heads over 8
    # KV heads): the prefill of one prompt, decode at B=4 S=256 (timed, and
    # at its chunk edges, bitwise across repeats and graph replays)
    flash_112 = check_flash(torch, attention, 1, PROMPT_LEN, gen, True, KIMI_HEADS)
    print(f"check flash_attention B=1 S={PROMPT_LEN} causal bf16 hd=112 " + json.dumps(flash_112))
    decode_112 = check_decode(torch, attention, SERVE_BATCH, 256, KIMI_HEADS)
    decode_112["launch_floor_ms"] = floor
    print(f"check decode_attention B={SERVE_BATCH} S=256 bf16 hd=112 " + json.dumps(decode_112))
    print(f"check decode_attention split edges B={SERVE_BATCH} S=256 bf16 hd=112 "
          + json.dumps(check_decode_split(torch, attention, SERVE_BATCH, 256, gen, KIMI_HEADS)))
    # phi3.5-moe's serving shapes, hd = 128 over 32 query and 8 KV heads, the same way
    flash_128 = check_flash(torch, attention, 1, PROMPT_LEN, gen, True, PHI_HEADS)
    print(f"check flash_attention B=1 S={PROMPT_LEN} causal bf16 hd=128 " + json.dumps(flash_128))
    decode_128 = check_decode(torch, attention, SERVE_BATCH, 256, PHI_HEADS)
    decode_128["launch_floor_ms"] = floor
    print(f"check decode_attention B={SERVE_BATCH} S=256 bf16 hd=128 " + json.dumps(decode_128))
    print(f"check decode_attention split edges B={SERVE_BATCH} S=256 bf16 hd=128 "
          + json.dumps(check_decode_split(torch, attention, SERVE_BATCH, 256, gen, PHI_HEADS)))
    for b, s in ((4, 128), (4, 512), (1, 2048)):
        print(f"check flash_attention B={b} S={s} causal bf16 "
              + json.dumps(check_flash(torch, attention, b, s, gen, True)))
    bwd_main = check_flash_bwd(torch, attention, TRAIN_BATCH, TRAIN_SEQ, gen)
    print(f"check flash_attention_bwd B={TRAIN_BATCH} S={TRAIN_SEQ} causal bf16 "
          + json.dumps(bwd_main))
    print("check flash_attention_bwd B=1 S=2048 causal bf16 "
          + json.dumps(check_flash_bwd(torch, attention, 1, 2048, gen)))
    # the MoE models' training layouts: kimi-k2's (hd = 112) and phi3.5-moe's
    bwd_112 = check_flash_bwd(torch, attention, 1, MOE_TRAIN_SEQ, gen, KIMI_HEADS)
    print(f"check flash_attention_bwd B=1 S={MOE_TRAIN_SEQ} causal bf16 hd=112 "
          + json.dumps(bwd_112))
    bwd_128 = check_flash_bwd(torch, attention, 1, MOE_TRAIN_SEQ, gen, PHI_HEADS)
    print(f"check flash_attention_bwd B=1 S={MOE_TRAIN_SEQ} causal bf16 hd=128 "
          + json.dumps(bwd_128))
    # the families' training attention: the backward pair at each shape of
    # FAM_BWD (non-causal, Sq != Skv, G = 1, S = 704), timed beside SDPA's
    fam_bwd = []
    for label, b, sq, skv, heads, causal in FAM_BWD:
        res = {"shape": f"{label}: B={b} Sq={sq} Skv={skv}, {heads[0]} heads over {heads[1]} KV "
                        f"of {heads[2]}, {'causal' if causal else 'non-causal'}, bf16",
               **check_flash_bwd(torch, attention, b, sq, gen, heads, skv, causal)}
        print("check flash_attention_bwd family " + json.dumps(res))
        fam_bwd.append(res)
    # a sequence shard's causal attention: the flash forward and the backward
    # pair at each query offset of OFFSET_CASES
    offsets = []
    for b, sq, skv, offs, heads in OFFSET_CASES:
        for off in offs:
            res = {"shape": f"B={b} Sq={sq} Skv={skv} q_offset={off}, {heads[0]} heads over "
                            f"{heads[1]} KV of {heads[2]}, causal, bf16",
                   **check_flash_offset(torch, attention, b, sq, skv, off, heads, gen)}
            print("check flash_attention q_offset " + json.dumps(res))
            offsets.append(res)
    # the families phase's attention shapes: non-causal, Sq != Skv, G = 1,
    # S = 704 and 720, each against its plain version, timed beside SDPA
    fam_flash, fam_decode = [], []
    for label, b, sq, skv, heads, causal in FAM_FLASH:
        res = {"shape": f"{label}: B={b} Sq={sq} Skv={skv}, {heads[0]} heads over {heads[1]} KV "
                        f"of {heads[2]}, {'causal' if causal else 'non-causal'}, bf16",
               **check_flash(torch, attention, b, sq, gen, True, heads, skv, causal)}
        print("check flash_attention family " + json.dumps(res))
        fam_flash.append(res)
    for label, b, s, heads in FAM_DECODE:
        res = {"shape": f"{label}: B={b} S={s}, {heads[0]} heads over {heads[1]} KV of "
                        f"{heads[2]}, bf16", **check_decode(torch, attention, b, s, heads)}
        res["launch_floor_ms"] = floor
        print("check decode_attention family " + json.dumps(res))
        fam_decode.append(res)
        print(f"check decode_attention split edges family {label} "
              + json.dumps(check_decode_split(torch, attention, b, s, gen, heads)))
    # the mesh families case's new shard shapes, in its f32
    mesh_flash = []
    for label, b, sq, skv, off in MESH_FAM_FLASH:
        res = check_flash_mesh_family(torch, attention, label, b, sq, skv, off, gen)
        print("check flash_attention mesh family " + json.dumps(res))
        mesh_flash.append(res)
    mesh_decode = check_decode_memory_tile(torch, attention, gen)
    print("check decode_attention mesh family " + json.dumps(mesh_decode))
    bf16_products(torch, torch.device("cuda", 0), torch_default)

    svc = PilotComputeService()
    try:
        broker = svc.submit_pilot({"number_of_nodes": 2, "type": "kafka"})
        spark = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"})
        cluster, ctx = broker.get_context(), spark.get_context()
        device = ctx.devices[0]
        km = kmeans_path(torch, kernels, miniapps, cluster, ctx, device)
        kw = kmeans_wide_path(torch, kernels, miniapps, cluster, ctx, device)
        rc = recon_path(torch, kernels, miniapps, tomo, cluster, ctx, device)
        sv = serve_path(torch, kernels, miniapps, cluster, ctx, device)
        sm = serve_moe_path(torch, kernels, miniapps, cluster, ctx, device)
        fm = families_path(torch, kernels, miniapps, cluster, ctx, device)
    finally:
        svc.cancel()
    rescore(torch, sv["app"].model, sv["params"], sv["served"])
    checkpoint_round_trip(torch, sv["params"])
    del sv["params"], sv["app"]  # the served model's card memory
    tn = train_path(torch, kernels)
    ftr = families_train_path(torch, kernels, device)
    trd = trained_path(torch, kernels, miniapps, device)
    pl = pipeline_path(torch, kernels, pipeline, kmeans, tomo)
    ct = continuous_path(torch, kernels, pipeline, miniapps, kmeans)
    tr = transport_path(torch, kernels, pipeline, miniapps, tomo)
    torch.cuda.empty_cache()  # the ranks share the card
    ms = mesh_path(torch, kernels)
    torch.cuda.empty_cache()
    print("a18 row_product " + json.dumps(row_product_copies(torch, ms["row_products"],
                                                           ms["serve_bf16_wall_s"])))
    torch.cuda.empty_cache()  # the group's ranks share the card
    tg = train_group_path(torch, kernels, torch.device("cuda", 0))
    dr = dryrun_path(torch, kernels, cell)
    paths = {"kmeans_path": km["launches"], "kmeans_wide_path": kw["launches"],
             "lightsource_path": rc["launches"], "serve_path": sv["launches"],
             "serve_moe_path": sm["launches"], "families_path": fm["launches"],
             "train_path": tn["launches"], "families_train_path": ftr["launches"],
             "trained_path": trd["launches"],
             "pipeline_path": pl["launches"], "continuous_path": ct["launches"],
             "transport_path": tr["launches"], "mesh_path": ms["launches"],
             "train_group_path": tg["launches"], "dryrun_path": dr["launches"]}
    launches = {k.name: sum(p[k.name] for p in paths.values()) for k in kernels.KERNELS}
    print("launches " + json.dumps(paths))
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    if km["launches"]["kmeans_assign"] < 1:
        raise AssertionError("kmeans_assign was not launched on the K-Means stream")

    src = "src/repro_torch/kernels/csrc/"

    def moe_shape(r: dict, shape: str, heads: tuple) -> dict:  # a MoE model's layout
        return {"shape": f"{shape}, {heads[0]} heads over {heads[1]} KV heads of {heads[2]}, bf16",
                **{k: r[k] for k in ("max_abs_err", "worst_err_over_tol", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}}

    def family_shapes(results: list) -> list:  # the families phase's shapes
        return [{k: r[k] for k in ("shape", "max_abs_err", "worst_err_over_tol", "ms",
                                   "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for r in results]

    def bwd_row(r: dict, part: str) -> dict:  # one backward kernel's numbers in a check
        return {**r, "ms": r[f"{part}_ms"], "bound_ms": r[f"{part}_bound_ms"],
                "bound_by": r[f"{part}_bound_by"]}

    def offset_shapes(part: str) -> list:  # the q_offset checks' numbers
        keys = {"fwd": ("max_abs_err", "worst_err_over_tol", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"),
                "bwd": ("bwd_max_abs_err", "bwd_worst_err_over_tol", "bwd_ms", "bwd_plain_ms",
                        "bwd_bound_ms", "bwd_bound_by", "library_bwd_ms")}[part]
        return [{"shape": r["shape"], **{k.replace("bwd_", ""): r[k] for k in keys},
                 "planted_offset_least_over_tol": r["planted_offset_least_over_tol"]}
                for r in offsets]

    def bwd_family_shapes(part: str) -> list:  # the families' training shapes
        return [{k: bwd_row(r, part)[k] for k in ("shape", "max_abs_err", "worst_err_over_tol",
                                                  "ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "fwd_lse_ms")}
                for r in fam_bwd]

    rows = [
        ("kmeans_assign", src + "kmeans_assign.cu", "src/repro/kernels/kmeans/kernel.py:45", assign_main),
        # no TPU kernel: the reference's update is a jnp scatter (update_scatter)
        ("kmeans_update", src + "kmeans_update.cu", "src/repro/kernels/kmeans/ref.py:38", update_main),
        ("tomo_backproject", src + "tomo.cu", "src/repro/kernels/tomo/kernel.py:86", bp),
        ("tomo_project", src + "tomo.cu", "src/repro/kernels/tomo/kernel.py:107", fp),
        # the serving instantiation's numbers; the training forward (the
        # log-sum-exp written) is held per element at the training shape too
        ("flash_attention", src + "flash_attention.cu", "src/repro/kernels/attention/kernel.py:81",
         {**flash_main, "max_abs_err": max(flash_main["max_abs_err"], bwd_main["fwd_out_max_abs_err"],
                                           flash_112["max_abs_err"], flash_128["max_abs_err"],
                                           *(r["max_abs_err"] for r in fam_flash),
                                           *(r["fwd_out_max_abs_err"] for r in fam_bwd)),
          "families": family_shapes(fam_flash), "q_offset": offset_shapes("fwd"),
          "mesh_families": family_shapes(mesh_flash),
          "hd112": moe_shape(flash_112, f"B=1 S={PROMPT_LEN} causal", KIMI_HEADS),
          "hd128": moe_shape(flash_128, f"B=1 S={PROMPT_LEN} causal", PHI_HEADS),
          "with_lse": {"shape": f"B={TRAIN_BATCH} S={TRAIN_SEQ}",
                       "max_abs_err": bwd_main["fwd_out_max_abs_err"],
                       "worst_err_over_tol": bwd_main["fwd_out_worst_err_over_tol"],
                       "lse_max_abs_err": bwd_main["lse_max_abs_err"], "ms": bwd_main["fwd_lse_ms"]}}),
        ("decode_attention", src + "decode_attention.cu",
         "src/repro/kernels/attention/decode_kernel.py:79",
         {**decode_main, "max_abs_err": max(decode_main["max_abs_err"], decode_112["max_abs_err"],
                                            decode_128["max_abs_err"], dr["shard"]["max_abs_err"],
                                            *(r["max_abs_err"] for r in fam_decode)),
          "families": family_shapes(fam_decode),
          "mesh_families": family_shapes([mesh_decode]),
          "shard": {k: dr["shard"][k] for k in ("shape", "max_abs_err", "worst_err_over_tol",
                                                "lse_max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
          "hd112": moe_shape(decode_112, f"B={SERVE_BATCH} S=256", KIMI_HEADS),
          "hd128": moe_shape(decode_128, f"B={SERVE_BATCH} S=256", PHI_HEADS)}),
        # no TPU kernel: the reference's flash backward is the pure-JAX
        # custom_vjp of runtime/sharded_attention.py (_flash_bwd); plain_ms
        # and library_ms are the whole backward's, the pair's (dq and dkdv)
        *((f"flash_attention_bwd_{part}", src + "flash_attention_bwd.cu",
           "src/repro/runtime/sharded_attention.py:165",
           {**bwd_row(bwd_main, part), "scope": BWD_SCOPE,
            "max_abs_err": max(bwd_main["max_abs_err"], bwd_112["max_abs_err"],
                               bwd_128["max_abs_err"], *(r["max_abs_err"] for r in fam_bwd)),
            "families": bwd_family_shapes(part),
            "q_offset_pair": offset_shapes("bwd"),
            "hd112": moe_shape(bwd_row(bwd_112, part), f"B=1 S={MOE_TRAIN_SEQ} causal", KIMI_HEADS),
            "hd128": moe_shape(bwd_row(bwd_128, part), f"B=1 S={MOE_TRAIN_SEQ} causal", PHI_HEADS)})
          for part in ("dq", "dkdv")),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **{key: r[key] for key in ("hd112", "hd128", "families", "with_lse", "scope",
                                    "q_offset", "q_offset_pair", "shard", "mesh_families")
            if key in r}}
        for name, source, replaces, r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
