#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

0. the card's name and power limit (nvidia-smi), then the nvcc build of the
   CUDA kernels (K2 in two routes) from ``src/repro_torch/kernels/csrc``;
1. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (K1-K4: the 8-objective smoke spec, k = 1024 each,
   capacity 8201; K2's global route (select.cu) bit for bit at
   [8, n] k = 1025 and 8202, on a compaction priority row at k = 8201 and
   on rows with a tie at the threshold, and its kept per-span kernel
   (blockselect.cu) on the same inputs, both routes timed beside a stable
   torch.sort of the row and torch.topk, warm and with a cold L2; K5:
   c = 4098 slab points of dim 68 against (Q, Cmax) in
   {(1, 20), (128, 20), (128, 1)}, and dim 3, in cost mode at mu in
   {1, 2, 1.5} and in ball mode, run-to-run and alone-vs-batch bits; K6:
   exact on all rows at n = 65,536 of the capping inputs and of a
   tie-heavy input, and at n = 2^20 on 4,096 sampled rows plus 256 of
   each clipped weight, 0.1 and 10), with the kernel's, the plain
   version's and, where one exists, a single PyTorch call's time (CUDA
   events, median of 21; K6's plain version of 5; K5 also at Q = 16;
   K1 also in its seeds-only mode and at the upkeep fold's n = 16,402),
   and the registers, local (spill) bytes and static shared memory of K4
   and K5 from ``cudaFuncGetAttributes`` with their launch plans;
2. serving through ``EnginePool``: 3 tenants x 4 shards, 16 chunks of
   1,048,576 rows each, interleaved with 32 submitted query batches
   (B = 128, all 8 objectives) per tenant; every response FRESH, the
   whole-stream sum/count estimates within 4 cv of the exact values, a
   plain-path twin engine bit-equal, the last round's pumped answers
   bit-equal to direct queries, and one absorb / one query moving the
   kernel launch counters by exactly (2, 4, 2, 0, 0, 0) /
   (0, 0, 0, 1, 0, 0);
3. durability: snapshot + WAL tail, close, ``EnginePool.open``, answers
   bit-identical;
4. the metric tier at the shape of US Census Data (1990), 2,458,285 points
   x 68 attributes (a 20-component Gaussian mixture made on the card from a
   fixed seed): ``ClusterEngine(k=4096, mu=2, 8 anchors)`` absorbs it in 10
   chunks, ``local_search(k=20, n_cand=32, rounds=16)`` and
   ``kcenter(20)`` run on it; a plain-path twin engine gives a bit-equal
   slab and service costs within rtol 1e-5, one absorb / one service_costs
   move the counters by exactly (1, 2, 1, 0, 0, 0) / (0, 0, 0, 0, 1, 0),
   the estimated costs of the generator's centers and of the search's
   initial set lie within 4 cv of their exact costs over all points, the
   search does not raise the exact cost, and k-center's coverage equals
   its total;
5. the universal tier, ``examples/quickstart.py`` at 2^20 keys (weights
   lognormal(0, 2) made on the card, hash seed 42, k = 64): one universal
   monotone sample (size within the Thm 5.1 expectation plus 4 sigma;
   COUNT, SUM, thresh(5), cap(2), moment(1.5) on the segment domain == 3
   within 4 cv of exact), 16 shard sketches folded with ``merge_sketches``
   equal to the whole-set sketch (member triples) with its SUM within
   4 cv, ``ops.multi_objective_bottomk_kernel`` (K1 + K2) equal to
   ``multi_bottomk_sample`` (members exact, probs within 1e-6), and on
   weights clip(lognormal(0, 1), 0.1, 10) ``universal_capping_sample``
   (k = 64, m_cap = 4096) against ``ops.universal_capping_kernel`` (K6 at
   2^20): members and hl equal, size within Thm 6.1's bound, cap_T
   estimates within 4 cv for T in {0.5, 1, 2, 5}; then a warm sample and
   a shard fold under the profiler (wall, device time, idle share);
6. scale-out serving through ``ShardedEnginePool``: one tenant of the
   smoke spec over 4 in-process hosts x 16 shards on the card, 16 chunks
   of 1,048,576 rows with a durable WAL, a query batch (B = 128) after
   each; every FRESH answer bit-equal to a single-host
   ``SegmentQueryEngine`` twin, one cross-host merge per epoch, one absorb
   / one cross-host query moving the counters by exactly
   (2, 4, 2, 0, 0, 0) / (1, 2, 1, 1, 0, 0), a host kill answered STALE
   with the last good values, ``rebalance`` FRESH and bit-equal again,
   and close + ``ShardedEnginePool.open`` back at the post-move placement
   with bit-identical answers; absorb and query p50/p95, the cross-host
   merge's wall time (synchronised before and after, median of 5) and the
   rebalance's wall time.

7. the training path at the full width of qwen2-1.5b (28 layers,
   d_model 1536, GQA 12/2 heads, d_ff 8960, vocab 151,936; 1,543,714,304
   fp32 parameters, random from seed 0): (a) ``train.main`` for 6 steps,
   batch 8 x seq 128, mesh 1x1x1 (NCCL at world size 1), the sampled
   exchange (k = 256), importance sampling and the telemetry fold, a
   checkpoint every 3 steps; each step's launches (9, 10, 1, 0, 0, 0); a
   resume from step 3 whose restored arrays carry the saved crc32s and
   whose losses 4-6 equal the first run's within RESUME_RTOL; one more
   step profiled whole and in its parts (forward + backward, exchange,
   AdamW, telemetry), the telemetry fold's kernel path equal to its plain
   path; the exchange at one pod returning its input;
   ``_sample_leaf`` through K1 + K2 against their plain versions on the
   real gradient of ``layers.attn.wq`` (66,060,288 rows) and the kernel
   alone on ``layers.mlp.wg`` (385,351,680 rows: at most 768 valid slots,
   finite positive taus, the HT |g| mass within 4 / sqrt(255)), where K1
   (seeds only, F = 3; within 2 ulp of plain) and K2 ([3, n], k = 257;
   equal to plain) are timed against their plain versions and
   ``torch.topk``; (b) two processes on the card over
   gloo, mesh 2x1x1, the same widths at 2 layers: 3 compressed steps,
   the exchanged ``layers.attn.wq`` gradient equal to the formula over the
   gathered slabs on the host, ``sharded_multisketch`` over the two
   ranks' halves of 2^20 rows equal to the one-shot build (members and
   taus exact, probs within 1e-5) and ``from_sharded``'s merged slab
   bit-equal to it;
8. model serving at full width, random weights from seed 0 (8a-8c:
   qwen2-1.5b; 8d: granite-moe-1b-a400m, 24 layers, d_model 1024, 32
   experts top-8, 1,334,756,352 parameters; 8e: qwen2-moe-a2.7b, 60
   experts top-4 + 4 shared, QKV bias, 14,315,735,040): (a)
   ``launch/serve.main`` at batch 8 x prompt 1024, gen 64: prefill,
   grow_cache, greedy decode, prefill ms and decode ms/token (p50 of the
   per-step CUDA-event times), peak memory; prefill and decode launch none
   of the port's kernels, the request telemetry's absorb moves K1-K3, its
   query (0, 0, 0, 1, 0, 0), the request-shape search K5, and the pool's
   estimates are exact (every request is in the sample); every kernel
   launch of the run is recorded with its inputs and outputs and held
   against its plain version (phase 1's tolerances), and plain-path twins
   on the card give the pool's answers (both predicates) within rtol
   1e-5, the request-shape slab bit for bit and the service costs of the
   search's centers and of 15 seeded center sets within rtol 1e-5; (b) fp32
   activations, batch 2 x 64: serve_step's logits at every position and
   prefill's last-position logits within 5e-3 x max(scale, 1) of
   forward_logits; (c) 16 decode steps (CUDA events) and one profiled
   step (wall, device, idle share) at 8a's cache, then the same at
   decode_32k's cache length 32,768 with the batch cut from 128 to 8
   (7.52 GB of KV from a seeded generator) beside its bound (bf16 weights
   and KV read once) and the traffic of the current design (per-call
   weight casts, the fp32 tied head, the KV read and k's fp32 up-cast);
   (d) granite-moe through serve.main at 8a's traffic, the fp32
   consistency within 2e-2 x max(scale, 1) at a capacity_factor of
   max(8, E / top_k) (capacity >= the sequence: no full-forward drop,
   as the reference test intends; 8 for granite, 15 for qwen2-moe), decode
   steps timed and profiled as in (c) at 8a's cache, ``train.main`` for 3
   steps (batch 8 x seq 128,
   ``--compress --importance-sampling``, mesh 1x1x1, launches (10, 11, 1,
   0, 0, 0) per step: 9 sampled leaves and the telemetry fold, finite
   losses) and ``_sample_leaf`` on the real gradient of ``layers.moe.wi``
   (402,653,184 rows; the checks and timings of 7a's wg leaf); (e)
   qwen2-moe-a2.7b through serve.main at batch 4 x prompt 512, gen 16
   (the checks of (a)), the fp32 consistency of (d), then decode steps
   timed and profiled at batch 4, cache 528;
9. the state-space families at full width, random weights from seed 0:
   falcon-mamba-7b (ssm: 64 Mamba-1 layers, d_model 4096, d_inner 8192,
   N = 16, vocab 65,024; 7,272,665,088 parameters) and zamba2-2.7b
   (hybrid: 54 Mamba-2 layers, 80 heads x 64, N = 64, and the published
   Zamba2 block's two shared blocks over 9 calls; 2,662,214,560): (a)
   falcon-mamba through ``serve.main`` at 8a's traffic with 8a's checks;
   (b) for both, the fp32 consistency of 8b at its 5e-3 bar; (c)
   falcon-mamba's decode as 8c at 9a's state (printed beside a 1,088-slot
   qwen2-1.5b KV cache), then 16 steps at batch 1 from long_500k's last
   position 524,287 and from position 2 (a seeded state, no prefill);
   zamba2's decode at 9d's cache and at decode_32k's 32,768 slots with
   the batch cut from 128 to 8 (48.3 GB of KV from a seeded generator);
   (d) zamba2 through ``serve.main`` at 8a's traffic with 8a's checks,
   ``train.main`` for 3 steps (batch 8 x seq 128, ``--compress
   --importance-sampling``, mesh 1x1x1; launches (23, 24, 1, 0, 0, 0) per
   step: 22 sampled leaves and the telemetry fold; 27 of K7 a step, 9
   shared calls x forward, recompute and backward; finite losses) and
   ``_sample_leaf`` on the real gradient of ``layers.mamba.wx``
   (707,788,800 rows, F n = 2,123,366,400 < 2^31; the checks and timings
   of 7a's wg leaf), the train state freed first;
10. the encoder and vlm families at full width, random weights from
   seed 0: hubert-xlarge (encoder: 48 bidirectional layers, d_model 1280,
   16 heads of 80, d_ff 5120, gelu, layernorm, vocab 504 padded to 512;
   945,277,440 parameters, over stub frame embeddings) and internvl2-76b
   (vlm: d_model 8192, GQA 64/8 heads of 128, d_ff 28,672, vocab 128,256
   untied, 256 stub patch embeddings before the text; the depth cut from
   80 to 8 layers, 8,946,589,696 parameters, 35.8 GB in fp32, since 80
   take 282 GB and its config is FSDP): (a) hubert ``train.main`` for 3
   steps at full depth, batch 8 x 1024 frames, mesh 1x1x1, the sampled
   exchange (k = 256), importance sampling and the telemetry fold, a
   checkpoint every 2 steps; finite losses, each step's launches the
   fold's (1, 2, 1) plus one K1 and one K2 for each of its 8 sampled
   leaves; a resume from step 2 as 7a's; ``_sample_leaf`` on the real
   gradient of ``layers.mlp.wi`` (314,572,800 rows; the checks and
   timings of 7a's wg leaf); (b) hubert's inference forward
   (``make_prefill_step``, no cache) at batch 8 x 1024, profiled, then at
   batch 1 x 32,768 frames (``prefill_32k``'s length, its batch cut from
   32; the length cut to the longest multiple of 512 that one profiled
   layer predicts inside ENCODER_LONG_BUDGET_S), and in fp32 at 2 layers
   prefill's last-position logits within 5e-3 x max(scale, 1) of
   forward_logits; (c) internvl2 (8 layers) through ``serve.main`` at
   batch 8 x [256 patches | 768 tokens], gen 64, decoding from index
   1,024, with 8a's checks and launches (2, 4, 2, 1, 2, 0); 16 decode
   steps and one profiled step with its copy kernels' share (the per-call
   weight casts); fp32 at 2 layers: serve_step from index 256 + t against
   forward_logits over [patches | tokens] within 5e-3 x max(scale, 1),
   and 32 greedy picks equal to the full forward's; (d) internvl2-smoke
   trained 3 steps on the card through ``train.main`` with the exchange,
   (1, 2, 1, 0, 0, 0) a step, every launch held against its plain
   version.
11. placement over gloo processes on the one card (``--place-worker``
   processes; fp32 activations), each held against a one-process run of
   the port with the same seed in this process: (a) FSDP, qwen2-moe-a2.7b
   at full width cut to 2 layers (its config sets ``fsdp``; each step
   gathers every layer through the host), mesh (1, 2, 1) in 2 processes:
   2 train steps at batch 8 x 128 (every step's loss and grad norm rtol
   1e-5; the first step's gradient within 1e-5 of each leaf's largest at
   4,096 sampled elements a leaf, read from the ranks' blocks; the MoE's
   top-k choices compared call by call, the flips printed with the least
   gate gap; after each step the sampled params rtol 1e-4 / atol 1e-6
   wherever the gradient agreed within GRAD_AGREE in every step so far,
   HELD_MIN of each leaf before the first routing flip: see
   ``_hold_train``),
   each rank's state bytes at most
   half of the one-process state plus the leaves the rule keeps whole,
   peak memory beside the one-process run's; then ``make_prefill_step``
   at batch 4 x 128 and 2 greedy ``make_serve_step`` steps (logits rtol
   1e-5, greedy tokens equal); (b) tensor parallelism and the per-shard
   exchange, qwen2-1.5b at 2 layers, mesh (2, 1, 2) in 4 processes: 3
   compressed steps (k = 256, min_size 65,536), the first loss rtol 1e-5
   of the one-process run's, every K1 (seeds only) and K2 launch held
   against its plain version at the call, one block's exchange against
   the formula over the gathered slabs, K1 and K2 timed at the largest
   block (emb.tok's [75,968, 1,536]), then one step at microbatch 2 on 6
   rows without the exchange (parts of 3 rows over the 2 (pod, data)
   ranks: shares of 2 and 1, as the reference cuts the global batch),
   its loss and grad norm rtol 1e-5 of the one-process microbatched
   step's; (c) gemma-2b and phi3-mini-3.8b at
   full width and depth, mesh (1, 1, 2) in 2 processes: prefill at batch
   4 x 128 and 4 greedy decode steps (gemma's cache placed on hd, the
   gathered case; phi3's on S, sequence-parallel), logits rtol 1e-5 and
   greedy tokens equal; (d) tensor parallelism over ``inner`` for the
   state-space families at full width: falcon-mamba-7b cut to 2 layers
   and zamba2-2.7b's JAX twin (``configs/twins.py``: the published block
   has no tensor-parallel form) to 6 (one group: its shared attention
   block runs once), mesh (1, 1, 2) in 2 processes: prefill at batch 4 x 512 and 8
   greedy decode steps (the Mamba states placed by ``cache_pspecs``),
   logits rtol 1e-5 and greedy tokens equal, each rank's param bytes
   beside the one-process run's; then zamba2 at (2, 1, 2) in 4 processes,
   2 steps with the exchange (k = 256, min_size 65,536): the first loss
   within 1e-6 of the one-process run's (the second follows the
   exchange, which samples each rank's block there), every K1 / K2
   launch held against its plain version at the call, a Mamba block
   ([6, 2560, 2560] of wx / wz / out_proj) among the sampled ones, and K1
   and K2 timed at that block; (f) K7 on heads split over model:
   qwen2-1.5b at 2 layers in bf16, mesh (1, 1, 2) in 2 processes (6 q
   heads and 1 kv head a rank), 2 train steps, every K7 forward and
   backward call held at the call against the plain loop on the same
   shards through phase 14's gate, the ranks' losses equal, the launches
   counted.
12. the dry run against the card (``repro_torch.launch.dryrun``): (a) the
   meta twin of 7a's step (qwen2-1.5b, batch 8 x 128, the exchange and
   the telemetry fold, one process), walked with trip counts (the layer
   loop's first layer walked, the rest booked) and with every layer
   walked: the same counts, the ops dispatched and booked printed; its
   argument bytes equal to the state and batch held on the card, its
   arguments plus temporaries within 0.97-1.01 of
   ``torch.cuda.max_memory_allocated`` over 4 steps of the same step on
   the card, and its matmul FLOPs over the step's p50 as achieved
   TFLOP/s; (b) the production cell zamba2-2.7b x decode_32k on (2, 16,
   16) through the CLI in its own process: status ok, memory and cost
   filled.
13. the twins of ``examples/*.py`` (``examples/torch/``) on the card at
   their short settings: quickstart at 100,000 keys, cluster_centers at
   4,000 points, serve_batched (zamba2-2.7b smoke) with 4 generated
   tokens and train_with_sampled_telemetry (granite-moe smoke) for 3
   steps, each through its ``main`` in this process; then
   gradient_compression_demo's ``worker`` in 8 gloo processes
   (``--demo-worker``; its 2 x 2 x 2 mesh), 2 dense and 2 sampled steps:
   the first losses equal, fewer bytes across pods sampled than dense,
   K1 and K2 launched on every rank. Every kernel launch of the phase is
   recorded at the call and held against its plain version on its
   inputs.
14. K7, attention (``kernels/attention.py``): the kernels against their
   plain loop in bf16 on every ``ATTN_CASES`` row (granite-moe's
   [4, 4,096, 16/8, 64], head dims 48 to 256, MQA, a group of 6,
   non-causal, q_offset with kv_valid_len, Sq != Sk, ragged tiles, and
   zamba2-2.7b's [2, 4,096, 32/32, 160] at its softmax scale 1/sqrt(80),
   the kernel and the plain loop both given it): out,
   dq, dk, dv through ``attn_gate`` (every tile of 64 positions within
   ATTN_TILE_GAP in norm, at most ATTN_ULP_SHARE of the elements more
   than one bf16 ulp apart) and the same bits run to run; at granite's
   shape three faults planted in the plain loop (a skipped diagonal kv
   tile, a skipped last kv tile, the split's mid and lo parts dropped)
   each break the gate; then at granite's shape the forward's and
   backward's
   times beside the reference's products at the bf16 peak, the plain
   loop's and scaled_dot_product_attention's (a yardstick the port never
   calls). (The fp32 checks of phases 8-11 run attention's plain loop: the
   kernel takes bf16 alone; 11f runs it in bf16.)
15. K8, the MoE's slot count (``kernels/moe_slots.py``): the kernel
   against its plain version, bit for bit, and the same bits run to run,
   on every ``SLOT_CASES`` row (granite-moe's [4, 32,768] at E 32, C
   1,280; qwen2-moe's E 60 and its padded 64 at top-4; decode at S = 1;
   one row; a row that is no multiple of its tile; every choice to one
   expert; E 128; a row of 64 of the largest tiles); at granite's shape
   its time, warm and with a cold L2, beside its byte bound, the plain
   one-hot cumsum's and a stable torch.sort of the row's (a yardstick the
   port never calls); then a granite-moe train step (24 layers, 2
   microbatches, 4 x 256) under a profiler counting 144 ``attn.kernel``
   and 96 ``moe.slots_kernel``, each as many as its wrapper's launches.

Prints the card line, a ``{"kernels": [...]}`` line (launch counts of K1-K4
from phase 2, of K5 from phase 4 and of K6 from phase 5, errors and times
from phase 1; K2's row is its global route, with both routes named under
``routes``; K6's row gives its time at n = 2^20 and its plain version's
at ``plain_n`` = 65,536, beside the kernel's own time there; every row's
``train_launches`` are phase 7a's first run, K1's and K2's ``exchange_*``
keys their times at the exchange's largest leaf; every row's
``moe_train_launches`` are 8d's run and ``serve_launches`` 8a's
serve.main run, K1's and K2's ``moe_exchange_*`` keys their times at
``layers.moe.wi``; every row's ``ssm_serve_launches`` are 9a's run and
``hybrid_train_launches`` 9d's, K1's and K2's ``hybrid_exchange_*`` keys
their times at ``layers.mamba.wx``; every row's ``encoder_train_launches``
are 10a's first run and ``vlm_serve_launches`` 10c's serve.main run, K1's
and K2's ``encoder_exchange_*`` keys their times at ``layers.mlp.wi``)
and, last,
``{"ok": true, ...}``. Every row's ``placement_launches`` are 11b's run
summed over its 4 ranks; K1's and K2's ``placement_block_*`` keys their
times at 11b's largest block; every row's ``placement_ssm_launches`` are
11d's training summed over its 4 ranks, and K1's and K2's
``placement_ssm_block_*`` keys their times at 11d's largest Mamba
block; every row's ``examples_launches`` are phase 13's, summed over the
twins and the demo's 8 ranks. K7's row (``attention``) is phase 14's,
its ``hybrid_train_launches`` 9d's a step, its ``placement_launches``
11f's summed over its 2 ranks; K8's row (``moe_slots``) is phase 15's;
both rows' ``step_launches`` are 15's granite step.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PLACE_WORKER_CMD = [sys.executable, str(Path(__file__).resolve())]
CHUNK = 1 << 20                 # rows per absorbed chunk
N_CHUNKS = 16                   # chunks per tenant
SHARDS = 4
B = 128                         # predicates per query batch
QUERIES_PER_TENANT = 32
CENSUS_N = 2_458_285            # US Census Data (1990), UCI: points
CENSUS_DIM = 68                 # ... and attributes
CENSUS_COMPONENTS = 20          # mixture components = centers sought
CENSUS_CHUNKS = 10
SLAB_K = 4096                   # ClusterEngine(k=...): capacity 4098
LS_CAND = 32
LS_ROUNDS = 16
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
REPS = 21
K6_SMALL = 65_536               # K6 kernel = plain on all rows
K6_ROWS = 4096                  # ... and on this many rows at 2^20
K6_CLIP_ROWS = 256              # ... plus this many of each clipped weight
UNIVERSAL_N = 1 << 20           # keys of the universal tier (phase 5)
UNIVERSAL_K = 64
UNIVERSAL_SHARDS = 16
CAPPING_M_CAP = 4096
SERVING_KERNELS = ("seeds", "blockselect", "compact", "segquery")
SCALE_HOSTS = 4                 # in-process hosts of phase 6
SCALE_SHARDS = 16
TRAIN_ARCH = "qwen2-1.5b"       # phase 7: the full-width training path
TRAIN_STEPS = 6
TRAIN_STEP_LAUNCHES = (9, 10, 1, 0, 0, 0)  # 8 sampled leaves + 1 fold
RESUME_RTOL = 1e-5              # resumed losses vs the uninterrupted run
WORKER_TIMEOUT_S = 400
SERVE_ARCH = "qwen2-1.5b"       # phase 8: the full-width serving path
SERVE_TRAFFIC = ["--batch", "8", "--prompt-len", "1024", "--gen", "64"]
CONSISTENCY_S = 64              # 8b/8d: fp32 decode vs forward, batch 2
LONG_T = 32_768                 # 8c: decode_32k's cache length, ...
LONG_BATCH = 8                  # ... its batch cut from 128 (120 GB of KV)
LONG_STEPS = 16
MOE_ARCH = "granite-moe-1b-a400m"
MOE_STEP_LAUNCHES = (10, 11, 1, 0, 0, 0)   # 9 sampled leaves + 1 fold
BIG_MOE_ARCH = "qwen2-moe-a2.7b"
BIG_MOE_TRAFFIC = ["--batch", "4", "--prompt-len", "512", "--gen", "16"]
SSM_ARCH = "falcon-mamba-7b"        # phase 9: the state-space families
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_STEP_LAUNCHES = (23, 24, 1, 0, 0, 0)  # 22 sampled leaves + 1 fold
HYBRID_STEP_ATTN = 9 * 3            # K7 launches a step: 9 shared calls x
                                    # (forward, remat's recompute, backward)
LONG_500K_LAST = 524_287            # long_500k's last position
ENCODER_ARCH = "hubert-xlarge"      # phase 10: the encoder and vlm families
ENCODER_STEPS = 3
ENCODER_S = 1024                    # frames: ~20 s of audio at 50 Hz
ENCODER_LONG_S = 32_768             # prefill_32k's length, batch cut to 1
ENCODER_LONG_BUDGET_S = 15.0        # ... S cut to fit this wall time
VLM_ARCH = "internvl2-76b"
VLM_LAYERS = 8                      # depth cut from 80: 35.8 GB in fp32
VLM_TRAFFIC = ["--batch", "8", "--prompt-len", "768", "--gen", "64"]
SERVE_RUN_LAUNCHES = (2, 4, 2, 1, 2, 0)  # a serve.main run's telemetry


def plain_attention():
    """K7's plain loop on every device until ``.close()``: for the checks
    that hold an fp32 model on the card against its own forward, a twin or
    the CPU (the kernel takes bf16 alone)."""
    from repro_torch.kernels import attention as KA
    stack = contextlib.ExitStack()
    stack.callback(setattr, KA, "attention_forward", KA.attention_forward)
    stack.callback(setattr, KA, "attention_backward", KA.attention_backward)
    KA.attention_forward = KA.attention_forward_plain
    KA.attention_backward = KA.attention_backward_plain
    return stack


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond, msg: str):
    if not cond:
        _fail(msg)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int = REPS, inner: int = 5) -> float:
    """Median device time of ``fn`` in ms. A sleep kernel holds the stream
    while the host enqueues ``inner`` calls, so the events bracket
    back-to-back device work and no host launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def cuda_ms_cold(torch, fn, flush, reps: int = REPS) -> float:
    """Median device time of one ``fn`` call after ``flush`` (a buffer
    larger than the 50 MB L2) is overwritten, so fn finds its inputs in
    device memory; a sleep kernel holds the stream while the host enqueues
    the flush and the call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def tie_rows(torch, seeds, k: int):
    """The seed rows with a tie at the (k+1)-th smallest spread over every
    span: a quarter of the k + 1 smallest of each row set to the row's
    (k+1)-th smallest value."""
    out = seeds.clone()
    kth = out.kthvalue(k + 1, dim=1, keepdim=True).values
    small = torch.topk(out, k + 1, dim=1, largest=False).indices
    pick = small[:, ::4]
    out.scatter_(1, pick, kth.expand(-1, pick.shape[1]))
    return out


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and fp32-
    rate operations over the fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulps(a, b, chunk: int = 1 << 26):
    """The largest per-element ulp distance of two float32 tensors (+inf
    must match), taken ``chunk`` elements at a time: the boolean gather's
    int64 indices of a whole [3, 707,788,800] pair would need 32 GB."""
    import torch
    a, b = a.reshape(-1), b.reshape(-1)
    worst = 0
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk], b[i:i + chunk]
        _check(torch.equal(torch.isinf(x), torch.isinf(y)),
               "inf pattern differs")
        fin = torch.isfinite(x)
        xi = x[fin].view(torch.int32).to(torch.int64)
        yi = y[fin].view(torch.int32).to(torch.int64)
        if xi.numel():
            worst = max(worst, int((xi - yi).abs().max().item()))
    return worst


def max_abs(a, b) -> float:
    import torch
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max().item()) if fin.any() else 0.0


def smoke_spec(C, scheme: str):
    objs = (C.SUM, C.COUNT, C.thresh(2.0), C.cap(1.5), C.moment(1.5),
            C.thresh(0.5), C.cap(4.0), C.moment(0.5))
    return C.MultiSketchSpec(objectives=tuple((f, 1024) for f in objs),
                             scheme=scheme, seed=17)


def predicate_table(C, rng, key_hi: int):
    """B predicates: EVERYTHING first, then key ranges, key masks and
    hash fractions in turn."""
    preds = [C.EVERYTHING]
    while len(preds) < B:
        r = len(preds) % 3
        if r == 0:
            lo = int(rng.integers(0, key_hi))
            preds.append(C.key_range(lo, int(rng.integers(lo, key_hi))))
        elif r == 1:
            preds.append(C.key_mask(7, int(rng.integers(0, 8))))
        else:
            preds.append(C.hash_fraction(float(rng.uniform(0.05, 0.9)),
                                         int(rng.integers(0, 1000))))
    return C.encode_predicates(preds)


def tenant_chunk(t: int, c: int, rng):
    """Chunk c of tenant t: distinct keys (i * 2654435761) mod 2^31 over
    the tenant's own range of i, lognormal(0, 1.5) weights."""
    i = (np.arange(CHUNK, dtype=np.int64) + t * (1 << 25) + c * CHUNK)
    keys = ((i * 2654435761) % (1 << 31)).astype(np.int32)
    w = rng.lognormal(0.0, 1.5, CHUNK).astype(np.float32)
    return keys, w


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(torch, C, K, dev):
    from repro_torch.kernels.blockselect import (
        batched_bottomk_select_plain, block_candidates_plain,
        select_from_candidates)
    from repro_torch.kernels.compact import (compact_take_plain,
                                             retention_priority_plain)
    from repro_torch.kernels.seeds import fused_seeds_fvals_plain
    from repro_torch.kernels.segquery import segment_query_slab_plain

    rng = np.random.default_rng(1)
    spec = smoke_spec(C, "ppswor")
    enc = spec.kernel_objectives()
    cap = spec.cap
    n = CHUNK + cap                            # one chunk plus one slab
    keys = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, n).astype(
        np.int32)).to(dev)
    w = torch.from_numpy(rng.lognormal(0, 1.5, n).astype(np.float32)).to(dev)
    act = torch.from_numpy(rng.random(n) < 0.99).to(dev)
    out = {}

    # K1 ------------------------------------------------------------------
    exact_rows = [j for j, (kind, _) in enumerate(enc) if kind != 4]
    moment_rows = [j for j, (kind, _) in enumerate(enc) if kind == 4]
    err = 0.0
    for scheme in ("ppswor", "priority"):
        sk, fk = K.fused_seeds_fvals(keys, w, act, enc, scheme, 17)
        sp, fp = fused_seeds_fvals_plain(keys, w, act, enc, scheme, 17)
        torch.cuda.synchronize()
        _check(torch.equal(fk[exact_rows], fp[exact_rows]),
               f"K1 {scheme}: fvals differ for sum/count/thresh/cap")
        _check(ulps(fk[moment_rows], fp[moment_rows]) <= 2,
               f"K1 {scheme}: moment fvals beyond 2 ulp")
        _check(ulps(sk, sp) <= 2, f"K1 {scheme}: seeds beyond 2 ulp")
        if scheme == "priority":
            _check(torch.equal(sk[exact_rows], sp[exact_rows]),
                   "K1 priority: seeds differ for sum/count/thresh/cap")
        err = max(err, max_abs(sk, sp), max_abs(fk, fp))
    nf = len(enc)
    # the seeds-only mode (fused_seeds), and the upkeep fold's shape
    # (two slabs, n = 16,402) in both modes
    up = 2 * cap
    for n_, k_, w_, a_ in ((n, keys, w, act),
                           (up, keys[:up], w[:up], act[:up])):
        sp, fp = fused_seeds_fvals_plain(k_, w_, a_, enc, "ppswor", 17)
        so = K.fused_seeds(k_, w_, a_, enc, "ppswor", 17)
        sk, fk = K.fused_seeds_fvals(k_, w_, a_, enc, "ppswor", 17)
        torch.cuda.synchronize()
        _check(ulps(so, sp) <= 2 and ulps(sk, sp) <= 2,
               f"K1 n={n_}: seeds beyond 2 ulp")
        _check(torch.equal(so, sk), f"K1 n={n_}: seeds-only bits differ")
        _check(torch.equal(fk[exact_rows], fp[exact_rows])
               and ulps(fk[moment_rows], fp[moment_rows]) <= 2,
               f"K1 n={n_}: fvals beyond their tolerance")
        err = max(err, max_abs(so, sp))

    def k1_times(k_, w_, a_):
        n_ = k_.shape[0]
        # bytes: key, weight, active read once; F seeds (+ F f-values)
        # written. ops: per row hash->u->r (~30) plus per objective f(w),
        # test, divide.
        ops = n_ * (30 + 4 * nf)
        b_f = bound(n_ * 9 + 2 * nf * n_ * 4, ops)
        b_s = bound(n_ * 9 + nf * n_ * 4, ops)
        return dict(
            ms=cuda_ms(torch, lambda: K.fused_seeds_fvals(
                k_, w_, a_, enc, "ppswor", 17)),
            plain_ms=cuda_ms(torch, lambda: fused_seeds_fvals_plain(
                k_, w_, a_, enc, "ppswor", 17)),
            bound_ms=b_f[0], bound_by=b_f[1],
            seeds_only_ms=cuda_ms(torch, lambda: K.fused_seeds(
                k_, w_, a_, enc, "ppswor", 17)),
            seeds_only_bound_ms=b_s[0])

    big, small = k1_times(keys, w, act), k1_times(keys[:up], w[:up],
                                                  act[:up])
    out["seeds"] = dict(max_abs_err=err, **big, library_ms=None,
                        upkeep_n=up, upkeep_ms=small["ms"],
                        upkeep_bound_ms=small["bound_ms"],
                        upkeep_seeds_only_ms=small["seeds_only_ms"],
                        upkeep_seeds_only_bound_ms=small[
                            "seeds_only_bound_ms"])
    for n_, t in ((n, big), (up, small)):
        print(f"K1 seeds n={n_} F={nf}: kernel {t['ms']:.4f} ms "
              f"(seeds only {t['seeds_only_ms']:.4f}), plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; seeds only "
              f"{t['seeds_only_bound_ms']:.4f}); exact/<=2ulp checks "
              f"passed, seeds-only bits equal", flush=True)

    # K2 ------------------------------------------------------------------
    # the main path's two selects: multisketch_select over the F seed rows
    # (k = kmax + 1 = 1025) and compact_take over one priority row
    # (k = capacity = 8201); the global route (select.cu) against the plain
    # version, and the kept per-span kernel (blockselect.cu) against its own
    seeds, _ = K.fused_seeds_fvals(keys, w, act, enc, "ppswor", 17)
    sorted_keys = torch.sort(keys).values         # K3's inputs too
    member = torch.from_numpy(rng.random(n) < cap / n).to(dev)
    keep = member | torch.from_numpy(rng.random(n) < 8 / n).to(dev)
    pri = retention_priority_plain(sorted_keys, w, member, keep)[None, :]
    ties = tie_rows(torch, seeds, 1025)
    err = 0.0
    for what, s_in, k in (("seeds", seeds, 1025), ("seeds", seeds, cap + 1),
                          ("priority row", pri, cap),
                          ("tie at the threshold", ties, 1025)):
        vk, ik, tk = K.batched_bottomk_select(s_in, k)
        vp, ip, tp = batched_bottomk_select_plain(s_in, k)
        torch.cuda.synchronize()
        _check(torch.equal(vk.view(torch.int32), vp.view(torch.int32))
               and torch.equal(ik, ip) and torch.equal(tk, tp),
               f"K2 {what} k={k}: vals/idx/tau differ")
        ck = K.blockselect.block_candidates(s_in, min(k + 1, n))
        cp = block_candidates_plain(s_in, min(k + 1, n))
        _check(torch.equal(ck[0], cp[0]) and torch.equal(ck[1], cp[1]),
               f"K2 {what} k={k}: per-span candidates differ")
        err = max(err, max_abs(vk, vp))
    _check(int((ties[0] == ties[0].kthvalue(1026).values).sum()) > 1,
           "K2: the tie input has no tie at its threshold")
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    times = {}
    for name, s_in, k in (("seeds", seeds, 1025), ("priority row", pri, cap)):
        nf_, ksel = s_in.shape[0], min(k + 1, n)
        t = dict(
            ms=cuda_ms(torch, lambda: K.batched_bottomk_select(s_in, k)),
            cold_ms=cuda_ms_cold(torch, lambda: K.batched_bottomk_select(
                s_in, k), flush),
            span_route_ms=cuda_ms(torch, lambda: select_from_candidates(
                *K.blockselect.block_candidates(s_in, ksel), n, k)),
            span_kernel_ms=cuda_ms(torch, lambda: K.blockselect
                                   .block_candidates(s_in, ksel)),
            plain_ms=cuda_ms(torch, lambda: batched_bottomk_select_plain(
                s_in, k)),
            library_ms=cuda_ms(torch, lambda: torch.sort(s_in, dim=1,
                                                         stable=True)),
            topk_ms=cuda_ms(torch, lambda: torch.topk(s_in, ksel, dim=1,
                                                      largest=False)))
        # bytes: every seed read once, k + 1 (value, index) pairs written;
        # ops: one comparison per seed at least
        t["bound_ms"], t["bound_by"] = bound(nf_ * n * 4 + nf_ * ksel * 8,
                                             nf_ * n)
        times[name] = t
        print(f"K2 select [{nf_},{n}] k={k}: global route {t['ms']:.4f} ms "
              f"(cold L2 {t['cold_ms']:.4f}), per-span route "
              f"{t['span_route_ms']:.4f} (its kernel "
              f"{t['span_kernel_ms']:.4f}), plain {t['plain_ms']:.4f}, "
              f"stable torch.sort of the row {t['library_ms']:.4f}, "
              f"torch.topk {t['topk_ms']:.4f}, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); exact, ties and signed zeros included",
              flush=True)
    main, comp = times["seeds"], times["priority row"]
    out["blockselect"] = dict(
        max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], cold_ms=main["cold_ms"],
        topk_ms=main["topk_ms"],
        routes={"global": {"source": "src/repro_torch/kernels/csrc/select.cu",
                           "ms": main["ms"], "ms_compact_take": comp["ms"]},
                "span": {"source":
                         "src/repro_torch/kernels/csrc/blockselect.cu",
                         "route_ms": main["span_route_ms"],
                         "kernel_ms": main["span_kernel_ms"],
                         "route_ms_compact_take": comp["span_route_ms"]}},
        compact_take={k_: comp[k_] for k_ in ("ms", "cold_ms", "plain_ms",
                                              "library_ms", "topk_ms",
                                              "bound_ms")})

    # K3 ------------------------------------------------------------------
    pk = K.retention_priority(sorted_keys, w, member, keep)
    pp = retention_priority_plain(sorted_keys, w, member, keep)
    tk_, vk_ = K.compact_take(sorted_keys, w, member, keep, cap)
    tp_, vp_ = compact_take_plain(sorted_keys, w, member, keep, cap)
    torch.cuda.synchronize()
    _check(torch.equal(pk, pp), "K3: priorities differ")
    _check(torch.equal(tk_, tp_) and torch.equal(vk_, vp_),
           "K3: compact_take differs")
    t_k = cuda_ms(torch, lambda: K.retention_priority(sorted_keys, w,
                                                      member, keep))
    t_p = cuda_ms(torch, lambda: retention_priority_plain(sorted_keys, w,
                                                          member, keep))
    # bytes: key, weight, member, keep read once, priority written; ops:
    # dedup compare, 1/(1+w), select (~6 per row)
    b_ms, b_by = bound(n * (4 + 4 + 1 + 1) + n * 4, 6 * n)
    out["compact"] = dict(max_abs_err=max_abs(pk, pp), ms=t_k, plain_ms=t_p,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"K3 compact n={n}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}); priorities and take exact",
          flush=True)

    # K4 ------------------------------------------------------------------
    # pump coalesces a tenant's requests into one table: phase 2 sends two
    # of B = 128 per tenant per round, so the main path launches B = 2 * 128
    slab = C.multisketch_build(spec, keys[:CHUNK], w[:CHUNK], act[:CHUNK])
    c = slab.keys.shape[0]
    table = torch.from_numpy(predicate_table(C, rng, 2 ** 31 - 1)).to(dev)
    stacked = torch.cat([table, torch.from_numpy(
        predicate_table(C, rng, 2 ** 31 - 1)).to(dev)])
    nb_main = stacked.shape[0]
    args = (slab.keys, slab.weights, slab.probs, slab.member)
    err = 0.0
    for b in (1, 16, B, nb_main):
        qk = K.segment_query_slab(*args, stacked[:b], enc)
        qp = segment_query_slab_plain(*args, stacked[:b], enc)
        q2 = K.segment_query_slab(*args, stacked[:b], enc)
        torch.cuda.synchronize()
        _check(torch.equal(qk, q2), f"K4 B={b}: not run-to-run identical")
        _check(torch.allclose(qk, qp, rtol=1e-5, atol=0.0),
               f"K4 B={b}: beyond rtol 1e-5 of the plain version")
        err = max(err, max_abs(qk, qp))
    full = K.segment_query_slab(*args, stacked, enc)
    for i in (0, 1, 2, 3, 77, B, B + 1, B + 77, nb_main - 1):
        alone = K.segment_query_slab(*args, stacked[i:i + 1].contiguous(),
                                     enc)
        _check(torch.equal(alone[:, 0], full[:, i]),
               f"K4: predicate {i} alone differs from its batch-of-"
               f"{nb_main} bits")
    for half in (0, B):
        own = K.segment_query_slab(*args, stacked[half:half + B], enc)
        _check(torch.equal(own, full[:, half:half + B]),
               f"K4: request at column {half} differs from its bits in the "
               f"coalesced batch of {nb_main}")
    ht = torch.where(slab.member, 1.0 / torch.clamp_min(slab.probs, 1e-30),
                     torch.zeros_like(slab.probs))
    contrib = torch.stack([f(slab.weights) for f, _ in spec.objectives]) * ht
    sel_t = C.predicate_matrix(slab.keys, stacked).to(torch.float32).T
    sel_t = sel_t.contiguous()
    t_k = cuda_ms(torch, lambda: K.segment_query_slab(*args, stacked, enc))
    t_p = cuda_ms(torch, lambda: segment_query_slab_plain(*args, stacked,
                                                          enc))
    t_l = cuda_ms(torch, lambda: torch.matmul(contrib, sel_t))
    n_hash = int((stacked[:, 5] & 1).sum().item())
    # bytes: slab fields read once, table read, answers written; ops: per
    # (slot, predicate) the range/mask test (6) and F adds, per (slot, hash
    # predicate) two fmix32 rounds (18), per slot F f(w) * ht (2F)
    b_ms, b_by = bound(c * 13 + nb_main * 6 * 4 + nf * nb_main * 4,
                       c * nb_main * (6 + nf) + c * n_hash * 18
                       + c * 2 * nf)
    out["segquery"] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                           bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
    print(f"K4 segquery c={c} F={nf} B={nb_main} (two coalesced requests "
          f"of {B}): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, torch.matmul "
          f"{t_l:.4f} ms, bound {b_ms:.5f} ms ({b_by}); rtol 1e-5 at B in "
          f"(1, 16, {B}, {nb_main}), run-to-run and batch-independent bits",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 2: serving through EnginePool
# ---------------------------------------------------------------------------

def phase_serving(torch, C, K, pool_mod, query_mod):
    from repro_torch.launch.pool import EnginePool
    SegmentQueryEngine = query_mod.SegmentQueryEngine
    tenants = {"t0": "ppswor", "t1": "ppswor", "t2": "priority"}
    rng_q = np.random.default_rng(5)
    tables = {t: predicate_table(C, rng_q, 2 ** 31 - 1) for t in tenants}
    pool = EnginePool(sleep=lambda s: None)
    specs = {t: smoke_spec(C, s) for t, s in tenants.items()}
    for t, spec in specs.items():
        pool.create_stream(t, spec, shards=SHARDS)
    rngs = {t: np.random.default_rng(100 + i) for i, t in enumerate(tenants)}
    exact = {t: [0.0, 0] for t in tenants}    # float64 sum, count
    twin_chunks = []
    absorb_ms, pump_ms = [], []
    futures = []
    per_round = QUERIES_PER_TENANT // N_CHUNKS
    K.reset_launch_counts()
    for c in range(N_CHUNKS):
        for t in tenants:
            keys, w = tenant_chunk(t_index(t), c, rngs[t])
            if t == "t0":
                twin_chunks.append((keys, w, c % SHARDS))
            t0 = time.perf_counter()
            r = pool.absorb(t, keys, w, shard=c % SHARDS)
            absorb_ms.append((time.perf_counter() - t0) * 1e3)
            _check(r.applied and r.accepted == CHUNK and r.quarantined == 0,
                   f"absorb {t}/{c} not applied: {r}")
            exact[t][0] += float(np.sum(w, dtype=np.float64))
            exact[t][1] += CHUNK
        round_futs = []
        for t in tenants:
            for _ in range(per_round):
                round_futs.append((t, tuple(exact[t]),
                                   pool.submit(t, predicates=tables[t])))
        t0 = time.perf_counter()
        pool.pump()
        pump_ms.append((time.perf_counter() - t0) * 1e3)
        futures += round_futs
    counts = K.launch_counts()
    for name in SERVING_KERNELS:
        _check(counts[name] > 0,
               f"kernel {name} never launched on the serving path")
    cvb = C.cv_bound(1.0, 1024)
    for t, (s_exact, n_exact), fut in futures:
        r = fut.result(0)
        _check(r.status == pool_mod.FRESH and r.epoch_lag == 0,
               f"{t}: response {r.status} lag {r.epoch_lag}")
        _check(r.values.shape == (8, B) and np.isfinite(r.values).all(),
               f"{t}: bad response values")
        for j, ex in ((0, s_exact), (1, float(n_exact))):
            _check(abs(float(r.values[j, 0]) - ex) <= 4 * cvb * ex,
                   f"{t}: objective {j} EVERYTHING estimate "
                   f"{r.values[j, 0]} vs exact {ex} beyond 4 cv")
    print(f"serving: {len(futures)} responses FRESH, EVERYTHING sum/count "
          f"within 4 cv ({4 * cvb:.4f}) of exact; absorb ms p50 "
          f"{np.percentile(absorb_ms, 50):.3f} p95 "
          f"{np.percentile(absorb_ms, 95):.3f}; query-batch (pump, "
          f"{len(tenants)} tenants x {per_round} x B={B}) ms p50 "
          f"{np.percentile(pump_ms, 50):.3f} p95 "
          f"{np.percentile(pump_ms, 95):.3f}", flush=True)

    # plain-path twin of tenant t0 on the card
    eng = pool._stream("t0").engine
    twin = SegmentQueryEngine(specs["t0"], shards=SHARDS, use_kernels=False)
    for keys, w, shard in twin_chunks:
        twin.absorb(keys, w, shard=shard)
    a, b = eng.merged, twin.merged
    for name in ("keys", "member", "aux", "valid", "weights", "taus"):
        _check(torch.equal(getattr(a, name), getattr(b, name)),
               f"twin: merged {name} differs")
    _check(ulps(a.seeds, b.seeds) <= 2, "twin: seeds beyond 2 ulp")
    _check(ulps(a.probs, b.probs) <= 4, "twin: probs beyond 4 ulp")
    qa = eng.query_many(predicates=tables["t0"])
    qb = twin.query_many(predicates=tables["t0"])
    _check(np.allclose(qa, qb, rtol=1e-5, atol=0.0),
           "twin: answers beyond rtol 1e-5")
    # the last round's pumped responses, each a slice of one coalesced
    # launch, against the engine asked directly and against the twin
    for t, _, fut in futures[-len(tenants) * per_round:]:
        got = fut.result(0).values
        direct = pool._stream(t).engine.query_many(predicates=tables[t])
        _check(np.array_equal(got, direct),
               f"{t}: pumped answers differ from the direct query's bits")
        if t == "t0":
            _check(np.allclose(got, qb, rtol=1e-5, atol=0.0),
                   "t0: pumped answers beyond rtol 1e-5 of the twin")
    print("twin (use_kernels=False): merged slab equal, answers within "
          "rtol 1e-5; last round's pumped answers (all 8 x B) bit-equal to "
          "direct queries and within rtol 1e-5 of the twin", flush=True)

    # one controlled epoch on the warm engine
    keys, w = tenant_chunk(t_index("t0"), N_CHUNKS, rngs["t0"])
    K.reset_launch_counts()
    pool.absorb("t0", keys, w, shard=0)
    absorb_counts = K.launch_counts()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    eng.query_many(predicates=tables["t0"])
    q_ms = (time.perf_counter() - t0) * 1e3
    query_counts = K.launch_counts()
    want_a = {"seeds": 2, "blockselect": 4, "compact": 2, "segquery": 0,
              "servicecost": 0, "rankcount": 0}
    want_q = {"seeds": 0, "blockselect": 0, "compact": 0, "segquery": 1,
              "servicecost": 0, "rankcount": 0}
    _check(absorb_counts == want_a, f"absorb launches {absorb_counts}")
    _check(query_counts == want_q, f"query launches {query_counts}")
    print(f"controlled epoch: absorb launches {absorb_counts}, query_many "
          f"launches {query_counts} ({q_ms:.3f} ms host)", flush=True)
    absorb_breakdown(torch, C, eng, rngs["t0"])
    pool.close()
    return counts


def absorb_breakdown(torch, C, eng, rng):
    """Where one warm absorb's time goes: host quarantine, then the
    engine's fold + absorb-time upkeep (drained) of that same chunk under
    the profiler: its wall time, the device time of its kernels and
    copies, and its sorts by input shape. A second, unprofiled absorb
    gives the wall time without the profiler's host overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    keys, w = tenant_chunk(t_index("t0"), N_CHUNKS + 1, rng)
    t0 = time.perf_counter()
    k, ww, act, _ = C.quarantine_chunk(keys, w)
    q_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        eng.absorb(k, ww, act, shard=1)
        eng.drain()
        fold_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched
    ops = [(e.key, e.self_device_time_total / 1e3)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    ops.sort(key=lambda x: -x[1])
    dev_ms = sum(t for _, t in ops)
    top = ", ".join(f"{name[:40]} {t:.3f}" for name, t in ops[:8])
    sorts = sorted(((e.input_shapes[0], e.count, e.device_time_total / 1e3)
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.device_type == DeviceType.CPU
                    and e.key == "aten::sort"), key=lambda x: -x[2])
    by_shape = ", ".join(f"{shape} x{n} {t:.3f}" for shape, n, t in sorts)
    keys, w = tenant_chunk(t_index("t0"), N_CHUNKS + 2, rng)
    k, ww, act, _ = C.quarantine_chunk(keys, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.absorb(k, ww, act, shard=2)
    eng.drain()
    plain_fold_ms = (time.perf_counter() - t0) * 1e3
    print(f"absorb breakdown: quarantine {q_ms:.3f} ms host; the same "
          f"chunk's engine fold + upkeep under the profiler {fold_ms:.3f} ms "
          f"wall (drained), device time {dev_ms:.3f} ms (idle share "
          f"{max(0.0, 1 - dev_ms / fold_ms):.3f}, profiler host overhead "
          f"included in the wall); top device ops ms: {top}; aten::sort by "
          f"input shape (count, device ms): {by_shape}; another chunk's "
          f"fold + upkeep without the profiler {plain_fold_ms:.3f} ms wall",
          flush=True)


def t_index(t: str) -> int:
    return int(t[1:])


# ---------------------------------------------------------------------------
# phase 3: durability
# ---------------------------------------------------------------------------

def phase_durability(C, pool_mod):
    EnginePool = pool_mod.EnginePool
    spec = smoke_spec(C, "ppswor")
    table = predicate_table(C, np.random.default_rng(7), 2 ** 31 - 1)
    rng = np.random.default_rng(300)
    with tempfile.TemporaryDirectory() as d:
        pool = EnginePool(durability_dir=d, sleep=lambda s: None)
        pool.create_stream("d0", spec, shards=SHARDS)
        for c in range(4):
            keys, w = tenant_chunk(3, c, rng)
            pool.absorb("d0", keys, w, shard=c % SHARDS)
            if c == 1:
                pool.snapshot("d0")        # chunks 2, 3 stay in the WAL tail
        before = pool.query("d0", predicates=table)
        pool.close()
        reopened = EnginePool.open(d, sleep=lambda s: None)
        after = reopened.query("d0", predicates=table)
        reopened.close()
    _check(before.status == after.status == pool_mod.FRESH,
           "durability: responses not FRESH")
    _check(np.array_equal(before.values, after.values),
           "durability: answers after EnginePool.open differ")
    print("durability: snapshot + WAL tail recovered, answers bit-identical",
          flush=True)


# ---------------------------------------------------------------------------
# phase 1, K5: the service-cost kernel against its plain version
# ---------------------------------------------------------------------------

def k5_inputs(torch, CO, dev, q, cmax, dim, c, mode, rng):
    """A slab of c points (the census mixture's scale) and a [q, cmax]
    table of ragged sets near the data with one all-invalid row; ``mode``:
    a cost-mode mu (1.0, 2.0, 1.5) for every row, or "ball"."""
    pts = rng.normal(0, 7.9, (c, dim)).astype(np.float32)
    centers = (pts[rng.integers(0, c, (q, cmax))]
               + rng.normal(0, 2.5, (q, cmax, dim))).astype(np.float32)
    cvalid = np.arange(cmax)[None, :] < rng.integers(1, cmax + 1, (q, 1))
    if q > 5:
        cvalid[5] = False
    ball = mode == "ball"
    mu = np.full(q, 1.0 if ball else mode, np.float32)
    # radii around the typical nearest-center distance, so balls cut sets
    radius = (np.sqrt(2.0 * dim) * 2.5 * rng.uniform(0.8, 1.2, q)).astype(
        np.float32)
    probs = rng.uniform(0.02, 1.0, c).astype(np.float32)
    member = rng.random(c) < 0.8
    slab = tuple(torch.from_numpy(a).to(dev) for a in (pts, probs, member))
    table = CO.table_to(CO.CostTable(centers, cvalid, mu, radius, np.full(
        q, int(ball), np.int32)), dev)
    return slab, table


def k5_check(torch, CO, got, want, slab, table, what):
    """Cost rows within rtol 1e-5 of the plain version; a ball row within
    that rtol plus the HT weight of exactly the slots whose plain d2 lies
    within 8 eps32 (|x|^2 + |c|^2) of r^2. Returns the largest error."""
    pts, probs, member = slab
    ht = torch.where(member, 1.0 / torch.clamp_min(probs, 1e-30),
                     torch.zeros_like(probs)).double()
    pn2 = (pts.double() ** 2).sum(1)
    err = 0.0
    for i in range(got.shape[0]):
        g, w = float(got[i]), float(want[i])
        slack = 1e-5 * abs(w)
        if int(table.mode[i]) == CO.MODE_BALL and bool(table.cvalid[i].any()):
            ctr = table.centers[i][table.cvalid[i]]
            d2 = CO.sq_dists(ctr, pts).double()
            tol = 8 * 2.0 ** -23 * ((ctr.double() ** 2).sum(1)[:, None]
                                    + pn2[None, :])
            near = ((d2.min(0).values - float(table.param[i]) ** 2).abs()
                    <= tol.max(0).values)
            slack += float(ht[near].sum())
        _check(abs(g - w) <= slack,
               f"K5 {what} row {i}: kernel {g} vs plain {w} (allowed "
               f"{slack})")
        err = max(err, abs(g - w))
    return err


def phase_k5(torch, K, dev):
    from repro_torch.core import costs as CO
    from repro_torch.kernels.servicecost import service_cost_slab_plain
    rng = np.random.default_rng(11)
    c = SLAB_K + 2                              # the engine's capacity
    err = 0.0
    for q, cmax, dim in ((1, 20, CENSUS_DIM), (128, 20, CENSUS_DIM),
                         (128, 1, CENSUS_DIM), (128, 20, 3)):
        for mode in (1.0, 2.0, 1.5, "ball"):
            slab, table = k5_inputs(torch, CO, dev, q, cmax, dim, c, mode,
                                    rng)
            got = K.service_cost_slab(*slab, table)
            again = K.service_cost_slab(*slab, table)
            want = service_cost_slab_plain(*slab, table)
            torch.cuda.synchronize()
            what = f"Q={q} Cmax={cmax} dim={dim} mode={mode}"
            _check(torch.equal(got, again), f"K5 {what}: not run-to-run "
                   "identical")
            e = k5_check(torch, CO, got, want, slab, table, what)
            if mode != "ball":
                err = max(err, e)
            if q > 5:
                _check(float(got[5]) == 0.0, f"K5 {what}: all-invalid row "
                       "not 0")
                for i in (0, 3, 77, q - 1):
                    alone = CO.CostTable(*(x[i:i + 1].contiguous()
                                           for x in table))
                    _check(torch.equal(K.service_cost_slab(*slab, alone)[0],
                                       got[i]),
                           f"K5 {what}: set {i} alone differs from its bits "
                           f"in the batch of {q}")
        pw = torch.rand(c, device=dev)
        k5_check(torch, CO, K.service_cost_slab(*slab, table,
                                                point_weights=pw),
                 service_cost_slab_plain(*slab, table, pw), slab, table,
                 f"Q={q} dim={dim} weighted")
    # timing at the local-search launch shapes: Q = 128, and the padded
    # Q = 16 of a round's last launch and of single queries
    slab, table = k5_inputs(torch, CO, dev, 16, 20, CENSUS_DIM, c, 2.0, rng)
    t_16 = cuda_ms(torch, lambda: K.service_cost_slab(*slab, table))
    slab, table = k5_inputs(torch, CO, dev, 128, 20, CENSUS_DIM, c, 2.0, rng)
    pts = slab[0]
    flat = table.centers.reshape(-1, CENSUS_DIM)
    pts_t = pts.T.contiguous()
    t_k = cuda_ms(torch, lambda: K.service_cost_slab(*slab, table))
    t_p = cuda_ms(torch, lambda: service_cost_slab_plain(*slab, table))
    t_l = cuda_ms(torch, lambda: torch.matmul(flat, pts_t))
    q, cmax = table.cvalid.shape
    # bytes: points, probs, member read once, centers, cvalid, mu, param,
    # mode read once, Q answers written; ops: 2 dim per (set, center, slot)
    # distance product, plus |x|^2 and |c|^2 (2 dim each)
    b_ms, b_by = bound(c * (CENSUS_DIM * 4 + 5)
                       + q * cmax * (CENSUS_DIM * 4 + 1) + q * 16,
                       2 * q * cmax * CENSUS_DIM * c + 2 * CENSUS_DIM * c
                       + 2 * q * cmax * CENSUS_DIM)
    print(f"K5 servicecost c={c} Q={q} Cmax={cmax} dim={CENSUS_DIM}: kernel "
          f"{t_k:.4f} ms (Q=16: {t_16:.4f} ms), plain {t_p:.4f} ms, "
          f"torch.matmul of the distance "
          f"product alone {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
          f"cost rows rtol 1e-5 and ball rows within the d2 window at "
          f"(Q, Cmax) in (1, 20), (128, 20), (128, 1) and dim 3, mu in "
          f"(1, 2, 1.5) and ball; run-to-run and alone-vs-batch bits",
          flush=True)
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_l, ms_q16=t_16)


def kernel_attributes(K):
    """Print the registers, local (spill) bytes and static shared memory
    of K4 and K5 (``cudaFuncGetAttributes``) and their launch plans at the
    main path's shapes."""
    from repro_torch.kernels import segquery, servicecost
    from repro_torch.kernels._util import kernel_attrs
    c4, c5 = 8201, SLAB_K + 2
    print("kernel attributes: " + "; ".join(
        f"{name} {kernel_attrs(name)}" for name in ("segquery",
                                                     "servicecost"))
        + f"; K4 plan at c={c4} (slices, slice_len) "
        f"{segquery.launch_plan(c4)}; K5 plan at c={c5} dim={CENSUS_DIM} "
        f"{servicecost.launch_plan(c5, CENSUS_DIM, 20)}", flush=True)


# ---------------------------------------------------------------------------
# phase 1, K6: the rank-count kernel against its plain version
# ---------------------------------------------------------------------------

def capping_inputs(torch, C, dev, n: int, seed: int):
    """The operands ``ops.universal_capping_kernel`` hands K6 for n keys
    (ids 0..n-1, hash seed 42) with weights clip(lognormal(0, 1), 0.1, 10)
    made on the card from ``seed``, 5 % of them inactive:
    (weights, u, r/w, active)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(n, generator=g, device=dev).exp().clamp(0.1, 10.0)
    act = torch.rand(n, generator=g, device=dev) >= 0.05
    u = C.uniform01(torch.arange(n, dtype=torch.int32, device=dev), 42)
    rw = torch.where(act, C.rank_of(u, "ppswor") / w,
                     torch.full_like(w, float("inf")))
    return torch.where(act, w, torch.zeros_like(w)), u, rw, act


def tie_heavy_inputs(torch, dev, n: int, seed: int):
    """K6 operands with many ties: weights from 4 values, u quantised to
    2^10 values, r/w on a grid of 1/8, 5 % of the keys inactive."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.tensor([0.1, 1.0, 2.5, 10.0], device=dev)
    w = vals[torch.randint(0, 4, (n,), generator=g, device=dev)]
    act = torch.rand(n, generator=g, device=dev) >= 0.05
    u = torch.randint(0, 1 << 10, (n,), generator=g, device=dev) / 1024.0
    rw = torch.randint(0, 64, (n,), generator=g, device=dev) / 8.0
    return torch.where(act, w, torch.zeros_like(w)), u, rw, act


def phase_k6(torch, C, K, dev, n_small: int = K6_SMALL,
             n_full: int = UNIVERSAL_N):
    from repro_torch.kernels.rankcount import rank_counts_plain
    err = 0.0
    for what, args in (("capping", capping_inputs(torch, C, dev, n_small, 6)),
                       ("tie-heavy", tie_heavy_inputs(torch, dev, n_small,
                                                      8))):
        hk_s, lk_s = K.rank_counts(*args)
        hp_s, lp_s = rank_counts_plain(*args)
        torch.cuda.synchronize()
        _check(torch.equal(hk_s, hp_s) and torch.equal(lk_s, lp_s),
               f"K6 {what} n={n_small}: counts differ from the plain version")
        err = max(err, max_abs(hk_s, hp_s), max_abs(lk_s, lp_s))
    args = capping_inputs(torch, C, dev, n_small, 6)
    t_small = cuda_ms(torch, lambda: K.rank_counts(*args))
    t_p = cuda_ms(torch, lambda: rank_counts_plain(*args), reps=5, inner=1)
    big = capping_inputs(torch, C, dev, n_full, 7)
    hk, lk = K.rank_counts(*big)
    g = torch.Generator(device=dev).manual_seed(9)
    w = big[0]
    # sampled rows, and rows from the two groups the clip at 0.1 and 10 makes
    rows = torch.cat([torch.randperm(n_full, generator=g, device=dev)[:K6_ROWS]]
                     + [torch.nonzero(big[3] & (w == c))[:K6_CLIP_ROWS, 0]
                        for c in (0.1, 10.0)])
    _check(rows.shape[0] == K6_ROWS + 2 * K6_CLIP_ROWS,
           "K6: fewer clipped keys than rows to check")
    hp, lp = rank_counts_plain(*big, rows=rows)
    torch.cuda.synchronize()
    _check(torch.equal(hk[rows], hp) and torch.equal(lk[rows], lp),
           f"K6 n={n_full}: counts of {rows.shape[0]} checked rows differ "
           f"from the plain version")
    _check(int(hk.max()) > 0 and int(lk.max()) > 0, "K6: all counts zero")
    err = max(err, max_abs(hk[rows], hp), max_abs(lk[rows], lp))
    t_k = cuda_ms(torch, lambda: K.rank_counts(*big))
    n_act = int(big[3].sum())
    # bytes: weight, two seeds, active read once, h, l written; ops: the
    # comparisons of a merge sort of both orders (2 n log2 n)
    b_ms, b_by = bound(n_full * 13 + n_full * 8,
                       2.0 * n_full * np.log2(n_full))
    # the all-pairs formulation's bound: 4 operations per ordered pair of
    # active keys
    pairs_ms, _ = bound(0, 4.0 * n_act * n_act)
    print(f"K6 rankcount n={n_full} ({n_act} active): kernel {t_k:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; all-pairs bound {pairs_ms:.2f} ms); "
          f"n={n_small}: kernel {t_small:.4f} ms, plain {t_p:.4f} ms; exact "
          f"on all rows at n={n_small} (capping and tie-heavy inputs) and on "
          f"{rows.shape[0]} rows at n={n_full} ({K6_ROWS} sampled, "
          f"{K6_CLIP_ROWS} each of w = 0.1 and w = 10)", flush=True)
    # ms and bound_ms are at n_full; the plain version's O(n^2) time is
    # taken at plain_n, beside the kernel's own time there
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, n=n_full, plain_n=n_small,
                ms_at_plain_n=t_small, allpairs_bound_ms=pairs_ms)


# ---------------------------------------------------------------------------
# phase 4: the metric tier at the Census1990 shape
# ---------------------------------------------------------------------------

def census_points(torch, dev, n: int):
    """n x 68 points of a 20-component Gaussian mixture, made on the card
    from a fixed seed: component means N(0, 7.5^2), spread 2.5, so
    |x|^2 ~ 4250 as in the published data's scale. Returns (X, means)."""
    g = torch.Generator(device=dev).manual_seed(1990)
    means = 7.5 * torch.randn((CENSUS_COMPONENTS, CENSUS_DIM), generator=g,
                              device=dev)
    label = torch.randint(0, CENSUS_COMPONENTS, (n,), generator=g,
                          device=dev)
    X = means[label] + 2.5 * torch.randn((n, CENSUS_DIM), generator=g,
                                         device=dev)
    return X.contiguous(), means


def counts_delta(K, before):
    now = K.launch_counts()
    return tuple(now[k] - before[k] for k in now)


def phase_metric(torch, C, K, dev, n: int = CENSUS_N):
    from repro_torch.launch.cluster import (ClusterEngine, _candidate_pool,
                                            kcenter, local_search)
    X, means = census_points(torch, dev, n)
    chunks = torch.tensor_split(X, CENSUS_CHUNKS)
    cfg = dict(dim=CENSUS_DIM, k=SLAB_K, mu=2.0, n_anchors=8, seed=0)
    eng = ClusterEngine(**cfg)
    want_fold = (1, 2, 1, 0, 0, 0)

    # the main path, counted from 0
    K.reset_launch_counts()
    absorb_ms = []
    for i, ch in enumerate(chunks):
        before = K.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.absorb(ch)
        torch.cuda.synchronize()
        absorb_ms.append((time.perf_counter() - t0) * 1e3)
        _check(counts_delta(K, before) == want_fold,
               f"absorb {i} launches {counts_delta(K, before)}, want "
               f"{want_fold}")
    _check(not eng.overflow, "metric slab overflowed")
    init = local_search(eng, k=CENSUS_COMPONENTS, n_cand=LS_CAND, rounds=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = local_search(eng, k=CENSUS_COMPONENTS, n_cand=LS_CAND,
                       rounds=LS_ROUNDS)
    ls_s = time.perf_counter() - t0
    ls_k5 = K.launch_counts()["servicecost"] - 1     # less init's scoring
    kc = kcenter(eng, CENSUS_COMPONENTS)
    counts = K.launch_counts()
    torch.cuda.synchronize()
    for name in ("seeds", "blockselect", "compact", "servicecost"):
        _check(counts[name] > 0, f"kernel {name} never launched on the "
               f"metric path")

    # one service_costs of Q <= 128
    q_one = C.cost_table(np.stack([res.centers, init.centers]), 2.0)
    before = K.launch_counts()
    eng.service_costs(q_one)
    _check(counts_delta(K, before) == (0, 0, 0, 0, 1, 0),
           f"service_costs launches {counts_delta(K, before)}")

    # the plain-path twin on the card: bit-equal slab, costs within rtol
    twin = ClusterEngine(use_kernels=False, **cfg)
    before = K.launch_counts()
    for ch in chunks:
        twin.absorb(ch)
    _check(counts_delta(K, before) == (0, 0, 0, 0, 0, 0),
           "the plain twin launched kernels")
    for name, a, b in zip(eng._sketch._fields, eng._sketch, twin._sketch):
        _check(torch.equal(a, b), f"metric twin: slab {name} differs")
    _check(torch.equal(eng._coords, twin._coords),
           "metric twin: coords differ")
    rng = np.random.default_rng(21)
    cand = _candidate_pool(eng, 4 * LS_CAND)
    sets = np.stack([cand[rng.choice(len(cand), CENSUS_COMPONENTS,
                                     replace=False)] for _ in range(30)])
    table = C.cost_table(np.concatenate(
        [means.cpu().numpy()[None], res.centers[None], sets]), 2.0)
    ka, kb = eng.service_costs(table), twin.service_costs(table)
    _check(np.allclose(ka, kb, rtol=1e-5, atol=0.0),
           f"metric twin: service costs beyond rtol 1e-5 (max rel "
           f"{np.max(np.abs(ka - kb) / np.abs(kb)):.3g})")

    # estimates against the exact costs over all n points
    exact = C.exact_service_costs(X, C.cost_table(np.stack(
        [means.cpu().numpy(), init.centers, res.centers]), 2.0)).cpu().numpy()
    est = eng.service_costs(C.cost_table(np.stack(
        [means.cpu().numpy(), init.centers]), 2.0))
    cvb = C.cv_bound(1.0, SLAB_K)
    for what, e, x in (("generator centers", est[0], exact[0]),
                       ("initial set", est[1], exact[1])):
        _check(abs(float(e) - float(x)) <= 4 * cvb * float(x),
               f"{what}: estimate {e} vs exact {x} beyond 4 cv "
               f"({4 * cvb:.4f})")
    _check(exact[2] <= exact[1], f"local search raised the exact cost: "
           f"{exact[1]} -> {exact[2]}")
    _check(all(a >= b for a, b in zip(res.history, res.history[1:])),
           "local search history not monotone")
    _check(abs(kc.coverage_est - kc.total_est) <= 1e-5 * kc.total_est,
           f"k-center coverage {kc.coverage_est} != total {kc.total_est}")
    idle, round_ms, dev_ms = round_idle_share(torch, eng, res.centers)
    print(f"metric tier n={n} dim={CENSUS_DIM} (capacity {eng.spec.cap}): "
          f"absorb ms p50 {np.percentile(absorb_ms, 50):.3f} p95 "
          f"{np.percentile(absorb_ms, 95):.3f} (first {absorb_ms[0]:.3f}); "
          f"launches per absorb {want_fold}, per service_costs "
          f"(0, 0, 0, 0, 1, 0); twin slab bit-equal, costs within rtol 1e-5; "
          f"local search {ls_s * 1e3:.3f} ms wall, {res.rounds} rounds, "
          f"{ls_k5} K5 launches; estimate/exact generator "
          f"{est[0] / exact[0]:.5f}, initial {est[1] / exact[1]:.5f} "
          f"(4 cv = {4 * cvb:.4f}); exact cost final/generator "
          f"{exact[2] / exact[0]:.5f}, initial/generator "
          f"{exact[1] / exact[0]:.5f}; k-center radius {kc.radius:.4f}, "
          f"coverage {kc.coverage_est:.1f} = total {kc.total_est:.1f}; one "
          f"round (641 sets) {round_ms:.3f} ms wall under the profiler, "
          f"device {dev_ms:.3f} ms, idle share {idle:.3f}", flush=True)
    return counts


def profile_ops(torch, fn):
    """fn() (synchronised) under the profiler: (wall ms, [(device op, ms)]
    longest first, the number of device op calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in dev),
                 key=lambda x: -x[1])
    return wall, ops, sum(e.count for e in dev)


def profiled(torch, fn):
    """fn() (synchronised) under the profiler: (device idle share, wall ms,
    device ms, the top device ops as "name ms" text)."""
    wall, ops, n = profile_ops(torch, fn)
    dev_ms = sum(t for _, t in ops)
    top = f"{n} device ops; " + ", ".join(f"{name[:40]} {t:.3f}"
                                          for name, t in ops[:4])
    return max(0.0, 1 - dev_ms / wall), wall, dev_ms, top


def round_idle_share(torch, eng, cur):
    """One local-search round's work from the center set ``cur`` (build the
    1 + k n_cand swap sets, score them through K5, argmin) under the
    profiler: (device idle share, wall ms, device ms)."""
    from repro_torch.core.costs import cost_table
    from repro_torch.launch.cluster import _candidate_pool, _swap_sets
    cand = _candidate_pool(eng, LS_CAND)

    def one_round():
        scores = eng.service_costs(cost_table(_swap_sets(cur, cand), eng.mu))
        int(np.argmin(scores[1:]))
    return profiled(torch, one_round)[:3]


# ---------------------------------------------------------------------------
# phase 5: the universal tier (examples/quickstart.py at 2^20 keys)
# ---------------------------------------------------------------------------

def phase_universal(torch, C, K, dev, n: int = UNIVERSAL_N,
                    shards: int = UNIVERSAL_SHARDS):
    from repro_torch.kernels import ops
    k = UNIVERSAL_K
    g = torch.Generator(device=dev).manual_seed(2015)
    keys = torch.arange(n, dtype=torch.int32, device=dev)
    w = (2.0 * torch.randn(n, generator=g, device=dev)).exp()
    act = torch.ones(n, dtype=torch.bool, device=dev)
    domain = torch.randint(0, 8, (n,), generator=g, device=dev)
    seg = domain == 3
    wall = {}

    def timed(name, fn):
        """fn's result; its wall time cold (the first call) and warm."""
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        wall[name] = times
        return out

    K.reset_launch_counts()
    # 1. one universal monotone sample, many statistics
    s = timed("universal_monotone_sample", lambda: C.universal_monotone_sample(
        keys, w, act, k, seed=42))
    size = int(s.member.sum())
    ebound = C.expected_size_bound(n, k)
    # E|S| <= ebound (Thm 5.1); one draw, a sum of indicators, gets 4 sigma
    _check(0 < size <= ebound + 4 * ebound ** 0.5,
           f"monotone sample size {size} vs E bound {ebound:.1f}")
    ratios = []
    for f in (C.COUNT, C.SUM, C.thresh(5.0), C.cap(2.0), C.moment(1.5)):
        est = float(C.estimate(f, w, s.prob, s.member, seg))
        ex = float(C.exact(f, w, act, seg))
        q = ex / float(C.exact(f, w, act))
        cvb = C.cv_bound(q, k)
        _check(abs(est - ex) <= 4 * cvb * ex, f"monotone {f.name} on domain "
               f"3: estimate {est} vs exact {ex} beyond 4 cv ({4 * cvb:.4f})")
        ratios.append(f"{f.name} {est / ex:.4f} (4cv {4 * cvb:.3f})")

    # 2. 16 shard sketches folded with merge_sketches
    cap = C.sketch_capacity(n, k)
    parts = torch.arange(n, device=dev).tensor_split(shards)
    fold_ms = []
    merged = None
    for p in parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sk = C.build_sketch(keys[p], w[p], act[p], k, cap, seed=42)
        merged = sk if merged is None else C.merge_sketches(merged, sk,
                                                            donate=True)
        torch.cuda.synchronize()
        fold_ms.append((time.perf_counter() - t0) * 1e3)
    whole = timed("build_sketch (whole set)",
                  lambda: C.build_sketch(keys, w, act, k, cap, seed=42))
    _check(not bool(merged.valid.all()), "merged sketch is full (capacity "
           f"{cap} too small)")
    _check(member_triples(torch, merged) == member_triples(torch, whole),
           "merged sketch's member (key, weight, prob) differ from the "
           "whole-set sketch's")
    sum_est = float(C.sketch_estimate(merged, C.SUM))
    sum_ex = float(w.double().sum())
    cvb = C.cv_bound(1.0, k)
    _check(abs(sum_est - sum_ex) <= 4 * cvb * sum_ex, f"merged sketch SUM "
           f"{sum_est} vs exact {sum_ex} beyond 4 cv")

    # 3. multi-objective bottom-k through K1 + K2 against the core sampler
    objs = ((0, 0.0), (3, 2.0), (1, 0.0))
    mk, pk = timed("multi_objective_bottomk_kernel",
                   lambda: ops.multi_objective_bottomk_kernel(
                       keys, w, act, objs, k, seed=42))
    core = timed("multi_bottomk_sample", lambda: C.multi_bottomk_sample(
        keys, w, act, [(ops.statfn_of(*o), k) for o in objs], seed=42))
    _check(torch.equal(mk, core.member), "multi-objective kernel members "
           "differ from multi_bottomk_sample's")
    _check(float((pk - core.prob).abs().max()) <= 1e-6,
           "multi-objective kernel probs beyond 1e-6 of the core's")

    # 4. universal capping: the sampler and K6 on the same keys
    g2 = torch.Generator(device=dev).manual_seed(2016)
    w2 = torch.randn(n, generator=g2, device=dev).exp().clamp(0.1, 10.0)
    cs = timed("universal_capping_sample", lambda: C.universal_capping_sample(
        keys, w2, act, k, m_cap=CAPPING_M_CAP, seed=42))
    ck, hl = timed("universal_capping_kernel",
                   lambda: ops.universal_capping_kernel(keys, w2, act, k,
                                                        seed=42))
    _check(torch.equal(ck, cs.member), "capping kernel members differ from "
           "universal_capping_sample's")
    _check(torch.equal(hl[act], cs.hl[act]), "capping kernel hl differs on "
           "active keys")
    csize = int(cs.member.sum())
    cbound = C.capping_size_bound(k, 10.0, 0.1)
    _check(0 < csize <= cbound, f"capping size {csize} > bound {cbound:.1f}")
    n_cand = int((act & (cs.hl <= k)).sum())
    _check(n_cand <= CAPPING_M_CAP, f"{n_cand} capping candidates > m_cap")
    cratios = []
    for T in (0.5, 1.0, 2.0, 5.0):
        f = C.cap(T)
        est = float(C.estimate(f, w2, cs.prob, cs.member))
        ex = float(C.exact(f, w2, act))
        _check(abs(est - ex) <= 4 * cvb * ex, f"capping cap_{T:g}: estimate "
               f"{est} vs exact {ex} beyond 4 cv")
        cratios.append(f"cap_{T:g} {est / ex:.4f}")
    counts = K.launch_counts()
    for name in ("seeds", "blockselect", "rankcount"):
        _check(counts[name] > 0, f"kernel {name} never launched on the "
               f"universal path")
    # where a warm sample's and a shard fold's time goes (refolding the
    # last shard leaves the merged sketch as it is)
    breakdown = {
        "monotone sample": profiled(torch, lambda: C.universal_monotone_sample(
            keys, w, act, k, seed=42)),
        "shard fold": profiled(torch, lambda: C.merge_sketches(
            merged, C.build_sketch(keys[parts[-1]], w[parts[-1]],
                                   act[parts[-1]], k, cap, seed=42)))}
    print(f"universal tier n={n} k={k}: monotone size {size} (E bound "
          f"{ebound:.1f}), domain-3 estimate/exact {'; '.join(ratios)}; "
          f"{shards} shard sketches (capacity {cap}) folded == whole-set "
          f"sketch, SUM estimate/exact {sum_est / sum_ex:.4f} (4 cv "
          f"{4 * cvb:.3f}); "
          f"one shard's build_sketch + merge_sketches fold ms p50 "
          f"{np.percentile(fold_ms, 50):.3f} p95 "
          f"{np.percentile(fold_ms, 95):.3f}; multi-objective kernel == "
          f"core sampler; capping size {csize} (bound {cbound:.1f}, "
          f"{n_cand} candidates), kernel == sampler, {', '.join(cratios)}; "
          f"wall ms (cold/warm): " + ", ".join(
              f"{a} {b[0]:.3f}/{b[1]:.3f}" for a, b in wall.items())
          + f"; launches {counts}", flush=True)
    for what, (idle, wall_ms, dev_ms, top) in breakdown.items():
        print(f"universal breakdown, one warm {what} under the profiler: "
              f"{wall_ms:.3f} ms wall, device {dev_ms:.3f} ms (idle share "
              f"{idle:.3f}); top device ops ms: {top}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 6: scale-out serving through ShardedEnginePool
# ---------------------------------------------------------------------------

def serving_ms(times):
    return (f"p50 {np.percentile(times, 50):.3f} p95 "
            f"{np.percentile(times, 95):.3f}")


def phase_scaleout(torch, C, K, pool_mod, query_mod, dev, card: str):
    """One tenant over SCALE_HOSTS in-process hosts x SCALE_SHARDS shards
    at the serving width: every FRESH answer bit-equal to a single-host
    engine twin, a host kill answered STALE with the last-good values, a
    rebalance FRESH and bit-equal again, close + open back at the
    post-move placement with bit-identical answers, and the launch counts
    of one absorb and one cross-host query. Returns the launch counts of
    the phase's serving run."""
    from repro_torch.launch.summary import merge_host_slabs
    ShardedEnginePool = pool_mod.ShardedEnginePool
    spec = smoke_spec(C, "ppswor")
    table = predicate_table(C, np.random.default_rng(8), 2 ** 31 - 1)
    rng = np.random.default_rng(600)
    twin = query_mod.SegmentQueryEngine(spec, shards=SCALE_SHARDS,
                                        device=dev)
    hosts = tuple(range(SCALE_HOSTS))
    absorb_ms, merge_query_ms, memo_query_ms = [], [], []

    def fresh_equal(r, what):
        _check(r.status == pool_mod.FRESH and r.epoch_lag == 0,
               f"scale-out {what}: response {r.status} lag {r.epoch_lag}")
        _check(np.array_equal(r.values, twin.query_many(predicates=table)),
               f"scale-out {what}: answers differ from the twin's bits")

    def timed(fn, times):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    with tempfile.TemporaryDirectory() as d:
        pool = ShardedEnginePool(hosts=hosts, durability_dir=d,
                                 sleep=lambda s: None, device=dev)
        placement = pool.create_stream("s6", spec, shards=SCALE_SHARDS)
        _check(sorted(set(placement)) == list(hosts),
               f"scale-out: placement {placement} leaves a host idle")
        K.reset_launch_counts()
        for c in range(N_CHUNKS):
            keys, w = tenant_chunk(6, c, rng)
            r = timed(lambda: pool.absorb("s6", keys, w,
                                          shard=c % SCALE_SHARDS),
                      absorb_ms)
            _check(r.applied and r.accepted == CHUNK,
                   f"scale-out absorb {c} not applied: {r}")
            twin.absorb(keys, w, shard=c % SCALE_SHARDS)
            fresh_equal(timed(lambda: pool.query("s6", predicates=table),
                              merge_query_ms), f"chunk {c}")
            fresh_equal(timed(lambda: pool.query("s6", predicates=table),
                              memo_query_ms), f"chunk {c} (memoised)")
        counts = K.launch_counts()
        for name in SERVING_KERNELS:
            _check(counts[name] > 0,
                   f"kernel {name} never launched on the scale-out path")
        st = pool._stream("s6")
        _check(st.cross_merges == N_CHUNKS,
               f"scale-out: {st.cross_merges} cross-host merges for "
               f"{N_CHUNKS} epochs")
        slabs = [pool._host_engine(st, pool._hosts[h]).merged
                 for h in sorted(set(placement))]
        merge_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            merge_host_slabs(spec, slabs)
            torch.cuda.synchronize()
            merge_ms.append((time.perf_counter() - t0) * 1e3)
        merge_ms = float(np.median(merge_ms))

        # one controlled epoch: an absorb, then a cross-host query
        keys, w = tenant_chunk(6, N_CHUNKS, rng)
        K.reset_launch_counts()
        pool.absorb("s6", keys, w, shard=1)
        absorb_counts = K.launch_counts()
        twin.absorb(keys, w, shard=1)
        K.reset_launch_counts()
        good = pool.query("s6", predicates=table)
        query_counts = K.launch_counts()
        fresh_equal(good, "controlled epoch")
        want_a = {"seeds": 2, "blockselect": 4, "compact": 2, "segquery": 0,
                  "servicecost": 0, "rankcount": 0}
        want_q = {"seeds": 1, "blockselect": 2, "compact": 1, "segquery": 1,
                  "servicecost": 0, "rankcount": 0}
        _check(absorb_counts == want_a,
               f"scale-out absorb launches {absorb_counts}")
        _check(query_counts == want_q,
               f"scale-out query launches {query_counts}")

        # host loss, then the rebalance that rebuilds its shards
        victim = placement[0]
        pool.kill_host(victim)
        r = pool.query("s6", predicates=table)
        _check(r.status == pool_mod.STALE and r.error is not None,
               f"scale-out: after the kill {r.status}")
        _check(np.array_equal(r.values, good.values),
               "scale-out: STALE answers differ from the last good ones")
        t0 = time.perf_counter()
        out = pool.rebalance("s6")["s6"]
        torch.cuda.synchronize()
        rebalance_ms = (time.perf_counter() - t0) * 1e3
        _check(out["error"] is None and out["moved"]
               and victim not in out["placement"],
               f"scale-out rebalance: {out['error']} {out['placement']}")
        fresh_equal(pool.query("s6", predicates=table), "after rebalance")
        pool.close()
        t0 = time.perf_counter()
        reopened = ShardedEnginePool.open(d, sleep=lambda s: None,
                                          device=dev)
        open_ms = (time.perf_counter() - t0) * 1e3
        _check(reopened.placement("s6") == out["placement"],
               "scale-out: reopened placement is not the post-move one")
        fresh_equal(reopened.query("s6", predicates=table), "after open")
        reopened.close()
    print(f"scale-out ({card}): {SCALE_HOSTS} hosts x {SCALE_SHARDS} shards,"
          f" {N_CHUNKS + 1} chunks of {CHUNK} rows, B={B}: every FRESH "
          f"answer bit-equal to the single-host twin; absorb ms (WAL on) "
          f"{serving_ms(absorb_ms)}; query ms with the cross-host merge "
          f"{serving_ms(merge_query_ms)}, memoised "
          f"{serving_ms(memo_query_ms)}; merge_host_slabs of "
          f"{len(slabs)} slabs {merge_ms:.3f} ms wall (synchronised, median "
          f"of 5); kill -> STALE "
          f"with the last good answers; rebalance {rebalance_ms:.1f} ms "
          f"wall ({len(out['moved'])} shards moved) -> FRESH bit-equal; "
          f"close + open {open_ms:.1f} ms -> post-move placement, "
          f"bit-identical; launches of one absorb {absorb_counts}, of one "
          f"cross-host query {query_counts}; serving run launches {counts}",
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 7: the training path (qwen2-1.5b at full width)
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
              "8", "--seq", "128", "--mesh", "1x1x1", "--compress",
              "--importance-sampling", "--ckpt-every", "3", "--log-every",
              "1"]


def _train_run(torch, K, train, argv):
    """train.main(argv) with the launch counts reset just before it: (final
    state, {step: loss}, {step: seconds}, per-step launch deltas, launches
    before the first step, the whole run's launches, the restored state's
    crc32 per checkpoint path or None)."""
    import zlib
    from repro_torch.ckpt.manager import _flatten
    rec = {"loss": {}, "sec": {}, "steps": [], "crc": None}

    def cb(event, **kw):
        if event == "restored":
            rec["crc"] = {
                path: (zlib.crc32(memoryview(np.ascontiguousarray(
                    x.detach().cpu().numpy()))) & 0xFFFFFFFF,
                       str(x.dtype).replace("torch.", ""), tuple(x.shape))
                for path, x in _flatten(kw["state"]).items()}
        elif event == "start":
            rec["before"] = tuple(K.launch_counts().values())
            rec["last"] = K.launch_counts()
        elif event == "step":
            rec["loss"][kw["step"]] = float(kw["metrics"]["loss"])
            rec["sec"][kw["step"]] = kw["seconds"]
            rec["steps"].append(counts_delta(K, rec["last"]))
            rec["last"] = K.launch_counts()
    K.reset_launch_counts()
    state = train.main(argv, callback=cb)
    return state, rec, tuple(K.launch_counts().values())


def _resumed_run(torch, K, train, argv, ck: str, rec, at: int, steps: int,
                 what: str):
    """Drop the checkpoint of step ``steps`` from ``ck`` and run ``argv``
    again with ``--resume``: the restored state must equal the one saved
    at step ``at`` (every array's crc32, dtype and shape) and the losses
    of steps at + 1 .. steps those of the first run ``rec`` within
    RESUME_RTOL. Prints the check; returns the final state."""
    import shutil
    from repro_torch.ckpt.manager import CheckpointManager
    shutil.rmtree(Path(ck) / f"step_{steps:010d}")
    t0 = time.perf_counter()
    state, rec2, _ = _train_run(torch, K, train, argv + [
        "--ckpt-dir", ck, "--resume"])
    resume_s = time.perf_counter() - t0
    _, meta = CheckpointManager(ck).read_meta(at)
    crc = rec2["crc"]
    _check(crc is not None and set(crc) == set(meta["arrays"]),
           f"{what}: restored arrays differ from the checkpoint's")
    for path, info in meta["arrays"].items():
        _check(crc[path] == (info["crc"], info["dtype"],
                             tuple(info["shape"])),
               f"{what}: restored {path} differs from the saved state")
    after = list(range(at + 1, steps + 1))
    gaps = [abs(rec2["loss"][s] - rec["loss"][s]) / abs(rec["loss"][s])
            for s in after]
    _check(sorted(rec2["loss"]) == after and max(gaps) <= RESUME_RTOL,
           f"{what}: resumed losses {rec2['loss']} vs {rec['loss']}")
    print(f"{what} resume from step {at}: restored state equal to the "
          f"saved one ({len(crc)} arrays, crc32), losses {at + 1}-{steps} "
          f"{[rec2['loss'][s] for s in after]}, max relative gap "
          f"{max(gaps):.3g} (<= {RESUME_RTOL}), run {resume_s:.1f} s",
          flush=True)
    return state


def _leaf_grads(torch, Mod, TT, cfg, params, batch):
    """The gradient tree of the loss at ``params`` (contiguous leaves)."""
    model = Mod.Model(cfg, params)
    loss, _ = model(batch)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True, materialize_grads=True)
    return TT.unflatten((n, g.contiguous()) for (n, _), g in zip(named,
                                                                  grads))


def big_leaf_kernels(torch, dev, g, seed: int, what: str):
    """``_sample_leaf`` through K1 + K2 on one large gradient leaf ``g``
    (flat): at most 768 valid slots, finite positive taus, the HT |g| mass
    within 4 / sqrt(255); then K1 (seeds only, F = 3; within 2 ulp of
    plain) and K2 ([3, n], k = 257; equal to plain) timed against their
    plain versions and ``torch.topk``. Returns their rows' stats."""
    from repro_torch.distopt import compression as CP
    from repro_torch.kernels import blockselect as kbs
    from repro_torch.kernels import seeds as ks
    sk = CP._sample_leaf(g, 256, seed, 0.01)
    nv = int(sk.valid.sum())
    _check(0 < nv <= 768, f"{what}: valid slots {nv}")
    _check(bool(torch.isfinite(sk.taus).all() and (sk.taus > 0).all()),
           f"{what}: taus {sk.taus.tolist()}")
    m = sk.valid
    est = float((sk.weights[m].abs().double() / sk.probs[m].double()).sum())
    exact = float(g.abs().double().sum())
    rel = abs(est / exact - 1)
    _check(rel <= 4 / np.sqrt(255), f"{what}: HT |g| mass off by {rel:.3f}")
    n = g.numel()
    _check(3 * n < 2 ** 31, f"{what}: F n = {3 * n} overflows int")
    keys = torch.arange(n, dtype=torch.int32, device=dev)
    wn = g.abs()
    wn /= torch.clamp_min(wn.max(), 1e-30)
    act = wn > 0
    enc = CP._leaf_spec(256, 0.01, "ppswor").kernel_objectives()
    k1 = cuda_ms(torch, lambda: ks.fused_seeds(keys, wn, act, enc, "ppswor",
                                               seed), reps=7, inner=1)
    seeds = ks.fused_seeds(keys, wn, act, enc, "ppswor", seed)
    s1 = ulps(seeds, ks.fused_seeds_fvals_plain(
        keys, wn, act, enc, "ppswor", seed, want_fvals=False)[0])
    _check(s1 <= 2, f"{what}: K1 at [3, {n}] {s1} ulp from plain")
    torch.cuda.empty_cache()
    p1 = cuda_ms(torch, lambda: ks.fused_seeds_fvals_plain(
        keys, wn, act, enc, "ppswor", seed, want_fvals=False), reps=3,
        inner=1)
    del keys, wn, act                 # K2's plain sort needs the room
    torch.cuda.empty_cache()
    k2 = cuda_ms(torch, lambda: kbs.batched_bottomk_select(seeds, 257),
                 reps=7, inner=1)
    kv, _, kt = kbs.batched_bottomk_select(seeds, 257)
    lib = cuda_ms(torch, lambda: torch.topk(seeds, 257, dim=1,
                                            largest=False), reps=3, inner=1)
    p2 = cuda_ms(torch, lambda: kbs.batched_bottomk_select_plain(seeds, 257),
                 reps=3, inner=1)
    pv, _, pt = kbs.batched_bottomk_select_plain(seeds, 257)
    _check(torch.equal(kv, pv) and torch.equal(kt, pt),
           f"{what}: K2 at [3, {n}] != plain")
    del seeds, kv, pv
    torch.cuda.empty_cache()
    nf = len(enc)
    b1, by1 = bound(n * (4 + 4 + 1 + 4 * nf), 0)
    b2, by2 = bound(4 * nf * n, 0)
    print(f"{what} ({n:,} rows): {nv} valid slots, taus "
          f"{[round(x, 6) for x in sk.taus.tolist()]}, HT |g| mass "
          f"relative error {rel:.4f} (<= {4 / np.sqrt(255):.4f}); K1 seeds "
          f"only F = {nf} {k1:.4f} ms (plain {p1:.4f}, bound {b1:.4f} "
          f"{by1}; {s1} ulp from plain), K2 [{nf}, n] k = 257 {k2:.4f} ms "
          f"(plain {p2:.4f}, torch.topk {lib:.4f}, bound {b2:.4f} {by2}; "
          f"= plain)", flush=True)
    del sk
    torch.cuda.empty_cache()
    return {"seeds": {"ms": k1, "plain_ms": p1, "bound_ms": b1,
                      "shape": f"F = {nf}, n = {n}, seeds only"},
            "blockselect": {"ms": k2, "plain_ms": p2, "bound_ms": b2,
                            "library_ms": lib,
                            "shape": f"[{nf}, {n}], k = 257"}}


def phase_train(torch, C, K, dev):
    """7a: ``train.main`` for qwen2-1.5b at full width, 6 steps with the
    sampled exchange at one pod, importance sampling, telemetry and a
    checkpoint every 3 steps; a resume from step 3 (restored state equal
    to the saved one bit for bit, losses of steps 4-6 within RESUME_RTOL);
    a profiled step and its parts; the exchange's identity at one pod;
    ``_sample_leaf`` kernel against plain at ``layers.attn.wq``, the kernel
    alone at ``layers.mlp.wg`` (385,351,680 rows), where K1 and K2 are
    timed. Returns the K1/K2 exchange-shape stats and the run's launch
    counts."""
    import shutil
    from repro_torch import tree as TT
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, Loader, SyntheticCorpus
    from repro_torch.distopt import compression as CP
    from repro_torch.launch import steps as St
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # two 18.5 GB checkpoints: inside the checkout (build/ is ignored by
    # git), on the disk that holds it, not in a possibly small TMPDIR
    (ROOT / "build").mkdir(exist_ok=True)
    ck = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        state, rec, run_counts = _train_run(torch, K, train,
                                            TRAIN_ARGV + ["--ckpt-dir", ck])
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [rec["loss"][s] for s in range(1, TRAIN_STEPS + 1)]
        _check(all(np.isfinite(losses)), f"train losses {losses}")
        per_step = set(rec["steps"])
        _check(per_step == {TRAIN_STEP_LAUNCHES},
               f"launches per step {rec['steps']}, want "
               f"{TRAIN_STEP_LAUNCHES}")
        _check(int(state["opt"]["step"]) == TRAIN_STEPS, "opt step")
        secs = [rec["sec"][s] for s in range(1, TRAIN_STEPS + 1)]
        print(f"train qwen2-1.5b full width ({cfg.num_layers} layers, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab_size}), batch 8 x "
              f"seq 128, sampled exchange k = 256 at one pod: losses "
              f"{[round(x, 4) for x in losses]}; step wall s "
              f"{[round(x, 4) for x in secs]}, p50 "
              f"{float(np.median(secs)):.4f} (steps 2-6 "
              f"{float(np.median(secs[1:])):.4f}); run {run_s:.1f} s with "
              f"2 checkpoints; peak memory {peak:.2f} GiB; launches: the "
              f"importance build {rec['before']}, each step "
              f"{TRAIN_STEP_LAUNCHES}, the run {run_counts}", flush=True)
        del state
        torch.cuda.empty_cache()

        # resume from step 3: drop the newer checkpoint, run steps 4-6 again
        state = _resumed_run(torch, K, train, TRAIN_ARGV, ck, rec, 3,
                             TRAIN_STEPS, "train")
    finally:
        shutil.rmtree(ck, ignore_errors=True)

    # one more step, profiled, and its parts
    mesh = Mesh((1, 1, 1), ("pod", "data", "model"), device=dev)
    opt_cfg = adamw.OptConfig(peak_lr=3e-3, warmup_steps=TRAIN_STEPS // 20
                              + 1, total_steps=TRAIN_STEPS)
    step_fn, _ = St.make_train_step(cfg, opt_cfg, mesh,
                                    compress=dict(k=256, min_size=65536),
                                    telemetry=train.TEL_SPEC)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
                      n_docs=20_000)
    loader = Loader(SyntheticCorpus(dcfg), dcfg)
    batch = train.make_batch(cfg, loader.batch(TRAIN_STEPS), dcfg, dev)
    box = {}

    def whole():
        box["out"] = step_fn(state, batch)
    idle, wall, dev_ms, top = profiled(torch, whole)
    del box["out"]
    torch.cuda.empty_cache()
    parts = {}

    def fwd_bwd():
        box["g"] = _leaf_grads(torch, Mod, TT, cfg, state["params"], batch)
    parts["forward+backward"] = profiled(torch, fwd_bwd)

    def exchange():
        box["x"] = CP.exchange_grads(mesh, dict(box["g"]), TRAIN_STEPS,
                                     k=256, min_size=65536)
    parts["exchange"] = profiled(torch, exchange)

    def adam():
        with torch.no_grad():
            box["a"] = adamw.apply_updates(state["params"], box["x"],
                                           state["opt"], opt_cfg)
    parts["adamw"] = profiled(torch, adam)
    del box["a"], box["x"]
    torch.cuda.empty_cache()
    tkeys = torch.arange(8, dtype=torch.int32, device=dev) + (6 << 16)

    def fold():
        box["t"] = C.multisketch_absorb_inline(
            train.TEL_SPEC, state["tel"], tkeys,
            torch.full((8,), 10.0, device=dev), use_kernels=True)
    parts["telemetry"] = profiled(torch, fold)
    plain_fold = C.multisketch_absorb_inline(
        train.TEL_SPEC, state["tel"], tkeys,
        torch.full((8,), 10.0, device=dev), use_kernels=False)
    for name, x, y in zip(plain_fold._fields, box.pop("t"), plain_fold):
        _check(torch.equal(x, y), f"telemetry fold {name}: kernel path != "
               f"plain path")
    print(f"train telemetry fold: kernel path = plain path (all 8 "
          f"fields)", flush=True)
    print(f"train step profiled: wall {wall:.3f} ms, device {dev_ms:.3f} ms, "
          f"idle share {idle:.3f}; top {top}", flush=True)
    for name, (pi, pw, pd, pt) in parts.items():
        print(f"train step part {name}: wall {pw:.3f} ms, device {pd:.3f} "
              f"ms, idle {pi:.3f}; top {pt}", flush=True)

    # at one pod the exchange returns its input gradient
    grads = box.pop("g")
    inp = dict(TT.flatten(grads))
    out = dict(TT.flatten(CP.exchange_grads(mesh, grads, TRAIN_STEPS, k=256,
                                            min_size=65536)))
    for path, g in inp.items():
        _check(torch.equal(out[path], g), f"exchange at one pod changed "
               f"{path}")
    negz = sum(int(((g == 0) & torch.signbit(g)).sum()) for g in inp.values())
    del out, state
    torch.cuda.empty_cache()

    # _sample_leaf: kernel against plain at layers.attn.wq
    wq = inp["layers.attn.wq"]
    seed = (17 + 5 * 1_000_003 + TRAIN_STEPS) & 0xFFFFFFFF
    a = CP._sample_leaf(wq, 256, seed, 0.01)
    b = CP._sample_leaf(wq, 256, seed, 0.01, use_kernels=False)
    for name in ("keys", "valid", "member", "aux", "weights"):
        _check(torch.equal(getattr(a, name), getattr(b, name)),
               f"_sample_leaf {name} kernel != plain at wq")
    su, tu, pu = ulps(a.seeds, b.seeds), ulps(a.taus, b.taus), ulps(
        a.probs, b.probs)
    _check(su <= 2 and tu <= 2 and pu <= 4,
           f"_sample_leaf ulps seeds {su} taus {tu} probs {pu}")
    print(f"train exchange: at one pod every leaf returned as it came "
          f"({len(inp)} leaves, {negz} -0.0 entries); _sample_leaf at "
          f"layers.attn.wq ({wq.numel():,} rows) kernel = plain: keys, "
          f"valid, member, weights exact, seeds {su} taus {tu} probs {pu} "
          f"ulp, {int(a.valid.sum())} valid slots", flush=True)

    # the kernel alone at layers.mlp.wg, 385,351,680 rows
    wg = inp["layers.mlp.wg"].reshape(-1)
    del inp, grads, a, b
    torch.cuda.empty_cache()
    x = big_leaf_kernels(torch, dev, wg, seed, "train exchange at "
                         "layers.mlp.wg")
    del wg
    torch.cuda.empty_cache()
    import torch.distributed as dist
    dist.destroy_process_group()           # the one-rank NCCL group
    return ({name: {f"exchange_{key}": v for key, v in row.items()}
             for name, row in x.items()}, dict(zip(K.COUNTED, run_counts)))


def phase_train_multiprocess(torch):
    """7b: two processes on the one card over gloo, mesh 2 x 1 x 1,
    qwen2-1.5b at full widths cut to 2 layers (``_train_worker``)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="chip_smoke_7b_")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--train-worker",
         str(r), port, out], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        _check(p.returncode == 0, f"train worker {r} failed:\n{log[-4000:]}")
    res = [json.loads((Path(out) / f"rank{r}.json").read_text())
           for r in range(2)]
    _check(res[0]["losses"] == res[1]["losses"], "pod-mean losses differ")
    for r in res:
        _check(r["exchange_max_rel"] <= 1e-6, f"rank {r['rank']} exchange "
               f"off the formula by {r['exchange_max_rel']}")
        _check(r["sharded_member_taus_exact"] and r["sharded_probs_max_abs"]
               <= 1e-5 and r["from_sharded_bitsame"],
               f"rank {r['rank']} sharded builds {r}")
    print(f"train 2 processes x gloo on one card, mesh 2x1x1, qwen2-1.5b "
          f"widths at 2 layers: losses {res[0]['losses']}, step s "
          f"{res[0]['step_s']}; exchange at {res[0]['leaf']} = (own + the "
          f"other pod's HT estimate) / 2 within "
          f"{max(r['exchange_max_rel'] for r in res):.3g}; "
          f"sharded_multisketch over 2 x 524,288 rows = one-shot build "
          f"(members, taus exact, probs within "
          f"{max(r['sharded_probs_max_abs'] for r in res):.3g}); "
          f"from_sharded merged slab bit-equal", flush=True)


def _train_worker(rank: int, port: str, out: str) -> int:
    """One rank of 7b (started by ``phase_train_multiprocess``)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    import repro_torch.core as C
    from repro_torch import tree as TT
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, Loader, SyntheticCorpus
    from repro_torch.distopt import compression as CP
    from repro_torch.launch import steps as St
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.query import SegmentQueryEngine
    from repro_torch.launch.summary import sharded_multisketch
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=2)
    mesh = Mesh((2, 1, 1), ("pod", "data", "model"), device=dev)
    step_fn, _ = St.make_train_step(
        cfg, adamw.OptConfig(peak_lr=3e-3, warmup_steps=1, total_steps=3),
        mesh, compress=dict(k=256, min_size=65536),
        telemetry=train.TEL_SPEC)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
                      n_docs=20_000)
    loader = Loader(SyntheticCorpus(dcfg), dcfg, importance=True, device=dev)
    params, _ = Mod.init_model(cfg, seed=0, device=dev)
    state = {"params": params, "opt": adamw.init_opt_state(params),
             "tel": C.multisketch_empty(train.TEL_SPEC, device=dev)}
    losses, secs = [], []
    for step in range(3):
        t0 = time.perf_counter()
        state, m = step_fn(state, train.make_batch(cfg, loader.batch(step),
                                                   dcfg, dev))
        torch.cuda.synchronize()
        secs.append(round(time.perf_counter() - t0, 4))
        losses.append(float(m["loss"]))

    # the exchange on this pod's gradient against the formula on the host
    batch = train.make_batch(cfg, loader.batch(3), dcfg, dev)
    grads = _leaf_grads(torch, Mod, TT, cfg, state["params"], batch)
    leaf = "layers.attn.wq"
    own = dict(TT.flatten(grads))[leaf].reshape(-1).cpu().numpy()
    out_tree, wires = CP.exchange_grads(mesh, grads, 3, k=256,
                                        min_size=65536, return_wires=True)
    got = dict(TT.flatten(out_tree))[leaf].reshape(-1).cpu().numpy()
    w = wires[leaf].cpu().numpy()                      # [2, 4, 768] int32
    total = np.zeros(own.shape, np.float32)
    est = []
    for p in range(2):
        idx = np.maximum(w[p, 0], 0)
        val, prob = w[p, 1].view(np.float32), w[p, 2].view(np.float32)
        c = np.where(w[p, 3] != 0, val / np.maximum(prob, np.float32(1e-30)),
                     np.float32(0)).astype(np.float32)
        np.add.at(total, idx, c)
        e = np.zeros(own.shape, np.float32)
        np.add.at(e, idx, c)
        est.append(e)
    pod = mesh.coords["pod"]
    want = ((total - est[pod]) + own) / np.float32(2)
    scale = np.maximum(np.abs(want), np.float32(1e-30))
    ex_rel = float(np.max(np.abs(got - want) / scale))

    # sharded builds over the two ranks' halves of 2^20 rows
    rng = np.random.default_rng(71)
    n = 1 << 20
    keys = rng.permutation(n).astype(np.int32)
    wts = rng.lognormal(0, 2, n).astype(np.float32)
    dmesh = Mesh((2,), ("data",), device=dev)
    spec = smoke_spec(C, "ppswor")
    sk = sharded_multisketch(spec, dmesh, keys, wts)
    one = C.multisketch_build(spec, keys, wts, device=dev)
    a, b = member_triples(torch, sk), member_triples(torch, one)
    exact = ([x[:2] for x in a] == [x[:2] for x in b]
             and torch.equal(sk.taus, one.taus))
    pmax = max((abs(x[2] - y[2]) for x, y in zip(a, b)), default=0.0)
    eng = SegmentQueryEngine.from_sharded(spec, dmesh, keys, wts)
    same = all(bool(torch.equal(x, y)) for x, y in zip(eng.merged, sk))
    (Path(out) / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "losses": losses, "step_s": secs, "leaf": leaf,
        "exchange_max_rel": ex_rel, "sharded_member_taus_exact": exact,
        "sharded_probs_max_abs": pmax, "from_sharded_bitsame": same}))
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# phase 8: model serving (prefill, KV-cache decode, launch/serve.py) and the
# MoE family, at full width
# ---------------------------------------------------------------------------

# the kernel wrappers the serving path calls, as (module, the attribute its
# callers look up at call time, counter): compact_take holds K2 by its own
# module's name
PATH_WRAPPERS = (("seeds", "fused_seeds_fvals", "seeds"),
                 ("blockselect", "batched_bottomk_select", "blockselect"),
                 ("compact", "batched_bottomk_select", "blockselect"),
                 ("compact", "retention_priority", "compact"),
                 ("segquery", "segment_query_slab", "segquery"),
                 ("servicecost", "service_cost_slab", "servicecost"))


def snapshot(torch, x):
    """A copy of x's tensors, in the same (named) tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(snapshot(torch, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(snapshot(torch, v) for v in x)
    if isinstance(x, dict):
        return {k: snapshot(torch, v) for k, v in x.items()}
    return x


class _Recorded:
    """A wrapper that records its calls. Its ``launches`` is the wrapped
    function's, which the kernel modules count through the module name
    this object takes."""

    def __init__(self, torch, fn, counter: str, calls: list):
        self._torch, self._fn, self._counter, self._calls = (torch, fn,
                                                             counter, calls)

    def __call__(self, *a, **kw):
        inputs = snapshot(self._torch, (a, kw))
        out = self._fn(*a, **kw)
        self._calls.append((self._counter, inputs,
                            snapshot(self._torch, out)))
        return out

    @property
    def launches(self):
        return self._fn.launches

    @launches.setter
    def launches(self, value):
        self._fn.launches = value


@contextlib.contextmanager
def recorded_launches(torch, wrappers=PATH_WRAPPERS):
    """Every call of a ``wrappers`` wrapper (default ``PATH_WRAPPERS``)
    inside the block, as (counter, inputs, outputs), copies taken at the
    call."""
    calls, saved = [], []
    for mod_name, attr, counter in wrappers:
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, _Recorded(torch, fn, counter, calls))
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def check_path_launches(torch, calls, what: str):
    """Each recorded launch's outputs against its kernel's plain version on
    the recorded inputs, at phase 1's tolerances (K1 within 2 ulp, the
    sum/count/thresh f-values exact; K2 and K3 bit for bit; K4 within rtol
    1e-5; K5 by ``k5_check``). Returns {counter: max abs error}."""
    from repro_torch.core import costs as CO
    from repro_torch.kernels.blockselect import batched_bottomk_select_plain
    from repro_torch.kernels.compact import retention_priority_plain
    from repro_torch.kernels.seeds import fused_seeds_fvals_plain
    from repro_torch.kernels.segquery import segment_query_slab_plain
    from repro_torch.kernels.servicecost import service_cost_slab_plain
    errs = {}
    for i, (name, (a, kw), got) in enumerate(calls):
        tag = f"{what}: {name} launch {i}"
        if name == "seeds only":
            want = fused_seeds_fvals_plain(*a, **kw, want_fvals=False)[0]
            _check(ulps(got, want) <= 2,
                   f"{tag}: seeds differ from the plain version")
            err = max_abs(got, want)
        elif name == "seeds":
            (sk, fk), (sp, fp) = got, fused_seeds_fvals_plain(*a, **kw)
            exact = [j for j, (kind, _) in enumerate(a[3]) if kind != 4]
            _check(ulps(sk, sp) <= 2 and ulps(fk, fp) <= 2
                   and torch.equal(fk[exact], fp[exact]),
                   f"{tag}: seeds/f-values differ from the plain version")
            err = max(max_abs(sk, sp), max_abs(fk, fp))
        elif name == "blockselect":
            (vk, ik, tk), (vp, ip, tp) = got, batched_bottomk_select_plain(
                *a, **kw)
            _check(torch.equal(vk.view(torch.int32), vp.view(torch.int32))
                   and torch.equal(ik, ip) and torch.equal(tk, tp),
                   f"{tag}: vals/idx/tau differ from the plain version")
            err = max_abs(vk, vp)
        elif name == "compact":
            want = retention_priority_plain(*a, **kw)
            _check(torch.equal(got, want), f"{tag}: priorities differ")
            err = max_abs(got, want)
        elif name == "segquery":
            want = segment_query_slab_plain(*a, **kw)
            _check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
                   f"{tag}: beyond rtol 1e-5 of the plain version")
            err = max_abs(got, want)
        else:
            want = service_cost_slab_plain(*a, **kw)
            err = k5_check(torch, CO, got, want, a[:3], a[3], tag)
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


def _serve_run(torch, K, dev, arch: str, argv):
    """serve.main for ``arch`` with the launch counts reset just before it:
    (result, per-block launch deltas, the run's launches, peak GiB, wall
    s). Prefill and decode launch none of the port's kernels; the request
    telemetry moves K1-K3 at absorb, K4 at query and K5 in the search.
    Every launch of the run is held against its plain version on its own
    inputs, and the same requests go through the plain versions on the
    card: the pool's answers (both predicates) within rtol 1e-5, the
    request-shape slab bit for bit and the service costs of the search's
    centers and of 15 seeded center sets within rtol 1e-5."""
    from repro_torch import core as C
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.query import SegmentQueryEngine
    deltas, info, last = {}, {}, {}

    def cb(event, **kw):
        deltas[event] = counts_delta(K, last["c"])
        info[event] = kw
        last["c"] = K.launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    last["c"] = K.launch_counts()
    t0 = time.perf_counter()
    with recorded_launches(torch) as calls:
        out = serve.main(["--arch", arch] + argv, callback=cb)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    run = tuple(K.launch_counts().values())
    args = dict(zip(argv[::2], argv[1::2]))
    B, P, G = (int(args[k]) for k in ("--batch", "--prompt-len", "--gen"))
    cfg = get_config(arch)
    toks = out["tokens"]
    _check(toks.shape == (B, G) and toks.min() >= 0
           and toks.max() < cfg.vocab_size, f"{arch} served tokens")
    none = (0,) * len(K.COUNTED)
    _check(deltas["prefilled"] == none and deltas["decoded"] == none,
           f"{arch}: the model path launched {deltas}")
    a, q, c = deltas["absorbed"], deltas["queried"], deltas["clustered"]
    _check(min(a[:3]) > 0 and a[3:] == (0, 0, 0), f"{arch} absorb {a}")
    _check(q == (0, 0, 0, 1, 0, 0), f"{arch} query {q}")
    _check(c[4] > 0, f"{arch} request-shape search {c}")
    st = out["stats"]
    _check(st[0, 0] == B * (P + G) and st[1, 0] == B and st[2, 0] == B,
           f"{arch} request telemetry {st.tolist()}")
    _check(len(out["decode_ms"]) == G - 1 and np.isfinite(out["est_cost"]),
           f"{arch} decode steps / cluster cost")

    # every launch of the run, against its plain version
    recorded = tuple(sum(1 for name, _, _ in calls if name == k)
                     for k in K.COUNTED)
    _check(recorded == run, f"{arch}: recorded launches {recorded}, "
           f"counted {run}")
    errs = check_path_launches(torch, calls, f"{arch} serve")

    # the same requests through the plain versions on the card
    twin = SegmentQueryEngine(serve.REQUEST_SPEC, use_kernels=False,
                              device=dev)
    twin.absorb(*C.quarantine_chunk(np.arange(B), np.full(B, float(P + G)))
                [:3])
    want = twin.query_many(serve.REQUEST_OBJECTIVES, serve.REQUEST_PREDICATES)
    _check(np.allclose(st, want, rtol=1e-5, atol=0.0),
           f"{arch}: pool answers {st.tolist()} vs plain {want.tolist()}")
    ceng, res = info["clustered"]["engine"], info["clustered"]["result"]
    feats = serve.request_features(toks, P + G)
    ctwin = serve.request_cluster_engine(B, int(args.get("--seed", 0)), dev,
                                         use_kernels=False)
    ctwin.absorb(feats)
    for name, x, y in zip(ceng._sketch._fields, ceng._sketch, ctwin._sketch):
        _check(torch.equal(x, y), f"{arch}: request-shape slab {name} differs")
    _check(torch.equal(ceng._coords, ctwin._coords),
           f"{arch}: request-shape coords differ")
    rng = np.random.default_rng(18)
    sets = (feats[rng.integers(0, B, (15, 2))]
            + rng.normal(0, 4.0, (15, 2, 2))).astype(np.float32)
    table = C.cost_table(np.concatenate([res.centers[None], sets]), 2.0)
    ka, kb = ceng.service_costs(table), ctwin.service_costs(table)
    _check(np.allclose(ka, kb, rtol=1e-5, atol=0.0) and kb.max() > 0,
           f"{arch}: service costs {ka.tolist()} vs plain {kb.tolist()}")
    print(f"serve {arch}: {sum(run)} kernel launches of the run held against "
          f"their plain versions on their own inputs (max abs err: "
          f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())}); plain "
          f"twins on the card: answers {want[:, 1].tolist()} (hash 0.5) "
          f"within rtol 1e-5, slab bit-equal, 16 service costs within rtol "
          f"1e-5 (max {float(kb.max()):.4g})", flush=True)
    return out, deltas, run, peak, wall


def no_drop(cfg):
    """A MoE config whose full forward can drop no choice (capacity >= the
    sequence: capacity_factor >= E / top_k, and at least the reference
    test's 8). A one-token decode step never drops, and a full-forward
    drop is intended behaviour, so the consistency check avoids it as the
    reference's test_smoke_decode_consistency does."""
    import dataclasses
    return dataclasses.replace(cfg, capacity_factor=max(
        8.0, cfg.num_experts / cfg.moe_top_k))


def _decode_consistency(torch, Mod, cfg, dev, tol: float, params=None):
    """fp32 activations, batch 2 x CONSISTENCY_S: serve_step's logits at
    every position and prefill's last-position logits against
    forward_logits, each within tol x max(scale, 1). ``params``: the fp32
    parameters from seed 0 when the caller holds them. Returns (max step
    error, prefill error, scale)."""
    if cfg.family == "moe":
        from repro_torch.models.moe import moe_capacity
        _check(moe_capacity(CONSISTENCY_S, cfg) >= CONSISTENCY_S,
               f"{cfg.name}: the full forward could drop choices")
    old = Mod.ACT_DTYPE
    Mod.ACT_DTYPE = torch.float32
    plain = plain_attention()
    try:
        if params is None:
            params, _ = Mod.init_model(cfg, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(9)
        S, V = CONSISTENCY_S, cfg.vocab_size
        toks = torch.randint(0, V, (2, S), generator=g, device=dev,
                             dtype=torch.int32)
        with torch.no_grad():
            full = Mod.forward_logits(params, cfg, {"tokens": toks})
        cache = Mod.make_cache(cfg, 2, S, dtype=torch.float32, device=dev)
        err = 0.0
        for t in range(S):
            logits, cache = Mod.serve_step(params, cfg, toks[:, t], cache, t)
            err = max(err, float((logits[:, :V] - full[:, t, :V]).abs()
                                 .max()))
        last, _ = Mod.prefill(params, cfg, {"tokens": toks})
        perr = float((last[:, :V] - full[:, -1, :V]).abs().max())
        scale = float(full[..., :V].abs().max())
    finally:
        Mod.ACT_DTYPE = old
        plain.close()
    _check(np.isfinite(scale) and err <= tol * max(scale, 1.0)
           and perr <= tol * max(scale, 1.0),
           f"{cfg.name} fp32 decode consistency: steps {err}, prefill "
           f"{perr}, scale {scale}, tol {tol}")
    return err, perr, scale


def _decode_steps(torch, Mod, cfg, params, dev, batch: int, length: int,
                  steps: int, seed: int):
    """A bf16 cache (k/v [L, batch, length, K, hd], SSM states) filled from
    a seeded generator; ``steps`` decode steps at the last indices, timed
    with CUDA events around all of them (ms per step), after two warm
    steps."""
    from repro_torch import tree as TT
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = Mod.make_cache(cfg, batch, length, device=dev)
    for t in TT.leaves(cache):
        t.normal_(generator=g)
    tok = torch.randint(0, cfg.vocab_size, (batch,), generator=g,
                        device=dev, dtype=torch.int32)
    for i in range(2):
        Mod.serve_step(params, cfg, tok, cache, length - steps - 2 + i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        logits, cache = Mod.serve_step(params, cfg, tok, cache,
                                       length - steps + i)
        tok = torch.argmax(logits, -1).to(torch.int32)
    end.record()
    end.synchronize()
    _check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
           f"{cfg.name} decode at cache length {length}: logits")
    return start.elapsed_time(end) / steps, cache, tok


def _profiled_decode(torch, Mod, cfg, params, dev, batch: int, length: int,
                     steps: int, seed: int):
    """``_decode_steps``, then one more step at the last index under the
    profiler; prints both. Returns (ms per step, the bf16 cache)."""
    ms, cache, tok = _decode_steps(torch, Mod, cfg, params, dev, batch,
                                   length, steps, seed)
    idle, wall, dev_ms, top = profiled(torch, lambda: Mod.serve_step(
        params, cfg, tok, cache, length - 1))
    print(f"serve {cfg.name} decode (batch {batch}, cache {length}): "
          f"{ms:.3f} ms/step over {steps} steps; one step profiled: wall "
          f"{wall:.3f} ms, device {dev_ms:.3f} ms, idle share {idle:.3f}; "
          f"top {top}", flush=True)
    return ms, cache


def phase_serve(torch, K, dev, card: str):
    """8a-8e (module docstring). Returns (serve launches of 8a's run, the
    MoE exchange's K1/K2 stats at layers.moe.wi, 8d's launches)."""
    from repro_torch import tree as TT
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, Loader, SyntheticCorpus
    from repro_torch.launch import train
    from repro_torch.models import model as Mod

    # 8a: qwen2-1.5b through serve.main
    out, deltas, run, peak, wall = _serve_run(torch, K, dev, SERVE_ARCH,
                                              SERVE_TRAFFIC)
    dms = out["decode_ms"]
    print(f"serve {SERVE_ARCH} full width, batch 8 x prompt 1024, gen 64 "
          f"({card}): prefill {out['prefill_ms']:.3f} ms, decode "
          f"{float(np.median(dms)):.3f} ms/token p50 (mean "
          f"{float(np.mean(dms)):.3f}, max {max(dms):.3f}), peak memory "
          f"{peak:.2f} GiB, run {wall:.1f} s; launches: absorb "
          f"{deltas['absorbed']}, query {deltas['queried']}, request-shape "
          f"search {deltas['clustered']}, the run {run}", flush=True)

    # 8b: fp32 decode consistency at full width
    cfg = get_config(SERVE_ARCH)
    err, perr, scale = _decode_consistency(torch, Mod, cfg, dev, 5e-3)
    print(f"serve {SERVE_ARCH} fp32 decode consistency (batch 2, S = "
          f"{CONSISTENCY_S}): max |serve_step - forward_logits| {err:.3g}, "
          f"prefill last position {perr:.3g}, logit scale {scale:.3g} "
          f"(bar {5e-3 * max(scale, 1.0):.3g})", flush=True)

    # decode steps at 8a's cache, then at decode_32k's cache length at
    # batch 8, each with one step profiled
    torch.cuda.empty_cache()
    params, _ = Mod.init_model(cfg, seed=0, device=dev)
    T = 1024 + 64
    _, cache = _profiled_decode(torch, Mod, cfg, params, dev, 8, T, 16, 10)
    del cache
    torch.cuda.empty_cache()
    ms_long, cache = _profiled_decode(torch, Mod, cfg, params, dev,
                                      LONG_BATCH, LONG_T, LONG_STEPS, 11)
    kv = sum(t.numel() * t.element_size() for t in cache.values())
    del cache
    n_emb = params["emb"]["tok"].numel()
    n_rest = sum(x.numel() for p, x in TT.flatten(params) if p != "emb.tok")
    k_elems = kv // 4                   # k's elements (k and v in bf16)
    nbytes = 8 * n_rest + 4 * n_emb + kv + 8 * k_elems
    b_long, _ = bound(nbytes, 0)
    floor, _ = bound(2 * (n_rest + n_emb) + kv, 0)
    del params
    torch.cuda.empty_cache()
    print(f"serve decode at cache length {LONG_T} (batch {LONG_BATCH}, "
          f"cut from decode_32k's 128; KV {kv / 1e9:.2f} GB): "
          f"{ms_long:.3f} ms/token over {LONG_STEPS} steps, "
          f"{ms_long / floor:.1f}x its bound {floor:.3f} ms (bf16 weights "
          f"and KV read once); the current design's traffic "
          f"{b_long:.3f} ms ({nbytes / 1e9:.2f} GB: per-call casts "
          f"{8 * n_rest / 1e9:.2f}, fp32 tied head {4 * n_emb / 1e9:.2f}, "
          f"KV {kv / 1e9:.2f}, k's fp32 up-cast {8 * k_elems / 1e9:.2f})",
          flush=True)

    # 8d: granite-moe serve, fp32 consistency, 3 train steps, the exchange
    mcfg = get_config(MOE_ARCH)
    out, deltas, mrun, mpeak, mwall = _serve_run(torch, K, dev, MOE_ARCH,
                                                 SERVE_TRAFFIC)
    dms = out["decode_ms"]
    print(f"serve {MOE_ARCH} full width, batch 8 x prompt 1024, gen 64: "
          f"prefill {out['prefill_ms']:.3f} ms, decode "
          f"{float(np.median(dms)):.3f} ms/token p50 (mean "
          f"{float(np.mean(dms)):.3f}), peak memory {mpeak:.2f} GiB, run "
          f"{mwall:.1f} s; launches: absorb {deltas['absorbed']}, query "
          f"{deltas['queried']}, the run {mrun}", flush=True)
    err, perr, scale = _decode_consistency(
        torch, Mod, no_drop(mcfg), dev, 2e-2)
    print(f"serve {MOE_ARCH} fp32 decode consistency (capacity_factor "
          f"{no_drop(mcfg).capacity_factor:g}): "
          f"max step error {err:.3g}, prefill {perr:.3g}, scale "
          f"{scale:.3g} (bar {2e-2 * max(scale, 1.0):.3g})", flush=True)
    torch.cuda.empty_cache()
    params, _ = Mod.init_model(mcfg, seed=0, device=dev)
    _profiled_decode(torch, Mod, mcfg, params, dev, 8, T, 16, 12)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", MOE_ARCH, "--steps", "3", "--batch", "8", "--seq",
            "128", "--mesh", "1x1x1", "--compress", "--importance-sampling",
            "--log-every", "1"]
    t0 = time.perf_counter()
    state, rec, trun = _train_run(torch, K, train, argv)
    twall = time.perf_counter() - t0
    tpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [rec["loss"][s] for s in (1, 2, 3)]
    _check(all(np.isfinite(losses)), f"{MOE_ARCH} train losses {losses}")
    _check(set(rec["steps"]) == {MOE_STEP_LAUNCHES},
           f"{MOE_ARCH} launches per step {rec['steps']}, want "
           f"{MOE_STEP_LAUNCHES}")
    secs = [rec["sec"][s] for s in (1, 2, 3)]
    print(f"train {MOE_ARCH} full width, batch 8 x seq 128, sampled "
          f"exchange k = 256 at one pod: losses "
          f"{[round(x, 4) for x in losses]}, step wall s "
          f"{[round(x, 4) for x in secs]}, peak memory {tpeak:.2f} GiB, run "
          f"{twall:.1f} s; launches: the importance build {rec['before']}, "
          f"each step {MOE_STEP_LAUNCHES}, the run {trun}", flush=True)
    dcfg = DataConfig(vocab_size=mcfg.vocab_size, seq_len=128,
                      global_batch=8, n_docs=20_000)
    batch = train.make_batch(mcfg, Loader(SyntheticCorpus(dcfg),
                                          dcfg).batch(3), dcfg, dev)
    grads = _leaf_grads(torch, Mod, TT, mcfg, state["params"], batch)
    wi = grads["layers"]["moe"]["wi"].reshape(-1)
    del grads, state
    torch.cuda.empty_cache()
    moe_x = big_leaf_kernels(torch, dev, wi, 0x5EED0018, "MoE exchange at "
                             "layers.moe.wi")
    del wi
    torch.cuda.empty_cache()
    import torch.distributed as dist
    dist.destroy_process_group()           # train.main's one-rank group

    # 8e: qwen2-moe-a2.7b serve (60 experts, 4 shared, QKV bias)
    out, deltas, brun, bpeak, bwall = _serve_run(
        torch, K, dev, BIG_MOE_ARCH, BIG_MOE_TRAFFIC)
    dms = out["decode_ms"]
    print(f"serve {BIG_MOE_ARCH} full width, batch 4 x prompt 512, gen 16: "
          f"prefill {out['prefill_ms']:.3f} ms, decode "
          f"{float(np.median(dms)):.3f} ms/token p50, peak memory "
          f"{bpeak:.2f} GiB, run {bwall:.1f} s; launches: the run {brun}",
          flush=True)
    torch.cuda.empty_cache()
    bcfg = get_config(BIG_MOE_ARCH)
    params, _ = Mod.init_model(bcfg, seed=0, device=dev)
    err, perr, scale = _decode_consistency(
        torch, Mod, no_drop(bcfg), dev, 2e-2, params)
    print(f"serve {BIG_MOE_ARCH} fp32 decode consistency (capacity_factor "
          f"{no_drop(bcfg).capacity_factor:g}): max step error {err:.3g}, prefill {perr:.3g}, scale "
          f"{scale:.3g} (bar {2e-2 * max(scale, 1.0):.3g})", flush=True)
    _profiled_decode(torch, Mod, bcfg, params, dev, 4, 512 + 16, 8, 13)
    del params
    torch.cuda.empty_cache()
    return (dict(zip(K.COUNTED, run)),
            {name: {f"moe_exchange_{key}": v for key, v in row.items()}
             for name, row in moe_x.items()},
            dict(zip(K.COUNTED, trun)))


def _ssm_serve(torch, K, dev, card: str, arch: str):
    """``_serve_run`` at phase 8a's traffic, printed. Returns its launches."""
    out, deltas, run, peak, wall = _serve_run(torch, K, dev, arch,
                                              SERVE_TRAFFIC)
    dms = out["decode_ms"]
    print(f"serve {arch} full width, batch 8 x prompt 1024, gen 64 "
          f"({card}): prefill {out['prefill_ms']:.3f} ms, decode "
          f"{float(np.median(dms)):.3f} ms/token p50 (mean "
          f"{float(np.mean(dms)):.3f}, max {max(dms):.3f}), peak memory "
          f"{peak:.2f} GiB, run {wall:.1f} s; launches: absorb "
          f"{deltas['absorbed']}, query {deltas['queried']}, request-shape "
          f"search {deltas['clustered']}, the run {run}", flush=True)
    return run


def _ssm_consistency(torch, Mod, cfg, dev):
    """``_decode_consistency`` at the reference test's 5e-3, printed."""
    err, perr, scale = _decode_consistency(torch, Mod, cfg, dev, 5e-3)
    print(f"serve {cfg.name} fp32 decode consistency (batch 2, S = "
          f"{CONSISTENCY_S}): max |serve_step - forward_logits| {err:.3g}, "
          f"prefill last position {perr:.3g}, logit scale {scale:.3g} "
          f"(bar {5e-3 * max(scale, 1.0):.3g})", flush=True)


def _nbytes(TT, tree) -> int:
    return sum(t.numel() * t.element_size() for t in TT.leaves(tree))


def _profiled_layer_prefill(torch, cfg, params, dev):
    """Layer 0's SSM block over a seeded bf16 [8, 1024, d_model] input,
    under no_grad and the profiler, printed: where a prefill's time goes."""
    from repro_torch.models import mamba as M
    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn((8, 1024, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    lp = {k: t[0] for k, t in params["layers"]["mamba"].items()}
    apply = M.apply_mamba1 if cfg.ssm_kind == "mamba1" else M.apply_mamba2

    def run():
        with torch.no_grad():
            apply(lp, x, cfg)
    run()
    idle, wall, dev_ms, top = profiled(torch, run)
    print(f"prefill of one {cfg.name} layer ({cfg.ssm_kind}) at batch 8 x "
          f"1024: wall {wall:.3f} ms, device {dev_ms:.3f} ms, idle share "
          f"{idle:.3f}; top {top}", flush=True)


def phase_ssm(torch, K, dev, card: str):
    """9a-9d (module docstring). Returns (9a's serve launches, 9d's train
    launches, the hybrid exchange's K1/K2 stats at layers.mamba.wx, 9d's
    K7 launches a step)."""
    from repro_torch import tree as TT
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, Loader, SyntheticCorpus
    from repro_torch.kernels import attention as KA
    from repro_torch.launch import train
    from repro_torch.models import model as Mod
    T = 1024 + 64

    # 9a-9c: falcon-mamba-7b: serve, fp32 consistency, decode
    run = _ssm_serve(torch, K, dev, card, SSM_ARCH)
    cfg = get_config(SSM_ARCH)
    _ssm_consistency(torch, Mod, cfg, dev)
    torch.cuda.empty_cache()
    params, _ = Mod.init_model(cfg, seed=0, device=dev)
    _profiled_layer_prefill(torch, cfg, params, dev)
    _, cache = _profiled_decode(torch, Mod, cfg, params, dev, 8, T, 16, 20)
    qcfg = get_config(SERVE_ARCH)
    qkv = 2 * qcfg.num_layers * 8 * T * qcfg.num_kv_heads * qcfg.head_dim * 2
    print(f"serve {SSM_ARCH} decode state at batch 8: "
          f"{_nbytes(TT, cache) / 1e9:.4f} GB at any position (conv "
          f"{_nbytes(TT, cache['conv']) / 1e9:.4f} bf16, h "
          f"{_nbytes(TT, cache['h']) / 1e9:.4f} fp32); {SERVE_ARCH}'s bf16 "
          f"KV cache of {T} slots at batch 8: {qkv / 1e9:.4f} GB", flush=True)
    del cache
    far, _, _ = _decode_steps(torch, Mod, cfg, params, dev, 1,
                              LONG_500K_LAST + LONG_STEPS, LONG_STEPS, 21)
    near, _, _ = _decode_steps(torch, Mod, cfg, params, dev, 1,
                               LONG_STEPS + 2, LONG_STEPS, 21)
    print(f"serve {SSM_ARCH} decode at batch 1 (long_500k): "
          f"{far:.3f} ms/step over {LONG_STEPS} steps from position "
          f"{LONG_500K_LAST:,}, {near:.3f} ms/step from position 2 (a seeded "
          f"state; no prefill)", flush=True)
    del params
    torch.cuda.empty_cache()

    # 9d, 9b, 9c: zamba2-2.7b: serve, fp32 consistency, decode
    hcfg = get_config(HYBRID_ARCH)
    _ssm_serve(torch, K, dev, card, HYBRID_ARCH)
    _ssm_consistency(torch, Mod, hcfg, dev)
    torch.cuda.empty_cache()
    params, _ = Mod.init_model(hcfg, seed=0, device=dev)
    _profiled_layer_prefill(torch, hcfg, params, dev)
    _profiled_decode(torch, Mod, hcfg, params, dev, 8, T, 16, 22)
    torch.cuda.empty_cache()
    ms_long, cache = _profiled_decode(torch, Mod, hcfg, params, dev,
                                      LONG_BATCH, LONG_T, LONG_STEPS, 23)
    kv = _nbytes(TT, {"k": cache["k"], "v": cache["v"]})
    state = _nbytes(TT, cache["mamba"])
    floor, _ = bound(2 * sum(x.numel() for x in TT.leaves(params)) + kv
                     + 2 * state, 0)
    print(f"serve {HYBRID_ARCH} decode at cache length {LONG_T} (batch "
          f"{LONG_BATCH}, cut from decode_32k's 128; KV {kv / 1e9:.2f} GB "
          f"over {hcfg.num_layers // hcfg.attn_every} shared-block groups, "
          f"SSM state {state / 1e9:.3f} GB): {ms_long:.3f} ms/token, "
          f"{ms_long / floor:.1f}x its bound {floor:.3f} ms (bf16 weights "
          f"and KV read once, the state read and written)", flush=True)
    del cache, params
    torch.cuda.empty_cache()

    # 9d: zamba2-2.7b trains 3 steps with the exchange
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", HYBRID_ARCH, "--steps", "3", "--batch", "8", "--seq",
            "128", "--mesh", "1x1x1", "--compress", "--importance-sampling",
            "--log-every", "1"]
    t0 = time.perf_counter()
    KA.launch.launches = 0
    state, rec, trun = _train_run(torch, K, train, argv)
    twall = time.perf_counter() - t0
    tpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [rec["loss"][s] for s in (1, 2, 3)]
    _check(all(np.isfinite(losses)), f"{HYBRID_ARCH} train losses {losses}")
    _check(set(rec["steps"]) == {HYBRID_STEP_LAUNCHES},
           f"{HYBRID_ARCH} launches per step {rec['steps']}, want "
           f"{HYBRID_STEP_LAUNCHES}")
    _check(KA.launch.launches == 3 * HYBRID_STEP_ATTN,
           f"{HYBRID_ARCH} K7 launches over 3 steps {KA.launch.launches}, "
           f"want {3 * HYBRID_STEP_ATTN}")
    secs = [rec["sec"][s] for s in (1, 2, 3)]
    print(f"train {HYBRID_ARCH} full width, batch 8 x seq 128, sampled "
          f"exchange k = 256 at one pod: losses "
          f"{[round(x, 4) for x in losses]}, step wall s "
          f"{[round(x, 4) for x in secs]}, peak memory {tpeak:.2f} GiB, run "
          f"{twall:.1f} s; launches: the importance build {rec['before']}, "
          f"each step {HYBRID_STEP_LAUNCHES} and K7 {HYBRID_STEP_ATTN}, the "
          f"run {trun}", flush=True)
    params = state["params"]
    del state                                # the moments and telemetry
    torch.cuda.empty_cache()
    dcfg = DataConfig(vocab_size=hcfg.vocab_size, seq_len=128,
                      global_batch=8, n_docs=20_000)
    batch = train.make_batch(hcfg, Loader(SyntheticCorpus(dcfg),
                                          dcfg).batch(3), dcfg, dev)
    grads = _leaf_grads(torch, Mod, TT, hcfg, params, batch)
    wx = grads["layers"]["mamba"]["wx"].reshape(-1)
    del grads, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hyb_x = big_leaf_kernels(torch, dev, wx, 0x5EED0019, "hybrid exchange "
                             "at layers.mamba.wx")
    print(f"hybrid exchange at layers.mamba.wx: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB (the leaf "
          f"{wx.numel() * 4 / 1e9:.2f} GB)", flush=True)
    del wx
    torch.cuda.empty_cache()
    import torch.distributed as dist
    dist.destroy_process_group()           # train.main's one-rank group
    return (dict(zip(K.COUNTED, run)), dict(zip(K.COUNTED, trun)),
            {name: {f"hybrid_exchange_{key}": v for key, v in row.items()}
             for name, row in hyb_x.items()}, HYBRID_STEP_ATTN)


# ---------------------------------------------------------------------------
# phase 10: the encoder and vlm families
# ---------------------------------------------------------------------------

def exchange_step_launches(cfg):
    """A ``train.main --compress`` step's launches: the telemetry fold's
    (1, 2, 1, 0, 0, 0), which is what a smoke config counts on the CPU
    (its leaves are all under the exchange's min_size of 65,536), plus
    one K1 and one K2 launch for each leaf of ``cfg`` the exchange
    samples. Returns (launches, sampled leaves)."""
    from repro_torch import tree as TT
    from repro_torch.models import model as Mod
    n = sum(1 for t in TT.leaves(Mod.abstract_params(cfg)[0])
            if t.numel() >= 65536)
    return (n + 1, n + 2, 1, 0, 0, 0), n


@contextlib.contextmanager
def cut_depth(module, arch: str, layers: int):
    """Inside the block ``module.get_config(arch)`` gives the config with
    ``num_layers`` cut to ``layers`` (the entry points read the registry
    at call time)."""
    import dataclasses
    get = module.get_config

    def cut(a):
        cfg = get(a)
        return dataclasses.replace(cfg, num_layers=layers) if a == arch \
            else cfg
    module.get_config = cut
    try:
        yield
    finally:
        module.get_config = get


def _n_params(TT, cfg) -> int:
    from repro_torch.models import model as Mod
    return sum(t.numel() for t in TT.leaves(Mod.abstract_params(cfg)[0]))


def _vlm_consistency(torch, Mod, cfg, dev, tol: float = 5e-3):
    """fp32 activations, batch 2, [frontend_tokens patches | CONSISTENCY_S
    tokens], both from a seeded generator: prefill over the patches and
    the first token, then serve_step at index frontend_tokens + t for
    every text position t (t = 0 decoded again), each against
    forward_logits within tol x max(scale, 1); then greedy decoding
    after a prefill of half the tokens, each pick equal to the full
    forward's argmax over the same prefix. Returns (max step error,
    prefill error, scale, the greedy picks checked)."""
    P, S, V = cfg.frontend_tokens, CONSISTENCY_S, cfg.vocab_size
    old = Mod.ACT_DTYPE
    Mod.ACT_DTYPE = torch.float32
    plain = plain_attention()
    try:
        params, _ = Mod.init_model(cfg, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(9)
        toks = torch.randint(0, V, (2, S), generator=g, device=dev,
                             dtype=torch.int32)
        patches = torch.randn((2, P, cfg.d_model), generator=g, device=dev)
        with torch.no_grad():
            full = Mod.forward_logits(params, cfg, {"tokens": toks,
                                                    "patches": patches})
        last, cache = Mod.prefill(params, cfg, {"tokens": toks[:, :1],
                                                "patches": patches})
        perr = float((last[:, :V] - full[:, P, :V]).abs().max())
        cache = Mod.grow_cache(cfg, cache, S - 1)
        err = 0.0
        for t in range(S):
            logits, cache = Mod.serve_step(params, cfg, toks[:, t], cache,
                                           P + t)
            err = max(err, float((logits[:, :V] - full[:, P + t, :V]).abs()
                                 .max()))
        scale = float(full[..., :V].abs().max())
        del full, cache
        h = S // 2
        last, cache = Mod.prefill(params, cfg, {"tokens": toks[:, :h],
                                                "patches": patches})
        cache = Mod.grow_cache(cfg, cache, h)
        picks = [torch.argmax(last, -1).to(torch.int32)]
        for t in range(h - 1):
            logits, cache = Mod.serve_step(params, cfg, picks[-1], cache,
                                           P + h + t)
            picks.append(torch.argmax(logits, -1).to(torch.int32))
        gen = torch.stack(picks, 1)
        with torch.no_grad():
            full = Mod.forward_logits(params, cfg, {
                "tokens": torch.cat([toks[:, :h], gen[:, :-1]], 1),
                "patches": patches})
        want = torch.argmax(full[:, P + h - 1:, :V], -1).to(torch.int32)
        del params, full, cache
    finally:
        Mod.ACT_DTYPE = old
        plain.close()
    _check(np.isfinite(scale) and err <= tol * max(scale, 1.0)
           and perr <= tol * max(scale, 1.0),
           f"{cfg.name} fp32 decode consistency: steps {err}, prefill "
           f"{perr}, scale {scale}, tol {tol}")
    _check(torch.equal(gen, want), f"{cfg.name}: greedy decode "
           f"{gen.tolist()} != the full forward's picks {want.tolist()}")
    return err, perr, scale, gen.numel()


def phase_encoder_vlm(torch, K, dev, card: str):
    """10a-10d (module docstring). Returns (10a's train launches, 10c's
    serve launches, the encoder exchange's K1/K2 stats at
    layers.mlp.wi)."""
    import dataclasses
    import shutil
    from repro_torch import tree as TT
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.data.pipeline import DataConfig, Loader, SyntheticCorpus
    from repro_torch.launch import serve, train
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as Mod
    import torch.distributed as dist

    # 10a: hubert-xlarge trains at full width and depth, then resumes
    cfg = get_config(ENCODER_ARCH)
    want, nleaf = exchange_step_launches(cfg)
    argv = ["--arch", ENCODER_ARCH, "--steps", str(ENCODER_STEPS), "--batch",
            "8", "--seq", str(ENCODER_S), "--mesh", "1x1x1", "--compress",
            "--importance-sampling", "--ckpt-every", "2", "--log-every", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (ROOT / "build").mkdir(exist_ok=True)
    ck = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        state, rec, enc_run = _train_run(torch, K, train,
                                         argv + ["--ckpt-dir", ck])
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = range(1, ENCODER_STEPS + 1)
        losses = [rec["loss"][s] for s in steps]
        secs = [rec["sec"][s] for s in steps]
        _check(all(np.isfinite(losses)), f"{ENCODER_ARCH} losses {losses}")
        _check(set(rec["steps"]) == {want}, f"{ENCODER_ARCH} launches per "
               f"step {rec['steps']}, want {want}")
        print(f"train {ENCODER_ARCH} full width and depth ({cfg.num_layers} "
              f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}, gelu, layernorm, "
              f"non-causal, vocab {cfg.vocab_size} padded to "
              f"{cfg.vocab_padded}; {_n_params(TT, cfg):,} fp32 parameters) "
              f"({card}), batch 8 x {ENCODER_S} frames, sampled exchange k "
              f"= 256 at one pod: losses {[round(x, 4) for x in losses]}; "
              f"step wall s {[round(x, 4) for x in secs]}, p50 "
              f"{float(np.median(secs)):.4f} (steps 2-{ENCODER_STEPS} "
              f"{float(np.median(secs[1:])):.4f}); run {run_s:.1f} s with "
              f"2 checkpoints; peak memory {peak:.2f} GiB; launches: the "
              f"importance build {rec['before']}, each step {want} ({nleaf} "
              f"sampled leaves + the fold), the run {enc_run}", flush=True)
        del state
        torch.cuda.empty_cache()
        state = _resumed_run(torch, K, train, argv, ck, rec, 2,
                             ENCODER_STEPS, f"train {ENCODER_ARCH}")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    dist.destroy_process_group()           # train.main's one-rank group
    params = state["params"]
    del state
    torch.cuda.empty_cache()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=ENCODER_S,
                      global_batch=8, n_docs=20_000)
    batch = train.make_batch(cfg, Loader(SyntheticCorpus(dcfg), dcfg).batch(
        ENCODER_STEPS), dcfg, dev)
    grads = _leaf_grads(torch, Mod, TT, cfg, params, batch)
    wi = grads["layers"]["mlp"]["wi"].reshape(-1)
    del grads, params, batch
    torch.cuda.empty_cache()
    enc_x = big_leaf_kernels(torch, dev, wi, 0x5EED0020, "encoder exchange "
                             "at layers.mlp.wi")
    del wi
    torch.cuda.empty_cache()

    # 10b: the inference forward ("prefill": no cache), seed-0 weights
    params, _ = Mod.init_model(cfg, seed=0, device=dev)
    step, _, csp = St.make_prefill_step(
        cfg, Mesh((1, 1), ("data", "model"), device=dev),
        SHAPES["prefill_32k"])
    _check(csp == {}, f"{ENCODER_ARCH}: prefill cache specs {csp}")
    g = torch.Generator(device=dev).manual_seed(30)

    def frames(b, s):
        """The batch input_specs gives the encoder's prefill: frames and
        labels (which the forward does not read)."""
        return {"frames": torch.randn((b, s, cfg.d_model), generator=g,
                                      device=dev).to(torch.bfloat16),
                "labels": torch.zeros((b, s), dtype=torch.int32,
                                      device=dev)}
    box = {}
    x8 = frames(8, ENCODER_S)

    def fwd8():
        box["out"] = step(params, x8)
    fwd8()
    idle, wall, dev_ms, top = profiled(torch, fwd8)
    logits, cache = box.pop("out")
    _check(cache == {} and tuple(logits.shape) == (8, cfg.vocab_padded)
           and bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
           f"{ENCODER_ARCH} forward at 8 x {ENCODER_S}")
    print(f"{ENCODER_ARCH} inference forward (make_prefill_step, no cache) "
          f"at batch 8 x {ENCODER_S} ({card}): wall {wall:.3f} ms, device "
          f"{dev_ms:.3f} ms, idle share {idle:.3f}; top {top}", flush=True)
    # one layer at prefill_32k's length first: it sets the length to run
    one = dataclasses.replace(cfg, num_layers=1)
    p1 = {**params, "layers": TT.tree_map(lambda t: t[:1], params["layers"])}
    x1 = frames(1, ENCODER_LONG_S)

    def fwd1():
        box["out"] = Mod.prefill(p1, one, x1)
    fwd1()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd1()
    torch.cuda.synchronize()
    layer_s = time.perf_counter() - t0
    idle1, wall1, dev1, top1 = profiled(torch, fwd1)
    S = ENCODER_LONG_S
    while (S > cfg.attn_chunk and cfg.num_layers * layer_s
           * (S / ENCODER_LONG_S) ** 2 > ENCODER_LONG_BUDGET_S):
        S -= cfg.attn_chunk
    del x1
    xl = frames(1, S)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    logits, cache = step(params, xl)
    end.record()
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    _check(cache == {} and bool(torch.isfinite(
        logits[:, :cfg.vocab_size]).all()), f"{ENCODER_ARCH} forward at {S}")
    print(f"{ENCODER_ARCH} inference forward at batch 1 x {S} frames "
          f"(prefill_32k's {ENCODER_LONG_S} at batch 32, the batch cut to 1"
          f"{'' if S == ENCODER_LONG_S else ' and the length to fit ' f'{ENCODER_LONG_BUDGET_S:g} s'}): wall {long_s:.3f} s, "
          f"CUDA-event span {start.elapsed_time(end):.3f} ms; one layer at "
          f"{ENCODER_LONG_S}: wall {layer_s * 1e3:.3f} ms unprofiled, "
          f"profiled wall {wall1:.3f} ms, device {dev1:.3f} ms, idle share "
          f"{idle1:.3f}; top {top1}", flush=True)
    del xl, logits, p1, box
    two = dataclasses.replace(cfg, num_layers=2)
    p2 = {**params, "layers": TT.tree_map(lambda t: t[:2], params["layers"])}
    old = Mod.ACT_DTYPE
    Mod.ACT_DTYPE = torch.float32
    plain = plain_attention()
    try:
        x2 = frames(2, ENCODER_S)
        with torch.no_grad():
            full = Mod.forward_logits(p2, two, x2)
        last, _ = Mod.prefill(p2, two, x2)
    finally:
        Mod.ACT_DTYPE = old
        plain.close()
    V = cfg.vocab_size
    perr = float((last[:, :V] - full[:, -1, :V]).abs().max())
    scale = float(full[..., :V].abs().max())
    _check(np.isfinite(scale) and perr <= 5e-3 * max(scale, 1.0),
           f"{ENCODER_ARCH} fp32 forward: last position {perr}, scale "
           f"{scale}")
    print(f"{ENCODER_ARCH} fp32 at 2 layers of the full width (batch 2 x "
          f"{ENCODER_S}): prefill's last-position logits vs forward_logits "
          f"{perr:.3g}, scale {scale:.3g} (bar "
          f"{5e-3 * max(scale, 1.0):.3g})", flush=True)
    del params, p2, full, last, x2
    torch.cuda.empty_cache()

    # 10c: internvl2-76b served at full width, depth cut to VLM_LAYERS
    vcfg = get_config(VLM_ARCH)
    cut = dataclasses.replace(vcfg, num_layers=VLM_LAYERS)
    traffic = dict(zip(VLM_TRAFFIC[::2], VLM_TRAFFIC[1::2]))
    vb, pl, gl = (int(traffic[k]) for k in ("--batch", "--prompt-len",
                                             "--gen"))
    P = vcfg.frontend_tokens
    with cut_depth(serve, VLM_ARCH, VLM_LAYERS):
        out, deltas, vlm_run, vpeak, vwall = _serve_run(
            torch, K, dev, VLM_ARCH, VLM_TRAFFIC)
    _check(vlm_run == SERVE_RUN_LAUNCHES, f"{VLM_ARCH} serve launches "
           f"{vlm_run}, want {SERVE_RUN_LAUNCHES}")
    dms = out["decode_ms"]
    print(f"serve {VLM_ARCH} full width ({VLM_LAYERS} of {vcfg.num_layers} "
          f"layers: {_n_params(TT, cut):,} fp32 parameters, d_model "
          f"{vcfg.d_model}, {vcfg.num_heads}/{vcfg.num_kv_heads} heads of "
          f"{vcfg.head_dim}, d_ff {vcfg.d_ff}, vocab {vcfg.vocab_size}) "
          f"({card}), batch {vb} x [{P} patches | {pl} tokens], gen {gl} "
          f"from index {P + pl}: "
          f"prefill {out['prefill_ms']:.3f} ms, decode "
          f"{float(np.median(dms)):.3f} ms/token p50 (mean "
          f"{float(np.mean(dms)):.3f}, max {max(dms):.3f}), peak memory "
          f"{vpeak:.2f} GiB, run {vwall:.1f} s; launches: absorb "
          f"{deltas['absorbed']}, query {deltas['queried']}, request-shape "
          f"search {deltas['clustered']}, the run {vlm_run}", flush=True)
    del out
    torch.cuda.empty_cache()
    params, _ = Mod.init_model(cut, seed=0, device=dev)
    T = P + pl + gl
    ms, cache, tok = _decode_steps(torch, Mod, cut, params, dev, vb, T, 16,
                                   31)
    wall, ops, n = profile_ops(torch, lambda: Mod.serve_step(
        params, cut, tok, cache, T - 1))
    dev_ms = sum(t for _, t in ops)
    copy_ms = sum(t for name, t in ops if "copy" in name.lower())
    n_layers = sum(t.numel() for p, t in TT.flatten(params)
                   if p.startswith("layers."))
    cast_b, _ = bound(6 * n_layers, 0)
    print(f"serve {VLM_ARCH} decode ({VLM_LAYERS} layers, batch {vb}, cache "
          f"{T}): {ms:.3f} ms/step over 16 steps; one step profiled: wall "
          f"{wall:.3f} ms, device {dev_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - dev_ms / wall):.3f}, {n} device ops; copy kernels "
          f"(the per-call fp32 -> bf16 weight casts and the cache writes) "
          f"{copy_ms:.3f} ms, {copy_ms / dev_ms:.3f} of the device time "
          f"(the casts' {6 * n_layers / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:g}"
          f" TB/s: {cast_b:.3f} ms); top "
          f"{', '.join(f'{k[:40]} {t:.3f}' for k, t in ops[:4])}",
          flush=True)
    del params, cache, tok
    torch.cuda.empty_cache()
    two = dataclasses.replace(vcfg, num_layers=2)
    err, perr, scale, picks = _vlm_consistency(torch, Mod, two, dev)
    print(f"serve {VLM_ARCH} fp32 decode consistency at 2 layers of the full "
          f"width ({_n_params(TT, two):,} parameters; batch 2 x "
          f"[{P} patches | {CONSISTENCY_S} tokens], serve_step from index "
          f"{P}): max "
          f"|serve_step - forward_logits| {err:.3g}, prefill {perr:.3g}, "
          f"logit scale {scale:.3g} (bar {5e-3 * max(scale, 1.0):.3g}); "
          f"{picks} greedy picks equal to the full forward's", flush=True)
    torch.cuda.empty_cache()

    # 10d: internvl2-smoke trains 3 steps on the card with the exchange
    scfg = get_smoke_config(VLM_ARCH)
    swant, _ = exchange_step_launches(scfg)
    sargv = ["--arch", VLM_ARCH, "--smoke", "--steps", "3", "--batch", "8",
             "--seq", "128", "--mesh", "1x1x1", "--compress",
             "--importance-sampling", "--log-every", "1"]
    with recorded_launches(torch) as calls:
        state, rec, srun = _train_run(torch, K, train, sargv)
    dist.destroy_process_group()
    losses = [rec["loss"][s] for s in (1, 2, 3)]
    _check(all(np.isfinite(losses)), f"{scfg.name} losses {losses}")
    _check(set(rec["steps"]) == {swant}, f"{scfg.name} launches per step "
           f"{rec['steps']}, want {swant}")
    recorded = tuple(sum(1 for name, _, _ in calls if name == k)
                     for k in K.COUNTED)
    _check(recorded == srun, f"{scfg.name}: recorded launches {recorded}, "
           f"counted {srun}")
    errs = check_path_launches(torch, calls, f"{scfg.name} train")
    print(f"train {scfg.name} on the card, batch 8 x [{scfg.frontend_tokens} "
          f"patches | {128 - scfg.frontend_tokens} tokens], sampled exchange "
          f"at one pod: losses "
          f"{[round(x, 4) for x in losses]}; launches each step {swant} "
          f"(the fold: every smoke leaf is under the exchange's 65,536), "
          f"the run {srun}, each held against its plain version (max abs "
          f"err: {', '.join(f'{k} {v:.3g}' for k, v in errs.items())})",
          flush=True)
    del state
    torch.cuda.empty_cache()
    return (dict(zip(K.COUNTED, enc_run)), dict(zip(K.COUNTED, vlm_run)),
            {name: {f"encoder_exchange_{key}": v for key, v in row.items()}
             for name, row in enc_x.items()})


# ---------------------------------------------------------------------------
# phase 11: FSDP and tensor-parallel placement, gloo processes on one card
# ---------------------------------------------------------------------------

PLACE_FSDP_ARCH = "qwen2-moe-a2.7b"  # 11a: its config sets fsdp
PLACE_TP_ARCH = "qwen2-1.5b"         # 11b
PLACE_CARD_ARCHS = ("gemma-2b", "phi3-mini-3.8b")   # 11c, full depth
PLACE_K7_ARCH = "qwen2-1.5b"         # 11f: bf16, K7 on heads split in two
PLACE_K7_STEPS = 2
# depth cut from 24 (11a) and 28 (11b): 11a's FSDP gathers every layer
# through the host in each step (~0.3 GB/s of gloo on the card's host),
# so its depth is what its time scales with (at 1 layer a routing flip in
# step 2 moves the loss past 1e-5)
PLACE_LAYERS = {"qwen2-moe-a2.7b": 2, "qwen2-1.5b": 2,
                # 11d: zamba2 keeps one group of attn_every = 6 layers, so
                # its one shared attention block runs once
                "falcon-mamba-7b": 2, "zamba2-2.7b": 6}
PLACE_STEPS = 3
PLACE_FSDP_STEPS = 2                 # 11a: ~40-50 s a step through gloo
PLACE_SERVE = (4, 128, 4)            # batch, prompt, decode steps
# 11a's: an FSDP decode step gathers every weight through the host
# (~16 s a step at 2 layers), so 2 steps, to fit 11d and 12 in the time
PLACE_FSDP_SERVE = (4, 128, 2)
PLACE_SSM_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")   # 11d
PLACE_SSM_SERVE = (4, 512, 8)
PLACE_SSM_STEPS = 2
# 11d's largest Mamba block: zamba2's wx / wz / out_proj over model 2
# ([6, 2560, 5120] / 2 on d_inner)
PLACE_SSM_BLOCK = (6, 2_560, 2_560)
PLACE_SAMPLES = 4096                 # param elements held per leaf (11a)
# a sampled param is held after a step where its gradient agreed with the
# one-process run's within GRAD_AGREE (relative) in that step and every
# earlier one: the ranks' fp32 sums run in another order, so a gradient
# that is rounding noise (its element's true gradient ~0) differs between
# the runs, and Adam's normalised step moves such an element by ~lr either
# way; the params' differences then feed the next step's gradients. In the
# steps before the first routing flip every leaf must have HELD_MIN of its
# samples held
GRAD_AGREE = 1e-3
HELD_MIN = 0.9
PLACE_TIMEOUT_S = 600
PLACE_MIN_SIZE = 65_536              # 11b's exchange: sampled blocks
# 11b's microbatched step: 6 rows in 2 parts of 3, over its 2 (pod, data)
# ranks (shares of 2 and 1 rows: the reference's global-batch parts)
PLACE_MB_ROWS = 6
WORKER_DEVICE = "cuda"
AX3 = ("pod", "data", "model")
# 11b's largest per-shard block: the tied emb.tok split on vocab over
# model 2 (151,936 / 2 rows x 1,536)
PLACE_BLOCK = (75_968, 1_536)


def _place_cfg(arch: str):
    """``arch``'s configuration for phase 11, cut to PLACE_LAYERS; the JAX
    package's (``configs/twins.py``): the published Zamba2 block has no
    tensor-parallel form."""
    import dataclasses
    from repro_torch.configs.twins import get_config
    cfg = get_config(arch)
    if arch in PLACE_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=PLACE_LAYERS[arch])
    return cfg


def _place_batches(torch, cfg, dev, serve=PLACE_SERVE, steps=PLACE_STEPS):
    """The train batches (8 x 128 tokens, seeded) and the serving prompt
    (``serve``'s batch x prompt), on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(11)
    tok = lambda *s: torch.randint(0, cfg.vocab_size, s, generator=gen,
                                   device=dev, dtype=torch.int32)
    B, S, _ = serve
    return [{"tokens": tok(8, 128)} for _ in range(steps)], tok(B, S)


def _sample_idx(torch, n: int, dev):
    gen = torch.Generator(device=dev).manual_seed(n % (1 << 31))
    return torch.randint(0, n, (min(PLACE_SAMPLES, n),), generator=gen,
                         device=dev)


def _state_bytes(TT, state) -> int:
    return sum(x.numel() * x.element_size() for x in TT.leaves(
        {"p": state["params"], "m": state["opt"]["m"],
         "v": state["opt"]["v"]}))


def _block_samples(torch, tree, specs, shapes, mesh, dev) -> dict:
    """{leaf: (values, mask)} at each leaf's PLACE_SAMPLES sampled flat
    positions of the WHOLE leaf (``shapes``), read from this rank's block
    (``tree``, placed by ``specs``): ``mask`` marks the positions the
    block holds, ``values`` is 0 elsewhere. Every sample lies in some
    rank's block (a leaf no axis splits: in every rank's)."""
    from repro_torch import tree as TT
    from repro_torch.launch import sharding as Sh
    out = {}
    for (p, x), (_, spec), (_, whole) in zip(
            TT.flatten(tree), TT.flatten(specs), TT.flatten(shapes)):
        dims = tuple(whole.shape)
        flat = _sample_idx(torch, whole.numel(), dev)
        mask = torch.ones_like(flat, dtype=torch.bool)
        local = torch.zeros_like(flat)
        for d, size in enumerate(dims):
            stride = int(np.prod(dims[d + 1:], dtype=np.int64))
            coord = (flat // stride) % size
            if d < len(spec) and spec[d] is not None:
                n, i = Sh._split(mesh, spec[d])
                mask &= coord // (size // n) == i
                coord = coord - i * (size // n)
            local = local * x.shape[d] + torch.where(mask, coord, 0)
        vals = x.reshape(-1)[torch.where(mask, local, 0)]
        out[p] = (torch.where(mask, vals, 0.0).cpu(), mask.cpu())
    return out


def _merge_samples(ranks, key) -> dict:
    """The whole leaves' samples from the ranks' ``_block_samples``."""
    import torch
    torch_where = torch.where
    out = {}
    for r in ranks:
        for p, (v, m) in r[key].items():
            out[p] = torch_where(m, v, out[p]) if p in out else v.clone()
    return out


def _place_train(torch, cfg, mesh, dev, compress=None, steps=PLACE_STEPS):
    """``steps`` placed train steps from seed 0 (fp32 activations):
    {losses, grad_norm, step seconds, state bytes, the bytes of the leaves
    the rule leaves whole over data, peak GiB, block samples
    (``_block_samples``) of each step's gradient ("grads") and of the
    params after each step ("params"), and each step's routing ("routes":
    per MoE call, this rank's top-k choices [B, S, k] and each token's
    least gap between adjacent gates of its k + 1 largest)}."""
    from repro_torch import tree as TT
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import steps as St
    from repro_torch.models import model as Mod
    from repro_torch.models import moe as MoE
    from repro_torch.optim import adamw
    params, _ = Mod.init_model(cfg, seed=0, device=dev)
    shapes = Mod.abstract_params(cfg)[0]
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=1, total_steps=steps)
    grads_seen, routes = [], []

    def grad_hook(grads, params_, step):
        grads_seen.append(_block_samples(torch, grads, specs["params"],
                                         shapes, mesh, dev))
        return grads
    route = MoE.route

    def recording_route(p, x, cfg_):
        r = route(p, x, cfg_)
        top = torch.sort(r.gates.detach(), dim=-1, descending=True,
                         stable=True).values[..., :cfg_.moe_top_k + 1]
        routes[-1].append((r.topi.cpu(),
                           (top[..., :-1] - top[..., 1:]).amin(-1).cpu()))
        return r
    step_fn, specs = St.make_train_step(cfg, opt, mesh, compress=compress,
                                        grad_transform=grad_hook)
    state = Sh.place({"params": params, "opt": adamw.init_opt_state(params)},
                     specs, mesh)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batches, _ = _place_batches(torch, cfg, dev, steps=steps)
    out = {"losses": [], "grad_norm": [], "sec": [], "params": [],
           "bytes": _state_bytes(TT, state),
           # the leaves the rule leaves whole over data (params, m, v)
           "kept": 3 * sum(x.numel() * x.element_size() for x, s in zip(
               TT.leaves(state["params"]), TT.leaves(specs["params"]))
               if "data" not in s)}
    MoE.route = recording_route
    try:
        for b in batches:
            routes.append([])
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            torch.cuda.synchronize()
            out["sec"].append(round(time.perf_counter() - t0, 3))
            out["losses"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            out["params"].append(_block_samples(
                torch, state["params"], specs["params"], shapes, mesh, dev))
    finally:
        MoE.route = route
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["grads"] = grads_seen
    out["routes"] = routes
    del state
    torch.cuda.empty_cache()
    return out


def _microbatch_step(torch, cfg, mesh, dev):
    """One train step from seed 0 at microbatch 2 on the first
    PLACE_MB_ROWS rows of 11b's first batch, no exchange (fp32
    activations): {loss, grad_norm, sec}."""
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import steps as St
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    params, _ = Mod.init_model(cfg, seed=0, device=dev)
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=1, total_steps=1)
    step_fn, specs = St.make_train_step(cfg, opt, mesh, microbatch=2)
    state = Sh.place({"params": params, "opt": adamw.init_opt_state(params)},
                     specs, mesh)
    del params
    batch = {k: v[:PLACE_MB_ROWS] for k, v in
             _place_batches(torch, cfg, dev, steps=1)[0][0].items()}
    t0 = time.perf_counter()
    state, m = step_fn(state, batch)
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "sec": round(time.perf_counter() - t0, 3)}
    del state
    torch.cuda.empty_cache()
    return out


def _place_serve(torch, cfg, mesh, dev, params=None, serve=PLACE_SERVE):
    """make_prefill_step at ``serve``'s batch x prompt, grow_placed_cache
    and greedy make_serve_step steps (fp32 activations): {prefill logits,
    per-step logits and tokens (host), cache pspecs (prefill, decode), the
    rank's param bytes, ms, peak GiB}."""
    from repro_torch import tree as TT
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import steps as St
    from repro_torch.models import model as Mod
    B, S, G = serve
    if params is None:
        params, _ = Mod.init_model(cfg, seed=0, device=dev)
    pre, psp, csp = St.make_prefill_step(cfg, mesh,
                                         ShapeConfig("p", S, B, "prefill"))
    placed = Sh.place(params, psp, mesh)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, prompt = _place_batches(torch, cfg, dev, serve)
    t0 = time.perf_counter()
    logits, cache = pre(placed, {"tokens": prompt})
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    cache, csp2 = St.grow_placed_cache(cfg, cache, csp, G, mesh)
    serve, _, csp3 = St.make_serve_step(cfg, ShapeConfig("d", S + G, B,
                                                         "decode"), mesh)
    _check(csp2 == csp3, f"{cfg.name}: grown cache specs {csp2} != {csp3}")
    rec = {"prefill": logits.cpu(), "logits": [], "tokens": [],
           "specs": (csp, csp2), "prefill_ms": pre_ms, "step_ms": [],
           "bytes": sum(x.numel() * x.element_size()
                        for x in TT.leaves(placed))}
    tok = logits.argmax(-1).to(torch.int32)
    for t in range(G):
        rec["tokens"].append(tok.cpu())
        t0 = time.perf_counter()
        logits, cache = serve(placed, tok, cache, S + t)
        torch.cuda.synchronize()
        rec["step_ms"].append(round((time.perf_counter() - t0) * 1e3, 2))
        rec["logits"].append(logits.cpu())
        tok = logits.argmax(-1).to(torch.int32)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del placed, cache
    torch.cuda.empty_cache()
    return rec


def _rel(a, b) -> float:
    """max |a - b| over max |b|, padded vocab rows (-1e30 on both) left
    out."""
    live = b > -1e29
    gap = (a - b).abs().where(live, 0.0).max()
    return float(gap / max(float(b.abs().where(live, 0.0).max()), 1e-12))


def _hold_serve(torch, got, want, what: str):
    """Placed serving against its one-process twin: prefill and step
    logits within rtol 1e-5 of the twin's largest, greedy tokens equal."""
    err = _rel(got["prefill"], want["prefill"])
    for t, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        err = max(err, _rel(a, b))
        _check(torch.equal(got["tokens"][t], want["tokens"][t]),
               f"{what}: greedy tokens differ at step {t}")
    _check(err <= 1e-5, f"{what}: logits {err:.3g} from the one-process "
           f"run")
    return err


def _routing_flips(torch, ranks, twin) -> list:
    """Per step, per MoE call (the forward's layers, then the recompute's):
    (tokens whose ordered top-k differ between the ranks' rows and the
    one-process run's, the least gap between adjacent gates of a token's
    k + 1 largest in the one-process run)."""
    out = []
    for s, calls in enumerate(twin["routes"]):
        out.append([(int((torch.cat([r["routes"][s][i][0] for r in ranks])
                          != topi).any(-1).sum()), float(gap.min()))
                    for i, (topi, gap) in enumerate(calls)])
    return out


def _hold_train(torch, ranks, twin, what: str):
    """Placed steps (``ranks``' results, rank order = data order) against
    the one-process ``twin``: every step's loss and grad norm rtol 1e-5;
    the first step's gradient within 1e-5 of its leaf's largest at every
    sample; the MoE's routing compared call by call; after each step the
    sampled params rtol 1e-4 / atol 1e-6 wherever the gradient agreed
    within GRAD_AGREE in every step so far (the key bias aside: its
    gradient is rounding noise, as tests/test_torch_train.py notes), with
    HELD_MIN of each leaf held in the steps before the first routing flip
    (a flipped token moves its rows of the gradient). Returns the numbers
    printed."""
    got = ranks[0]
    steps = len(twin["losses"])
    flips = _routing_flips(torch, ranks, twin)
    first_flip = next((s for s, calls in enumerate(flips)
                       if any(n for n, _ in calls)), steps)
    grads = [_merge_samples([{"g": r["grads"][s]} for r in ranks], "g")
             for s in range(steps)]
    params = [_merge_samples([{"p": r["params"][s]} for r in ranks], "p")
              for s in range(steps)]
    ggap = [0.0] * steps
    pgap, least, fails = [0.0] * steps, [1.0] * steps, []
    agree = {}
    for s in range(steps):
        for p, (want, _) in twin["grads"][s].items():
            have = grads[s][p]
            top = max(float(want.abs().max()), 1e-30)
            ggap[s] = max(ggap[s], float((have - want).abs().max()) / top)
            agree[p] = agree.get(p, True) & (
                (have - want).abs() <= GRAD_AGREE * want.abs())
            if p == "layers.attn.bk":
                continue
            w = twin["params"][s][p][0]
            off = (params[s][p] - w).abs() / (1e-4 * w.abs() + 1e-6)
            ok = agree[p]
            share = float(ok.float().mean())
            least[s] = min(least[s], share)
            if bool(ok.any()):
                pgap[s] = max(pgap[s], float(off[ok].max()))
            if s < first_flip and share < HELD_MIN:
                fails.append(f"{p} after step {s + 1}: {share:.3f} held")
    print(f"{what}: losses {got['losses']} vs one process "
          f"{twin['losses']}, grad norms {got['grad_norm']} vs "
          f"{twin['grad_norm']}; routing flips per step and MoE call "
          f"{[[n for n, _ in c] for c in flips]} (least top-k gate gap "
          f"{[min((g for _, g in c), default=0.0) for c in flips]}); "
          f"gradient gap per step {[float(f'{g:.3g}') for g in ggap]} of "
          f"each leaf's largest; params held after each step at "
          f"{[round(x, 4) for x in least]} of a leaf's samples at least "
          f"(the key bias aside), largest gap "
          f"{[float(f'{g:.3g}') for g in pgap]} of rtol 1e-4 + atol 1e-6",
          flush=True)
    for key in ("losses", "grad_norm"):
        np.testing.assert_allclose(got[key], twin[key], rtol=1e-5,
                                   err_msg=f"{what}: {key}")
    _check(ggap[0] <= 1e-5, f"{what}: first-step gradient {ggap[0]:.3g} "
           f"of the leaf's largest from the one-process run")
    _check(max(pgap) <= 1.0, f"{what}: held params off the one-process "
           f"run ({max(pgap):.3g} of the bar)")
    _check(not fails, f"{what}: too few params held before the first "
           f"routing flip: {fails}")
    return flips, first_flip, ggap, least, pgap


def _spawn_place(sub: str, world: int) -> list:
    """Run ``sub`` in ``world`` gloo processes on the card; their
    results (rank order)."""
    import pickle
    import socket
    import torch
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix=f"chip_smoke_11{sub}_")
    procs = [subprocess.Popen(
        [*PLACE_WORKER_CMD, "--place-worker",
         sub, str(r), str(world), port, out], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PLACE_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        _check(p.returncode == 0,
               f"placement worker 11{sub}/{r} failed:\n{log[-4000:]}")
    return [pickle.load(open(Path(out) / f"rank{r}.pkl", "rb"))
            for r in range(world)]


def _place_worker(sub: str, rank: int, world: int, port: str,
                  out: str) -> int:
    """One rank of 11a / 11b / 11c (started by ``phase_placement``)."""
    import pickle
    import torch
    import torch.distributed as dist
    import os
    sys.path.insert(0, str(ROOT / "src"))
    # the ranks share the host's cores (gloo stages through them)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    import repro_torch.kernels as K
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as Mod
    dev = torch.device(WORKER_DEVICE)
    if sub == "f":         # 11f runs bf16, through K7
        plain = contextlib.ExitStack()
    else:
        Mod.ACT_DTYPE = torch.float32
        plain = plain_attention()
    res = {"rank": rank}
    if sub == "f":
        res.update(_place_k7_worker(torch, dev))
    elif sub == "a":
        cfg = _place_cfg(PLACE_FSDP_ARCH)
        mesh = Mesh((1, 2, 1), AX3, device=dev)
        res["train"] = _place_train(torch, cfg, mesh, dev,
                                    steps=PLACE_FSDP_STEPS)
        res["serve"] = _place_serve(torch, cfg, mesh, dev,
                                    serve=PLACE_FSDP_SERVE)
    elif sub == "b":
        res.update(_place_exchange_worker(torch, K, dev))
    elif sub == "c":
        mesh = Mesh((1, 1, 2), AX3, device=dev)
        for arch in PLACE_CARD_ARCHS:
            from repro_torch.configs.registry import get_config
            res[arch] = _place_serve(torch, get_config(arch), mesh, dev)
    elif sub == "d":       # 11d: the Mamba blocks over inner, serving
        mesh = Mesh((1, 1, 2), AX3, device=dev)
        for arch in PLACE_SSM_ARCHS:
            res[arch] = _place_serve(torch, _place_cfg(arch), mesh, dev,
                                     serve=PLACE_SSM_SERVE)
            torch.cuda.empty_cache()
    else:                  # 11d: zamba2 trained with the exchange
        res.update(_place_exchange_worker(
            torch, K, dev, arch=PLACE_SSM_ARCHS[1], steps=PLACE_SSM_STEPS,
            formula=False))
    plain.close()
    if rank != 0:          # rank 0 carries the gathered logits
        for key in ("serve", *PLACE_CARD_ARCHS, *PLACE_SSM_ARCHS):
            if key in res:
                res[key] = {k: v for k, v in res[key].items()
                            if k not in ("logits", "prefill")}
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _place_k7_worker(torch, dev):
    """11f's rank: PLACE_K7_STEPS bf16 train steps of PLACE_K7_ARCH at
    (1, 1, 2), its q heads split over model, every K7 call held against
    the plain loop on the same shards at the call (``attn_gate``) ->
    {losses, K7 launches, forward and backward calls held, the (q, kv)
    heads of the shards, the largest gaps per tensor, the limits broken}."""
    from repro_torch.kernels import attention as KA
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    cfg = _place_cfg(PLACE_K7_ARCH)
    mesh = Mesh((1, 1, 2), AX3, device=dev)
    fwd, bwd = KA.attention_forward, KA.attention_backward
    seen = {"fwd": 0, "bwd": 0, "heads": set(), "gaps": {}, "broken": []}

    def hold(names, got, want, q, k):
        seen["heads"].add((q.shape[2], k.shape[2]))
        gaps = {n: attn_gaps(torch, a, b) for n, a, b in zip(names, got,
                                                             want)}
        for n, g in gaps.items():
            worst = seen["gaps"].setdefault(n, dict.fromkeys(g, 0.0))
            for key, x in g.items():
                worst[key] = max(worst[key], x)
        seen["broken"] += attn_gate(gaps)

    def fwd_held(q, k, v, causal, Cq, Ck, q_offset, kv_valid_len,
                 scale=None):
        plan = (causal, Cq, Ck, q_offset, kv_valid_len, scale)
        out, lse = fwd(q, k, v, *plan)
        want, _ = KA.attention_forward_plain(q, k, v, *plan)
        hold(("out",), (out,), (want,), q, k)
        seen["fwd"] += 1
        return out, lse

    def bwd_held(q, k, v, out, lse, do, causal, Cq, Ck, q_offset,
                 kv_valid_len, scale=None):
        plan = (causal, Cq, Ck, q_offset, kv_valid_len, scale)
        got = bwd(q, k, v, out, lse, do, *plan)
        po, pl = KA.attention_forward_plain(q, k, v, *plan)
        want = KA.attention_backward_plain(q, k, v, po, pl, do, *plan)
        hold(("dq", "dk", "dv"), got, want, q, k)
        seen["bwd"] += 1
        return got
    params, _ = Mod.init_model(cfg, seed=0, device=dev)
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=1,
                          total_steps=PLACE_K7_STEPS)
    step_fn, specs = St.make_train_step(cfg, opt, mesh)
    state = Sh.place({"params": params, "opt": adamw.init_opt_state(params)},
                     specs, mesh)
    del params
    batches, _ = _place_batches(torch, cfg, dev, steps=PLACE_K7_STEPS)
    KA.attention_forward, KA.attention_backward = fwd_held, bwd_held
    KA.launch.launches = 0
    losses = []
    try:
        for b in batches:
            state, m = step_fn(state, b)
            losses.append(float(m["loss"]))
    finally:
        KA.attention_forward, KA.attention_backward = fwd, bwd
    return {"losses": losses, "launches": KA.launch.launches,
            "fwd": seen["fwd"], "bwd": seen["bwd"],
            "heads": sorted(seen["heads"]), "gaps": seen["gaps"],
            "broken": seen["broken"][:8]}


def phase_placement_k7(torch, card: str) -> int:
    """11f: PLACE_K7_ARCH in bf16 at (1, 1, 2) in 2 gloo processes, K7 on
    each rank's share of the heads, every call held against the plain
    loop on the same shards. Returns K7's launches over the ranks."""
    cfg = _place_cfg(PLACE_K7_ARCH)
    t0 = time.perf_counter()
    ranks = _spawn_place("f", 2)
    wall = time.perf_counter() - t0
    want_heads = cfg.num_heads // 2
    for r in ranks:
        _check(r["losses"] == ranks[0]["losses"]
               and all(np.isfinite(r["losses"])),
               f"11f: losses {[x['losses'] for x in ranks]}")
        _check(not r["broken"], f"11f: rank {r['rank']}: K7 beyond the "
               f"gate: {r['broken']}")
        _check(r["bwd"] == cfg.num_layers * PLACE_K7_STEPS
               and r["launches"] == r["fwd"] + r["bwd"],
               f"11f: rank {r['rank']}: {r['launches']} launches, "
               f"{r['fwd']} forward and {r['bwd']} backward calls held")
        _check(all(h == want_heads for h, _ in r["heads"]),
               f"11f: rank {r['rank']} ran heads {r['heads']}")
    launches = sum(r["launches"] for r in ranks)
    print(f"11f K7 on split heads: {PLACE_K7_ARCH} at {cfg.num_layers} "
          f"layers in bf16, mesh (1, 1, 2), 2 gloo processes on {card}: "
          f"(q, kv) heads a rank {ranks[0]['heads']} of ({cfg.num_heads}, "
          f"{cfg.num_kv_heads}); losses {ranks[0]['losses']}; K7 launches "
          f"{[r['launches'] for r in ranks]} ({ranks[0]['fwd']} forward, "
          f"{ranks[0]['bwd']} backward a rank), each held against the "
          f"plain loop on its shards: worst "
          f"{attn_text(ranks[0]['gaps'])} (rank 0), "
          f"{attn_text(ranks[1]['gaps'])} (rank 1); phase wall "
          f"{wall:.1f} s", flush=True)
    return launches


def _place_exchange_worker(torch, K, dev, arch=PLACE_TP_ARCH,
                           steps=PLACE_STEPS, formula=True):
    """11b's (11d's) rank: ``steps`` compressed steps of ``arch`` at (pod
    2, data 1, model 2), every K1 (seeds only) and K2 launch checked
    against its plain version at the call; then (``formula``) one leaf's
    exchange against the formula."""
    from repro_torch import tree as TT
    from repro_torch.distopt import compression as CP
    from repro_torch.kernels import blockselect as kbs
    from repro_torch.kernels import seeds as ks
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    cfg = _place_cfg(arch)
    mesh = Mesh((2, 1, 2), AX3, device=dev)
    errs = {"seeds": 0.0, "blockselect": 0.0}
    checked = {"seeds": 0, "blockselect": 0}
    blocks = []
    k1, k2 = ks.fused_seeds, kbs.batched_bottomk_select

    def seeds_checked(*a, **kw):
        got = k1(*a, **kw)
        want = ks.fused_seeds_fvals_plain(*a, **kw, want_fvals=False)[0]
        _check(ulps(got, want) <= 2, "11b: K1 launch beyond 2 ulp of plain")
        errs["seeds"] = max(errs["seeds"], max_abs(got, want))
        checked["seeds"] += 1
        blocks.append(a[0].shape[0])
        return got

    def select_checked(*a, **kw):
        got = k2(*a, **kw)
        want = kbs.batched_bottomk_select_plain(*a, **kw)
        _check(all(torch.equal(x, y) for x, y in zip(got, want)),
               "11b: K2 launch differs from plain")
        errs["blockselect"] = max(errs["blockselect"],
                                  max_abs(got[0], want[0]))
        checked["blockselect"] += 1
        del want
        torch.cuda.empty_cache()
        return got
    params, _ = Mod.init_model(cfg, seed=0, device=dev)
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=1, total_steps=steps)
    step_fn, specs = St.make_train_step(cfg, opt, mesh, compress=dict(
        k=256, min_size=PLACE_MIN_SIZE))
    state = Sh.place({"params": params, "opt": adamw.init_opt_state(params)},
                     specs, mesh)
    del params
    batches, _ = _place_batches(torch, cfg, dev, steps=steps)
    ks.fused_seeds, kbs.batched_bottomk_select = (seeds_checked,
                                                  select_checked)
    K.reset_launch_counts()
    losses, secs = [], []
    try:
        for b in batches:
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            torch.cuda.synchronize()
            secs.append(round(time.perf_counter() - t0, 3))
            losses.append(float(m["loss"]))
    finally:
        ks.fused_seeds, kbs.batched_bottomk_select = k1, k2
    counts = K.launch_counts()
    out = {"losses": losses, "sec": secs, "counts": counts,
           "checked": checked, "errs": errs, "blocks": sorted(set(blocks)),
           "bytes": _state_bytes(TT, state), "coords": mesh.coords}
    if not formula:
        return out
    out["microbatch"] = _microbatch_step(torch, cfg, mesh, dev)
    # one block's exchange against the formula over the gathered slabs
    Mod.ACT_DTYPE = torch.float32
    sh = St.P.Shards(mesh, specs["params"])
    model = Mod.Model(cfg, state["params"], sh)
    loss, _ = model({k: v[Sh.batch_slice(mesh, 8)]
                     for k, v in batches[0].items()})
    named = list(model.named_parameters())
    grads = TT.unflatten((n, g.contiguous()) for (n, _), g in zip(
        named, torch.autograd.grad(loss, [p for _, p in named])))
    leaf = "layers.mlp.wi"
    own = dict(TT.flatten(grads))[leaf].reshape(-1).cpu().numpy()
    out_tree, wires = CP.exchange_grads(mesh, grads, 3, k=256,
                                        min_size=PLACE_MIN_SIZE,
                                        return_wires=True)
    got = dict(TT.flatten(out_tree))[leaf].reshape(-1).cpu().numpy()
    w = wires[leaf].cpu().numpy()
    est = []
    for p in range(2):
        e = np.zeros(own.shape, np.float32)
        np.add.at(e, np.maximum(w[p, 0], 0), np.where(
            w[p, 3] != 0, w[p, 1].view(np.float32) / np.maximum(
                w[p, 2].view(np.float32), np.float32(1e-30)),
            np.float32(0)).astype(np.float32))
        est.append(e)
    pod = mesh.coords["pod"]
    want = (((np.zeros_like(own) + est[0]) + est[1]) - est[pod] + own) \
        / np.float32(2)
    ex = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                      np.float32(1e-30))))
    return {**out, "exchange_leaf": (leaf, own.shape[0]),
            "exchange_max_rel": ex}


def phase_placement(torch, K, dev, card: str):
    """11a FSDP at (1, 2, 1) in 2 processes, 11b tensor parallelism and
    the per-shard exchange at (2, 1, 2) in 4, 11c the card gap (gemma-2b,
    phi3-mini-3.8b at full depth) at (1, 1, 2) in 2; each held against a
    one-process run with the same seed on the card. Returns (K1/K2 stats
    at the largest block, the path's launches summed over 11b's ranks)."""
    from repro_torch import tree as TT
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as Mod
    old = Mod.ACT_DTYPE
    Mod.ACT_DTYPE = torch.float32
    plain = plain_attention()
    one = Mesh((1, 1, 1), AX3, device=dev)
    try:
        # --- 11a: FSDP at full width, 2 layers --------------------------
        t0 = time.perf_counter()
        ranks = _spawn_place("a", 2)
        wall = time.perf_counter() - t0
        cfg = _place_cfg(PLACE_FSDP_ARCH)
        twin_train = _place_train(torch, cfg, one, dev,
                                  steps=PLACE_FSDP_STEPS)
        twin_serve = _place_serve(torch, cfg, one, dev,
                                  serve=PLACE_FSDP_SERVE)
        flips, first_flip, ggap, least, pgap = _hold_train(
            torch, [r["train"] for r in ranks], twin_train, "11a")
        for r in ranks:
            _check(r["train"]["losses"] == ranks[0]["train"]["losses"],
                   "11a: ranks' losses differ")
            kept = r["train"]["kept"]
            _check(r["train"]["bytes"] <= (twin_train["bytes"] - kept) / 2
                   + kept, f"11a: rank {r['rank']} holds "
                   f"{r['train']['bytes']} of {twin_train['bytes']} bytes "
                   f"({kept} whole)")
        serr = _hold_serve(torch, ranks[0]["serve"], twin_serve, "11a")
        print(f"11a FSDP {PLACE_FSDP_ARCH} at {cfg.num_layers} layer(s) "
              f"({_n_params(TT, cfg):,} params), mesh (1, 2, 1), 2 gloo "
              f"processes on {card}: losses {ranks[0]['train']['losses']} "
              f"vs one process {twin_train['losses']} (rtol 1e-5), grad "
              f"norms as well, the first step's gradient within "
              f"{ggap[0]:.3g} of each leaf's largest, routing flips "
              f"{[sum(n for n, _ in c) for c in flips]} a step, params "
              f"held within {max(pgap):.3g} of their bar where the "
              f"gradient agreed ({min(least[:first_flip] or [1.0]):.3f} "
              f"of a leaf at least before the first flip); state bytes "
              f"per rank {[r['train']['bytes'] for r in ranks]} vs "
              f"{twin_train['bytes']}, train peak GiB "
              f"{[round(r['train']['peak_gib'], 2) for r in ranks]} vs "
              f"{twin_train['peak_gib']:.2f}, step s "
              f"{ranks[0]['train']['sec']} vs {twin_train['sec']}; "
              f"prefill {PLACE_FSDP_SERVE[0]} x {PLACE_FSDP_SERVE[1]} + "
              f"{PLACE_FSDP_SERVE[2]} decode steps: logits within "
              f"{serr:.3g}, "
              f"greedy tokens equal, prefill ms "
              f"{ranks[0]['serve']['prefill_ms']:.1f} vs "
              f"{twin_serve['prefill_ms']:.1f}, decode ms/step p50 "
              f"{np.median(ranks[0]['serve']['step_ms']):.1f} vs "
              f"{np.median(twin_serve['step_ms']):.1f}, serve peak GiB "
              f"{[round(r['serve']['peak_gib'], 2) for r in ranks]} vs "
              f"{twin_serve['peak_gib']:.2f}; phase wall {wall:.1f} s",
              flush=True)
        del twin_train, twin_serve
        torch.cuda.empty_cache()

        # --- 11b: tensor parallelism and the per-shard exchange ---------
        t0 = time.perf_counter()
        ranks = _spawn_place("b", 4)
        wall = time.perf_counter() - t0
        cfg = _place_cfg(PLACE_TP_ARCH)
        twin = _place_train(torch, cfg, one, dev)
        _check(abs(ranks[0]["losses"][0] - twin["losses"][0])
               <= 1e-5 * abs(twin["losses"][0]),
               f"11b: first loss {ranks[0]['losses'][0]} vs one process "
               f"{twin['losses'][0]}")
        counts = {k: sum(r["counts"][k] for r in ranks)
                  for k in ranks[0]["counts"]}
        for r in ranks:
            _check(r["losses"] == ranks[0]["losses"], "11b: losses differ")
            _check(r["checked"]["seeds"] == r["counts"]["seeds"] > 0
                   and r["checked"]["blockselect"]
                   == r["counts"]["blockselect"] > 0,
                   f"11b: rank {r['rank']} launches {r['counts']} vs "
                   f"checked {r['checked']}")
            _check(r["exchange_max_rel"] <= 1e-5, f"11b: rank {r['rank']} "
                   f"exchange off the formula by {r['exchange_max_rel']}")
        biggest = max(max(r["blocks"]) for r in ranks)
        _check(biggest == PLACE_BLOCK[0] * PLACE_BLOCK[1],
               f"11b: largest block {biggest} rows")
        mb_twin = _microbatch_step(torch, cfg, one, dev)
        mb = ranks[0]["microbatch"]
        for r in ranks:
            _check(r["microbatch"]["loss"] == mb["loss"],
                   "11b: microbatched losses differ between ranks")
        for key in ("loss", "grad_norm"):
            _check(abs(mb[key] - mb_twin[key]) <= 1e-5 * abs(mb_twin[key]),
                   f"11b: microbatched {key} {mb[key]} vs one process "
                   f"{mb_twin[key]}")
        gen = torch.Generator(device=dev).manual_seed(21)
        g = torch.randn(biggest, generator=gen, device=dev)
        stats = big_leaf_kernels(torch, dev, g, 17, f"11b on {card}: "
                                 f"emb.tok block {PLACE_BLOCK}")
        del g
        torch.cuda.empty_cache()
        print(f"11b tensor parallel {PLACE_TP_ARCH} at {cfg.num_layers} "
              f"layers, mesh (2, 1, 2), 4 gloo processes on {card}: "
              f"compressed losses {ranks[0]['losses']} (first vs one "
              f"process {twin['losses'][0]}), step s {ranks[0]['sec']}; "
              f"K1/K2 launches {counts['seeds']}/{counts['blockselect']} "
              f"over the ranks, each held against its plain version (max "
              f"abs {max(r['errs']['seeds'] for r in ranks):.3g} / "
              f"{max(r['errs']['blockselect'] for r in ranks):.3g}) on "
              f"blocks of {ranks[0]['blocks']} rows; exchange of "
              f"{ranks[0]['exchange_leaf']} block = formula within "
              f"{max(r['exchange_max_rel'] for r in ranks):.3g}; a "
              f"microbatch-2 step on {PLACE_MB_ROWS} rows (parts of "
              f"{PLACE_MB_ROWS // 2} over 2 (pod, data) ranks: shares 2 and "
              f"1) loss {mb['loss']:.7g} / grad norm {mb['grad_norm']:.7g} "
              f"vs one process {mb_twin['loss']:.7g} / "
              f"{mb_twin['grad_norm']:.7g} (rtol 1e-5), step s {mb['sec']} "
              f"vs {mb_twin['sec']}; phase wall {wall:.1f} s", flush=True)
        del twin
        torch.cuda.empty_cache()

        # --- 11c: gemma-2b and phi3-mini-3.8b at full width and depth ---
        t0 = time.perf_counter()
        ranks = _spawn_place("c", 2)
        wall = time.perf_counter() - t0
        for arch in PLACE_CARD_ARCHS:
            twin = _place_serve(torch, get_config(arch), one, dev)
            err = _hold_serve(torch, ranks[0][arch], twin, f"11c {arch}")
            got = ranks[0][arch]
            print(f"11c {arch} full depth, mesh (1, 1, 2), 2 gloo "
                  f"processes on {card}: cache pspecs "
                  f"{[s['k'] for s in got['specs']]} (prefill, decode), "
                  f"logits within {err:.3g} of one "
                  f"process, greedy tokens equal; prefill ms "
                  f"{got['prefill_ms']:.1f} vs {twin['prefill_ms']:.1f}, "
                  f"decode ms/step p50 {np.median(got['step_ms']):.1f} vs "
                  f"{np.median(twin['step_ms']):.1f}, peak GiB "
                  f"{[round(r[arch]['peak_gib'], 2) for r in ranks]} vs "
                  f"{twin['peak_gib']:.2f}", flush=True)
            del twin
            torch.cuda.empty_cache()
        print(f"11c wall {wall:.1f} s", flush=True)

        # --- 11d: the state-space families over inner -------------------
        ssm_stats, ssm_counts = phase_placement_ssm(torch, dev, card, one)
    finally:
        Mod.ACT_DTYPE = old
        plain.close()
    return ({name: {**{f"placement_block_{k}": v for k, v in s.items()},
                    **{f"placement_ssm_block_{k}": v
                       for k, v in ssm_stats[name].items()}}
             for name, s in stats.items()}, counts, ssm_counts)


def _ssm_train_twin(torch, cfg, mesh, dev):
    """11d's training in one process: PLACE_SSM_STEPS compressed steps
    from seed 0 (the exchange at one pod returns its input): {losses,
    state bytes}."""
    from repro_torch import tree as TT
    from repro_torch.launch import steps as St
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    params, _ = Mod.init_model(cfg, seed=0, device=dev)
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=1,
                          total_steps=PLACE_SSM_STEPS)
    step_fn, _ = St.make_train_step(cfg, opt, mesh, compress=dict(
        k=256, min_size=PLACE_MIN_SIZE))
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    del params
    losses = []
    for b in _place_batches(torch, cfg, dev, steps=PLACE_SSM_STEPS)[0]:
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
    out = {"losses": losses, "bytes": _state_bytes(TT, state)}
    del state
    torch.cuda.empty_cache()
    return out


def phase_placement_ssm(torch, dev, card: str, one):
    """11d: falcon-mamba-7b (2 layers) and zamba2-2.7b (6 layers: one
    shared attention block) at full width, mesh (1, 1, 2) in 2 processes:
    prefill and greedy decode against the one-process run (logits rtol
    1e-5, greedy tokens equal), the Mamba states placed by cache_pspecs;
    then zamba2 trained with the exchange at (2, 1, 2) in 4 processes:
    the first loss within 1e-6 of the one-process run's, every K1 / K2
    launch held against its plain version at the call, on the ranks'
    Mamba blocks among others; K1 and K2 timed at the largest Mamba
    block. Returns (K1/K2 stats there, the training's launches summed
    over its ranks)."""
    from repro_torch import tree as TT
    t0 = time.perf_counter()
    ranks = _spawn_place("d", 2)
    wall = time.perf_counter() - t0
    for arch in PLACE_SSM_ARCHS:
        cfg = _place_cfg(arch)
        twin = _place_serve(torch, cfg, one, dev, serve=PLACE_SSM_SERVE)
        err = _hold_serve(torch, ranks[0][arch], twin, f"11d {arch}")
        got = ranks[0][arch]
        states = [s.get("mamba", s) for s in got["specs"]]
        for s in states:
            _check(all("model" in sp for sp in s.values()),
                   f"11d {arch}: Mamba states {s} not all on model")
        print(f"11d {arch} at {cfg.num_layers} layers, full width "
              f"({_n_params(TT, cfg):,} params), mesh (1, 1, 2), 2 gloo "
              f"processes on {card}: Mamba state pspecs {states[1]}"
              f"{' (k/v ' + str(got['specs'][1]['k']) + ')' if 'k' in got['specs'][1] else ''}, "
              f"logits within {err:.3g} of one process over prefill "
              f"{PLACE_SSM_SERVE[0]} x {PLACE_SSM_SERVE[1]} and "
              f"{PLACE_SSM_SERVE[2]} decode steps, greedy tokens equal; "
              f"param bytes per rank {[r[arch]['bytes'] for r in ranks]} "
              f"vs {twin['bytes']}; prefill ms {got['prefill_ms']:.1f} vs "
              f"{twin['prefill_ms']:.1f}, decode ms/step p50 "
              f"{np.median(got['step_ms']):.1f} vs "
              f"{np.median(twin['step_ms']):.1f}, peak GiB "
              f"{[round(r[arch]['peak_gib'], 2) for r in ranks]} vs "
              f"{twin['peak_gib']:.2f}", flush=True)
        del twin
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _spawn_place("e", 4)
    wall_e = time.perf_counter() - t0
    cfg = _place_cfg(PLACE_SSM_ARCHS[1])
    twin = _ssm_train_twin(torch, cfg, one, dev)
    gap = abs(ranks[0]["losses"][0] - twin["losses"][0]) / abs(
        twin["losses"][0])
    _check(gap <= 1e-6, f"11d: first loss {ranks[0]['losses'][0]} vs one "
           f"process {twin['losses'][0]} ({gap:.3g})")
    counts = {k: sum(r["counts"][k] for r in ranks)
              for k in ranks[0]["counts"]}
    block = int(np.prod(PLACE_SSM_BLOCK))
    for r in ranks:
        _check(r["losses"] == ranks[0]["losses"], "11d: losses differ")
        _check(all(np.isfinite(r["losses"])), "11d: losses not finite")
        _check(r["checked"]["seeds"] == r["counts"]["seeds"] > 0
               and r["checked"]["blockselect"]
               == r["counts"]["blockselect"] > 0,
               f"11d: rank {r['rank']} launches {r['counts']} vs checked "
               f"{r['checked']}")
        _check(block in r["blocks"], f"11d: rank {r['rank']} sampled no "
               f"Mamba block of {block} rows ({r['blocks']})")
    _check(max(max(r["blocks"]) for r in ranks) >= block,
           "11d: largest block")
    gen = torch.Generator(device=dev).manual_seed(22)
    g = torch.randn(block, generator=gen, device=dev)
    stats = big_leaf_kernels(torch, dev, g, 17, f"11d on {card}: Mamba "
                             f"block {PLACE_SSM_BLOCK}")
    del g
    torch.cuda.empty_cache()
    print(f"11d zamba2-2.7b at {cfg.num_layers} layers, mesh (2, 1, 2), 4 "
          f"gloo processes on {card}: compressed losses "
          f"{ranks[0]['losses']} vs one process {twin['losses']} (first "
          f"within {gap:.3g}; the second follows the exchange, which samples "
          f"each rank's block here and whole leaves in one process), step s "
          f"{ranks[0]['sec']}; state bytes per rank "
          f"{[r['bytes'] for r in ranks]} vs {twin['bytes']}; K1/K2 "
          f"launches {counts['seeds']}/{counts['blockselect']} over the "
          f"ranks, each held against its plain version (max abs "
          f"{max(r['errs']['seeds'] for r in ranks):.3g} / "
          f"{max(r['errs']['blockselect'] for r in ranks):.3g}) on blocks "
          f"of {ranks[0]['blocks']} rows; 11d walls {wall:.1f} s (serve) + "
          f"{wall_e:.1f} s (train)", flush=True)
    return stats, counts


# ---------------------------------------------------------------------------
# phase 12: the dry run against the card
# ---------------------------------------------------------------------------

DRY_CELL = ("zamba2-2.7b", "decode_32k")      # 12b, on (2, 16, 16)
DRY_REPS = 4                                   # 12a's steps on the card


def phase_dryrun(torch, dev, card: str):
    """12a: the meta twin of 7a's step (qwen2-1.5b, batch 8 x 128, the
    exchange at k = 256, the telemetry fold; one process) through
    ``dryrun.measure_step``: its argument bytes equal the same state and
    batch on the card exactly; its arguments plus temporaries beside
    ``torch.cuda.max_memory_allocated`` over DRY_REPS steps of the same
    step on the card; its matmul FLOPs over the step's p50 as achieved
    TFLOP/s. 12b: one production cell, DRY_CELL on (2, 16, 16), through
    the CLI in a process of its own (the Mamba-2 blocks at model 16,
    across pods)."""
    import os
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core import multisketch_empty
    from repro_torch.launch import steps as St
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import measure_step
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("7a", 128, 8, "train")
    comp = dict(k=256, min_size=65536)
    # the trip-counted walk (the dry run's), and every layer walked
    (mem, hlo, walk), (mem_f, hlo_f, walk_f) = (measure_step(
        cfg, shape, Mesh((1, 1, 1), AX3, device="meta"), compress=comp,
        telemetry=train.TEL_SPEC, trip_counts=tc) for tc in (True, False))
    _check(mem["argument_size_in_bytes"] == mem_f["argument_size_in_bytes"]
           and all(hlo[k] == hlo_f[k] for k in (
               "flops", "matmul_flops", "hbm_bytes", "transcendental",
               "coll_bytes", "coll_ops", "kernels")),
           f"12a: the trip-counted walk's counts differ from the full "
           f"walk's: {hlo} vs {hlo_f}")
    step_fn, _ = St.make_train_step(cfg, adamw.OptConfig(),
                                    Mesh((1, 1, 1), AX3, device=dev),
                                    compress=comp, telemetry=train.TEL_SPEC)
    params, _ = Mod.init_model(cfg, seed=0, device=dev)
    state = {"params": params, "opt": adamw.init_opt_state(params),
             "tel": multisketch_empty(train.TEL_SPEC, device=dev)}
    del params
    gen = torch.Generator(device=dev).manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 128),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    nbytes = sum(x.numel() * x.element_size()
                 for x in tree_leaves((state, batch))
                 if isinstance(x, torch.Tensor))
    _check(nbytes == mem["argument_size_in_bytes"],
           f"12a: the card holds {nbytes} bytes of state and batch, the "
           f"meta twin counts {mem['argument_size_in_bytes']}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(DRY_REPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        _check(np.isfinite(float(m["loss"])), "12a: loss not finite")
    peak = torch.cuda.max_memory_allocated()
    del state, m
    torch.cuda.empty_cache()
    p50 = float(np.median(secs[1:]))
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    full = mem_f["argument_size_in_bytes"] + mem_f["temp_size_in_bytes"]
    _check(0.97 <= predicted / peak <= 1.01,
           f"12a: predicted {predicted} bytes vs max_memory_allocated {peak}")
    print(f"12a dry-run twin of 7a's step ({TRAIN_ARCH}, batch 8 x 128, "
          f"exchange k = 256, telemetry fold; walked on meta with trip "
          f"counts in {walk:.1f} s: {hlo['dispatched_ops']:,} ops "
          f"dispatched, {hlo['n_ops']:,} booked; every layer walked in "
          f"{walk_f:.1f} s: {hlo_f['n_ops']:,} ops, the same counts): "
          f"argument bytes {nbytes:,} on the "
          f"card = {mem['argument_size_in_bytes']:,} counted; arguments + "
          f"temporaries {predicted / 2 ** 30:.2f} GiB predicted "
          f"({full / 2 ** 30:.2f} walking every layer) vs "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB over "
          f"{DRY_REPS} steps (ratio {predicted / peak:.4f}); matmul FLOPs "
          f"{hlo['matmul_flops']:.6g} (all FLOPs {hlo['flops']:.6g}, HBM "
          f"bytes {hlo['hbm_bytes']:.6g}) over the step's p50 "
          f"{p50:.4f} s (steps {[round(s, 4) for s in secs]}) = "
          f"{hlo['matmul_flops'] / p50 / 1e12:.3f} TFLOP/s achieved on "
          f"{card}", flush=True)
    out = tempfile.mkdtemp(prefix="chip_smoke_12_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRY_CELL[0], "--shape", DRY_CELL[1], "--multi-pod", "--twin",
         "--out", f"{out}/cell.json"], capture_output=True, text=True,
        env=env, timeout=300)
    wall = time.perf_counter() - t0
    _check(r.returncode == 0, f"12b: dry-run cell failed:\n"
           f"{r.stderr[-3000:]}")
    cell = json.loads(Path(f"{out}/cell.json").read_text())
    _check(cell["status"] == "ok" and cell["hlo_cost"]["matmul_flops"] > 0
           and cell["memory"]["argument_size_in_bytes"] > 0,
           f"12b: cell {cell}")
    mem_c, hlo_c = cell["memory"], cell["hlo_cost"]
    print(f"12b dry run {DRY_CELL[0]} x {DRY_CELL[1]} x {cell['mesh']} "
          f"(rank 0 of 512, a fake group; {wall:.1f} s with its process): "
          f"status {cell['status']}, per-rank arguments "
          f"{mem_c['argument_size_in_bytes'] / 1e9:.3f} GB + temporaries "
          f"{mem_c['temp_size_in_bytes'] / 1e9:.3f} GB, matmul FLOPs "
          f"{hlo_c['matmul_flops']:.6g}, HBM bytes {hlo_c['hbm_bytes']:.6g}, "
          f"collectives {hlo_c['coll_ops']} ({hlo_c['coll_bytes']:.6g} "
          f"bytes, {hlo_c['coll_bytes_xpod']:.6g} across pods); phase 12 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 13: the example twins (examples/torch/) on the card
# ---------------------------------------------------------------------------

# the twins that run in this process, each at its short setting
EXAMPLE_RUNS = (("quickstart", ["--keys", "100000"]),
                ("cluster_centers", ["--points", "4000"]),
                ("serve_batched", ["--gen", "4"]),
                ("train_with_sampled_telemetry", ["--steps", "3"]))
DEMO_STEPS = 2          # gradient_compression_demo: 2 steps of each run
DEMO_WORLD = 8          # ... on its 2 x 2 x 2 mesh of gloo processes
# the exchange's K1 runs seeds only (counted with K1)
EXAMPLE_WRAPPERS = PATH_WRAPPERS + (("seeds", "fused_seeds", "seeds only"),)


def _example(name: str):
    """The module of ``examples/torch/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _held_launches(torch, K, calls, what: str):
    """The launches counted since the last reset, every one of them among
    ``calls`` and held against its plain version: ({kernel: launches},
    {counter: max abs err})."""
    counts = K.launch_counts()
    recorded = {k: 0 for k in K.COUNTED}
    for name, _, _ in calls:
        recorded["seeds" if name == "seeds only" else name] += 1
    _check(recorded == counts,
           f"{what}: recorded launches {recorded}, counted {counts}")
    return counts, check_path_launches(torch, calls, what)


def _demo_worker(rank: int, world: int, port: str, out: str) -> int:
    """One rank of 13's gradient_compression_demo: the twin's own
    ``worker`` on the card, its kernel launches recorded and held against
    their plain versions here; writes ``out``/rank<r>.json."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.kernels as K
    demo = _example("gradient_compression_demo")
    with recorded_launches(torch, EXAMPLE_WRAPPERS) as calls:
        demo.worker(rank, world, port, out, DEMO_STEPS, device=WORKER_DEVICE)
    counts, errs = _held_launches(torch, K, calls, f"13 demo rank {rank}")
    with open(Path(out) / f"rank{rank}.json", "w") as f:
        json.dump({"counts": counts, "errs": errs}, f)
    return 0


def phase_examples(torch, K, card: str):
    """13: the five twins of ``examples/*.py`` on the card at their short
    settings (``EXAMPLE_RUNS`` through their ``main``;
    gradient_compression_demo's ``worker`` in DEMO_WORLD gloo processes,
    as the script launches it). Every kernel launch is recorded at the
    call and held against its plain version on its inputs (phase 1's
    tolerances). Returns the launches summed over the twins."""
    import socket
    totals = {k: 0 for k in K.COUNTED}
    for name, argv in EXAMPLE_RUNS:
        mod = _example(name)
        torch.cuda.empty_cache()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with recorded_launches(torch, EXAMPLE_WRAPPERS) as calls:
            mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, errs = _held_launches(torch, K, calls, f"13 {name}")
        del calls
        for k, v in counts.items():
            totals[k] += v
        print(f"13 {name} {' '.join(argv)} on {card}: launches {counts}, "
              f"each held against its plain version (max abs err "
              f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }); wall "
              f"{wall:.1f} s", flush=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="chip_smoke_13_")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [*PLACE_WORKER_CMD, "--demo-worker", str(r), str(DEMO_WORLD), port,
         out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DEMO_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PLACE_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        _check(p.returncode == 0, f"13 demo rank {r} failed:\n{log[-4000:]}")
    res = json.loads((Path(out) / "result.json").read_text())
    ranks = [json.loads((Path(out) / f"rank{r}.json").read_text())
             for r in range(DEMO_WORLD)]
    dense, sampled = res["dense"], res["sampled"]
    _check(len(dense) == len(sampled) == DEMO_STEPS
           and np.all(np.isfinite(dense + sampled))
           and dense[0] == sampled[0],
           f"13 demo: losses {dense} / {sampled}")
    _check(0 < res["sampled_xpod_bytes"] < res["dense_xpod_bytes"],
           f"13 demo: cross-pod bytes {res['sampled_xpod_bytes']} sampled "
           f"vs {res['dense_xpod_bytes']} dense")
    for r in ranks:
        _check(r["counts"]["seeds"] > 0 and r["counts"]["blockselect"] > 0,
               f"13 demo: a rank's exchange launched {r['counts']}")
        for k, v in r["counts"].items():
            totals[k] += v
    print(f"13 gradient_compression_demo --steps {DEMO_STEPS}, "
          f"{DEMO_WORLD} gloo processes on {card}: dense losses {dense}, "
          f"sampled {sampled}; cross-pod bytes of a step on rank 0 "
          f"{res['dense_xpod_bytes']:,} dense vs "
          f"{res['sampled_xpod_bytes']:,} sampled; K1/K2 launches "
          f"{sum(r['counts']['seeds'] for r in ranks)}/"
          f"{sum(r['counts']['blockselect'] for r in ranks)} over the ranks, "
          f"each held against its plain version (max abs "
          f"{max(r['errs'].get('seeds only', 0.0) for r in ranks):.3g} / "
          f"{max(r['errs'].get('blockselect', 0.0) for r in ranks):.3g}); "
          f"wall {wall:.1f} s", flush=True)
    return totals


def member_triples(torch, sk):
    """A sketch's member slots as a sorted list of (key, weight, prob)."""
    m = sk.member & sk.valid
    return sorted(zip(sk.keys[m].tolist(), sk.weights[m].tolist(),
                      sk.probs[m].tolist()))


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 14, K7: attention forward and backward against its plain loop
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, K, hd, causal, q_offset, kv_valid_len, chunk): granite-moe's
# microbatch first, then head dims 80 / 96 / 128 / 256, MQA, a large GQA
# group, non-causal, q_offset with kv_valid_len, Sq != Sk, ragged tiles
ATTN_CASES = (
    (4, 4096, 4096, 16, 8, 64, True, 0, None, 512),
    (2, 512, 512, 8, 2, 80, True, 0, None, 128),
    (2, 512, 512, 8, 8, 96, True, 0, None, 128),
    (2, 512, 512, 12, 2, 128, True, 0, None, 128),
    (1, 512, 512, 8, 1, 256, True, 0, None, 128),
    (2, 300, 300, 16, 16, 80, False, 0, None, 300),
    (2, 64, 512, 8, 2, 64, True, 448, 500, 64),
    (2, 128, 256, 4, 4, 64, False, 0, 200, 128),
    (1, 100, 260, 6, 3, 48, True, 0, None, 260),
    (1, 200, 200, 4, 2, 32, True, 0, None, 200),
    # zamba2-2.7b's shared blocks: head dim 160 (run padded to 256) at the
    # softmax scale 1/sqrt(80), an eleventh field (the others: 1/sqrt(hd))
    (2, 4096, 4096, 32, 32, 160, True, 0, None, 512, 80 ** -0.5),
)
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
# K7's gate against the plain loop, per tensor (out, dq, dk, dv). Both sides
# compute the same fp32 values in another order and round each result to
# bf16; besides, the plain loop rounds p to bf16 at the running maximum of
# its 64..512-key chunks and the kernel at that of its 64-key tiles. So most
# elements agree to the bit or one ulp, and no stretch of positions drifts.
# On one H100 over three seeds of every ATTN_CASES row the kernel read at
# most 2.4e-3 in a tile, and over-ulp shares of 0.085 (out), 0.017 (dq),
# 0.020 (dk) and 4.7e-4 (dv); at granite's shape the planted faults
# (``attn_faults``) read 0.10 or more in a tile (a skipped kv tile) and
# 0.13 over-ulp in dq, dk and dv (the split's mid and lo parts dropped).
ATTN_TILE = 64                  # positions of one tile of the norm gate
ATTN_TILE_GAP = 2.0 ** -6       # largest ||got - want|| / ||want|| a tile
ATTN_ULP_SHARE = {"out": 0.25, "dq": 0.05, "dk": 0.05, "dv": 0.01}
                                # share of elements > 1 bf16 ulp apart
ATTN_FAULT_FROM = 1024          # planted "diagonal" fault: from this row on
ATTN_NAMES = ("out", "dq", "dk", "dv")
ATTN_STEP_CALLS = 24 * 2 * 3    # granite: layers x microbatches x (fwd,
                                # remat's recompute, bwd)


def attn_inputs(torch, dev, case, seed: int):
    """bf16 q, k, v and dO of an ATTN_CASES row, made on the card."""
    B, Sq, Sk, H, Kh, hd = case[:6]
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, generator=g, device=dev).to(
        torch.bfloat16)
    return mk(B, Sq, H, hd), mk(B, Sk, Kh, hd), mk(B, Sk, Kh, hd), \
        mk(B, Sq, H, hd)


def attn_gaps(torch, got, want) -> dict:
    """One tensor [B, S, heads, hd] against its plain value: ``tile``, the
    largest ||got - want|| / ||want|| over tiles of ATTN_TILE positions of
    one (batch, head) (inf where want's tile is 0 and got's is not);
    ``norm``, the same over the whole tensor; ``over_ulp``, the share of
    elements more than one bf16 ulp of want apart."""
    a, b = got.float(), want.float()
    d = a - b
    B, S, Hh, D = b.shape
    n = -(-S // ATTN_TILE)

    def tile_norms(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n * ATTN_TILE - S))
        return x.reshape(B, n, ATTN_TILE, Hh, D).square().sum((2, 4)).sqrt()
    dt, bt = tile_norms(d), tile_norms(b)
    tile = torch.where(bt > 0, dt / bt.clamp_min(1e-30),
                       torch.where(dt > 0, float("inf"), 0.0))
    ulp = torch.exp2(torch.floor(torch.log2(
        b.abs().clamp_min(2.0 ** -126))) - 7)
    return dict(tile=float(tile.max()) if tile.numel() else 0.0,
                norm=float(d.norm() / b.norm().clamp_min(1e-30)),
                over_ulp=float((d.abs() > ulp).float().mean())
                if d.numel() else 0.0)


def attn_gate(gaps: dict) -> list:
    """{tensor name: attn_gaps} -> the limits broken, as text (none: the
    kernel's result passes)."""
    broken = []
    for name, g in gaps.items():
        if not g["tile"] <= ATTN_TILE_GAP:
            broken.append(f"{name} tile {g['tile']:.3e} > {ATTN_TILE_GAP}")
        if not g["over_ulp"] <= ATTN_ULP_SHARE[name]:
            broken.append(f"{name} over-ulp {g['over_ulp']:.3e} > "
                          f"{ATTN_ULP_SHARE[name]}")
    return broken


def attn_faults(torch, KA, Sk: int, start: int = ATTN_FAULT_FROM) -> dict:
    """Planted faults, made in the plain loop: name -> a context in which
    ``attention_forward_plain`` / ``_backward_plain`` give what a kernel
    with that fault would: "diagonal" skips the 64-key tile that holds a
    row's own key, for rows at ``start`` or past it; "last_tile" skips
    the last 64 keys; "hi_only" drops the mid and lo parts of the fp32
    operand of dV, dK and dQ (P or dS rounded to bf16)."""
    from unittest import mock
    mask, einsum = KA._mask, torch.einsum

    def keys(kp, device):
        return torch.arange(kp[0], kp[0] + len(kp), device=device)

    def diagonal(qp, kp, causal, device):
        q = torch.arange(qp[0], qp[0] + len(qp), device=device)[:, None]
        k = keys(kp, device)[None, :]
        skip = (q // 64 == k // 64) & (q >= start)
        return mask(qp, kp, causal, device) & ~skip[None, :, None, None, :]

    def last_tile(qp, kp, causal, device):
        keep = keys(kp, device) < Sk - 64
        return mask(qp, kp, causal, device) & keep[None, None, None, None, :]

    def hi_only(spec, x, y):
        if spec in ("bqkgc,bqkgh->bckh", "bqkgc,bckh->bqkgh"):
            x = x.to(torch.bfloat16).to(x.dtype)
        return einsum(spec, x, y)
    return {"diagonal": lambda: mock.patch.object(KA, "_mask", diagonal),
            "last_tile": lambda: mock.patch.object(KA, "_mask", last_tile),
            "hi_only": lambda: mock.patch.object(torch, "einsum", hi_only)}


def attn_scale(case):
    """An ATTN_CASES row's softmax scale: its eleventh field, or None
    (1/sqrt(hd)) where it has ten."""
    return case[10] if len(case) > 10 else None


def attention_plain(KA, case, q, k, v, do):
    """The plain loop's (out, dq, dk, dv) of one case."""
    causal, q_offset, kv_valid, chunk = case[6:10]
    scale = attn_scale(case)
    Cq, Ck = min(chunk, q.shape[1]), min(chunk, k.shape[1])
    op, lp = KA.attention_forward_plain(q, k, v, causal, Cq, Ck, q_offset,
                                        kv_valid, scale)
    gp = KA.attention_backward_plain(q, k, v, op, lp, do, causal, Cq, Ck,
                                     q_offset, kv_valid, scale)
    return (op, *gp)


def attention_pair(KA, case, q, k, v, do):
    """(kernel, plain) results of one case: (out, dq, dk, dv) each."""
    causal, q_offset, kv_valid = case[6:9]
    scale = attn_scale(case)
    ok, lk = KA.attention_forward_kernel(q, k, v, causal, q_offset, kv_valid,
                                         scale)
    gk = KA.attention_backward_kernel(q, k, v, ok, lk, do, causal, q_offset,
                                      kv_valid, scale)
    return (ok, *gk), attention_plain(KA, case, q, k, v, do)


def attn_flops(case, passes: int) -> float:
    """The reference's tensor operations of ``passes`` S x Sk products
    (forward 2: s, pv; backward 5: s, dv, dp, dk, dq) over the pairs the
    mask leaves visible."""
    B, Sq, Sk, H, Kh, hd, causal = case[:7]
    pairs = Sq * (Sq + 1) / 2 if causal and Sq == Sk else Sq * Sk
    return passes * 2.0 * B * H * hd * pairs


def attn_text(gaps: dict) -> str:
    return ", ".join(f"{name} tile {g['tile']:.3e} norm {g['norm']:.3e} "
                     f"over-ulp {g['over_ulp']:.3e}"
                     for name, g in gaps.items())


def attention_gaps(torch, KA, dev, n: int, case):
    """Case ``n`` of ATTN_CASES: the kernel against the plain loop, and
    its bits run to run -> ({tensor: attn_gaps}, and at granite's shape
    (n 0) {fault: {tensor: attn_gaps of the fault's plain loop}})."""
    q, k, v, do = attn_inputs(torch, dev, case, 100 + n)
    got, want = attention_pair(KA, case, q, k, v, do)
    again, _ = attention_pair(KA, case, q, k, v, do)
    torch.cuda.synchronize()
    for name, a, c in zip(ATTN_NAMES, got, again):
        _check(torch.equal(a, c), f"K7 {case}: {name} not run-to-run "
               "identical")
        _check(bool(torch.isfinite(a.float()).all()),
               f"K7 {case}: {name} not finite")
    gaps = {name: attn_gaps(torch, a, b)
            for name, a, b in zip(ATTN_NAMES, got, want)}
    faults = {}
    if n == 0:
        for fault, planted in attn_faults(torch, KA, case[2]).items():
            with planted():
                bad = attention_plain(KA, case, q, k, v, do)
            faults[fault] = {name: attn_gaps(torch, a, b)
                             for name, a, b in zip(ATTN_NAMES, bad, want)}
    return gaps, faults


def phase_attention(torch, dev):
    """K7 against its plain loop on every ATTN_CASES row (bf16 in and
    out) through ``attn_gate``, and its bits run to run; at granite's
    shape each planted fault of ``attn_faults`` must break the gate. Then
    at granite's shape the kernel's, the plain loop's and
    scaled_dot_product_attention's times (the last a yardstick the port
    never calls)."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention as KA
    gaps, faults = {}, {}
    for n, case in enumerate(ATTN_CASES):
        gaps[n], found = attention_gaps(torch, KA, dev, n, case)
        faults.update(found)
        print(f"K7 case {case}: {attn_text(gaps[n])}", flush=True)
        broken = attn_gate(gaps[n])
        _check(not broken, f"K7 {case}: beyond the gate: {broken}")
    for fault, fg in faults.items():
        print(f"K7 planted fault {fault} at {ATTN_CASES[0][:6]}: "
              f"{attn_text(fg)}; broken: {attn_gate(fg)}", flush=True)
        _check(attn_gate(fg), f"K7: the planted fault {fault} passes the "
               "gate")
    case = ATTN_CASES[0]
    B, S, _, H, Kh, hd, causal, _, _, chunk = case
    q, k, v, do = attn_inputs(torch, dev, case, 7)
    o, lse = KA.attention_forward_kernel(q, k, v, True)
    t_fwd = cuda_ms(torch, lambda: KA.attention_forward_kernel(q, k, v,
                                                               True))
    t_bwd = cuda_ms(torch, lambda: KA.attention_backward_kernel(
        q, k, v, o, lse, do, True))
    op, lp = KA.attention_forward_plain(q, k, v, True, chunk, chunk, 0, None)
    p_fwd = cuda_ms(torch, lambda: KA.attention_forward_plain(
        q, k, v, True, chunk, chunk, 0, None), reps=3, inner=1)
    p_bwd = cuda_ms(torch, lambda: KA.attention_backward_plain(
        q, k, v, op, lp, do, True, chunk, chunk, 0, None), reps=3, inner=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kt, vt = (t.repeat_interleave(H // Kh, dim=1) for t in (kt, vt))
    l_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    lo = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    dot = do.transpose(1, 2)
    l_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        lo, (qg, kg, vg), dot, retain_graph=True))
    b_fwd = attn_flops(case, 2) / BF16_OPS_PER_S * 1e3
    b_bwd = attn_flops(case, 5) / BF16_OPS_PER_S * 1e3
    print(f"K7 attention {case[:6]} causal: kernel fwd {t_fwd:.3f} ms "
          f"bwd {t_bwd:.3f} ms, bound (the reference's products at the "
          f"bf16 peak) fwd {b_fwd:.3f} ms bwd {b_bwd:.3f} ms, plain loop "
          f"fwd {p_fwd:.1f} ms bwd {p_bwd:.1f} ms, "
          f"scaled_dot_product_attention fwd {l_fwd:.3f} ms bwd "
          f"{l_bwd:.3f} ms", flush=True)
    worst = {name: {key: max(g[name][key] for g in gaps.values())
                    for key in ("tile", "norm", "over_ulp")}
             for name in ATTN_NAMES}
    fault_max = {fault: {key: max(g[key] for g in fg.values())
                         for key in ("tile", "over_ulp")}
                 for fault, fg in faults.items()}
    del q, k, v, do, o, lse, op, lp, qt, kt, vt, qg, kg, vg, lo, dot
    return dict(ms=t_fwd, bwd_ms=t_bwd, bound_ms=b_fwd, bwd_bound_ms=b_bwd,
                bound_by="operations", plain_ms=p_fwd, plain_bwd_ms=p_bwd,
                library_ms=l_fwd, library_bwd_ms=l_bwd, worst_gaps=worst,
                planted_faults=fault_max)


def granite_step_counts(torch, dev) -> dict:
    """The ``attn.kernel`` and ``moe.slots_kernel`` counts of one
    granite-moe train step (24 layers, 2 microbatches of 2 x 256 tokens)
    under a profiler, each checked against its expected count
    (ATTN_STEP_CALLS, SLOT_STEP_CALLS) and its wrapper's launch count."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import moe_slots as KS
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_model
    from repro_torch.optim import adamw
    from repro_torch.telemetry import spans
    cfg = get_config(MOE_ARCH)
    mesh = Mesh((1, 1, 1), AX3, device=dev)
    step, _ = make_train_step(cfg, adamw.OptConfig(), mesh, microbatch=2)
    params, _ = init_model(cfg, seed=0, device=dev)
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    del params
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (4, 256)).astype(np.int32)).to(dev)
    KA.launch.launches = KS.expert_slots.launches = 0
    spans.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        state, _ = step(state, {"tokens": toks})
        torch.cuda.synchronize()
    counted = {name: sum(int(c.value) for c in spans.counts()
                         if c.name == name)
               for name in ("attn.kernel", "moe.slots_kernel")}
    spans.reset()
    for name, want, launches in (
            ("attn.kernel", ATTN_STEP_CALLS, KA.launch.launches),
            ("moe.slots_kernel", SLOT_STEP_CALLS,
             KS.expert_slots.launches)):
        _check(counted[name] == want == launches,
               f"{counted[name]} {name} counts and {launches} launches in "
               f"a granite step, expected {want}")
    del state
    torch.cuda.empty_cache()
    return counted


# K8's cases (name, B, S, k, E, C, choices): "routed" gives each token k
# distinct experts of E at random, as the router does; "one" sends every
# choice to expert 0 (all but C overflow); "padded" routes among the first
# 60 of E = 64 (the padded experts are never chosen). granite-moe's
# microbatch first (C = moe_capacity(4,096)), then qwen2-moe's E 60 and its
# padded 64 at top-4, decode at S = 1, one row, a row of 8,008 (not a
# multiple of its tile of 256), E 128, and a row long enough for the
# largest tile (8,192 choices, 64 tiles).
SLOT_CASES = (
    ("granite", 4, 4096, 8, 32, 1280, "routed"),
    ("qwen2-moe", 2, 4096, 4, 60, 344, "routed"),
    ("qwen2-moe-padded", 2, 4096, 4, 64, 320, "padded"),
    ("decode", 8, 1, 8, 32, 8, "routed"),
    ("one-row", 1, 4096, 8, 32, 1280, "routed"),
    ("ragged", 3, 1001, 8, 32, 320, "routed"),
    ("one-expert", 4, 4096, 8, 32, 1280, "one"),
    ("e128", 2, 2048, 8, 128, 160, "routed"),
    ("long-row", 1, 65536, 8, 32, 20480, "routed"),
)
SLOT_STEP_CALLS = 24 * 2 * 2    # granite: layers x microbatches x (fwd,
                                # remat's recompute)


def slot_inputs(torch, dev, case, seed: int):
    """flat_e [B, S*k] int64 of a SLOT_CASES row, made on the card."""
    _, B, S, k, E, _, choices = case
    if choices == "one":
        return torch.zeros((B, S * k), dtype=torch.int64, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    real = 60 if choices == "padded" else E
    draw = torch.rand((B, S, real), generator=g, device=dev)
    return draw.argsort(dim=-1)[..., :k].reshape(B, S * k).contiguous()


def phase_moe_slots(torch, dev):
    """K8 against its plain version on every SLOT_CASES row, bit for bit,
    and its bits run to run; then at granite's shape the kernel's time
    (warm, and with a cold L2) beside its byte bound, the plain one-hot
    cumsum's and a stable torch.sort of the row's (a yardstick the port
    never calls)."""
    from repro_torch.kernels import moe_slots as KS
    for n, case in enumerate(SLOT_CASES):
        _, B, S, k, E, C, _ = case
        flat_e = slot_inputs(torch, dev, case, 200 + n)
        got = KS.expert_slots_kernel(flat_e, E, C)
        again = KS.expert_slots_kernel(flat_e, E, C)
        want = KS.expert_slots_plain(flat_e, E, C)
        torch.cuda.synchronize()
        for name, a, c, w in zip(("slot", "keep", "dest"), got, again, want):
            _check(a.dtype == w.dtype and torch.equal(a, w),
                   f"K8 {case}: {name} differs from the plain version")
            _check(torch.equal(a, c), f"K8 {case}: {name} not run-to-run "
                   "identical")
        print(f"K8 case {case}: equal to plain, tile "
              f"{KS.slot_tile(S * k)}, kept {int(got[1].sum())} of "
              f"{got[1].numel()}", flush=True)
    _, B, S, k, E, C, _ = case = SLOT_CASES[0]
    flat_e = slot_inputs(torch, dev, case, 7)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    t_k = cuda_ms(torch, lambda: KS.expert_slots_kernel(flat_e, E, C))
    t_cold = cuda_ms_cold(torch, lambda: KS.expert_slots_kernel(flat_e, E, C),
                          flush)
    t_plain = cuda_ms(torch, lambda: KS.expert_slots_plain(flat_e, E, C),
                      reps=5, inner=2)
    t_lib = cuda_ms(torch, lambda: torch.sort(flat_e, dim=1, stable=True))
    nbytes = flat_e.numel() * (8 + 8 + 1 + 8)   # read ids; slot, keep, dest
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"K8 moe_slots [{B}, {S * k}] E {E} C {C}: kernel {t_k:.4f} ms "
          f"(cold L2 {t_cold:.4f}), bound {b_ms:.4f} ms (bytes, "
          f"{nbytes / 1e6:.2f} MB), plain one-hot cumsum {t_plain:.3f} ms, "
          f"stable torch.sort of the row {t_lib:.4f} ms", flush=True)
    del flat_e, flush
    return dict(ms=t_k, cold_ms=t_cold, bound_ms=b_ms, bound_by="bytes",
                plain_ms=t_plain, library_ms=t_lib)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch.core as C
    import repro_torch.kernels as K
    from repro_torch.kernels._util import kernel_lib
    from repro_torch.launch import pool as pool_mod
    from repro_torch.launch import query as query_mod

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernel_lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda")

    walls = []

    def done(phase: str):
        """Print the phase's wall time and the script's so far."""
        walls.append(time.perf_counter())
        print(f"phase {phase}: {walls[-1] - walls[-2]:.1f} s (script "
              f"{walls[-1] - walls[0]:.1f} s)", flush=True)
    walls.append(t0)
    kstats = phase_kernels(torch, C, K, dev)
    kstats["servicecost"] = phase_k5(torch, K, dev)
    kernel_attributes(K)
    kstats["rankcount"] = phase_k6(torch, C, K, dev)
    done("0-1")
    counts = phase_serving(torch, C, K, pool_mod, query_mod)
    phase_durability(C, pool_mod)
    metric_counts = phase_metric(torch, C, K, dev)
    universal_counts = phase_universal(torch, C, K, dev)
    phase_scaleout(torch, C, K, pool_mod, query_mod, dev, card)
    done("2-6")
    train_stats, train_counts = phase_train(torch, C, K, dev)
    phase_train_multiprocess(torch)
    done("7")
    serve_counts, moe_stats, moe_counts = phase_serve(torch, K, dev, card)
    done("8")
    ssm_counts, hybrid_counts, hybrid_stats, hybrid_attn = phase_ssm(
        torch, K, dev, card)
    done("9")
    enc_counts, vlm_counts, enc_stats = phase_encoder_vlm(torch, K, dev, card)
    done("10")
    place_stats, place_counts, place_ssm_counts = phase_placement(
        torch, K, dev, card)
    attn_place = phase_placement_k7(torch, card)
    done("11")
    phase_dryrun(torch, dev, card)
    done("12")
    example_counts = phase_examples(torch, K, card)
    done("13")
    attn_stats = phase_attention(torch, dev)
    done("14")
    slot_stats = phase_moe_slots(torch, dev)
    step_counts = granite_step_counts(torch, dev)
    done("15")

    sources = {"seeds": ("seeds.cu", "seeds.py:58"),
               "blockselect": ("select.cu", "blockselect.py:41"),
               "compact": ("compact.cu", "compact.py:39"),
               "segquery": ("segquery.cu", "segquery.py:44"),
               "servicecost": ("servicecost.cu", "servicecost.py:48"),
               "rankcount": ("rankcount.cu", "rankcount.py:30")}
    main_path = {"servicecost": metric_counts, "rankcount": universal_counts}
    rows = []
    for name, (cu, tpu) in sources.items():
        launches = main_path.get(name, counts)[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{cu}",
                     "replaces": f"src/repro/kernels/{tpu}",
                     "launches": launches, **kstats[name],
                     **train_stats.get(name, {}),
                     "train_launches": train_counts[name],
                     **moe_stats.get(name, {}),
                     "moe_train_launches": moe_counts[name],
                     "serve_launches": serve_counts[name],
                     **hybrid_stats.get(name, {}),
                     "ssm_serve_launches": ssm_counts[name],
                     "hybrid_train_launches": hybrid_counts[name],
                     **enc_stats.get(name, {}),
                     "encoder_train_launches": enc_counts[name],
                     "vlm_serve_launches": vlm_counts[name],
                     **place_stats.get(name, {}),
                     "placement_launches": place_counts[name],
                     "placement_ssm_launches": place_ssm_counts[name],
                     "examples_launches": example_counts[name]})
    rows.append({"name": "attention", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/attention.cu",
                 "replaces": "none (src/repro/models/layers.py _make_flash "
                             "is plain JAX)", **attn_stats,
                 "step_launches": step_counts["attn.kernel"],
                 "hybrid_train_launches": hybrid_attn,
                 "placement_launches": attn_place})
    rows.append({"name": "moe_slots", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/moe_slots.cu",
                 "replaces": "none (src/repro/models/moe.py's slot "
                             "assignment is plain JAX)", **slot_stats,
                 "step_launches": step_counts["moe.slots_kernel"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-worker"]:
        sys.exit(_train_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--demo-worker"]:
        sys.exit(_demo_worker(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--place-worker"]:
        sys.exit(_place_worker(sys.argv[2], int(sys.argv[3]),
                               int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    sys.exit(main())
