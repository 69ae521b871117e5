#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds all four kernel libraries from src/repro_torch/kernels/*/csrc;
3. drives the serving miss path through the public API — the released
   policy (checkpoints/respect-v1, hidden 128) on the ten Table-I graphs
   plus 64 synthetic graphs (uniform system, whole-decode kernel B1 in its
   cluster template), a seeded RespectScheduler.init (the default hidden
   256) on the synthetic graphs (B1 in its block template) and on the
   first 14 of them (two waves of 16-block clusters: B1's wide template),
   then a heterogeneous system (scan decode with the single-step kernel) —
   with the launch counters reset just before and read just after;
4. checks the ten golden order/assignment digests
   (tests/golden/dnn_schedules.json) and holds the synthetic and
   heterogeneous results to the plain PyTorch path on the CPU (at the
   release's width, and with seeded schedulers at hidden 96 and 640 through
   the single-step kernel B2, as every profile-conditioned batch); a
   uniform batch at hidden 384 (a width the block's thread groups do not
   divide) through B1's block template, equal to the CPU plain path;
5. holds each kernel (B1's three templates apart) to its plain PyTorch
   version on the card at the main path's shapes, times both with CUDA
   events (and, for each kernel, its device time from the profiler's kernel
   durations: a kernel under 0.2 ms is reported by that time, which leaves
   out the host's enqueue), computes each kernel's bound and the end-to-end
   cold-miss rate; B2 at a half-dense mask at bucket 1024 at hidden 128, 96
   and 640;
6. the LM zoo's serving path: the full zamba2-7b (81 layers, d_model 3584,
   bf16, seeded random weights) serves a batch of 2 x 2048-token prompts and
   a ragged 1 x 1000 one (prefill, then 16 greedy decode steps each), with
   the launch counters reset just before and read just after (13 flash and
   68 SSD launches a prefill, none in decode); prints prefill and decode
   tokens/s and where a prefill's device time goes, and checks there that
   every B3 and B4 launch of the bf16 model ran the kernels' bfloat16
   (tensor-core) templates;
7. holds the flash-attention and SSD-scan kernels to their plain versions
   at the path's shapes (and a GQA, a Dv != D, an Sq < Sk and an
   in_scale != dt case), times kernel, plain version and — for flash —
   PyTorch's scaled_dot_product_attention as a yardstick, with their bounds;
8. runs one full-width mmmmmA unit in float32 through the kernels and
   through the plain versions on the card, and compares the logits;
9. the heterogeneous batch's scan: records every step's (h, mask) of each
   bucket, holds B2 to its plain version on each recorded step and times it
   over them (device time a batch and a launch, bound over the same steps),
   then a time split of the batch's cold miss (pack, encode, scan decode,
   rho, repair) with B2's device time and the device's idle share in the
   decode, checking by kernel name that every step ran ptr_step_cluster;
10. checks from the profiler's kernel names that every B1 launch of the
   respect-v1 path (one a bucket) ran the cluster template;
11. (between 4 and 5) the seeded and sampled path, with the launch counters
   reset just before and read just after: seeded weights drawn on the host
   for seed 0 at hidden 256, 128 and 96, their leaves (read back from the
   card) against tests/golden/torch_seeded_schedules.json, then those
   schedulers on the 64 synthetic graphs (B1 block template at hidden 256
   and 96, B1 cluster template) and on the heterogeneous batch (the scan with
   B2, a start token conditioned through w_sys), digests against the golden
   file (hidden 256 on the synthetic graphs and hidden 96 on the
   heterogeneous ones are the main path's runs of 1 and 3, held to the file
   there); B1's sampled decode of respect-v1 (graph i keyed
   fold_in(PRNGKey(1), i)) on the synthetic and Table-I graphs, orders
   against the golden file, logp and entropy against the plain version, and
   B1's device time sampled against greedy; fallback_schedule_many on
   respect-v1 (digests, served_by, the cache untouched); a save/load round
   trip of the hidden-256 scheduler;
12. (after 11) the serving front end, repro_torch.serving.SchedulerService,
   over a fresh RespectScheduler.from_release() on the card: warmup
   (synthetic n = 30 at batch 1 and 16, the Table-I graphs, one
   heterogeneous graph), after which live traffic builds and loads no kernel
   library; clean traffic from eight submitter threads (the Table-I,
   synthetic and heterogeneous graphs at k = 4 and 16 synthetic ones at
   k = 3, each twice), with the launch counters reset just before and read
   just after, held to schedule_many and the golden digests with nothing
   degraded, failed, retried or restarted ("service clean traffic":
   requests/s, p50/p99); the seeded fault replay of tests/test_faults.py's
   soak over the same traffic, every rung's results held to the clean
   phase, the seeded golden file and the host heuristic, and the fallback
   rung's first call timed apart from the later ones; the deadline checks;
13. (after 12) the RL training engine, repro_torch.core.rl.RLTrainer, on
   the card at respect-v1's training configuration (hidden 128, lr 3e-4,
   stage counts 2, 3, 4, 6, 8) with the launch counters reset just before
   and read just after: the labelled packs of DagSampler(seed=0, n=(5,
   50)).packed_stream(64, 4) for three draws (buckets 8-64), the first three
   steps held to tests/golden/torch_train_steps.json (labels, sampled and
   baseline orders, assignments and per-graph rewards equal; metrics and
   parameters within the TOL_TRAIN_* tolerances) and B1's sampled rollout
   to the same orders; one B1 launch a step in the greedy baseline; one
   draw at each other stage count; a heterogeneous step (B2 in the
   baseline's scan, w_sys moves) held to the same step from a CPU copy of
   the trainer's state (metrics and every parameter within the TOL_TRAIN_*
   tolerances); a step at the paper's scale (hidden 256,
   batch 128, |V| = 30); a held-out eval of 128 graphs per stage count
   (B1, equal to the CPU plain path); a save/restore round trip, bit for
   bit; ms a step and training graphs/s per bucket and, from one profiled
   bucket-64 step, its split over the trainer's rl.* profiler ranges, the
   device's idle share and B1's device time;
14. (after 13) the gap-to-optimal eval, repro_torch.eval, on the card: the
   smoke uniform grid, the smoke heterogeneous grid and the smoke
   generalization tier with RespectScheduler.from_release() and a CUDA
   ExactOracle (bb_max_n 12, bb budget 2 s), the launch counters reset just
   before and read just after each tier (B1 cluster template: two launches a
   bucket a grid scenario, one a generalization scenario; B2: two a step of
   each heterogeneous/memcap bucket), held to BENCH_eval.json in every
   non-timing field (integers and flags equal, floats within EVAL_RTOL
   relative; on a difference the first respect schedule that leaves the CPU
   plain path is printed) and to check_results, check_hetero and
   check_generalization; the card's solve-time ratios beside the artifact's
   (the JAX package's CPU numbers); then python -m repro_torch.train_release
   run in-process for 6 steps into build/, its release verified by sha256
   and loaded on the card and on the CPU, which schedule the Table-I and
   synthetic graphs identically;
15. (after 6-8) the models the ingest path traces, served at full width on
   the card with seeded random weights, the launch counters reset just
   before and read just after each, every launch's shape recorded:
   whisper-tiny (4 + 4 layers, d_model 384, bf16; B = 2, 1500 frames, 64
   prompt tokens, max_len 80) with 12 flash launches a prefill (4 encoder,
   non-causal; 4 decoder self, causal; 4 cross, non-causal), all of them the
   bf16 template by profiler name; xlstm-350m (full width, 2 of 24 layers
   "xs" by the script's clock, d_model 1024, bf16; B = 2, 1024 prompt
   tokens) with 2 SSD launches a prefill (1 mLSTM layer: the numerator at
   N = P = 512, the normalizer at P = 1, both
   ssd_scan_tiled_bf16_kernel by profiler name, in the xs unit's split and in
   item 17's timing, and never ssd_scan_tiled_kernel); 16 greedy decode steps
   each, which launch neither kernel; prefill and decode tokens/s;
16. one full-width whisper encoder block plus decoder block, and one
   full-width xs unit, in float32 through the kernels and through the plain
   versions on the card, logits compared (the xs unit's SSD launches
   ssd_scan_tiled_kernel by profiler name: float32 keeps the CUDA-core tiled
   template);
17. B3 at whisper-tiny's three shapes and B4 at xlstm-350m's two, each held
   to its plain version and timed (kernel, plain version, PyTorch's
   scaled_dot_product_attention for B3, bound, and for B4 the bound's share
   of the device time);
18. ingest_model of both full configs at seq 64 and 12 and 64 nodes:
   parameter bytes equal to BENCH_ingest.json's, flops printed beside its,
   no warning, the graph hash equal to the CPU's
   (tests/golden/torch_ingest_hashes.json) and to a second trace's;
19. RespectScheduler.schedule_model of both full configs at k = 4 through
   B1 on the card (one launch each), equal to the CPU plain path's and
   dependency-valid;
20. the eval's ingest/k4 cell (run_scenario with a CUDA ExactOracle, 12
   nodes) equal in every non-timing field to the same cell on the CPU.
21. (last, after 10) the LM zoo's training path (python -m repro_torch.train_lm's
   functions: TrainLoop over make_train_fn, examples/train_lm.py's
   TrainConfig with two microbatches) at full width with seeded random
   weights, the launch counters reset just before and read just after each:
   whisper-tiny (bf16, B = 8, 1500 zero frames, 128 tokens, 6 steps; 12 B3
   launches a microbatch forward, flash_fwd_bf16 by profiler name) and
   xlstm-350m (bf16, full width cut to 2 of 24 layers, B = 2, S = 256, 3
   steps; 2 B4 launches a microbatch forward, ssd_scan_tiled_bf16_kernel by
   name); each run saved halfway and
   resumed there through TrainLoop (whisper's also against an uninterrupted
   run), finite losses, every gradient leaf non-zero in the first
   microbatch, ms a step and tokens/s, and one profiled step's split over
   the lm.* ranges with the device's idle share (xlstm: one xs unit),
   run last (item 24);
22. the three SMOKE archs in float32 through the kernels' float32 templates,
   three steps each against tests/golden/torch_lm_train_steps.json (the JAX
   package's), and one full-width float32 unit of whisper (ec) and of xlstm
   (xs), the loss and every gradient leaf, kernel path against plain path;
23. B3 and B4 under autograd at zamba2-7b's prefill shapes, whisper-tiny's
   three (at its training microbatch) and xlstm-350m's two, a GQA and a
   Dv != D case: B3's lse against the plain version's, B4's y and h_final
   against the plain version's, each autograd Function's input gradients
   against plain autograd (B4's Function recomputes the plain scan in its
   backward, so that comparison checks its wiring), B4's forward template by
   profiler name (ssd_scan_tiled_bf16_kernel at xlstm's, ssd_scan_bf16_kernel
   at zamba2's) and its device time with the bound's share of it, B3's device
   time with and without the lse, the flash backward beside
   scaled_dot_product_attention's forward + backward, B4's recompute backward
   beside B4's forward, each with its bound (run first in the phase, before 22
   and 21);
24. (last of all) one profiled train step of whisper-tiny and of one
   full-width xs unit of xlstm-350m: the lm.* split, the device's idle
   share, B3's bf16 / B4's tiled bf16 template by kernel name (a window that
   shows fewer than the counted launches is profiled again, up to three
   times, as device_ms does);
25. (after 15-17) the rest of the LM zoo served in bf16 with seeded random
   weights, one model at a time, each freed before the next, the launch
   counters reset just before and read just after each: minicpm3-4b (MLA,
   24 of 62 layers by the script's clock, d_model 2560; B = 2, S = 1024),
   llava-next-mistral-7b (16 of 32 layers; B = 1, 1152 patch embeddings +
   128 tokens), qwen3-14b (qk_norm, 20 of 40 layers; B = 2, S = 1024), each
   with 8 greedy decode steps, and the
   two MoE archs at full width cut in depth to fit the card's 80 GB,
   qwen3-moe-235b-a22b (4 of 94 layers; B = 2, S = 512) and kimi-k2-1t-a32b
   (1 of 61; B = 1, S = 512), 4 decode steps each (ZOO_ARCHS); one B3 launch
   a layer a prefill, none in decode, all of them the bf16 template by
   profiler name; prefill and decode tokens/s and a prefill's device split;
26. a float32 unit of each held to the plain path: one full-width layer of
   the three dense archs (logits, greedy tokens; minicpm3's holds B3 at
   D = 96, Dv = 64), one full-width MoE block of each MoE arch with its
   routes compared (a flip is printed with its gate margin and is a fault
   above TOL_MOE_FLIP) and its output on the tokens whose routes agree;
27. B3 at each of the five archs' prefill shapes held to its plain version
   and timed (kernel, plain version, scaled_dot_product_attention, bound);
28. (after 18-20) the pod-scale partitioner: partition_model of the ten
   archs at train_4k, 8 stages, mesh slice 64 with compiler, exact and
   respect (respect-v1 on the card, one B1 cluster launch a graph, the
   launch counters reset just before and read just after), every
   assignment equal to tests/golden/torch_partitions.json (the JAX
   package's), the bottleneck ratios and solve times printed; B1 at the
   largest bucket of these graphs held to its plain version and timed;
29. (last, after 24) data parallelism: two gloo ranks sharing the card
   (repro_torch.core.rl.train_data_parallel, spawned by
   repro_torch.parallel.data.run_ranks after the kernels are built) take the
   three golden train steps, each rank its slice of the global pack and of
   the global key split, held to tests/golden/torch_train_steps.json as in
   item 13 (integers equal, parameters within TOL_TRAIN_PARAM), the ranks'
   parameters equal, one B1 launch a step on each rank by the ranks' own
   counters; then a 2-rank run of bucket-32 steps beside the same steps in
   one process, ms a step on the host clock (a correctness rig, not scaling:
   both ranks share one card);
30. compressed_all_reduce on two gloo ranks on the card over random trees of
   respect-v1's gradient shapes against the same on two CPU ranks: int8
   payloads, int32 totals and scales equal, means and error feedback within
   TOL_COMPRESS;
31. python -m repro_torch.train_respect --devices 2 (gloo, one card) for 4
   steps with a save and an eval (the baseline decision broadcast from
   rank 0) at 2 and 4, then a resume to step 6; the agent it writes loads
   into RespectScheduler and schedules the Table-I graphs;
32. qwen3-14b at full width (40 layers, d_model 5120, bf16, seeded weights)
   cut into 4 stages by the respect cut at train_4k (partition_table of
   repro_torch.pipeline_demo: one B1 launch, counted), run by
   PipelineRunner with 4 microbatches of 1 x 2048 tokens, the launch
   counters reset just before and read just after one pipelined forward
   (160 flash_fwd: 40 layers x 4 microbatches); pipelined against
   sequential three times (TOL_PIPE, 0 expected), wall time of each,
   the device's idle share and the flash_fwd_bf16 kernels by profiler name
   in each, the bubble share, peak allocated bytes; B3 at the path's shape
   held to its plain version and timed (kernel, plain, SDPA, bound);
33. a float32 unit of 4 full-width qwen3-14b layers in 2 stages, kernel path
   against plain path within TOL_ZOO_F32 x max(1, |x|);
34. (with 19) RespectScheduler.schedule_model of the archs of
   tests/golden/torch_ingest_zoo_hashes.json (the seven newer zoo archs and
   zamba2-7b) at full config, 12 and 64 nodes, through B1 on the card: their
   ingest at seq 64 hashed equal to the file, no warning; one B1 cluster
   launch each at the default seq (llava-next-mistral-7b's clamped to its
   1152 patches + 8), equal to the CPU plain path's and dependency-valid;
35. (after 31) the release trainer's rank body (repro_torch.train_release.train,
   which python -m repro_torch.train_release --devices 2 --backend gloo
   --share-device runs through run_ranks) for 2 steps on two gloo ranks
   sharing the card: the ranks' parameters equal by sha256, equal to the
   release rank 0 writes, and moved off the seeded init;
36. (last, after 33) B3 under autograd at the training shapes of
   minicpm3-4b (B = 2, S = 1024, 40 heads, D = 96, Dv = 64),
   llava-next-mistral-7b (B = 1, 1152 + 128 tokens, 32 / 8 heads), qwen3-14b
   (B = 2, S = 1024, 40 / 8), internlm2-1.8b (B = 2, S = 1024, 16 / 8) and
   qwen3-moe-235b-a22b (B = 2, S = 512, 64 / 4): the lse, the output and the
   Function's dq, dk, dv against the plain versions (TOL_LSE, TOL_BF16_OUT,
   TOL_FLASH_GRAD); B3's device time with the lse, its bound, SDPA's
   forward, the plain flash backward beside SDPA's forward + backward;
37. a float32 unit of one full-width layer of each family under Model.loss,
   kernel path against plain path: MLA (minicpm3-4b), the VLM (llava, with
   patches), qk-norm GQA (qwen3-14b), plain GQA (internlm2-1.8b), MoE
   (qwen3-moe-235b-a22b, its routes compared: a flip above TOL_MOE_FLIP is
   a fault); the loss and every gradient leaf within TOL_ZOO_F32 x max(1,
   |x|), every leaf non-zero, one B3 launch in the forward (kimi-k2-1t-a32b
   is held on the CPU only: one block is 19.4 G parameters);
38. timed bf16 steps through TrainLoop (repro_torch.train_lm.make_loop,
   microbatches 2; its checkpoints counted, not written) of internlm2-1.8b
   at full width cut to 12 of 24 layers (the script's clock) and minicpm3-4b
   at full width cut to 6 of 62 layers (the card's 80 GB, the script's
   clock), B = 2, S = 1024, 2 steps each, the
   launch counters
   reset just before and read just after each: finite losses, one B3 launch
   a layer a microbatch forward, every gradient leaf non-zero in the first
   microbatch, ms a step, tokens/s and peak allocated bytes;
39. one profiled step of each run of 38: its lm.* split, the device's idle
   share and flash_fwd_bf16 by kernel name;
39a. activation remat (build_model(cfg, remat=...)): minicpm3-4b at 38's
   setting before its cut (12 of 62 layers, B = 2, S = 1024, microbatches 2, the seeded
   weights), one train step with remat off and one with it on: loss and
   grad_norm within the zoo's bf16 bound of each other, the peak allocated
   bytes of each, and B3's launches, the remat backward adding exactly one
   recomputed forward a layer a microbatch (every other training phase
   builds its model with remat=False, as the reference's LM example does);
40. (after 39) the twin of examples/edge_pipeline_deploy.py
   (repro_torch.edge_pipeline_deploy.deploy_table) with its default agent,
   RespectScheduler.init(seed=0) at hidden 256, the launch counters reset
   just before and read just after: the 10 Table-I models at k = 4, 5, 6,
   the compiler emulation's, the exact solver's and RESPECT's assignment
   sha256 and monotone flag equal to tests/golden/torch_edge_deploy.json
   (the JAX package's) and their bottleneck_s within TOL_DEPLOY relative,
   30 B1 launches (one a schedule call, B = 1) of the template the rule
   picks at each bucket (decode.decode_template with the card's count of
   16-block clusters: ptr_decode_wide_f32) and no other, the table's
   host-clock time split into the compiler emulation, the exact solver,
   the evaluation and RESPECT's schedule calls (encode, B1, the rest),
   the card synchronized around each part; the quickstart twin on ResNet50 at k = 4 the same way
   (one launch), its per-stage placement too;
41. B1 at the table's largest bucket (InceptionResNetv2, bucket 1024,
   B = 1): the wide template (greedy and sampled) and the block template
   (a build with -DPTR_DECODE_FORCE_BLOCK) held to the plain version and
   timed in turns by their exact profiler names;
42. the serve_traffic twin (hidden 64: the cluster template) with its two
   bursts of 80 requests, counted: every result equal to schedule_many's
   and to the golden pool's, 0 failed, degraded, retried or restarted,
   burst 2 served from the cache and by deduplication; graphs/s of each
   burst and p50/p99;
43. (last) the sharded step makers (repro_torch.launch) on a one-device
   DeviceMesh (data = 1, model = 1) on the card over a one-rank gloo group:
   internlm2-1.8b at its full config in bf16 with seeded weights, B = 2,
   S = 1024; every parameter, cache, batch and optimizer-state sharding
   they return equal to the resolver's on that mesh; make_prefill_step
   bit-equal to Model.prefill with one B3 launch a layer, counted;
   make_decode_step's one step bit-equal to Model.decode_step (logits and
   cache), no launch; make_train_step's one step equal to make_train_fn's
   (loss, grad_norm and every parameter bit for bit, both under
   torch.use_deterministic_algorithms: the embedding's gradient scatter
   otherwise adds in a nondeterministic order), one B3 launch a layer;
44. B3 at that prefill's shape held to its plain version and timed;
45. (started before 40, on the host beside 40-44, the card hidden from it;
   read last) the multi-pod dry run (repro_torch.launch.dryrun) in three
   processes of their own:
   the golden cells of tests/golden/torch_dryrun.json (the JAX package's
   XLA lowering at 256/512 host devices) with argument and output bytes
   equal (a prefill's cache in the decode layout, ROADMAP §C), model flops
   equal, per-device flops within 5 %; each cell's three roofline terms,
   dominant term, mfu_bound and GiB a device (a model at the H100's
   published peaks);
46. internlm2-1.8b at 43's shapes on a 1 x 1 mesh, prefill and a
   train step (one microbatch): the dry run's argument bytes equal to what
   the card holds, its peak estimate beside torch.cuda.max_memory_allocated,
   its step_lower_bound_s at most the measured median step (a step below
   the bound fails: the roofline would be wrong); 24 B3 launches a prefill;
47. (last) sharded execution on real ranks (repro_torch.launch.ranks): four
   ranks (NCCL one a card with four cards or more, else gloo with every rank
   on card 0), first a probe of the functional collectives DTensor issues on
   CUDA tensors (gloo's all-gather through
   repro_torch.parallel.collectives, counted); internlm2-1.8b at full width
   (4 of 24 layers) in bf16 on a (2, 2) (data, model) mesh: prefill B = 2,
   S = 1024 and 8 decode steps fed the single process's greedy tokens, two
   train steps (microbatches 2) of a 2-layer model, the trained state saved
   on (2, 2) and restored onto (4, 1) bit for bit; one full-width float32
   zamba2-7b mmmmmA unit on (1, 4): prefill, 4 greedy decode steps, the loss
   and every gradient; then SX_CELLS, each with the model's own inputs:
   whisper-tiny (2, 2) bf16 with two train steps, an xlstm-350m xs unit on
   (1, 4) in float32 (the loss's gradients: the sLSTM's sharded backward)
   and as a bf16 prefill, qwen3-14b (2, 2) bf16 and llava-next (2, 2)
   float32 at 2 layers with the loss's gradients, minicpm3-4b (MLA) and
   qwen3-moe-235b-a22b (the MoE dispatch) (2, 2) bf16 at 2 layers with the
   loss's gradients under remat (the MoE's served values against the
   single process fed the ranks' routes, a route its own router would pick
   otherwise a fault above the gate margin NEAR_TIE); each against the
   single-process call on the card (run first, then freed); each rank's
   B3/B4 launches by counter and by profiler name, every replicated value
   equal across ranks; B3 and B4 at the ranks' local shapes held to their
   plain versions and timed;
48. (between 4 and 11) the decode_bf16 path, with the launch counters
   reset just before and read just after: RespectScheduler.from_release(
   decode_bf16=True) on the ten Table-I and 64 synthetic graphs (one
   ptr_decode_cluster_bf16 a bucket, nothing else of B1) and
   init(seed=0, decode_bf16=True) on the synthetic ones (one
   ptr_decode_block_bf16) and on the first 16 of them (one
   ptr_decode_wide_bf16: two waves of the 14 clusters the card holds at
   bucket 32 in bf16), their digests against
   tests/golden/torch_bf16_schedules.json (the JAX package's bf16 schedules)
   and the CPU plain bf16 path; (with 5) the three bf16 templates held to
   the plain bf16 version at bucket 1024, B = 4 and bucket 32, B = 64
   (hidden 128), bucket 32, B = 64 and bucket 1024, B = 2 (hidden 256),
   their device time in turns with the float32 twin's, their bound at 2
   bytes an element; (with 10) the templates the path ran by profiler
   name.

Exits non-zero, printing no result, without CUDA or outside a checkout of
the repository.  The last line is the JSON device record.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "dnn_schedules.json"
SEEDED_GOLDEN = ROOT / "tests" / "golden" / "torch_seeded_schedules.json"
BF16_GOLDEN = ROOT / "tests" / "golden" / "torch_bf16_schedules.json"
sys.path.insert(0, str(ROOT / "src"))
try:     # the H100's published peaks, the dry run's roofline's (one home for them)
    from repro_torch.launch.roofline import HW
except ImportError:      # outside a checkout, or without torch: main() says so
    HW = {}
HBM_BYTES_PER_S = HW.get("hbm_bw")        # H100 SXM device memory
F32_FLOPS_PER_S = HW.get("f32_flops")     # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = HW.get("peak_flops")   # H100 SXM bf16 tensor cores, dense
STAGES = 4
FORCE_BLOCK = ("PTR_DECODE_FORCE_BLOCK",)   # B1's build with only its block template
BF16_TWIN = {"ptr_decode_cluster": "ptr_decode_cluster_bf16",
             "ptr_decode_block": "ptr_decode_block_bf16",
             "ptr_decode_wide_f32": "ptr_decode_wide_bf16"}
TOL_LOGITS = 1e-4              # single step: float32 sums in another order
TOL_LOGP = 1e-3                # whole decode: drift carried through n LSTM steps
HETERO = dict(n_stages=STAGES, compute_rate=(4e12, 2e12, 4e12, 8e12),
              link_bw=(320e6, 160e6, 320e6, 640e6))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.asarray(a, dtype=np.int64).tobytes()).hexdigest()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


LEAD_IN = 4096   # spin kernels that open every profiled window (profiled())
LEAD_IN_CYCLES = 20_000_000   # and the last one's cycles: about 10 ms


@contextlib.contextmanager
def profiled():
    """A torch.profiler window over the host and the card that opens with
    LEAD_IN one-cycle spin kernels and one of LEAD_IN_CYCLES.  Late in a
    long process a window loses its first kernels (on an H100, a few more
    with each earlier window of the process; neither torch's events nor the
    raw kineto results hold them), so the spin kernels are lost in their
    place; device_kernels() leaves them out of what the window reports."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda._sleep(LEAD_IN_CYCLES)
        torch.cuda.synchronize()
        yield prof


def device_kernels(prof) -> list:
    """The device kernels of a profiled() window, its lead-in left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name]


def device_ms(fn, name: str, iters: int, attempts: int = 3) -> float:
    """Mean device time, in ms, of the kernels whose name holds ``name``:
    the profiler's kernel durations of the last ``iters`` of ``2 iters + 2``
    calls of ``fn`` (one such kernel a call), without the host's enqueue
    between launches.  The profiler may miss the first kernels of a window
    (it has missed three 0.3 ms ones in a row, and late in a long run 13 of
    22 in each of three windows); a window that still shows fewer than
    ``iters`` is profiled again with twice the calls, up to ``attempts``
    times."""
    import torch
    fn()
    torch.cuda.synchronize()
    seen, calls = [], []
    for attempt in range(attempts):
        calls.append(2 ** (attempt + 1) * iters + 2)
        with profiled() as prof:
            for _ in range(calls[-1]):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.elapsed_us())
                       for e in device_kernels(prof) if name in e.name)
        if len(spans) >= iters:
            return sum(us for _, us in spans[-iters:]) / iters / 1e3
        seen.append(len(spans))
    raise SmokeFailure(f"profiler saw {seen} {name} kernels in windows of {calls} calls")


def turns_ms(calls: dict, order: tuple, iters: int, attempts: int = 3) -> dict[str, list]:
    """Device time, in ms, of each turn of ``order`` in one profiled()
    window: ``calls`` maps a kernel's exact name to a call that launches it
    once; a turn is ``2 iters + 2`` calls of its name's, then a one-cycle spin
    kernel that ends it, and reads the mean of its last ``iters`` kernels.
    Fails if a turn ran a kernel of another name of ``calls``.  A window that
    shows fewer than ``iters`` kernels in a turn is profiled again with twice
    the calls, up to ``attempts`` times.  Returns each name's turns, in
    order."""
    import torch
    from torch.autograd import DeviceType
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(attempts):
        n_calls = 2 ** (attempt + 1) * iters + 2
        with profiled() as prof:
            for name in order:
                for _ in range(n_calls):
                    calls[name]()
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                        for e in prof.events() if e.device_type == DeviceType.CUDA
                        and (e.name in calls or "spin_kernel" in e.name))
        # the turns start at the first kernel of a call (the lead-in's spin
        # kernels come before it); each later spin kernel ends one
        first = next((i for i, ev in enumerate(events) if ev[1] in calls), len(events))
        turns, cur = [], []
        for _, name, us in events[first:]:
            if name in calls:
                cur.append((name, us))
            else:
                turns.append(cur)
                cur = []
        for name, turn in zip(order, turns):
            check(all(nm == name for nm, _ in turn),
                  f"a turn of {name} ran {sorted({nm for nm, _ in turn})}")
        if len(turns) == len(order) and all(len(t) >= iters for t in turns):
            out = {name: [] for name in order}
            for name, turn in zip(order, turns):
                out[name].append(sum(us for _, us in turn[-iters:]) / iters / 1e3)
            return out
        seen.append([len(t) for t in turns])
    raise SmokeFailure(f"profiler saw turns of {seen} kernels, {order} of {iters} wanted")


def profile_kernels(fn) -> list[tuple[str, float, float]]:
    """(name, start, end), in microseconds and by start, of every device
    kernel one profiled call of ``fn`` ran."""
    import torch
    with profiled() as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in device_kernels(prof)),
                  key=lambda k: k[1])


def kernel_names(fn) -> list[str]:
    """The names of the device kernels one profiled call of ``fn`` ran."""
    return [name for name, _, _ in profile_kernels(fn)]


def busy_window(spans) -> tuple[float, float]:
    """(busy, window) of (start, end) spans: the length of their union, and
    first start to last end."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for st, en in spans[1:]:
        if st > cur_e:
            busy, cur_s = busy + cur_e - cur_s, st
        cur_e = max(cur_e, en)
    return busy + cur_e - cur_s, max(en for _, en in spans) - spans[0][0]


def reported_ms(event_ms: float, dev_ms: float) -> float:
    """The time a kernel row reports: CUDA events around back-to-back calls,
    or, for a kernel under 0.2 ms, where the host's enqueue between launches
    is a visible share of that, its device time."""
    return dev_ms if event_ms < 0.2 else event_ms


def frontier_sizes(graph, order) -> list[int]:
    """Selectable-node count before each real step of a decode (the rows the
    kernels read that step)."""
    remaining = [len(p) for p in graph.parents]
    frontier = sum(1 for r in remaining if r == 0)
    sizes = []
    for v in order[: graph.n]:
        sizes.append(frontier)
        frontier -= 1
        for c in graph.children[v]:
            remaining[c] -= 1
            frontier += remaining[c] == 0
    return sizes


def decode_work(graphs, orders, n: int, H: int, D: int,
                itemsize: int = 4) -> tuple[float, float]:
    """(bytes, flops) a whole decode of ``graphs`` padded to ``n`` needs:
    every real row of C, CWg, CWp and emb read once, the weights once, the
    outputs written once; per real step the gate products, the two query
    products and the frontier rows' scores, softmax and glimpse.  CWg and CWp
    (C @ W_ref of both heads) are the kernel's inputs, computed before it:
    neither W_ref nor that product counts.  C, CWg, CWp, emb, wx, wh, the
    two query weights, v, v and dec0 count ``itemsize`` bytes an element (2
    for the bf16 templates); the bias, h0, c0, the indices and the outputs
    4."""
    w_bytes = (itemsize * (2 * H * 4 * H + 2 * H * H + 3 * H)   # wx, wh, 2 w_q, v, v, dec0
               + 4 * 4 * H)                                      # b
    nbytes, flops = float(w_bytes), 0.0
    for g, o in zip(graphs, orders):
        nbytes += itemsize * 4 * g.n * H + 4 * (2 * H + n * D + 1) + 3 * 4 * n
        for m in frontier_sizes(g, o):
            flops += 2 * 2 * H * 4 * H + 10 * H    # gates (x and h halves) + cell
            flops += 2 * 2 * H * H                 # qg, qp
            flops += m * (3 * H * 2 + 2 * H + 8)   # two heads' tanh-dot, glimpse, softmaxes
    return nbytes, flops


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def first_divergence(net_cpu, graph, kernel_order, max_deg: int, system=None) -> str:
    """First step where the card's order leaves the CPU plain decode (under
    ``system``'s profile, if any), with the CPU's top-2 logit margin there."""
    import torch
    from repro_torch.core.batching import pack_padded
    batch = pack_padded([graph], max_deg=max_deg)
    sys_feat = None if system is None else scan_profile(system, "cpu", system.n_stages)[0]
    with torch.inference_mode():
        C, (h0, c0), emb = net_cpu.encode(batch.feats, batch.n_valid)
        plain = net_cpu.plain_logits_fn(C)
        seen = []

        def recording(h, mask):
            seen.append(plain(h, mask))
            return seen[-1]

        order, _, _ = net_cpu.decode(C, emb, (h0, c0), batch.parent_mat, n_valid=batch.n_valid,
                                     logits_fn=recording, sys_feat=sys_feat)
    order = order[0, : graph.n].numpy()
    diff = [t for t in range(graph.n) if order[t] != kernel_order[t]]
    if not diff:
        return "orders agree; the assignment differs"
    t = diff[0]
    top2 = torch.topk(seen[t][0], 2).values
    return (f"first diverging step {t}: card picked {kernel_order[t]}, CPU {order[t]}; "
            f"CPU top-2 logit margin {float(top2[0] - top2[1]):.3e}")


# ---------------------------------------------------------------------- #
# the single-step kernel B2 on the heterogeneous batch's scan decode
# ---------------------------------------------------------------------- #
def step_work(mask, H: int) -> tuple[float, float]:
    """(bytes, flops) of one single-step launch over a (B, n) mask: the
    selectable rows of C, CWg and CWp, h, the int32 mask, the query weights
    and vectors read once, the logits written once; both query products of
    every graph and, per selectable row, both heads' tanh-dots, its share of
    the glimpse and of the softmax."""
    B, n = mask.shape
    m = int(mask.sum())
    nbytes = 4 * (3 * m * H + B * n + B * H + 2 * H * H + 2 * H + B * n)
    return nbytes, B * 2 * 2 * H * H + m * (3 * H * 2 + 2 * H + 8)


def compare_logits(got, want, mask) -> tuple[bool, float, float]:
    """(masked logits byte-equal, max |err| and max |err| / max(1, |want|)
    over the selectable ones) of a single step's kernel and plain logits."""
    same = bool((got[~mask] == want[~mask]).all())
    if not bool(mask.any()):
        return same, 0.0, 0.0
    d = (got[mask] - want[mask]).abs()
    return same, float(d.max()), float((d / want[mask].abs().clamp_min(1.0)).max())


def scan_profile(system, device, n_stages: int = STAGES):
    """(sys_feat, system with ``n_stages`` stages, capacities) as the scan of
    ``BucketedDecoder.fused_schedules`` takes them."""
    import torch
    system = system.with_stages(n_stages)
    profile = system.profile_features()
    sys_feat = torch.from_numpy(profile).to(device) if profile.any() else None
    return sys_feat, system, system.capacity_vector()


def scan_split(net, graphs, system, max_deg: int, logits_factory, kname: str, expect: int,
               attempts: int = 3) -> dict:
    """A cold miss of ``graphs`` under ``system`` on the scan path, bucket by
    bucket: the host clock around each stage (pack, encode, scan decode with
    ``logits_factory(net, C)`` as the step, rho, repair), synchronized; then
    one profiled pass of every bucket's scan decode: the device time of the
    ``expect`` kernels named ``kname`` it launches, the names of all
    single-step kernels it ran, and the device's busy time in the decode's
    window (a pass whose profile shows fewer is profiled again, as in
    device_ms)."""
    import torch
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.core.segment import repair, rho_dp
    sys_feat, system, caps = scan_profile(system, "cuda")
    split = dict.fromkeys(("pack", "encode", "decode", "rho", "repair"), 0.0)

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[key] += time.perf_counter() - t0
        return out

    decodes = []
    with torch.inference_mode():
        for bucket_n, idxs in bucketize(graphs).items():
            gs = [graphs[i] for i in idxs]
            batch = timed("pack", lambda: pack_padded(gs, bucket_n, max_deg).to("cuda"))
            C, (h0, c0), emb = timed("encode", lambda: net.encode(batch.feats, batch.n_valid))

            def decode(C=C, emb=emb, h0=h0, c0=c0, batch=batch):
                return net.decode(C, emb, (h0, c0), batch.parent_mat, n_valid=batch.n_valid,
                                  logits_fn=logits_factory(net, C), sys_feat=sys_feat)[0]

            order = timed("decode", decode)
            assign = timed("rho", lambda: rho_dp(order, batch.flops, batch.param_bytes,
                                                 batch.out_bytes, batch.parent_mat, STAGES,
                                                 system, batch.n_valid).cpu().numpy())
            timed("repair", lambda: [repair(g, assign[r, : g.n], STAGES, mem_capacity=caps)
                                     for r, g in enumerate(gs)])
            decodes.append(decode)
        seen = []
        for _ in range(attempts):   # a sleep (spin_kernel) first, as in replay_device_ms
            kern = profile_kernels(lambda: [torch.cuda._sleep(20_000_000)]
                                   + [d() for d in decodes])
            b2 = [(st, en) for nm, st, en in kern if kname in nm]
            if len(b2) == expect:
                break
            seen.append(len(b2))
        else:
            raise SmokeFailure(f"profiler saw {seen} {kname} kernels in {attempts} scan decodes "
                               f"of {expect} steps")
    busy, window = busy_window([(st, en) for nm, st, en in kern if "spin_kernel" not in nm])
    return {"split": split, "b2_ms": sum(en - st for st, en in b2) / 1e3, "b2_count": expect,
            "step_names": sorted({nm for nm, _, _ in kern if "ptr_step" in nm}),
            "busy_ms": busy / 1e3, "window_ms": window / 1e3}


def split_line(label: str, card: str, res: dict) -> str:
    split = res["split"]
    total = sum(split.values())
    share = 100 * res["b2_ms"] / (split["decode"] * 1e3)
    idle = 100 * (1 - res["busy_ms"] / res["window_ms"])
    return (f"time split, {label} on {card} (host clock, synchronized): "
            + ", ".join(f"{k} {v * 1e3:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
            + f"; a profiled pass of the scan decode: B2 {res['b2_count']} launches, "
            f"{res['b2_ms']:.3f} ms of device time ({share:.1f}% of the decode stage's host "
            f"time), device busy {res['busy_ms']:.2f} ms of a {res['window_ms']:.2f} ms window "
            f"(idle {idle:.1f}%)")


def record_scan(net, graphs, system, max_deg: int) -> list[dict]:
    """Per bucket of ``graphs``: the encoded contexts C, their hoisted
    projections and every step's (h, mask) of the scan decode under
    ``system``, recorded on the card around the path's own single-step
    logits_fn."""
    import torch
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.kernels.ptr import ops
    sys_feat = scan_profile(system, "cuda")[0]
    recs = []
    with torch.inference_mode():
        for bucket_n, idxs in bucketize(graphs).items():
            batch = pack_padded([graphs[i] for i in idxs], bucket_n, max_deg).to("cuda")
            C, (h0, c0), emb = net.encode(batch.feats, batch.n_valid)
            step, steps = ops.make_logits_fn(net, C), []

            def recording(h, mask, step=step, steps=steps):
                steps.append((h.clone(), mask.clone()))
                return step(h, mask)

            net.decode(C, emb, (h0, c0), batch.parent_mat, n_valid=batch.n_valid,
                       logits_fn=recording, sys_feat=sys_feat)
            CWg, CWp = ops.precompute_refs(net, C)
            recs.append({"bucket_n": bucket_n, "B": len(idxs), "C": C, "CWg": CWg, "CWp": CWp,
                         "steps": steps})
    return recs


def replay(net, rec: dict, launch):
    """Calls ``launch`` (a single-step function with the kernel's arguments)
    on every recorded step of one bucket, back to back; returns the logits."""
    g, p = net.glimpse, net.pointer
    return [launch(rec["C"], rec["CWg"], rec["CWp"], h, g.w_q, g.v, p.w_q, p.v, mask)
            for h, mask in rec["steps"]]


def replay_device_ms(net, rec: dict, launch, kname: str, attempts: int = 3) -> list[float]:
    """Device time (ms) of each launch of a replay of one bucket's recorded
    steps, by the profiler's kernel durations.  The profiler may miss the
    first kernels of a window (see device_ms; up to 32 of 40 in one run), so
    a window opens with a 10 ms sleep on the device and eight launches of
    the first step, and the last kernels are taken; a window that still
    shows too few is profiled again."""
    import torch
    first = {**rec, "steps": rec["steps"][:1] * 8}

    def window():
        torch.cuda._sleep(20_000_000)   # cycles: about 10 ms
        replay(net, first, launch)
        replay(net, rec, launch)

    n = len(rec["steps"])
    with torch.inference_mode():
        window()
        seen = []
        for _ in range(attempts):
            kern = [(en - st) / 1e3 for nm, st, en in profile_kernels(window) if kname in nm]
            if len(kern) >= n:
                return kern[-n:]
            seen.append(len(kern))
    raise SmokeFailure(f"profiler saw {seen} {kname} kernels in {attempts} replays of "
                       f"{len(rec['steps'])} steps")


def steps_bound(net, rec: dict) -> tuple[float, str]:
    """The sum over a bucket's recorded steps of each launch's bound (ms),
    and what bounds most of it."""
    H = net.hidden
    t_b = t_f = total = 0.0
    for _, mask in rec["steps"]:
        nbytes, flops = step_work(mask, H)
        total += max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        t_b += nbytes / HBM_BYTES_PER_S
        t_f += flops / F32_FLOPS_PER_S
    return total * 1e3, "bytes" if t_b >= t_f else "operations"


# ---------------------------------------------------------------------- #
# the seeded and sampled path: threefry weights and uniforms, the fallback
# rung, save/load
# ---------------------------------------------------------------------- #
SEEDED_ROUTES = {256: "ptr_decode_block", 128: "ptr_decode_cluster", 96: "ptr_decode_block"}


def schedule_digests(results) -> dict:
    return {"order_sha256": [digest(r["order"]) for r in results],
            "assign_sha256": [digest(r["assignment"]) for r in results]}


def digest_misses(got: dict, want: dict) -> list[int]:
    return [i for i, pair in enumerate(zip(got["order_sha256"], got["assign_sha256"],
                                           want["order_sha256"], want["assign_sha256"]))
            if pair[:2] != pair[2:]]


def seeded_phase(card: str, sched, seeded: dict, table1, names, synth, hetero_graphs,
                 hsys) -> None:
    """The seeded and sampled path on the card (docstring item 11); raises
    SmokeFailure on any difference from the golden file.  ``seeded`` holds
    the main path's seeded schedulers at hidden 256 and 96."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import flatten_leaves
    from repro_torch.core import RespectScheduler, prng, ptrnet
    from repro_torch.core.batching import bucketize, pack_padded, sample_order
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import decode_batch, decode_batch_reference, step_uniforms

    gold = json.loads(SEEDED_GOLDEN.read_text())
    check(gold["meta"]["table1"] == names, "seeded golden: Table-I graphs differ")
    D = sched.max_deg
    synth_steps = sum(bucketize(synth))
    hetero_steps = sum(bucketize(hetero_graphs))
    t_phase = time.perf_counter()

    def delta(before):
        torch.cuda.synchronize()
        return {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}

    def expect(label, ran, **want):
        full = {k: want.get(k, 0) for k in ran}
        check(ran == full, f"{label}: launches {ran}, expected {full}")

    def leaf_digests(net) -> dict:
        return {n: hashlib.sha256(np.ascontiguousarray(a, "<f4").tobytes()).hexdigest()
                for n, a in flatten_leaves(ptrnet.params_to_numpy(net))}

    # ---- the path, counted ------------------------------------------- #
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    seeded = {**seeded, 128: RespectScheduler.init(seed=0, hidden=128)}  # on the host; cuda
    t_init = time.perf_counter() - t0
    batches = {"synthetic": (synth, None), "hetero": (hetero_graphs, hsys)}
    # what the main path has not run: it ran hidden 256 on the synthetic
    # batch and hidden 96 on the heterogeneous one
    todo = {256: ("hetero",), 128: ("synthetic", "hetero"), 96: ("synthetic",)}
    for H, route in SEEDED_ROUTES.items():
        check(leaf_digests(seeded[H].net) == gold["leaves"][str(H)],
              f"hidden {H}: the seeded leaves on the card differ from the golden file")
        for label in todo[H]:
            graphs, system = batches[label]
            before = dict(ops.LAUNCHES)
            got = schedule_digests(seeded[H].schedule_many(graphs, STAGES, system,
                                                           use_cache=False))
            if label == "hetero":
                expect(f"seeded hidden {H}, {label}", delta(before), ptr_step=hetero_steps)
            else:
                expect(f"seeded hidden {H}, {label}", delta(before),
                       **{route: synth_steps if route == "ptr_step" else 1})
            bad = digest_misses(got, gold["seeded"][str(H)][label])
            check(not bad, f"seeded hidden {H}, {label}: graphs {bad} differ from the golden "
                  "file")
        print(f"seeded init hidden {H}: 16 leaves equal to the golden file on the card; "
              f"{len(synth)} synthetic graphs ({route}) and {len(hetero_graphs)} heterogeneous "
              "ones (scan + B2, w_sys-conditioned start token): order and assignment digests "
              f"equal the golden file (here: {', '.join(todo[H])}; the rest on the main path)",
              flush=True)
    print(f"seeded init hidden 128: drawn on the host in {t_init:.2f} s", flush=True)

    sampled = {}                 # bucket_n -> (graphs, keys) of the sampled batches
    root = prng.PRNGKey(gold["meta"]["sample_seed"])
    for label, graphs in (("synthetic", synth), ("table1", table1)):
        keys = prng.fold_in(root, np.arange(len(graphs)))
        want = gold["sample_order"][label]
        want = [want[nm] for nm in names] if label == "table1" else want
        for bucket_n, idxs in bucketize(graphs).items():
            batch = pack_padded([graphs[i] for i in idxs], bucket_n, D)
            before = dict(ops.LAUNCHES)
            order, logp, ent = sample_order(sched.net, batch.feats, batch.parent_mat,
                                            keys[idxs], n_valid=batch.n_valid, decode="kernel")
            expect(f"sampled {label}, bucket {bucket_n}", delta(before), ptr_decode_cluster=1)
            order = order.cpu().numpy()
            bad = [i for r, i in enumerate(idxs)
                   if digest(order[r, : graphs[i].n]) != want[i]]
            check(not bad, f"sampled {label}: graphs {bad} differ from JAX's sample_order")
            sampled[(label, bucket_n)] = ([graphs[i] for i in idxs], keys[idxs], logp, ent)
    print(f"sampled decode (respect-v1, B1 cluster template): {len(synth)} synthetic and "
          f"{len(table1)} Table-I orders equal JAX's sample_order digests", flush=True)

    sched.clear_cache()
    sched.schedule_many(synth[:3], STAGES)
    stats = sched.cache_stats()
    before = dict(ops.LAUNCHES)
    fb = sched.fallback_schedule_many(table1 + synth, STAGES,
                                      fallback_seed=gold["meta"]["fallback_seed"])
    expect("fallback", delta(before), ptr_decode_cluster=len(bucketize(table1 + synth)))
    check(all(r["served_by"] == "fallback" and not r["cache_hit"] for r in fb),
          "fallback results are not stamped served_by='fallback'")
    check(sched.cache_stats() == stats, f"fallback touched the cache: {stats} -> "
          f"{sched.cache_stats()}")
    got = schedule_digests(fb)
    want = {k: [gold["fallback"]["table1"][nm][k] for nm in names]
            + gold["fallback"]["synthetic"][k] for k in ("order_sha256", "assign_sha256")}
    bad = digest_misses(got, want)
    check(not bad, f"fallback: graphs {bad} differ from the golden file")
    print(f"fallback: {len(fb)} schedules (Table-I and synthetic) equal the golden file, all "
          f"served_by='fallback', cache {stats} unchanged", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        seeded[256].save(Path(tmp) / "seeded-256")
        back = RespectScheduler.load(Path(tmp) / "seeded-256")
        check(leaf_digests(back.net) == gold["leaves"]["256"], "save/load: leaves differ")
        before = dict(ops.LAUNCHES)
        got = schedule_digests(back.schedule_many(synth, STAGES, use_cache=False))
        expect("save/load", delta(before), ptr_decode_block=1)
    bad = digest_misses(got, gold["seeded"]["256"]["synthetic"])
    check(not bad, f"save/load: graphs {bad} differ from the golden file")
    ran = delta(dict.fromkeys(ops.LAUNCHES, 0))
    print(f"save/load round trip of the hidden-256 scheduler: digests equal; the seeded path "
          f"launched {ran} in {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(all(ran[k] > 0 for k in ("ptr_decode_block", "ptr_decode_cluster", "ptr_step")),
          f"the seeded path left a kernel unlaunched: {ran}")

    # ---- B1 sampled against its plain version, and against greedy ----- #
    err = 0.0
    for (label, bucket_n), (graphs, keys, logp, ent) in sampled.items():
        batch = pack_padded(graphs, bucket_n, D).to("cuda")
        with torch.inference_mode():
            C, (h0, c0), emb = sched.net.encode(batch.feats, batch.n_valid)
            args = (sched.net, C, emb, h0, c0, batch.parent_mat, batch.n_valid,
                    step_uniforms(keys, bucket_n).cuda())
            po, pl_, pe = decode_batch_reference(*args)
            ko, kl, ke = decode_batch(*args)
        valid = torch.arange(bucket_n, device="cuda")[None, :] < batch.n_valid[:, None].long()
        check(torch.equal(torch.where(valid, ko, -1), torch.where(valid, po, -1)),
              f"sampled {label} bucket {bucket_n}: kernel and plain orders differ")
        e = max(float((kl - pl_).abs().max()), float((ke - pe).abs().max()),
                float((logp - pl_).abs().max()), float((ent - pe).abs().max()))
        check(e <= TOL_LOGP, f"sampled {label} bucket {bucket_n}: logp/entropy error {e:.3e}")
        err = max(err, e)
    print(f"sampled decode against the plain version on the card: orders equal, max |err| "
          f"logp/entropy {err:.2e} (tolerance {TOL_LOGP})", flush=True)

    big = [i for i in bucketize(table1)[1024]][-4:]
    for label, graphs, keys in (
            ("bucket 32, B=64", synth, prng.fold_in(root, np.arange(len(synth)))),
            ("bucket 1024, B=4", [table1[i] for i in big], prng.fold_in(root, np.array(big)))):
        batch = pack_padded(graphs, max_deg=D).to("cuda")
        with torch.inference_mode():
            C, (h0, c0), emb = sched.net.encode(batch.feats, batch.n_valid)
            args = (sched.net, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
            unif = step_uniforms(keys, batch.bucket_n).cuda()
            t = {"greedy": [], "sampled": []}
            for mode in ("greedy", "sampled", "sampled", "greedy"):
                extra = (unif,) if mode == "sampled" else ()
                t[mode].append(device_ms(lambda: decode_batch(*args, *extra),
                                         "ptr_decode_cluster", iters=5))
            # the rows a step reads depend on the order, so the two modes'
            # work differs by their orders' frontiers as well as by the pick
            rows = [sum(sum(frontier_sizes(gr, o)) for gr, o in zip(graphs, out[0].cpu().numpy()))
                    for out in (decode_batch(*args), decode_batch(*args, unif))]
        g, smp = t["greedy"], t["sampled"]
        print(f"ptr_decode_cluster {label} on {card}, device time (profiler, greedy, sampled, "
              f"sampled, greedy): greedy {min(g):.4f} - {max(g):.4f} ms, sampled "
              f"{min(smp):.4f} - {max(smp):.4f} ms (sampled / greedy "
              f"{statistics.mean(smp) / statistics.mean(g):.3f}); selectable rows summed over "
              f"the real steps: greedy {rows[0]}, sampled {rows[1]}", flush=True)
    del seeded


# ---------------------------------------------------------------------- #
# the decode_bf16 path: B1's bf16 storage templates
# ---------------------------------------------------------------------- #
def bf16_path(card: str, table1, names, synth) -> tuple[dict, dict, float]:
    """The decode_bf16 path, counted: RespectScheduler.from_release(
    decode_bf16=True) on the Table-I and synthetic graphs runs one
    ptr_decode_cluster_bf16 a bucket and nothing else of B1, init(seed=0,
    decode_bf16=True) on the synthetic ones one ptr_decode_block_bf16 and on
    the first BF16_WIDE_BATCH of them the template the rule picks with the
    card's count of bf16 wide clusters (ptr_decode_wide_bf16); their digests
    equal the JAX package's bf16 schedules (BF16_GOLDEN) and the CPU plain
    bf16 path.  Returns the path's launches, the runs (for the profiler's
    names, read late) and the seconds it took."""
    import numpy as np
    import torch

    from repro_torch.core import RespectScheduler
    from repro_torch.core.batching import bucketize
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import decode_template, wide_clusters

    t0 = time.perf_counter()
    gold = json.loads(BF16_GOLDEN.read_text())
    check(gold["meta"]["table1"] == names, "bf16 golden: Table-I graphs differ")
    scheds = {"respect-v1": RespectScheduler.from_release(decode_bf16=True),
              "init_seed0": RespectScheduler.init(seed=0, decode_bf16=True)}
    scheds["init_seed0_few"] = scheds["init_seed0"]
    few = synth[:BF16_WIDE_BATCH]
    batches = {"respect-v1": table1 + synth, "init_seed0": synth, "init_seed0_few": few}
    few_template = decode_template(32, 256, 6, True, batch=len(few),
                                   clusters=wide_clusters(32, 256, 6, True))
    check(few_template == "ptr_decode_wide_bf16",
          f"decode_bf16 init(seed=0): {len(few)} graphs of bucket 32 take {few_template}")
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    res, ran = {}, {}
    for label, sched in scheds.items():
        before = dict(ops.LAUNCHES)
        res[label] = sched.schedule_many(batches[label], STAGES, use_cache=False)
        torch.cuda.synchronize()
        ran[label] = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    launches = dict(ops.LAUNCHES)
    n_buckets = len(bucketize(table1 + synth))
    for label, template, count in (("respect-v1", "ptr_decode_cluster_bf16", n_buckets),
                                   ("init_seed0", "ptr_decode_block_bf16", 1),
                                   ("init_seed0_few", few_template, 1)):
        want = {k: count * (k == template) for k in launches}
        check(ran[label] == want, f"decode_bf16 {label}: launches {ran[label]}, expected "
              f"{count} {template} and nothing else")

    want = {k: [gold["table1"][nm][k] for nm in names] + gold["synthetic"]["respect-v1"][k]
            for k in ("order_sha256", "assign_sha256")}
    bad = digest_misses(schedule_digests(res["respect-v1"]), want)
    check(not bad, f"decode_bf16 respect-v1: graphs {bad} differ from the bf16 golden file")
    bad = digest_misses(schedule_digests(res["init_seed0"]), gold["synthetic"]["init_seed0"])
    check(not bad, f"decode_bf16 init(seed=0): graphs {bad} differ from the bf16 golden file")
    bad = digest_misses(schedule_digests(res["init_seed0_few"]),
                        {k: v[:len(few)] for k, v in gold["synthetic"]["init_seed0"].items()})
    check(not bad, f"decode_bf16 init(seed=0), {len(few)} graphs: graphs {bad} differ from the "
          "bf16 golden file")
    f32 = json.loads(GOLDEN.read_text())["models"]
    differ = [nm for nm, r in zip(names, res["respect-v1"])
              if digest(r["order"]) != f32[nm]["order_sha256"]]
    check(differ == gold["table1_differs_from_f32"]["order"],
          f"decode_bf16: Table-I orders that differ from float32 {differ}")
    cpu = {"respect-v1": RespectScheduler.from_release(device="cpu", decode_bf16=True),
           "init_seed0": RespectScheduler.init(seed=0, device="cpu", decode_bf16=True)}
    for label, sched in cpu.items():
        want = sched.schedule_many(batches[label], STAGES, use_cache=False)
        for lb in (label, label + "_few"):
            bad = [i for i, (r, rc) in enumerate(zip(res.get(lb, []), want))
                   if not (np.array_equal(r["order"], rc["order"])
                           and np.array_equal(r["assignment"], rc["assignment"]))]
            check(not bad, f"decode_bf16 {lb}: graphs {bad} differ from the CPU plain bf16 path")
    sec = time.perf_counter() - t0
    print(f"decode_bf16 path on {card}: respect-v1 on {len(table1)} Table-I and {len(synth)} "
          f"synthetic graphs ran {n_buckets} ptr_decode_cluster_bf16 launches, init(seed=0) on "
          f"the synthetic ones 1 ptr_decode_block_bf16 and on the first {len(few)} 1 "
          f"{few_template} (counted {launches}); every order and assignment digest equals the "
          f"JAX package's bf16 schedules and the CPU plain bf16 path; Table-I orders that "
          f"differ from float32: {differ} ({sec:.1f} s)", flush=True)
    return launches, {"respect-v1": (scheds["respect-v1"], table1 + synth,
                                     "ptr_decode_cluster_bf16", n_buckets),
                      "init_seed0": (scheds["init_seed0"], synth, "ptr_decode_block_bf16", 1),
                      "init_seed0_few": (scheds["init_seed0"], few, few_template, 1)}, sec


def bf16_names(card: str, runs: dict) -> float:
    """Which B1 templates the decode_bf16 path ran, by the profiler's kernel
    names (exact), in one window: ptr_decode_cluster_bf16 for respect-v1,
    one a bucket, ptr_decode_block_bf16 for init(seed=0) on the synthetic
    graphs and ptr_decode_wide_bf16 on the first BF16_WIDE_BATCH, nothing
    else of B1.  Returns its seconds."""
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import TEMPLATES

    t0 = time.perf_counter()
    before = dict(ops.LAUNCHES)
    names_run = kernel_names(lambda: [sched.schedule_many(graphs, STAGES, use_cache=False)
                                      for sched, graphs, _, _ in runs.values()])
    counted = {t: ops.LAUNCHES[t] - before[t] for t in TEMPLATES.values()}
    ran = {t: names_run.count(t) for t in TEMPLATES.values()}
    want = {t: 0 for t in TEMPLATES.values()}
    for _, _, template, count in runs.values():
        want[template] += count
    print(f"decode_bf16 path: B1 kernels by profiler name {ran}, counted {counted}", flush=True)
    check(ran == counted == want, f"decode_bf16 path ran B1 templates {ran} (counted "
          f"{counted}), expected {want}")
    return time.perf_counter() - t0


# ---------------------------------------------------------------------- #
# the serving front end: SchedulerService over respect-v1 on the card
# ---------------------------------------------------------------------- #
SERVICE_THREADS = 8     # submitter threads
SERVICE_WINDOW = 8      # requests each submitter keeps in flight
K3_GRAPHS = 16          # synthetic graphs also requested at k = 3
SOAK = dict(seed=0, n_calls=40, p_crash=0.08, p_error=0.15, p_slow=0.05, p_corrupt=0.08,
            slow_s=0.005, rungs=("policy", "fallback"))   # tests/test_faults.py's soak


class FallbackTimer:
    """Delegates to a scheduler, recording each ``fallback_schedule_many``
    call's wall time, arguments and kernel launches (only the service's
    worker calls it, so each launch delta is that call's own)."""

    def __init__(self, inner):
        self._inner = inner
        self.calls: list[tuple[float, tuple, dict]] = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def fallback_schedule_many(self, graphs, *args, **kw):
        from repro_torch.kernels.build import LAUNCHES
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        out = self._inner.fallback_schedule_many(graphs, *args, **kw)
        self.calls.append((time.perf_counter() - t0, (graphs, *args),
                           {k: LAUNCHES[k] - before[k] for k in LAUNCHES}))
        return out


def drive(svc, requests) -> tuple[list, float]:
    """Sends ``(key, graph, k, system)`` requests from SERVICE_THREADS
    threads, each keeping SERVICE_WINDOW in flight; returns ``(key,
    result)`` pairs and the wall time from the first submit to the last
    result."""
    out: list[list] = [[] for _ in range(SERVICE_THREADS)]
    errors: list[BaseException] = []

    def submitter(tid):
        try:
            mine = requests[tid::SERVICE_THREADS]
            for i in range(0, len(mine), SERVICE_WINDOW):
                futs = [(key, svc.submit(g, k, system))
                        for key, g, k, system in mine[i:i + SERVICE_WINDOW]]
                out[tid] += [(key, f.result(timeout=300)) for key, f in futs]
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(SERVICE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a submitter thread did not finish")
    check(not errors, f"submitters raised: {errors[:3]}")
    return [kr for rs in out for kr in rs], wall


def drained(st) -> bool:
    return (st.completed + st.failed == st.requests
            and st.cache_hits + st.cache_misses + st.dedup_hits + st.degraded + st.failed
            == st.requests and st.queue_depth == 0 and st.inflight_keys == 0)


def service_phase(card: str, golden: dict, names, table1, synth, hetero_graphs, hsys,
                  res_uniform, res_hetero, cpu) -> None:
    """SchedulerService over a fresh ``from_release()`` on the card: warmup,
    clean traffic from eight threads, the seeded fault replay and the
    deadline checks; raises SmokeFailure on any difference.
    ``res_uniform``/``res_hetero`` are the main path's ``schedule_many``
    results of ``table1 + synth`` and of the heterogeneous batch; ``cpu`` is
    the release on the CPU, whose plain path witnesses the fallback rung
    where the seeded golden file has no digests."""
    import numpy as np
    import torch

    from repro_torch.core import RespectScheduler, heuristic_schedule_many, validate_monotone
    from repro_torch.kernels import build
    from repro_torch.serving import DegradeConfig, FaultPlan, FaultyScheduler, SchedulerService

    t_phase = time.perf_counter()
    sched = RespectScheduler.from_release()            # device: cuda, fresh caches
    fb_gold = json.loads(SEEDED_GOLDEN.read_text())["fallback"]
    groups = {"table1": (table1, STAGES, None), "synth": (synth, STAGES, None),
              "hetero": (hetero_graphs, STAGES, hsys), "k3": (synth[:K3_GRAPHS], 3, None)}
    graph_of = {(label, i): g for label, (gs, _, _) in groups.items() for i, g in enumerate(gs)}
    setting = {label: (k, system) for label, (_, k, system) in groups.items()}
    requests = [(key, g, *setting[key[0]]) for key, g in graph_of.items()] * 2
    requests = [requests[i] for i in np.random.default_rng(0).permutation(len(requests))]

    def same(r, order, assign) -> bool:
        return np.array_equal(r["order"], order) and np.array_equal(r["assignment"], assign)

    def numpy_only(r) -> bool:
        return (isinstance(r["order"], np.ndarray) and isinstance(r["assignment"], np.ndarray)
                and not any(isinstance(v, torch.Tensor) for v in r.values()))

    # ---- 1. warmup: then live traffic builds and loads nothing --------- #
    svc = SchedulerService(sched)
    t0 = time.perf_counter()
    keys = svc.warmup([(30, 1), (30, 16), *table1], n_stages=STAGES)
    keys += svc.warmup([hetero_graphs[0]], n_stages=STAGES, system=hsys)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    libs = set(build._libs)
    check(sched.cache_stats() == {"hits": 0, "misses": 0, "size": 0},
          f"warmup filled the schedule cache: {sched.cache_stats()}")
    check({("ptr_decode", ()), ("ptr_step", ())} <= libs, f"warmup left {libs} loaded")
    print(f"service warmup on {card}: {t_warm:.3f} s for {len(keys)} (bucket_n, bucket_b, impl) "
          f"keys {[(k[0], k[1], k[-1]) for k in keys]} (the kernels were built at the start of "
          "the script); schedule cache empty", flush=True)

    # ---- 2. clean traffic, counted ------------------------------------ #
    want = {("table1", i): r for i, r in enumerate(res_uniform[:len(table1)])}
    want.update({("synth", i): r for i, r in enumerate(res_uniform[len(table1):])})
    want.update({("hetero", i): r for i, r in enumerate(res_hetero)})
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
    got, wall = drive(svc, requests)
    check(svc.close(timeout=300), "the clean service did not drain")
    torch.cuda.synchronize()
    ran = dict(build.LAUNCHES)
    st = svc.stats()
    check(build.build_kernels(["ptr_decode", "ptr_step"]) == 0.0 and set(build._libs) == libs,
          f"live traffic built or loaded a kernel library: {set(build._libs) - libs}")
    want.update({("k3", i): r for i, r in enumerate(
        sched.schedule_many(groups["k3"][0], 3, use_cache=False))})
    check(len(got) == len(requests) and st.requests == len(requests) and drained(st),
          f"clean traffic: {len(got)} results of {len(requests)}, stats {st.as_dict()}")
    check(st.degraded == st.failed == st.retries == st.worker_restarts == 0
          and all(r["served_by"] == "policy" for _, r in got),
          f"clean traffic left the policy rung: degraded {st.degraded}, failed {st.failed}, "
          f"retries {st.retries}, worker restarts {st.worker_restarts}")
    check(ran["ptr_decode_cluster"] > 0 and ran["ptr_step"] > 0 and ran["ptr_decode_block"] == 0,
          f"clean traffic launched {ran}: expected ptr_decode_cluster (uniform requests) and "
          "ptr_step (heterogeneous ones) and no ptr_decode_block")
    check(st.dedup_hits > 0 and st.cache_hits > 0,
          f"clean traffic: dedup hits {st.dedup_hits}, cache hits {st.cache_hits}")
    bad = [key for key, r in got if not (numpy_only(r) and same(r, want[key]["order"],
                                                                 want[key]["assignment"]))]
    check(not bad, f"clean traffic: results {bad[:5]} differ from schedule_many's")
    bad = [names[i] for (label, i), r in got if label == "table1"
           and (digest(r["order"]), digest(r["assignment"]))
           != tuple(golden["models"][names[i]][h] for h in ("order_sha256", "assign_sha256"))]
    check(not bad, f"clean traffic: Table-I results {bad} differ from the golden digests")
    clean = {key: r for key, r in got}
    print(f"service clean traffic on {card}: {len(requests)} requests ({len(graph_of)} distinct, "
          f"each twice; {SERVICE_THREADS} threads, {SERVICE_WINDOW} in flight each, max_batch 16, "
          f"max_wait_ms 2) in {wall:.3f} s: {len(requests) / wall:.2f} requests/s, p50 "
          f"{st.p50_ms:.2f} ms, p99 {st.p99_ms:.2f} ms, mean {st.mean_ms:.2f} ms; {st.batches} "
          f"batches (full {st.flush_full}, max_wait {st.flush_deadline}, drain {st.flush_drain}, "
          f"largest {st.max_batch_observed}); misses {st.cache_misses}, hits {st.cache_hits}, "
          f"dedups {st.dedup_hits}; all served by the policy rung, 0 degraded / failed / retried "
          f"/ restarted; results equal schedule_many's and the ten golden digests; launches "
          f"{ran}; no kernel built or loaded after warmup", flush=True)

    # ---- 3. the seeded fault replay ------------------------------------ #
    sched.clear_cache()
    timer = FallbackTimer(sched)
    faulty = FaultyScheduler(timer, FaultPlan.random(**SOAK))
    cfg = DegradeConfig(retry_attempts=1, retry_backoff_s=0.001, retry_backoff_max_s=0.002,
                        restart_backoff_s=0.01, restart_backoff_max_s=0.05)
    svc = SchedulerService(faulty, max_batch=4, max_wait_ms=1, degrade=cfg)
    got, wall = drive(svc, requests)
    check(svc.close(timeout=300), "the fault replay did not drain")
    st = svc.stats()
    check(len(got) == len(requests) and st.requests == len(requests) and drained(st)
          and st.failed == 0, f"fault replay: {len(got)} results of {len(requests)}, "
          f"stats {st.as_dict()}")
    check(len(faulty.fired) > 0, "fault replay: no fault fired")
    by_rung: dict = {}
    for key, r in got:
        by_rung.setdefault(r["served_by"], []).append((key, r))
    check(set(by_rung) <= {"policy", "fallback", "heuristic"}, f"rungs {set(by_rung)}")
    bad = [key for key, r in got if not (numpy_only(r) and validate_monotone(
        graph_of[key], r["assignment"], setting[key[0]][0]))]
    check(not bad, f"fault replay: results {bad[:5]} are not valid monotone schedules")
    bad = [key for key, r in by_rung.get("policy", [])
           if not same(r, clean[key]["order"], clean[key]["assignment"])]
    check(not bad, f"fault replay: policy results {bad[:5]} differ from the clean phase's")
    fb_want = {}
    for key, _ in by_rung.get("fallback", []):
        label, i = key
        if label == "table1":
            fb_want[key] = tuple(fb_gold["table1"][names[i]][h]
                                 for h in ("order_sha256", "assign_sha256"))
        elif label == "synth":
            fb_want[key] = tuple(fb_gold["synthetic"][h][i]
                                 for h in ("order_sha256", "assign_sha256"))
    # no golden digests for the heterogeneous and k = 3 requests: the CPU
    # plain path's fallback rung, once per group that reached the rung
    for label in {key[0] for key, _ in by_rung.get("fallback", [])} - {"table1", "synth"}:
        gs, k, system = groups[label]
        for i, r in enumerate(cpu.fallback_schedule_many(gs, k, system)):
            fb_want[(label, i)] = (digest(r["order"]), digest(r["assignment"]))
    bad = [key for key, r in by_rung.get("fallback", [])
           if (digest(r["order"]), digest(r["assignment"])) != fb_want[key]]
    check(not bad, f"fault replay: fallback results {bad[:5]} differ from the seeded golden "
          "file or the CPU plain path's fallback rung")
    fb_cpu = sorted({key[0] for key, _ in by_rung.get("fallback", [])} - {"table1", "synth"})
    bad = [key for key, r in by_rung.get("heuristic", [])
           if not same(r, *heuristic_schedule_many([graph_of[key]], *setting[key[0]])[0])]
    check(not bad, f"fault replay: heuristic results {bad[:5]} differ from "
          "heuristic_schedule_many on the host")
    fb_launches = {k: sum(c[2][k] for c in timer.calls) for k in build.LAUNCHES}
    check(timer.calls and fb_launches["ptr_decode_cluster"] > 0,
          f"fault replay: the fallback rung ran {len(timer.calls)} calls launching {fb_launches}; "
          "expected B1 (ptr_decode_cluster) on the card")
    kinds = {kind: sum(f[2] == kind for f in faulty.fired) for kind in ("crash", "error", "slow",
                                                                         "corrupt")}
    (t_first, first_args, _), later = timer.calls[0], timer.calls[1:]
    n_first = len(first_args[0])
    t0 = time.perf_counter()
    sched.fallback_schedule_many(*first_args)          # the same call, weights drawn
    t_again = time.perf_counter() - t0
    later_pg = [t / len(args[0]) for t, args, _ in later]
    est = svc._estimator.snapshot()
    print(f"service fault replay on {card} (FaultPlan.random(seed=0, n_calls=40, p_crash 0.08, "
          f"p_error 0.15, p_slow 0.05, p_corrupt 0.08), max_batch 4, max_wait_ms 1): "
          f"{len(requests)} requests in {wall:.3f} s, 100% completed, {len(faulty.fired)} faults "
          f"fired {kinds}; served policy {len(by_rung.get('policy', []))}, fallback "
          f"{len(by_rung.get('fallback', []))}, heuristic {len(by_rung.get('heuristic', []))}; "
          f"retries {st.retries}, worker restarts {st.worker_restarts}, degraded for error "
          f"{st.degrade_error}, crash {st.degrade_crash}; policy results equal the clean "
          "phase's, fallback results the seeded golden file (Table-I, synthetic) or the CPU "
          f"plain path's fallback rung ({', '.join(fb_cpu) or 'none reached it'}), heuristic "
          "results the host's; the fallback rung launched "
          f"{fb_launches}", flush=True)
    print(f"fallback rung on {card}: first call {t_first:.4f} s for {n_first} graphs of "
          f"{sorted(g.n for g in first_args[0])} nodes ({t_first / n_first:.4f} s a graph; it "
          f"draws the seeded weights on the host), the same call again {t_again:.4f} s; the "
          f"{len(later)} later calls "
          + (f"{min(later_pg):.4f} - {max(later_pg):.4f} s a graph (median "
             f"{statistics.median(later_pg):.4f})" if later else "none")
          + f"; cost estimator after the replay (s a graph): "
          + ", ".join(f"{k} {v:.5f}" for k, v in sorted(est.items())), flush=True)

    # ---- 4. deadlines -------------------------------------------------- #
    sched.clear_cache()
    svc = SchedulerService(sched)
    roomy = table1 + synth[:16]
    res_roomy = [f.result(timeout=300)
                 for f in [svc.submit(g, STAGES, deadline_ms=60_000.0) for g in roomy]]
    late = synth[16:24]
    res_late = [f.result(timeout=300)
                for f in [svc.submit(g, STAGES, deadline_ms=0.001) for g in late]]
    check(svc.close(timeout=300), "the deadline service did not drain")
    st = svc.stats()
    wants = res_uniform[:len(table1)] + res_uniform[len(table1):len(table1) + 16]
    check(all(r["served_by"] == "policy" and r["deadline_met"] and same(r, w["order"],
                                                                        w["assignment"])
              for r, w in zip(res_roomy, wants)),
          "a generous deadline left the policy rung or changed a result")
    check(all(r["served_by"] == "heuristic" and not r["deadline_met"] for r in res_late)
          and st.degrade_deadline == len(late) == st.deadline_missed and drained(st),
          f"expired budgets: rungs {[r['served_by'] for r in res_late]}, stats {st.as_dict()}")
    print(f"service deadlines on {card}: {len(roomy)} requests with a 60 s budget stayed on the "
          f"policy rung, results unchanged; {len(late)} with an expired one went to the "
          f"heuristic floor (degrade_deadline {st.degrade_deadline}, deadline_missed "
          f"{st.deadline_missed}); the service phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del sched


# ---------------------------------------------------------------------- #
# the RL training engine: respect-v1's training configuration on the card
# ---------------------------------------------------------------------- #
TRAIN_GOLDEN = ROOT / "tests" / "golden" / "torch_train_steps.json"
TOL_TRAIN_REWARD = 1e-6   # reward means: exact per graph, summed over graphs in another order
TOL_TRAIN_REL = 1e-5      # loss, entropy, advantage, grad_norm, leaf norms: float32 sums
TOL_TRAIN_PARAM = 1e-5    # parameter entries: float32 gradient sums through Adam's lr / eps
TRAIN_DRAWS = 3           # uniform draws at k = 4 (the golden steps are the first draw's)
PAPER = dict(hidden=256, batch=128, n=30)   # the paper's scale
WIDE_BATCH = 14   # bucket-32 graphs at hidden 256 in two waves of the wide template's 7 clusters
BF16_WIDE_BATCH = 16   # and in bf16, in two waves of its 14 (two blocks an SM)


def int_digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.asarray(a, dtype=np.int64).tobytes()).hexdigest()


def f32_digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<f4").tobytes()).hexdigest()


def golden_errors(want: dict, got: dict, after: dict) -> dict:
    """Checks one training step against its golden record (integers and
    per-graph rewards equal, floats within the TOL_TRAIN_* tolerances);
    returns the largest error of each kind."""
    import numpy as np
    for k, v in want.items():
        if k.endswith("sha256") or k in ("bucket_n", "batch"):
            check(got[k] == v, f"train golden: {k} differs")
    err = {"reward": 0.0, "rel": 0.0, "param": 0.0, "norm": 0.0}
    for k, v in want["metrics"].items():
        d = abs(got["metrics"][k] - v)
        if k.startswith("reward"):
            err["reward"] = max(err["reward"], d)
        else:
            err["rel"] = max(err["rel"], d / max(1.0, abs(v)))
    for k, v in want["leaf_norms"].items():
        err["norm"] = max(err["norm"], abs(np.linalg.norm(after[k].astype(np.float64)) - v) / v)
    for e in want["entries"]:
        err["param"] = max(err["param"], abs(float(after[e["leaf"]].reshape(-1)[e["index"]])
                                             - e["value"]))
    check(err["reward"] <= TOL_TRAIN_REWARD and err["rel"] <= TOL_TRAIN_REL
          and err["norm"] <= TOL_TRAIN_REL and err["param"] <= TOL_TRAIN_PARAM,
          f"train golden: errors {err} beyond rewards {TOL_TRAIN_REWARD}, metrics and norms "
          f"{TOL_TRAIN_REL} (relative), parameters {TOL_TRAIN_PARAM}")
    return err


def profile_ranges(fn, prefix: str, marks: bool = False):
    """One profiled call of ``fn``: its device kernels as (name, start, end)
    and its host ranges whose name starts with ``prefix`` (the trainer's
    ``record_function`` ranges) as (name, start, end), microseconds, by
    start.  The ranges' device-side annotations are not kernels.  With
    ``marks``, also the (start, end) of the spin kernels ``fn`` launched
    itself (``torch.cuda._sleep``, after its first other kernel): where
    device kernels must be divided, a mark divides them on the device's own
    clock, since the profiler's device times drift from its host clock late
    in a long process (a train step's first milliseconds of kernels have
    started before its first host range)."""
    import torch
    from torch.autograd import DeviceType
    with profiled() as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.name, e.time_range.start, e.time_range.end) for e in device_kernels(prof)
                      if not e.name.startswith(prefix)), key=lambda k: k[1])
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name.startswith(prefix) and e.device_type == DeviceType.CPU]
    ranges.sort(key=lambda k: k[1])
    if not marks:
        return kernels, ranges
    first = kernels[0][1] if kernels else float("inf")
    spins = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name
                   and e.time_range.start > first)
    return kernels, ranges, spins


def same_step(got: dict, want: dict, got_net, want_net) -> dict:
    """The largest error of one train step's metrics and parameters against
    another run of it, checked at the TOL_TRAIN_* tolerances."""
    import numpy as np
    from repro_torch.checkpoint.manager import flatten_leaves
    from repro_torch.core.ptrnet import param_tree
    err = {"reward": 0.0, "rel": 0.0, "param": 0.0}
    for k, v in want.items():
        d = abs(got[k] - v)
        if k.startswith("reward"):
            err["reward"] = max(err["reward"], d)
        else:
            err["rel"] = max(err["rel"], d / max(1.0, abs(v)))
    a, b = flatten_leaves(param_tree(got_net)), flatten_leaves(param_tree(want_net))
    check([n for n, _ in a] == [n for n, _ in b], "parameter trees differ")
    for (_, x), (_, y) in zip(a, b):
        err["param"] = max(err["param"], float(np.abs(x - y).max()))
    return err


def train_phase(card: str) -> None:
    """Drives the port's RLTrainer on the card at respect-v1's training
    configuration (see the module docstring, item 13) with the launch
    counters reset just before and read just after."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.core import DagSampler, PipelineSystem, prng
    from repro_torch.core import rl
    from repro_torch.checkpoint.manager import flatten_leaves
    from repro_torch.core.batching import bucketize
    from repro_torch.core.ptrnet import param_tree
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import decode_template, wide_clusters

    gold = json.loads(TRAIN_GOLDEN.read_text())
    c = gold["meta"]["config"]
    system = PipelineSystem(c["n_stages"])
    hsys = PipelineSystem(**HETERO)
    root = prng.PRNGKey(c["key_seed"])
    t_phase = time.perf_counter()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    tt = rl.RLTrainer(system=system, hidden=c["hidden"], lr=c["lr"], seed=c["seed"],
                      stage_counts=tuple(c["stage_counts"]))
    check(tt.device.type == "cuda" and tt.params.dec0.is_cuda, "trainer is not on the card")
    sampler = DagSampler(seed=c["seed"], n=tuple(c["n"]))
    stream = sampler.packed_stream(c["batch"], c["n_stages"], system=system,
                                   batches_per_epoch=TRAIN_DRAWS, epochs=1)

    # ---- the uniform feed: the golden steps, then the rest of the draws #
    errs = {"reward": 0.0, "rel": 0.0, "param": 0.0, "norm": 0.0}
    by_bucket: dict[int, list[tuple[float, float]]] = {}
    step = 0
    for pack in stream:
        key = prng.fold_in(root, step)
        if step < len(gold["steps"]):
            want = gold["steps"][step]
            got = {"bucket_n": pack.bucket_n, "batch": pack.batch,
                   "n_valid_sha256": int_digest(pack.n_valid),
                   "label_assign_sha256": int_digest(pack.label_assign)}
            keys = rl._split(key, pack.batch)
            with torch.no_grad():
                sampled = rl._policy_rewards(tt.params, pack, keys, c["n_stages"], system, True)
                impl = rl._resolve(tt.baseline_params, pack.to("cuda"), False)
                base = rl._policy_rewards(tt.baseline_params, pack, keys, c["n_stages"], system,
                                          False, impl)
                b1_sampled = rl.make_rollout_fn(c["n_stages"], system, sample=True,
                                                decode_impl="kernel")(tt.params, pack, key)
            valid = pack.valid_mask().to("cuda")
            for prefix, (r, _, _, o, a) in (("sample", sampled), ("baseline", base)):
                got[f"{prefix}_order_sha256"] = int_digest(torch.where(valid, o, -1).cpu())
                got[f"{prefix}_assign_sha256"] = int_digest(a.cpu())
                got[f"{prefix}_rewards_sha256"] = f32_digest(r.cpu())
            check(int_digest(torch.where(valid, b1_sampled[3], -1).cpu())
                  == want["sample_order_sha256"],
                  f"train golden step {step}: B1's sampled rollout differs from the scan's orders")
        before = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tt.train_step(pack, key, n_stages=c["n_stages"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ran = {t: ops.LAUNCHES[t] - before[t] for t in ops.LAUNCHES}
        check(ran["ptr_decode_cluster"] == 1 and ran["ptr_step"] == 0,
              f"train step {step} (bucket {pack.bucket_n}): launches {ran}, expected one "
              "ptr_decode_cluster in the baseline pass")
        by_bucket.setdefault(pack.bucket_n, []).append((dt, m["n_graphs"]))
        if step < len(gold["steps"]):
            got["metrics"] = m
            after = dict(flatten_leaves(param_tree(tt.params)))
            e = golden_errors(gold["steps"][step], got, after)
            errs = {k2: max(errs[k2], e[k2]) for k2 in errs}
        step += 1
    check(step > len(gold["steps"]), "the uniform feed ran no step past the golden ones")
    print(f"train golden on {card}: the first {len(gold['steps'])} steps of respect-v1's training "
          f"configuration (hidden {c['hidden']}, batch {c['batch']}, lr {c['lr']}, |V| "
          f"{c['n'][0]}-{c['n'][1]}) equal tests/golden/torch_train_steps.json: labels, sampled "
          "and baseline orders, assignments and per-graph rewards; B1's sampled rollout equals "
          f"the scan's orders; max error reward means {errs['reward']:.2e} (tolerance "
          f"{TOL_TRAIN_REWARD}), loss/entropy/advantage/grad_norm {errs['rel']:.2e} relative "
          f"({TOL_TRAIN_REL}), leaf norms {errs['norm']:.2e} relative ({TOL_TRAIN_REL}), "
          f"parameter entries {errs['param']:.2e} ({TOL_TRAIN_PARAM})", flush=True)
    for bn in sorted(by_bucket):
        ts = [dt for dt, _ in by_bucket[bn]]
        gps = [g / dt for dt, g in by_bucket[bn]]
        print(f"train steps bucket {bn} on {card}: {len(ts)} steps, "
              f"{statistics.median(ts) * 1e3:.2f} ms a step (median; min {min(ts) * 1e3:.2f}, "
              f"max {max(ts) * 1e3:.2f}), {statistics.median(gps):.1f} training graphs/s "
              "(median, real graphs only)", flush=True)

    # ---- one draw at each other stage count ---------------------------- #
    for i, k in enumerate(kk for kk in c["stage_counts"] if kk != c["n_stages"]):
        other = DagSampler(seed=c["seed"], n=tuple(c["n"]))
        other.restore({"seed": c["seed"], "count": TRAIN_DRAWS + i})
        for pack in other.packed_stream(c["batch"], k, system=system, batches_per_epoch=1,
                                        epochs=1):
            m = tt.train_step(pack, prng.fold_in(root, step), n_stages=k)
            check(all(np.isfinite(v) for v in m.values()), f"k = {k}: metrics {m}")
            step += 1
    print(f"train stage counts on {card}: one draw at each of k = "
          f"{[kk for kk in c['stage_counts'] if kk != c['n_stages']]} ({step} steps in all), "
          "metrics finite", flush=True)

    # ---- a heterogeneous step: B2 in the baseline, w_sys learns ------- #
    # the same step from a CPU copy of the trainer's state (the plain path)
    # holds the card's B2 baseline, advantage, gradient and update
    hpack = DagSampler(seed=7, n=tuple(c["n"])).next_packed_batch(c["batch"], c["n_stages"],
                                                                  system=hsys)
    w_sys = tt.params.w_sys.detach().clone()
    o = tt.state.opt_state
    cpu = lambda t: None if t is None else t.cpu()
    cpu_state = (copy.deepcopy(tt.params).to("cpu"), rl._frozen_copy(tt.baseline_params).to("cpu"),
                 optim.OptState(step=o.step.cpu(), mu=optim.tree_map(cpu, o.mu),
                                nu=optim.tree_map(cpu, o.nu),
                                master=None if o.master is None else optim.tree_map(cpu, o.master)))
    hkey = prng.fold_in(root, step)
    before = dict(ops.LAUNCHES)
    hstep = rl.make_train_step(c["n_stages"], hsys, tt.optimizer)
    _, tt.state.opt_state, hm = hstep(tt.params, tt.baseline_params, tt.state.opt_state, hpack,
                                      hkey)
    torch.cuda.synchronize()
    ran = {t: ops.LAUNCHES[t] - before[t] for t in ops.LAUNCHES}
    check(ran["ptr_step"] == hpack.bucket_n and ran["ptr_decode_cluster"] == 0,
          f"heterogeneous train step: launches {ran}, expected {hpack.bucket_n} ptr_step (one a "
          "step of the baseline's scan) and no B1")
    moved = float((tt.params.w_sys.detach() - w_sys).abs().max())
    check(moved > 0, "heterogeneous train step: w_sys did not move")
    hm = {k: float(v) for k, v in hm.items()}
    cpu_net = cpu_state[0]
    _, _, cm = hstep(*cpu_state, hpack, hkey)
    herr = same_step(hm, {k: float(v) for k, v in cm.items()}, tt.params, cpu_net)
    check(herr["reward"] <= TOL_TRAIN_REWARD and herr["rel"] <= TOL_TRAIN_REL
          and herr["param"] <= TOL_TRAIN_PARAM,
          f"heterogeneous train step: card against the CPU plain path, errors {herr} beyond "
          f"rewards {TOL_TRAIN_REWARD}, metrics {TOL_TRAIN_REL} (relative), parameters "
          f"{TOL_TRAIN_PARAM}; card {hm}, CPU {cm}")
    print(f"train heterogeneous step on {card}: bucket {hpack.bucket_n}, B={hpack.batch}, "
          f"{ran['ptr_step']} ptr_step launches in the baseline's scan, reward sample "
          f"{hm['reward_sample']:.4f} baseline {hm['reward_baseline']:.4f}, advantage "
          f"{hm['advantage']:.4f}, w_sys moved by up to {moved:.3e}; held to the same step from "
          f"a CPU copy of the state (plain path): reward means {herr['reward']:.2e} "
          f"({TOL_TRAIN_REWARD}), loss/entropy/advantage/grad_norm {herr['rel']:.2e} relative "
          f"({TOL_TRAIN_REL}), every parameter {herr['param']:.2e} ({TOL_TRAIN_PARAM})",
          flush=True)
    del cpu_state, cpu_net

    # ---- the paper's scale: hidden 256, batch 128, |V| = 30 ------------ #
    wide = rl.RLTrainer(system=system, hidden=PAPER["hidden"], lr=c["lr"], seed=c["seed"])
    ppack = DagSampler(seed=c["seed"], n=PAPER["n"]).next_packed_batch(PAPER["batch"],
                                                                       c["n_stages"])
    impl = rl._resolve(wide.baseline_params, ppack.to("cuda"), False)
    tmpl = (decode_template(ppack.bucket_n, PAPER["hidden"], batch=ppack.batch,
                            clusters=wide_clusters(ppack.bucket_n, PAPER["hidden"], 6))
            if impl == "kernel" else "ptr_step")
    before = dict(ops.LAUNCHES)
    times = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm = wide.train_step(ppack, prng.fold_in(root, 1000 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ran = {t: ops.LAUNCHES[t] - before[t] for t in ops.LAUNCHES}
    check(ran[tmpl] == (2 if impl == "kernel" else 2 * ppack.bucket_n),
          f"paper-scale step: launches {ran}, expected {tmpl}")
    print(f"train paper scale on {card}: hidden {PAPER['hidden']}, B={ppack.batch}, |V| = "
          f"{PAPER['n']} (bucket {ppack.bucket_n}, dense {ppack.dense}): baseline decode {impl} "
          f"({tmpl}); {times[0] * 1e3:.2f} ms the first step, {times[1] * 1e3:.2f} ms the second "
          f"({ppack.batch / times[1]:.1f} training graphs/s), loss {pm['loss']:.4f}", flush=True)
    del wide

    # ---- held-out eval: 128 graphs per stage count, against the CPU ---- #
    cpu_net = rl._frozen_copy(tt.params).to("cpu")
    evals = []
    for k in c["stage_counts"]:
        epack = DagSampler(seed=c["seed"] + 1, n=tuple(c["n"])).next_packed_batch(128, k)
        before = ops.LAUNCHES["ptr_decode_cluster"]
        got = tt.evaluate(epack, n_stages=k)
        check(ops.LAUNCHES["ptr_decode_cluster"] - before == 1, f"eval k = {k}: no B1 launch")
        want = rl.make_eval_fn(k, system)(cpu_net, epack)
        check(got["exact_match"] == float(want["exact_match"])
              and abs(got["reward_greedy"] - float(want["reward_greedy"])) <= TOL_TRAIN_REWARD,
              f"eval k = {k}: card {got}, CPU plain path {want}")
        evals.append(f"k={k} reward {got['reward_greedy']:.4f} exact-match "
                     f"{got['exact_match']:.4f}")
    print(f"train held-out eval on {card} (128 graphs a stage count, bucket {epack.bucket_n}, B1; "
          f"equal to the CPU plain path): " + "; ".join(evals), flush=True)

    # ---- save and restore: bit for bit --------------------------------- #
    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    tt.consider_baseline(0.5)
    tt.save(ckpt)
    back = rl.RLTrainer(system=system, hidden=c["hidden"], lr=c["lr"], seed=c["seed"] + 1,
                        stage_counts=tuple(c["stage_counts"]))
    check(back.restore(ckpt) == tt.step_count, "restore returned another step")
    a, b = flatten_leaves(tt.state.tree()), flatten_leaves(back.state.tree())
    same = all(x.dtype == y.dtype and x.tobytes() == y.tobytes() for (_, x), (_, y) in zip(a, b))
    check(len(a) == 67 and [n for n, _ in a] == [n for n, _ in b] and same,
          "save/restore: the restored trainer state differs")
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"train save/restore on {card}: {len(a)} leaves (the reference's names) bit-equal after "
          f"a round trip at step {tt.step_count}", flush=True)
    launches = dict(ops.LAUNCHES)
    t_phase = time.perf_counter() - t_phase
    print(f"train phase launches: {launches}", flush=True)

    # ---- where a bucket-64 step's time goes; the device's idle share --- #
    # one profiled pack and train_step: the trainer's rl.* ranges on the
    # host clock (not synchronized: a range that waits on the device holds
    # the wait), the step's kernels on the device
    graphs = DagSampler(seed=c["seed"], n=tuple(c["n"])).next_batch(c["batch"])
    big = [graphs[i] for i in bucketize(graphs)[64]]

    def pack_and_step():
        spack = rl.pack_graphs(big, c["n_stages"], system).to("cuda")
        tt.train_step(spack, prng.fold_in(root, 2001), n_stages=c["n_stages"])

    kernels, ranges = profile_ranges(pack_and_step, "rl.")
    step_ranges = [r for r in ranges if r[0] == "rl.train_step"]
    names = {r[0][3:] for r in ranges}
    check(len(step_ranges) == 1 and names <= set(rl.SPANS),
          f"profiled train step: ranges {sorted(names)} (expected one train_step, of {rl.SPANS})")
    _, s0, s1 = step_ranges[0]
    kernels = [k for k in kernels if k[1] >= s0]
    split: dict[str, float] = {}
    for name, st, en in ranges:
        if name != "rl.train_step":
            split[name[3:]] = split.get(name[3:], 0.0) + (en - st) / 1e3
    total = (s1 - s0) / 1e3
    label = split.pop("label")
    split["other"] = total - sum(split.values())
    busy, window = busy_window([(st, en) for _, st, en in kernels])
    b1_ms = sum(en - st for nm, st, en in kernels if "ptr_decode" in nm) / 1e3
    check(any("ptr_decode_cluster" in nm for nm, _, _ in kernels),
          "profiled train step ran no ptr_decode_cluster kernel")
    print(f"train step split, bucket 64 (B={len(big)}, hidden {c['hidden']}) on {card}, from one "
          f"profiled train_step (the trainer's rl.* ranges, host clock): step {total:.2f} ms = "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
          + f"; label (pack_graphs, before the step) {label:.2f} ms; device: {len(kernels)} "
          f"kernels, busy {busy / 1e3:.2f} ms of a {window / 1e3:.2f} ms window (idle "
          f"{100 * (1 - busy / window):.1f}%), B1 (baseline) {b1_ms:.4f} ms of device time",
          flush=True)
    print(f"train phase on {card}: {t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------- #
# the gap-to-optimal eval and the release trainer
# ---------------------------------------------------------------------- #
EVAL_BENCH = ROOT / "BENCH_eval.json"
EVAL_RTOL = 1e-12   # float64 re-derivations from equal integer assignments
# the size ramp off: inside it the first draws hold 5-6 nodes, every reward is
# 1.0 and the weights would not move
RELEASE_ARGS = ["--max-steps", "6", "--eval-every", "3", "--batch", "16", "--n-max", "20",
                "--stage-counts", "2,4", "--ramp-batches", "1"]


def eval_divergence(card, cpu) -> str:
    """The first graph of the eval tiers whose respect schedule from the
    scheduler ``card`` differs from the CPU plain path's (``cpu``), with
    :func:`first_divergence` there."""
    import numpy as np
    from repro_torch.core import PipelineSystem
    from repro_torch.eval import generalization_grid, hetero_grid, scenario_grid
    for sc in (scenario_grid(smoke=True) + hetero_grid(smoke=True)
               + generalization_grid(smoke=True)):
        graphs = sc.build()
        system = (sc.resolve_system(graphs) if hasattr(sc, "resolve_system")
                  else PipelineSystem(sc.n_stages))
        got = card.schedule_many(graphs, sc.n_stages, system, use_cache=False)
        want = cpu.schedule_many(graphs, sc.n_stages, system, use_cache=False)
        for i, (g, r, w) in enumerate(zip(graphs, got, want)):
            if not (np.array_equal(r["order"], w["order"])
                    and np.array_equal(r["assignment"], w["assignment"])):
                cond = None if system.is_uniform else system
                return (f"{sc.name} graph {i} (n = {g.n}): "
                        f"{first_divergence(cpu.net, g, r['order'], cpu.max_deg, cond)}")
    return "every respect schedule equals the CPU plain path's"


def eval_phase(card: str, table1, synth) -> None:
    """The three smoke eval tiers on the card, held to BENCH_eval.json, with
    the launch counters reset just before and read just after each; then a
    short run of the release trainer on the card (see the module docstring,
    item 14)."""
    import numpy as np
    import torch
    from repro_torch import train_release
    from repro_torch.checkpoint import params_sha256, verify_release
    from repro_torch.core import RespectScheduler
    from repro_torch.core.batching import bucketize
    from repro_torch.core.ptrnet import param_tree
    from repro_torch.eval import (ExactOracle, check_generalization, check_hetero,
                                  check_results, diff_results, generalization_grid, hetero_grid,
                                  run_generalization, run_grid, scenario_grid, summarize,
                                  summarize_hetero)
    from repro_torch.eval.__main__ import BB_BUDGET_S, BB_MAX_N
    from repro_torch.kernels.ptr import ops

    bench = json.loads(EVAL_BENCH.read_text())
    t_phase = time.perf_counter()
    sched = RespectScheduler.from_release()
    oracle = ExactOracle()
    check(sched.device.type == "cuda" and oracle.device.type == "cuda",
          "eval: scheduler or oracle is not on the card")
    uniform, hetero, gen = (scenario_grid(smoke=True), hetero_grid(smoke=True),
                            generalization_grid(smoke=True))

    def buckets(scs):
        return [bn for sc in scs for bn in bucketize(sc.build())]

    # respect runs twice a grid scenario (an untimed warm call, then the timed
    # one), once a generalization scenario: one B1 launch a bucket a call on
    # a uniform system, one B2 launch a step (bucket_n) on a conditioned one
    runs = {
        "uniform": (lambda: run_grid(uniform, sched, oracle, bb_max_n=BB_MAX_N,
                                     bb_budget_s=BB_BUDGET_S),
                    {"ptr_decode_cluster": 2 * len(buckets(uniform)), "ptr_step": 0}),
        "hetero": (lambda: run_grid(hetero, sched, oracle, bb_max_n=BB_MAX_N,
                                    bb_budget_s=BB_BUDGET_S),
                   {"ptr_decode_cluster": 0, "ptr_step": 2 * sum(buckets(hetero))}),
        "gen": (lambda: run_generalization(sched, gen),
                {"ptr_decode_cluster": len(buckets(gen)), "ptr_step": 0}),
    }
    tiers, times = {}, {}
    for label, (fn, want) in runs.items():
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        tiers[label] = fn()
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        ran = dict(ops.LAUNCHES)
        check(ran["ptr_decode_block"] == 0
              and all(ran[k] == v for k, v in want.items()) and sum(want.values()) > 0,
              f"eval {label} tier: launches {ran}, expected {want} and no ptr_decode_block")
        print(f"eval {label} tier on {card}: {times[label]:.2f} s; B1 (ptr_decode_cluster) "
              f"{ran['ptr_decode_cluster']} launches, B2 (ptr_step) {ran['ptr_step']} launches",
              flush=True)

    meta = {"smoke": True, "trained_agent": sched.release is not None, "bb_max_n": BB_MAX_N,
            "n_scenarios": len(uniform)}
    summary = summarize(tiers["uniform"], meta, generalization=tiers["gen"])
    summary.update(summarize_hetero(tiers["hetero"]))
    diffs = diff_results(json.loads(json.dumps(summary)), bench, rtol=EVAL_RTOL)
    problems = (check_results(tiers["uniform"]) + check_hetero(tiers["hetero"])
                + check_generalization(tiers["gen"]))
    if diffs or problems:
        print("eval: " + "; ".join(diffs[:10] + problems[:10]), flush=True)
        print("eval first_divergence: "
              + eval_divergence(sched, RespectScheduler.from_release(device="cpu")), flush=True)
    check(not problems, f"eval checks failed: {problems}")
    check(not diffs, f"eval tiers differ from BENCH_eval.json in {len(diffs)} fields")
    print(f"eval on {card}: the three smoke tiers equal BENCH_eval.json in every non-timing "
          f"field (floats within {EVAL_RTOL} relative): match_rate_respect "
          f"{summary['match_rate_respect']!r}, table1_matches_k4 {summary['table1_matches_k4']}, "
          f"hetero_match_rate_respect {summary['hetero_match_rate_respect']!r}, "
          f"gen_gap_mean_respect {summary['gen_gap_mean_respect']!r}; check_results, "
          "check_hetero and check_generalization find no problem", flush=True)
    for label in ("uniform", "hetero"):
        res = tiers[label]
        print(f"eval {label} speedups on {card}: speedup_oracle_batched "
              f"{res['speedup_oracle_batched']!r} (host exact_dp {res['t_exact_host_s']:.4f} s, "
              f"oracle on the card {res['t_exact_device_s']:.4f} s), speedup_respect_vs_exact "
              f"{res['speedup_respect_vs_exact']!r} (respect "
              f"{res['aggregate']['respect']['t_s']:.4f} s); BENCH_eval.json's (the JAX "
              f"package on a CPU): {bench['speedup_oracle_batched']!r}, "
              f"{bench['speedup_respect_vs_exact']!r}", flush=True)

    # ---- a short run of the release trainer on the card ----------------- #
    out = ROOT / "build" / "chip_smoke_release"
    shutil.rmtree(out, ignore_errors=True)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    rc = train_release.main(RELEASE_ARGS + ["--out", str(out / "rel"), "--ckpt-dir",
                                            str(out / "ckpt"), "--label-cache",
                                            str(out / "labels")])
    torch.cuda.synchronize()
    t_rel = time.perf_counter() - t0
    ran = dict(ops.LAUNCHES)
    check(rc == 0, f"release trainer exited {rc}")
    check(ran["ptr_decode_cluster"] > 0 and ran["ptr_step"] == 0,
          f"release trainer: launches {ran}, expected B1 in its baselines and evals")
    _, manifest = verify_release(out / "rel")        # the port's reader: the sha256 check
    check(manifest["train"]["steps"] == 6, f"release trainer: {manifest['train']['steps']} steps")
    init = RespectScheduler.init(seed=0, hidden=128, device="cpu").net
    check(manifest["params_sha256"] != params_sha256(param_tree(init)),
          "release trainer: the weights did not move off their seeded init")
    on_card = RespectScheduler.from_release(out / "rel")
    on_cpu = RespectScheduler.from_release(out / "rel", device="cpu")
    check(on_card.device.type == "cuda"
          and on_card.release["params_sha256"] == on_cpu.release["params_sha256"]
          == manifest["params_sha256"], "release: the card and the CPU loaded other weights")
    for label, graphs in (("Table-I", table1), ("synthetic", synth)):
        got = on_card.schedule_many(graphs, STAGES, use_cache=False)
        want = on_cpu.schedule_many(graphs, STAGES, use_cache=False)
        bad = [f"{i}: {first_divergence(on_cpu.net, g, r['order'], on_cpu.max_deg)}"
               for i, (g, r, w) in enumerate(zip(graphs, got, want))
               if not (np.array_equal(r["order"], w["order"])
                       and np.array_equal(r["assignment"], w["assignment"]))]
        check(not bad, f"release, {label}: card and CPU differ:\n  " + "\n  ".join(bad))
    shutil.rmtree(out, ignore_errors=True)
    print(f"release trainer on {card}: {' '.join(RELEASE_ARGS)} in {t_rel:.2f} s (B1 "
          f"{ran['ptr_decode_cluster']} launches), sha256 verified, loaded on the card and the "
          f"CPU, the {len(table1)} Table-I and {len(synth)} synthetic schedules equal", flush=True)
    print(f"eval phase on {card}: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------- #
# the LM zoo's serving path: zamba2-7b, kernels B3 (flash) and B4 (SSD)
# ---------------------------------------------------------------------- #
ZOO_ARCH = "zamba2-7b"
ZOO_PARAMS = 5_768_654_656     # count_params of the full config (the JAX package's count)
SERVE = ((2, 2048), (1, 1000))  # (batch, prompt tokens) of the served run; 1000: ragged
DECODE_STEPS = 16
PER_PREFILL = {"flash_fwd": 13, "ssd_scan": 68}   # 13 "A" sites, 13 x 5 + 3 "m" layers
# |got - want| <= atol + rtol * |want|.  A bf16 output of the kernel and of its
# plain version round float32 sums taken in another order, so they may differ
# by one bf16 step, 2^-7 = 7.8e-3 of the value (measured: one step, 1.95e-3 at
# most for flash and 0.25 at |y| >= 32 for the SSD scan, on an H100); rtol 8e-3
# holds exactly that one step at any magnitude, atol 4e-3 the values near 0.
TOL_BF16_OUT = (4e-3, 8e-3)
TOL_SSD_STATE = (1e-4, 1e-4)   # float32 state, sums in another order (measured <= 1.05e-5)
TOL_ZOO_F32 = 1e-4             # x max(1, |logits|): float32 logits through a full-width unit
                               # (measured 1.35e-5 at |logits| <= 4; a bf16 slip is ~1e-3)


def flash_work(b, hq, hkv, sq, sk, d, dv, itemsize, causal: bool = True) -> tuple[float, float]:
    """(bytes, flops) of an attention: q, k, v read once, o written once;
    the two products over the (query, key) pairs the mask keeps (the
    kernel module's formula)."""
    from repro_torch.kernels.flash.kernel import attention_flops
    flops = attention_flops(b, hq, sq, sk, d, dv, causal)
    return itemsize * b * (hq * sq * d + hkv * sk * (d + dv) + hq * sq * dv), flops


def ssd_work(bt, s, h, p, g, n, q, itemsize, in_scale: bool) -> tuple[float, float]:
    """(bytes, flops) of an SSD scan: x, B, C, dt (and in_scale) read once, y
    and the final state written once; per chunk the lower triangle of
    C B^T and of its product with x, and the two (N, P) state products (the
    kernel module's formula)."""
    from repro_torch.kernels.ssd.kernel import scan_flops
    nbytes = (itemsize * bt * s * (2 * h * p + 2 * g * n) + 4 * bt * s * h * (2 if in_scale else 1)
              + 4 * h + 4 * bt * h * n * p)
    return nbytes, scan_flops(bt, s, h, p, n, q)


def plain_flash(q, k, v, *, causal=True, scale=None, return_lse=False):
    from repro_torch.kernels.flash.ref import attention_with_lse, reference_attention
    if return_lse:
        return attention_with_lse(q, k, v, causal=causal, scale=scale)
    return reference_attention(q, k, v, causal=causal, scale=scale)


# B4's tiled templates (N or P above 128), by exact profiler name: neither name holds the other
SSD_TILED_BF16, SSD_TILED_F32 = "ssd_scan_tiled_bf16_kernel", "ssd_scan_tiled_kernel"
# seconds spent in ssd_templates' profiled windows, printed with the whole run's time
SSD_NAME_CHECK_S = [0.0]
# host-clock seconds of each phase of run_phases, printed with the whole run's time
PHASE_S: dict = {}


def clocked(name: str, fn, *args):
    """``fn(*args)``, its host-clock seconds kept under ``name`` in
    :data:`PHASE_S`."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[name] = round(time.perf_counter() - t0, 1)


def ssd_templates(fn, calls: int = 10) -> dict[str, tuple[int, float]]:
    """{kernel name: (count, mean device ms)} of the SSD scan kernels in one
    profiled window of ``calls`` calls of ``fn`` (a late window may lose its
    first kernels: the counts are at most ``calls``)."""
    import torch
    t0 = time.perf_counter()
    with profiled() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen: dict[str, list[float]] = {}
    for e in device_kernels(prof):
        if "ssd_scan" in e.name:
            seen.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    SSD_NAME_CHECK_S[0] += time.perf_counter() - t0
    return {k: (len(v), sum(v) / len(v)) for k, v in seen.items()}


def only_template(seen: dict, want: str, label: str) -> None:
    """Fail unless every SSD kernel of ``seen`` (ssd_templates) is ``want``."""
    names = {k.split("(")[0].split("<")[0].split()[-1] for k in seen}
    check(names == {want}, f"{label}: SSD kernels {sorted(seen)}, expected only {want}")


def plain_ssd(x, dt, A, B, C, *, chunk, in_scale=None):
    from repro_torch.kernels.ssd.ref import ssd_chunked
    y, hf = ssd_chunked(x, dt, A, B, C, chunk=chunk, in_scale=in_scale)
    return y.to(x.dtype), hf


def plain_kernels():
    """The zoo ops' plain versions in place of their CUDA launches (same
    padding and layout code around them, and the same autograd Functions
    under grad), for comparison only."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import vjp
    from repro_torch.kernels.ssd import ops as ssd_ops
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(flash_ops, "flash_attention_cuda", plain_flash))
    stack.enter_context(mock.patch.object(vjp, "flash_attention_cuda", plain_flash))
    stack.enter_context(mock.patch.object(ssd_ops, "ssd_scan_cuda", plain_ssd))
    return stack


def device_split(label: str, card: str, fn) -> list[str]:
    """Profile one call of ``fn`` and print where its device time goes (the
    two zoo kernels, cuBLAS matmuls, everything else, and the largest of the
    rest), with the device's busy and idle share of the kernels' window.
    Returns the names of the device kernels it ran."""
    import torch

    with profiled() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    kern = device_kernels(prof)
    if not kern:
        print(f"{label} time split: the profiler saw no device time (not measured)", flush=True)
        return []
    split = {"flash (B3)": 0.0, "ssd scan (B4)": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    other: dict[str, float] = {}
    spans = []
    for e in kern:
        name, us = e.name, e.time_range.elapsed_us()
        low = name.lower()
        spans.append((e.time_range.start, e.time_range.end))
        key = ("flash (B3)" if "flash_fwd" in low else "ssd scan (B4)" if "ssd_scan" in low
               else "matmul (cuBLAS)" if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass",
                                                                "cublas", "matmul"))
               else "other")
        split[key] += us
        if key == "other":
            other[name[:60]] = other.get(name[:60], 0.0) + us
    busy, window = busy_window(spans)
    total = sum(split.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
    print(f"{label} time split on {card} (torch.profiler, device time): "
          + ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
          + f"; {len(kern)} kernels, device busy {busy / 1e3:.2f} ms of a {window / 1e3:.2f} ms "
          f"window (idle {100 * (1 - busy / window):.1f}%), host {host * 1e3:.1f} ms profiled; "
          "largest other: " + ", ".join(f"{n} {v / 1e3:.2f} ms" for n, v in top), flush=True)
    return [e.name for e in kern]


def wall(fn, reps: int) -> float:
    """Median seconds of ``reps`` synchronized calls of ``fn`` (host clock)."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def serve_rates(label: str, card: str, model, params, batch: dict, max_len: int,
                steps: int = DECODE_STEPS) -> None:
    """Print prefill tokens/s (median of 3) and greedy decode tokens/s over
    ``steps`` steps of ``model`` on ``batch`` (host clock, synchronized);
    the VLM's patches count as prompt positions."""
    b, s = batch["tokens"].shape
    if "patches" in batch:
        s += batch["patches"].shape[1]
    t_pre = wall(lambda: model.prefill(params, batch, max_len=max_len), reps=3)
    logits, cache = model.prefill(params, batch, max_len=max_len)

    def decode():
        tok = logits.argmax(-1)
        for t in range(steps):
            tok = model.decode_step(params, tok, cache, s + t)[0].argmax(-1)
    t_dec = wall(decode, reps=1)
    print(f"{label} B={b} S={s} on {card}: prefill {t_pre * 1e3:.1f} ms = "
          f"{b * s / t_pre:.0f} tokens/s (median of 3); decode {steps} steps "
          f"{t_dec * 1e3:.1f} ms = {b * steps / t_dec:.1f} tokens/s "
          f"({t_dec / steps * 1e3:.2f} ms a step)", flush=True)


def zoo_phase(card: str) -> list[dict]:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models.model import build_model, count_params

    cfg = get_config(ZOO_ARCH)
    model = build_model(cfg)                                   # device: cuda
    check(count_params(model) == ZOO_PARAMS, f"{ZOO_ARCH}: parameter count differs")
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    print(f"zoo: {ZOO_ARCH} full config ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, {ZOO_PARAMS} parameters) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = {shape: torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).cuda()
               for shape in SERVE}

    # ---- the zoo's main path, counted: prefill then greedy decode ------- #
    for k in kbuild.LAUNCHES:
        kbuild.LAUNCHES[k] = 0
    for (b, s), tokens in prompts.items():
        before = dict(kbuild.LAUNCHES)
        logits, cache = model.prefill(params, {"tokens": tokens},
                                      max_len=s + DECODE_STEPS)
        torch.cuda.synchronize()
        mid = dict(kbuild.LAUNCHES)
        seq, tok = [logits], logits.argmax(-1)
        for t in range(DECODE_STEPS):
            logits, cache = model.decode_step(params, tok, cache, s + t)
            seq.append(logits)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        after = dict(kbuild.LAUNCHES)
        pre = {k: mid[k] - before[k] for k in PER_PREFILL}
        dec = {k: after[k] - mid[k] for k in PER_PREFILL}
        out = torch.cat(seq, dim=1).float()
        print(f"zoo served B={b} S={s}: prefill launches {pre}, {DECODE_STEPS} decode steps "
              f"launches {dec}; logits {tuple(out.shape)}", flush=True)
        check(pre == PER_PREFILL, f"prefill B={b} S={s}: launches {pre}, expected {PER_PREFILL}")
        check(not any(dec.values()), f"decode launched kernels {dec}")
        check(out.shape == (b, DECODE_STEPS + 1, cfg.vocab_size) and bool(torch.isfinite(out).all()),
              f"served B={b} S={s}: logits not finite or of the wrong shape")
        del cache, logits, seq
    launches = dict(kbuild.LAUNCHES)

    # ---- throughput, and where a prefill's device time goes ------------- #
    for (b, s), tokens in prompts.items():
        serve_rates("zoo serve", card, model, params, {"tokens": tokens}, s + DECODE_STEPS)
    b, s = SERVE[0]
    names = device_split(f"zoo prefill B={b} S={s}", card, lambda: model.prefill(
        params, {"tokens": prompts[(b, s)]}, max_len=s + DECODE_STEPS))
    if names:   # bf16 inputs run the tensor-core templates, and only those
        ran = {k: sum(k in n for n in names) for k in ("flash_fwd_bf16", "flash_fwd_f32",
                                                       "ssd_scan_bf16", "ssd_scan_f32",
                                                       SSD_TILED_BF16, SSD_TILED_F32)}
        print(f"zoo prefill B={b} S={s}: kernel templates launched {ran}", flush=True)
        check(ran == {"flash_fwd_bf16": PER_PREFILL["flash_fwd"], "flash_fwd_f32": 0,
                      "ssd_scan_bf16": PER_PREFILL["ssd_scan"], "ssd_scan_f32": 0,
                      SSD_TILED_BF16: 0, SSD_TILED_F32: 0},
              f"bf16 prefill ran {ran}, expected only the bf16 templates")
    logits, cache = model.prefill(params, {"tokens": prompts[(b, s)]}, max_len=s + DECODE_STEPS)
    device_split(f"zoo decode step B={b} kv_len={s}", card,
                 lambda: model.decode_step(params, logits.argmax(-1), cache, s))
    del cache, logits
    del params, prompts
    torch.cuda.empty_cache()

    # ---- each kernel against its plain version, at the path's shapes ---- #
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def within(got, want, tol):
        atol, rtol = tol
        got, want = got.float(), want.float()
        return bool(((got - want).abs() <= atol + rtol * want.abs()).all()), \
            float((got - want).abs().max())

    rows = []
    flash_err, flash_t = 0.0, None
    for label, b, hq, hkv, sq, sk, d, dv in (
            ("path", 2, 32, 32, 2048, 2048, 112, 112),
            ("GQA group 4, ragged", 1, 32, 8, 1000, 1000, 112, 112),
            ("Dv != D", 2, 32, 32, 1000, 1000, 112, 64),
            ("Sq < Sk", 2, 32, 32, 128, 2048, 112, 112)):
        # the path's layout: (B, S, H, D) activations viewed as (B, H, S, D)
        q = randn(b, sq, hq, d).transpose(1, 2)
        k = randn(b, sk, hkv, d).transpose(1, 2)
        v = randn(b, sk, hkv, dv).transpose(1, 2)
        got = flash_ops.flash_attention(q, k, v, causal=True)
        with plain_kernels():
            want = flash_ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ok, err = within(got, want, TOL_BF16_OUT)
        check(ok, f"flash {label}: kernel and plain version differ (max |err| {err:.3e})")
        flash_err = max(flash_err, err)
        print(f"flash {label} B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} Dv={dv} bf16: "
              f"max |err| {err:.3e} (tolerance atol, rtol {TOL_BF16_OUT})", flush=True)
        if label == "path":
            ev_ms = cuda_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True), iters=10)
            dev_ms = device_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True),
                               "flash_fwd_bf16", iters=10)
            ms = reported_ms(ev_ms, dev_ms)
            with plain_kernels():
                plain_ms = cuda_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True),
                                   iters=3)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                             iters=10)
            b_ms, b_by = bound(*flash_work(b, hq, hkv, sq, sk, d, dv, 2), BF16_FLOPS_PER_S)
            flash_t = (ms, plain_ms, b_ms, b_by, lib_ms)
            print(f"flash_fwd path shape on {card}: kernel {ev_ms:.4f} ms (CUDA events; device "
                  f"{dev_ms:.4f} ms), plain {plain_ms:.3f} ms, "
                  f"scaled_dot_product_attention {lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
    rows.append({"name": "flash_fwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash/csrc/flash_fwd.cu",
                 "replaces": "src/repro/kernels/flash/kernel.py:43",
                 "launches": launches["flash_fwd"], "max_abs_err": flash_err, "ms": flash_t[0],
                 "plain_ms": flash_t[1], "bound_ms": flash_t[2], "bound_by": flash_t[3],
                 "library_ms": flash_t[4]})

    ssd_err, ssd_t = 0.0, None
    d_inner, nh, g, n, p, chunk = 7168, 112, 2, 64, 64, 64
    for label, bt, s, scaled in (("path", 2, 2048, False), ("in_scale != dt", 2, 2048, True),
                                 ("ragged", 1, 1000, False)):
        # the path's layout: x, B and C are views into the conv output
        xbc = randn(bt, s, d_inner + 2 * g * n)
        x = xbc[..., :d_inner].reshape(bt, s, nh, p)
        Bm = xbc[..., d_inner: d_inner + g * n].reshape(bt, s, g, n)
        Cm = xbc[..., d_inner + g * n:].reshape(bt, s, g, n)
        dt = F.softplus(torch.randn((bt, s, nh), generator=gen, device="cuda") * 0.5 - 2.0)
        A = torch.exp(0.2 * torch.randn((nh,), generator=gen, device="cuda"))
        sc = (torch.rand((bt, s, nh), generator=gen, device="cuda") if scaled else None)
        args = (x, dt, A, Bm, Cm)
        y, hf = ssd_ops.ssd_scan(*args, chunk=chunk, in_scale=sc)
        with plain_kernels():
            wy, wh = ssd_ops.ssd_scan(*args, chunk=chunk, in_scale=sc)
        torch.cuda.synchronize()
        ok_y, err_y = within(y, wy, TOL_BF16_OUT)
        ok_h, err_h = within(hf, wh, TOL_SSD_STATE)
        check(ok_y and ok_h, f"ssd {label}: kernel and plain version differ "
              f"(y {err_y:.3e}, state {err_h:.3e})")
        ssd_err = max(ssd_err, err_y, err_h)
        print(f"ssd {label} Bt={bt} S={s} H={nh} P={p} N={n} G={g} chunk {chunk} bf16: max |err| "
              f"y {err_y:.3e} (tolerance atol, rtol {TOL_BF16_OUT}), state {err_h:.3e} "
              f"(tolerance {TOL_SSD_STATE})", flush=True)
        if label == "path":
            ev_ms = cuda_ms(lambda: ssd_ops.ssd_scan(*args, chunk=chunk), iters=10)
            dev_ms = device_ms(lambda: ssd_ops.ssd_scan(*args, chunk=chunk), "ssd_scan_bf16",
                               iters=10)
            ms = reported_ms(ev_ms, dev_ms)
            with plain_kernels():
                plain_ms = cuda_ms(lambda: ssd_ops.ssd_scan(*args, chunk=chunk), iters=2)
            b_ms, b_by = bound(*ssd_work(bt, s, nh, p, g, n, chunk, 2, False), BF16_FLOPS_PER_S)
            ssd_t = (ms, plain_ms, b_ms, b_by)
            print(f"ssd_scan path shape on {card}: kernel {ev_ms:.4f} ms (CUDA events; device "
                  f"{dev_ms:.4f} ms), plain {plain_ms:.3f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    rows.append({"name": "ssd_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd/kernel.py:41",
                 "launches": launches["ssd_scan"], "max_abs_err": ssd_err, "ms": ssd_t[0],
                 "plain_ms": ssd_t[1], "bound_ms": ssd_t[2], "bound_by": ssd_t[3],
                 "library_ms": None})

    # ---- one full-width unit in float32: kernels against plain versions  #
    cfg6 = cfg.scaled(n_layers=6, dtype="float32")
    m6 = build_model(cfg6)
    p6 = m6.init_params(seed=1)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 1000))).cuda()
    before = dict(kbuild.LAUNCHES)
    got, _ = m6.prefill(p6, {"tokens": tokens})
    mid = dict(kbuild.LAUNCHES)
    with plain_kernels():
        want, _ = m6.prefill(p6, {"tokens": tokens})
    torch.cuda.synchronize()
    check(mid["flash_fwd"] - before["flash_fwd"] == 1 and mid["ssd_scan"] - before["ssd_scan"] == 5
          and kbuild.LAUNCHES == mid, "f32 unit: unexpected kernel launches")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(err <= TOL_ZOO_F32 * max(1.0, scale) and torch.equal(got.argmax(-1), want.argmax(-1)),
          f"f32 unit: kernel path and plain path differ (max |err| {err:.3e}, |logits| {scale:.3f})")
    print(f"zoo f32 unit ({cfg6.pattern()}, d_model {cfg.d_model}), B=1 S=1000: kernel path vs "
          f"plain path on the card, logits max |err| {err:.3e} (|logits| up to {scale:.3f}, "
          f"tolerance {TOL_ZOO_F32} x max(1, |logits|)), greedy tokens equal", flush=True)
    del m6, p6
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------- #
# the models ingest traces, served: whisper-tiny (B3) and xlstm-350m (B4)
# ---------------------------------------------------------------------- #
INGEST_ARCHS = ("whisper-tiny", "xlstm-350m")
INGEST_BENCH = ROOT / "BENCH_ingest.json"
INGEST_HASHES = ROOT / "tests" / "golden" / "torch_ingest_hashes.json"
INGEST_ZOO_HASHES = ROOT / "tests" / "golden" / "torch_ingest_zoo_hashes.json"
INGEST_NODES = (12, 64)
# (batch, prompt tokens, max_len) of the served runs; whisper also takes 1500 frames
SERVED = {"whisper-tiny": (2, 64, 80), "xlstm-350m": (2, 1024, 1024 + DECODE_STEPS)}
# layers served where the depth is cut: xlstm-350m's 1024-step sLSTM loops by the script's clock
SERVED_LAYERS = {"xlstm-350m": 4}
# launches a prefill: whisper 4 encoder + 4 decoder self + 4 cross (B3), by shape;
# xlstm 2 mLSTM layers x (numerator P = 512, normalizer P = 1) (B4)
SERVED_PER_PREFILL = {
    "whisper-tiny": {"flash_fwd": {"encoder": 4, "decoder self": 4, "cross": 4}},
    "xlstm-350m": {"ssd_scan": {"numerator": 2, "normalizer": 2}},
}
FLASH_SRC, SSD_SRC = ("src/repro_torch/kernels/flash/csrc/flash_fwd.cu",
                      "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu")


def launch_shapes(log: list):
    """The zoo ops' CUDA wrappers, each call's shape class appended to
    ``log`` before the real wrapper launches (and counts) its kernel."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    real_flash, real_ssd = flash_ops.flash_attention_cuda, ssd_ops.ssd_scan_cuda

    def flash(q, k, v, *, causal=True, scale=None):
        kind = ("decoder self" if causal else "encoder" if q.shape[2] == k.shape[2] else "cross")
        log.append(("flash_fwd", kind))
        return real_flash(q, k, v, causal=causal, scale=scale)

    def ssd(x, dt, A, B, C, *, chunk, in_scale=None):
        log.append(("ssd_scan", "normalizer" if x.shape[-1] == 1 else "numerator"))
        return real_ssd(x, dt, A, B, C, chunk=chunk, in_scale=in_scale)
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(flash_ops, "flash_attention_cuda", flash))
    stack.enter_context(mock.patch.object(ssd_ops, "ssd_scan_cuda", ssd))
    return stack


def served_models_phase(card: str) -> list[dict]:
    """whisper-tiny and xlstm-350m served at full width on the card, their
    launches counted; one full-width unit of each in float32 held to the
    plain path; B3 and B4 at these paths' shapes held to their plain
    versions and timed (see the module docstring, items 15-17)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models.model import build_model

    gen = torch.Generator(device="cuda").manual_seed(3)

    def inputs(cfg, b, s, dtype):
        out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")}
        if cfg.family == "audio":
            out["audio_embed"] = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                                              device="cuda").to(dtype)
        return out

    launched: dict[str, dict] = {}
    for arch, (b, s, max_len) in SERVED.items():
        full = get_config(arch)
        cfg = full.scaled(n_layers=SERVED_LAYERS[arch]) if arch in SERVED_LAYERS else full
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init_params(seed=0)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        batch = inputs(cfg, b, s, torch.bfloat16)
        want = SERVED_PER_PREFILL[arch]
        # ---- the path, counted: prefill then greedy decode ------------- #
        for k in kbuild.LAUNCHES:
            kbuild.LAUNCHES[k] = 0
        log: list = []
        with launch_shapes(log):
            logits, cache = model.prefill(params, batch, max_len=max_len)
            torch.cuda.synchronize()
            pre = {k: kbuild.LAUNCHES[k] for k in ("flash_fwd", "ssd_scan")}
            n_pre = len(log)
            seq, tok = [logits], logits.argmax(-1)
            for t in range(DECODE_STEPS):
                logits, cache = model.decode_step(params, tok, cache, s + t)
                seq.append(logits)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
        dec = {k: kbuild.LAUNCHES[k] - pre[k] for k in pre}
        by_shape = {}
        for kern, kind in log[:n_pre]:
            by_shape.setdefault(kern, {}).setdefault(kind, 0)
            by_shape[kern][kind] += 1
        out = torch.cat(seq, dim=1).float()
        print(f"{arch} served on {card}: full width ({cfg.n_layers} of {full.n_layers} layers"
              + (f" + {cfg.encoder_layers} encoder, {cfg.encoder_seq} frames" if cfg.encoder_layers
                 else "") + f", d_model {cfg.d_model}, {cfg.dtype}, seeded weights drawn in "
              f"{t_init:.2f} s), B={b} S={s}: prefill launches {pre} by shape {by_shape}, "
              f"{DECODE_STEPS} decode steps launches {dec}; logits {tuple(out.shape)}", flush=True)
        want_pre = {k: sum(want.get(k, {}).values()) for k in pre}
        check(pre == want_pre and by_shape == want and len(log) == n_pre,
              f"{arch} prefill: launches {pre} by shape {by_shape}, expected {want}")
        check(not any(dec.values()), f"{arch} decode launched kernels {dec}")
        check(out.shape == (b, DECODE_STEPS + 1, cfg.vocab_size)
              and bool(torch.isfinite(out).all()), f"{arch}: logits not finite or misshapen")
        launched[arch] = by_shape
        del cache, logits, seq
        serve_rates(f"{arch} serve", card, model, params, batch, max_len)
        if arch == "whisper-tiny":   # bf16 runs the tensor-core template, and only that
            names = device_split(f"{arch} prefill B={b} S={s}", card,
                                 lambda: model.prefill(params, batch, max_len=max_len))
            if names:
                ran = {k: sum(k in n for n in names) for k in ("flash_fwd_bf16", "flash_fwd_f32")}
                check(ran == {"flash_fwd_bf16": 12, "flash_fwd_f32": 0},
                      f"{arch} bf16 prefill ran flash templates {ran}")
        else:   # one of the 12 "xs" units (the whole prefill is ~250k launches to profile)
            unit = build_model(cfg.scaled(n_layers=2))
            uparams = unit.init_params(seed=0)
            names = device_split(f"{arch} one xs unit, prefill B={b} S={s}", card,
                                 lambda: unit.prefill(uparams, batch))
            if names:   # bf16: the tensor-core tiled template, and not the CUDA-core one
                ran = {k: sum(k in n for n in names) for k in (SSD_TILED_BF16, SSD_TILED_F32)}
                check(ran == {SSD_TILED_BF16: 2, SSD_TILED_F32: 0},
                      f"{arch} xs unit ran tiled templates {ran}, expected 2 {SSD_TILED_BF16}")
            del unit, uparams
        del params, model, batch
        torch.cuda.empty_cache()

    # ---- one full-width unit of each in float32: kernels vs plain ------ #
    for arch, kw, s, want_k in (
            ("whisper-tiny", {"encoder_layers": 1, "n_layers": 1}, 64, {"flash_fwd": 3}),
            ("xlstm-350m", {"n_layers": 2}, 1024, {"ssd_scan": 2})):
        cfg = get_config(arch).scaled(dtype="float32", **kw)
        model = build_model(cfg)
        params = model.init_params(seed=1)
        batch = inputs(cfg, 1, s, torch.float32)
        before = dict(kbuild.LAUNCHES)
        got, _ = model.prefill(params, batch)
        mid = dict(kbuild.LAUNCHES)
        with plain_kernels():
            ref, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        ran = {k: mid[k] - before[k] for k in ("flash_fwd", "ssd_scan") if mid[k] > before[k]}
        check(ran == want_k and kbuild.LAUNCHES == mid,
              f"{arch} f32 unit: launches {ran}, expected {want_k}")
        if arch == "xlstm-350m":   # float32 keeps the CUDA-core tiled template (by name, on
            short = inputs(cfg, 1, 64, torch.float32)   # one chunk: the sLSTM loop is eager)
            only_template(ssd_templates(lambda: model.prefill(params, short), calls=1),
                          SSD_TILED_F32, f"{arch} f32 unit")
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        check(err <= TOL_ZOO_F32 * max(1.0, scale) and torch.equal(got.argmax(-1), ref.argmax(-1)),
              f"{arch} f32 unit: kernel path and plain path differ (max |err| {err:.3e}, "
              f"|logits| {scale:.3f})")
        unit = "e" * cfg.encoder_layers + "c" * cfg.n_layers if cfg.encoder_layers else \
            cfg.pattern()
        print(f"{arch} f32 unit ({unit}, d_model {cfg.d_model}), B=1 S={s}: kernel path vs "
              f"plain path on the card, logits max "
              f"|err| {err:.3e} (|logits| up to {scale:.3f}, tolerance {TOL_ZOO_F32} x max(1, "
              f"|logits|)), greedy tokens equal", flush=True)
        del model, params
        torch.cuda.empty_cache()

    # ---- B3 and B4 at these paths' shapes, against their plain versions  #
    def within(got, want, tol):
        atol, rtol = tol
        got, want = got.float(), want.float()
        return bool(((got - want).abs() <= atol + rtol * want.abs()).all()), \
            float((got - want).abs().max())

    rows = []
    wcfg = get_config("whisper-tiny")
    b, s = SERVED["whisper-tiny"][:2]
    h, dh, se = wcfg.n_heads, wcfg.resolved_head_dim, wcfg.encoder_seq
    for kind, sq, sk, causal in (("encoder", se, se, False), ("cross", s, se, False),
                                 ("decoder self", s, s, True)):
        q = torch.randn((b, sq, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, sk, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, sk, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # the path's layout

        def call(q=q, k=k, v=v, causal=causal):
            return flash_ops.flash_attention(q, k, v, causal=causal)
        got = call()
        with plain_kernels():
            ref = call()
            plain_ms = cuda_ms(call, iters=3)
        torch.cuda.synchronize()
        ok, err = within(got, ref, TOL_BF16_OUT)
        check(ok, f"flash whisper {kind}: kernel and plain version differ (max |err| {err:.3e})")
        ev_ms = cuda_ms(call, iters=20)
        dev_ms = device_ms(call, "flash_fwd_bf16", iters=10)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), iters=20)
        b_ms, b_by = bound(*flash_work(b, h, h, sq, sk, dh, dh, 2, causal), BF16_FLOPS_PER_S)
        print(f"flash_fwd whisper-tiny {kind} B={b} H={h} Sq={sq} Sk={sk} D={dh} bf16 "
              f"{'causal' if causal else 'non-causal'} on {card}: max |err| {err:.3e} (tolerance "
              f"atol, rtol {TOL_BF16_OUT}); kernel {ev_ms:.4f} ms (CUDA events; device "
              f"{dev_ms:.4f} ms), plain {plain_ms:.3f} ms, scaled_dot_product_attention "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
        rows.append({"name": f"flash_fwd (whisper-tiny {kind})", "route": "cuda",
                     "source": FLASH_SRC, "replaces": "src/repro/kernels/flash/kernel.py:43",
                     "launches": launched["whisper-tiny"]["flash_fwd"][kind],
                     "max_abs_err": err, "ms": reported_ms(ev_ms, dev_ms), "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})

    xcfg = get_config("xlstm-350m")
    b, s = SERVED["xlstm-350m"][:2]
    nh = xcfg.n_heads
    ph = xcfg.ssm.expand * xcfg.d_model // nh
    chunk = xcfg.ssm.chunk
    gates = torch.randn((b, s, 2 * nh), generator=gen, device="cuda")
    i_g, f_g = torch.sigmoid(gates[..., :nh]), torch.sigmoid(gates[..., nh:] + 2.0)
    dtv = -torch.log(f_g.clamp(1e-6, 1 - 1e-6))
    A = torch.ones((nh,), device="cuda")
    kq = torch.randn((b, s, 2, nh, ph), generator=gen, device="cuda").to(torch.bfloat16)
    kk, qq = kq[:, :, 0] * ph ** -0.5, kq[:, :, 1]
    for kind, p in (("numerator", ph), ("normalizer", 1)):
        x = (torch.randn((b, s, nh, p), generator=gen, device="cuda").to(torch.bfloat16)
             if p > 1 else torch.ones((b, s, nh, 1), dtype=torch.bfloat16, device="cuda"))

        def call(x=x):
            return ssd_ops.ssd_scan(x, dtv, A, kk, qq, chunk=chunk, in_scale=i_g)
        y, hf = call()
        with plain_kernels():
            wy, wh = call()
            plain_ms = cuda_ms(call, iters=2)
        torch.cuda.synchronize()
        ok_y, err_y = within(y, wy, TOL_BF16_OUT)
        ok_h, err_h = within(hf, wh, TOL_SSD_STATE)
        check(ok_y and ok_h, f"ssd xlstm {kind}: kernel and plain version differ "
              f"(y {err_y:.3e}, state {err_h:.3e})")
        ev_ms = cuda_ms(call, iters=10)
        only_template(ssd_templates(call), SSD_TILED_BF16, f"ssd xlstm {kind}")
        dev_ms = device_ms(call, SSD_TILED_BF16, iters=10)
        b_ms, b_by = bound(*ssd_work(b, s, nh, p, nh, ph, chunk, 2, True), BF16_FLOPS_PER_S)
        print(f"ssd_scan xlstm-350m {kind} Bt={b} S={s} H=G={nh} N={ph} P={p} chunk {chunk} bf16 "
              f"({SSD_TILED_BF16}) on {card}: max |err| y {err_y:.3e} (tolerance atol, rtol "
              f"{TOL_BF16_OUT}), state {err_h:.3e} (tolerance {TOL_SSD_STATE}); kernel "
              f"{ev_ms:.4f} ms (CUDA events; device {dev_ms:.5f} ms), plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}; {b_ms / dev_ms:.4f} of the device time)", flush=True)
        rows.append({"name": f"ssd_scan (xlstm-350m {kind}, tiled)", "route": "cuda",
                     "source": SSD_SRC, "replaces": "src/repro/kernels/ssd/kernel.py:41",
                     "launches": launched["xlstm-350m"]["ssd_scan"][kind],
                     "max_abs_err": max(err_y, err_h), "ms": reported_ms(ev_ms, dev_ms),
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    return rows


# ---------------------------------------------------------------------- #
# the rest of the zoo served: MLA, the VLM front end, qk_norm GQA, MoE (B3)
# ---------------------------------------------------------------------- #
# arch: (layers kept, or None for all; batch; prompt tokens; patches; decode steps).
# The two MoE archs keep what fits the card's 80 GB in bf16 beside the
# embedding and head: qwen3-moe 4 of 94 layers (4.8 GB of experts a layer),
# kimi-k2 1 of 61 (33.8 GB of experts a layer).
# (layers kept, B, text tokens, patches, decode steps); the dense archs' depth is cut
# to half by the script's clock, the MoE archs' by the card
ZOO_ARCHS = {
    "minicpm3-4b": (24, 2, 1024, 0, 8),
    "llava-next-mistral-7b": (16, 1, 128, 1152, 8),
    "qwen3-14b": (20, 2, 1024, 0, 8),
    "qwen3-moe-235b-a22b": (4, 2, 512, 0, 4),
    "kimi-k2-1t-a32b": (1, 1, 512, 0, 4),
}
TOL_MOE_FLIP = 1e-4   # a float32 route may flip only at a k-th/(k+1)-th gate margin below this


def attn_heads(cfg) -> tuple[int, int, int, int]:
    """(Hq, Hkv, D, Dv) of ``cfg``'s attention as B3 sees it (MLA: the
    materialized nope + rope query and key, the value's own width)."""
    if cfg.attention == "mla":
        return (cfg.n_heads, cfg.n_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                cfg.v_head_dim)
    return cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.resolved_head_dim


def zoo_batch(cfg, b: int, s: int, n_patches: int, dtype, gen) -> dict:
    """Seeded prompt tokens (and the VLM stub's patch embeddings) on the card."""
    import torch
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")}
    if n_patches:
        out["patches"] = torch.randn((b, n_patches, cfg.d_model), generator=gen,
                                     device="cuda").to(dtype)
    return out


def moe_block_f32(arch: str, cfg, b: int, s: int, gen) -> str:
    """One full-width MoE block of ``arch`` in float32 on one seeded input,
    through B3's float32 template and through the plain version: routes
    equal (a flip is reported with its gate margin and is a fault above
    TOL_MOE_FLIP), the block's output within TOL_ZOO_F32 x max(1, |out|) on
    the tokens whose routes agree.  Returns the printed line."""
    import contextlib

    import torch

    from repro_torch.kernels import build as kbuild
    from repro_torch.models import blocks, mlp
    from repro_torch.models.common import Init

    c32 = cfg.scaled(dtype="float32")
    p = blocks.init_block(Init(torch.device("cuda"), gen), c32, "a")
    x = torch.randn((b, s, c32.d_model), generator=gen, device="cuda")
    pos = torch.arange(s, device="cuda")

    def run(plain: bool):
        with contextlib.ExitStack() as stack:
            routes = stack.enter_context(mlp.recorded_routes())
            if plain:
                stack.enter_context(plain_kernels())
            y, _ = blocks.block_forward(p, c32, "a", x, pos, mode="prefill")
        torch.cuda.synchronize()
        return y, routes[0]

    before = kbuild.LAUNCHES["flash_fwd"]
    got, route = run(False)
    gates, top_e = route.gates, route.top_e
    check(kbuild.LAUNCHES["flash_fwd"] == before + 1, f"{arch} f32 MoE block: B3 did not launch")
    want, want_route = run(True)
    want_e = want_route.top_e
    k = c32.moe.top_k
    flipped = (top_e.sort(-1).values != want_e.sort(-1).values).any(-1)
    srt = torch.topk(gates, k + 1, dim=-1).values
    margin = srt[:, k - 1] - srt[:, k]
    flip_margins = [float(m) for m in margin[flipped]]
    check(all(m <= TOL_MOE_FLIP for m in flip_margins),
          f"{arch} f32 MoE block: routes flipped at gate margins {flip_margins} "
          f"(a flip above {TOL_MOE_FLIP} is a fault)")
    keep = ~flipped.reshape(b, s)
    err = float((got - want)[keep].abs().max())
    scale = float(want[keep].abs().max())
    check(err <= TOL_ZOO_F32 * max(1.0, scale),
          f"{arch} f32 MoE block: kernel path and plain path differ (max |err| {err:.3e}, "
          f"|out| {scale:.3f})")
    line = (f"{arch} f32 MoE block (full width, {c32.moe.n_experts} experts top {k}), B={b} "
            f"S={s}: kernel path vs plain path on the card, routes of {b * s} tokens: "
            f"{len(flip_margins)} flipped" + (f" at gate margins {flip_margins}" if flip_margins
                                              else "") +
            f" (smallest k-th/(k+1)-th margin {float(margin.min()):.3e}; a flip above "
            f"{TOL_MOE_FLIP} is a fault), block output max |err| {err:.3e} (|out| up to "
            f"{scale:.3f}, tolerance {TOL_ZOO_F32} x max(1, |out|))")
    del p, x, got, want, gates, route, want_route
    torch.cuda.empty_cache()
    return line


def zoo_archs_phase(card: str) -> list[dict]:
    """minicpm3-4b (MLA), llava-next-mistral-7b (1152 patches + 128 tokens),
    qwen3-14b (qk_norm) at full width and depth, qwen3-moe-235b-a22b and
    kimi-k2-1t-a32b at full width and ZOO_ARCHS' depth, served in bf16 on
    the card, one after the other, each freed before the next; their
    launches counted; one float32 unit (MoE: block) of each held to the
    plain path; B3 at each one's shape held to its plain version and timed
    (see the module docstring, items 25-27)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.models.model import build_model, count_params

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for arch, (layers, b, s, n_patches, steps) in ZOO_ARCHS.items():
        full = get_config(arch)
        cfg = full if layers is None else full.scaled(n_layers=layers)
        model = build_model(cfg)
        n_params = count_params(model)
        cut = ("full depth" if layers is None else
               f"cut to {layers} of {full.n_layers} layers (the "
               + ("card's 80 GB)" if cfg.moe is not None else "script's clock)"))
        t0 = time.perf_counter()
        params = model.init_params(seed=0)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        batch = zoo_batch(cfg, b, s, n_patches, torch.bfloat16, gen)
        seq = s + n_patches
        max_len = seq + steps
        n_attn = cfg.pattern().count("a")
        # ---- the path, counted: prefill then greedy decode ------------- #
        for key in kbuild.LAUNCHES:
            kbuild.LAUNCHES[key] = 0
        logits, cache = model.prefill(params, batch, max_len=max_len)
        torch.cuda.synchronize()
        pre = dict(kbuild.LAUNCHES)
        outs, tok = [logits], logits.argmax(-1)
        for t in range(steps):
            logits, cache = model.decode_step(params, tok, cache, seq + t)
            outs.append(logits)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        dec = {key: kbuild.LAUNCHES[key] - pre[key] for key in pre}
        pre = {key: n for key, n in pre.items() if n}
        out = torch.cat(outs, dim=1).float()
        print(f"{arch} served on {card}: d_model {cfg.d_model}, {cfg.n_layers} layers ({cut}), "
              f"bf16, {n_params} parameters ({2 * n_params / 1e9:.2f} GB) drawn in {t_init:.2f} s, "
              f"B={b} S={s}" + (f" after {n_patches} patches" if n_patches else "")
              + f": prefill launches {pre}, {steps} decode steps launches "
              f"{ {key: n for key, n in dec.items() if n} }; logits {tuple(out.shape)}", flush=True)
        check(pre == {"flash_fwd": n_attn},
              f"{arch} prefill: launches {pre}, expected {n_attn} flash_fwd (one a layer)")
        check(not any(dec.values()), f"{arch} decode launched kernels {dec}")
        check(out.shape == (b, steps + 1, cfg.vocab_size) and bool(torch.isfinite(out).all()),
              f"{arch}: logits not finite or misshapen")
        launched = pre["flash_fwd"]
        del cache, logits, outs, out
        serve_rates(f"{arch} serve", card, model, params, batch, max_len, steps=steps)
        # bf16 runs the tensor-core template, and only that; a profiler
        # window that shows fewer launches than were counted is read again,
        # up to three times (late in the run windows lose their first kernels)
        for _ in range(3):
            names = device_split(f"{arch} prefill B={b} S={seq}", card,
                                 lambda: model.prefill(params, batch, max_len=max_len))
            ran = {key: sum(key in n for n in names) for key in ("flash_fwd_bf16",
                                                                 "flash_fwd_f32")}
            if not names or ran["flash_fwd_bf16"] == n_attn:
                break
        if names:
            check(ran == {"flash_fwd_bf16": n_attn, "flash_fwd_f32": 0},
                  f"{arch} bf16 prefill ran flash templates {ran}")
        del params, model, batch
        torch.cuda.empty_cache()

        # ---- float32: one unit (MoE: one block), kernels vs plain ------ #
        if cfg.moe is not None:
            print(moe_block_f32(arch, full, b, s, gen), flush=True)
        else:
            c32 = full.scaled(n_layers=1, dtype="float32")
            m32 = build_model(c32)
            p32 = m32.init_params(seed=1)
            b32 = zoo_batch(c32, b, s, n_patches, torch.float32, gen)
            before = dict(kbuild.LAUNCHES)
            got, _ = m32.prefill(p32, b32)
            mid = dict(kbuild.LAUNCHES)
            with plain_kernels():
                ref, _ = m32.prefill(p32, b32)
            torch.cuda.synchronize()
            check(mid["flash_fwd"] == before["flash_fwd"] + 1 and kbuild.LAUNCHES == mid,
                  f"{arch} f32 unit: unexpected launches")
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            check(err <= TOL_ZOO_F32 * max(1.0, scale)
                  and torch.equal(got.argmax(-1), ref.argmax(-1)),
                  f"{arch} f32 unit: kernel path and plain path differ (max |err| {err:.3e}, "
                  f"|logits| {scale:.3f})")
            print(f"{arch} f32 unit (1 layer, d_model {c32.d_model}), B={b} S={seq}: kernel path "
                  f"vs plain path on the card, logits max |err| {err:.3e} (|logits| up to "
                  f"{scale:.3f}, tolerance {TOL_ZOO_F32} x max(1, |logits|)), greedy tokens "
                  "equal", flush=True)
            del m32, p32, b32, got, ref
            torch.cuda.empty_cache()

        # ---- B3 at this arch's prefill shape, against its plain version  #
        rows.append(flash_prefill_row(card, gen, arch, cfg, b, seq, launched))
        torch.cuda.empty_cache()
    return rows


def flash_prefill_row(card: str, gen, label: str, cfg, b: int, seq: int, launched: int) -> dict:
    """B3 at ``cfg``'s bf16 causal prefill shape (B, S = ``seq``) on seeded
    inputs in the path's layout, held to its plain version (TOL_BF16_OUT)
    and timed beside the plain version and scaled_dot_product_attention;
    its kernels-line row with ``launched`` launches."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import ops as flash_ops

    hq, hkv, d, dv = attn_heads(cfg)
    # the path's layout: (B, S, H, D) activations viewed as (B, H, S, D)
    q, k, v = (torch.randn((b, seq, h, w), generator=gen, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for h, w in ((hq, d), (hkv, d), (hkv, dv)))

    def call():
        return flash_ops.flash_attention(q, k, v, causal=True, scale=d ** -0.5)
    got = call()
    with plain_kernels():
        ref = call()
        plain_ms = cuda_ms(call, iters=3)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= TOL_BF16_OUT[0] + TOL_BF16_OUT[1] * ref.float().abs()).all())
    check(ok, f"flash {label}: kernel and plain version differ (max |err| {err:.3e})")
    ev_ms = cuda_ms(call, iters=10)
    dev_ms = device_ms(call, "flash_fwd_bf16", iters=10)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=d ** -0.5, enable_gqa=hq != hkv), iters=10)
    b_ms, b_by = bound(*flash_work(b, hq, hkv, seq, seq, d, dv, 2), BF16_FLOPS_PER_S)
    print(f"flash_fwd {label} B={b} Hq={hq} Hkv={hkv} S={seq} D={d} Dv={dv} bf16 causal on "
          f"{card}: max |err| {err:.3e} (tolerance atol, rtol {TOL_BF16_OUT}); kernel "
          f"{ev_ms:.4f} ms (CUDA events; device {dev_ms:.4f} ms), plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})",
          flush=True)
    return {"name": f"flash_fwd ({label})", "route": "cuda", "source": FLASH_SRC,
            "replaces": "src/repro/kernels/flash/kernel.py:43", "launches": launched,
            "max_abs_err": err, "ms": reported_ms(ev_ms, dev_ms), "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def ingest_phase(card: str) -> None:
    """Ingest both models' full configs, schedule them and the zoo's other
    archs through B1 and score the eval's ingest/k4 cell on the card, each
    held to the CPU (see the module docstring, items 18-20 and 34)."""
    import numpy as np
    import torch

    from repro_torch.core import RespectScheduler, validate_graph, validate_monotone
    from repro_torch.eval import ExactOracle, diff_results, ingest_scenarios, run_scenario
    from repro_torch.eval.__main__ import BB_BUDGET_S, BB_MAX_N
    from repro_torch.ingest import coarsen_program, ingest_model, trace_model
    from repro_torch.kernels.ptr import ops

    bench = {(r["arch"], r["n_nodes"]): r for r in json.loads(INGEST_BENCH.read_text())["reports"]}
    golden = json.loads(INGEST_HASHES.read_text())
    seq = golden["seq_len"]
    for arch in INGEST_ARCHS:
        again = trace_model(arch, smoke=False, seq_len=seq).program   # a second, uncached trace
        for n in INGEST_NODES:
            t0 = time.perf_counter()
            res = ingest_model(arch, n, smoke=False, seq_len=seq)
            t_ing = time.perf_counter() - t0
            rep, want, g = res.report, bench[(arch, n)], res.graph
            validate_graph(g)
            stable = coarsen_program(again, n, model_name=g.model_name).content_hash()
            check(rep["param_bytes_total"] == want["param_bytes_total"],
                  f"ingest {arch}/{n}: param bytes {rep['param_bytes_total']}, BENCH_ingest.json "
                  f"{want['param_bytes_total']}")
            check(rep["n_warnings"] == 0 and g.n <= n and g.max_in_degree <= 6,
                  f"ingest {arch}/{n}: warnings {rep['warnings']}, {g.n} nodes, in-degree "
                  f"{g.max_in_degree}")
            check(stable == rep["graph_hash"], f"ingest {arch}/{n}: not bit-stable")
            check(rep["graph_hash"] == golden["graph_hash"][arch][str(n)],
                  f"ingest {arch}/{n}: graph hash differs from the CPU's ({INGEST_HASHES.name})")
            print(f"ingest {arch} full config, seq {seq}, {n} nodes: {t_ing:.2f} s "
                  f"({rep['n_records']} records, notes {rep['notes']}); param bytes "
                  f"{rep['param_bytes_total']:.0f} (BENCH_ingest.json "
                  f"{want['param_bytes_total']:.0f}); flops {rep['flops_total']:.0f} "
                  f"(BENCH_ingest.json {want['flops_total']:.0f}, ratio "
                  f"{rep['flops_total'] / want['flops_total']:.4f}); 0 warnings; {g.n} nodes, "
                  f"{g.num_edges} edges; hash equal to the CPU's and across two traces",
                  flush=True)

    sched = RespectScheduler.from_release()
    cpu = RespectScheduler.from_release(device="cpu")
    # the zoo's other archs (item 34): the full configs' hashes at seq 64 against the CPU's
    zoo_golden = json.loads(INGEST_ZOO_HASHES.read_text())
    check(zoo_golden["seq_len"] == seq, f"{INGEST_ZOO_HASHES.name}: seq {zoo_golden['seq_len']}")
    zoo_archs = tuple(zoo_golden["graph_hash"])
    t0 = time.perf_counter()
    for arch in zoo_archs:
        for n in INGEST_NODES:
            rep = ingest_model(arch, n, smoke=False, seq_len=seq).report
            want = zoo_golden["graph_hash"][arch][str(n)]
            check(rep["n_warnings"] == 0 and rep["graph_hash"] == want,
                  f"ingest {arch}/{n}: warnings {rep['warnings']}, graph hash "
                  f"{rep['graph_hash']} against the CPU's {want} ({INGEST_ZOO_HASHES.name})")
    print(f"ingest of the {len(zoo_archs)} archs of {INGEST_ZOO_HASHES.name} (full configs, seq "
          f"{seq}, {INGEST_NODES} nodes) on the card's host: {time.perf_counter() - t0:.1f} s, "
          "0 warnings, every graph hash equal to the CPU's", flush=True)
    for arch in INGEST_ARCHS + zoo_archs:
        for n in INGEST_NODES:
            for k in ops.LAUNCHES:
                ops.LAUNCHES[k] = 0
            res = sched.schedule_model(arch, STAGES, n_nodes=n, smoke=False, use_cache=False)
            torch.cuda.synchronize()
            ran = dict(ops.LAUNCHES)
            want = cpu.schedule_model(arch, STAGES, n_nodes=n, smoke=False, use_cache=False)
            g = ingest_model(arch, n, smoke=False, max_deg=sched.max_deg).graph
            check(ran["ptr_decode_cluster"] == 1 and ran["ptr_decode_block"] == 0
                  and ran["ptr_step"] == 0, f"schedule_model {arch}/{n}: launches {ran}")
            check(np.array_equal(res["order"], want["order"])
                  and np.array_equal(res["assignment"], want["assignment"]),
                  f"schedule_model {arch}/{n}: card and CPU plain path differ")
            check(validate_monotone(g, res["assignment"], STAGES),
                  f"schedule_model {arch}/{n}: not dependency-valid")
            print(f"schedule_model {arch} (full config, {n} nodes, traced seq "
                  f"{res['ingest']['seq_len']}) k={STAGES} on {card}: "
                  f"B1 (ptr_decode_cluster) {ran['ptr_decode_cluster']} launch; nodes a stage "
                  f"{np.bincount(res['assignment'], minlength=STAGES).tolist()}, assignment "
                  f"equal to the CPU plain path's, dependency-valid", flush=True)

    sc = ingest_scenarios()[0]
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    rec = run_scenario(sc, sched, ExactOracle(), bb_max_n=BB_MAX_N, bb_budget_s=BB_BUDGET_S)
    torch.cuda.synchronize()
    t_cell = time.perf_counter() - t0
    ran = dict(ops.LAUNCHES)
    want = run_scenario(sc, cpu, ExactOracle(device="cpu"), bb_max_n=BB_MAX_N,
                        bb_budget_s=BB_BUDGET_S)
    diffs = diff_results(json.loads(json.dumps(rec)), json.loads(json.dumps(want)),
                         rtol=EVAL_RTOL)
    check(ran["ptr_decode_cluster"] > 0 and ran["ptr_step"] == 0,
          f"eval {sc.name}: launches {ran}")
    check(not diffs, f"eval {sc.name}: the card differs from the CPU in {diffs[:5]}")
    flags = [(gr["model"], gr["respect_gap"], gr["respect_match"], gr["respect_valid"])
             for gr in rec["graphs"]]
    check(all(valid for *_, valid in flags) and rec["oracle"]["parity"],
          f"eval {sc.name}: {flags}, oracle parity {rec['oracle']['parity']}")
    print(f"eval {sc.name} on {card} ({t_cell:.2f} s; B1 {ran['ptr_decode_cluster']} launches): "
          f"every non-timing field equal to the CPU's; respect (model, gap, match, valid) "
          f"{flags}; oracle parity {rec['oracle']['parity']}", flush=True)


# ---------------------------------------------------------------------- #
# the pod-scale partitioner: the ten archs' block graphs through B1
# ---------------------------------------------------------------------- #
PARTITIONS = ROOT / "tests" / "golden" / "torch_partitions.json"


def partitioner_phase(card: str) -> list[dict]:
    """``partition_model`` of the ten archs at the golden file's settings
    (train_4k, 8 stages, mesh slice 64) with each of its methods, respect-v1
    through B1 on the card; assignments held to
    tests/golden/torch_partitions.json (the JAX package's); B1 at the
    largest bucket held to its plain version and timed (see the module
    docstring, item 28)."""
    import torch

    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.core import RespectScheduler
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.core.partitioner import model_graph, partition_model
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import TEMPLATES, decode_batch, decode_batch_reference

    gold = json.loads(PARTITIONS.read_text())
    meta = gold["meta"]
    shape, k, mesh = SHAPES[meta["shape"]], meta["n_stages"], meta["mesh_slice"]
    sched = RespectScheduler.from_release()            # device: cuda
    check(sched.release["params_sha256"] == meta["release_params_sha256"],
          "partitioner: the release is not the one the golden file was written with")

    def partition_all():
        out = {}
        for arch in ARCH_IDS:
            for method in meta["methods"]:
                t0 = time.perf_counter()
                assign, ev, g = partition_model(
                    get_config(arch), shape, k, method=method, mesh_slice=mesh,
                    scheduler=sched if method == "respect" else None)
                out[arch, method] = (assign, ev, g, time.perf_counter() - t0)
        return out

    # ---- the path, counted: every arch and method, respect through B1 -- #
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    res = partition_all()
    launches = dict(ops.LAUNCHES)
    for arch in ARCH_IDS:
        for method in meta["methods"]:
            assign, _, g, _ = res[arch, method]
            check([int(a) for a in assign] == gold["archs"][arch][method]["assignment"],
                  f"partition {arch} {method}: the assignment differs from {PARTITIONS.name}")
        bott = {m: res[arch, m][1].bottleneck_s for m in meta["methods"]}
        solve = {m: res[arch, m][3] * 1e3 for m in meta["methods"]}
        print(f"partition {arch} ({g.n} nodes, k={k}, mesh slice {mesh}) on {card}: bottleneck "
              f"compiler/exact {bott['compiler'] / bott['exact']:.4f}, compiler/respect "
              f"{bott['compiler'] / bott['respect']:.4f}; solve ms (host clock, first call): "
              + ", ".join(f"{m} {t:.2f}" for m, t in solve.items())
              + "; assignments equal the golden file", flush=True)
    print(f"partitioner launches {launches}", flush=True)
    check(launches["ptr_decode_cluster"] == len(ARCH_IDS)
          and launches["ptr_decode_block"] == 0 and launches["ptr_step"] == 0,
          f"partitioner: launches {launches}, expected {len(ARCH_IDS)} ptr_decode_cluster "
          "(one a graph: PodSystem is uniform)")
    for _ in range(3):   # a window that shows fewer launches than counted is read again
        sched.clear_cache()
        names = kernel_names(lambda: [partition_model(get_config(arch), shape, k,
                                                      method="respect", mesh_slice=mesh,
                                                      scheduler=sched) for arch in ARCH_IDS])
        ran = {t: names.count(t) for t in TEMPLATES.values()}
        if ran["ptr_decode_cluster"] == len(ARCH_IDS):
            break
    check(ran == {t: len(ARCH_IDS) * (t == "ptr_decode_cluster") for t in TEMPLATES.values()},
          f"partitioner ran B1 templates {ran} by profiler name")

    # ---- B1 at the largest bucket of these graphs, against plain ------- #
    graphs = [model_graph(get_config(arch), shape, mesh) for arch in ARCH_IDS]
    by_bucket = bucketize(graphs)
    n = max(by_bucket)
    gs = [graphs[i] for i in by_bucket[n]]
    net, D = sched.net, sched.max_deg
    batch = pack_padded(gs, max_deg=D).to("cuda")
    with torch.inference_mode():
        C, (h0, c0), emb = net.encode(batch.feats, batch.n_valid)
        args = (net, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
        before = dict(ops.LAUNCHES)
        k_out = decode_batch(*args)
        p_out = decode_batch_reference(*args)
        torch.cuda.synchronize()
        check(ops.LAUNCHES["ptr_decode_cluster"] == before["ptr_decode_cluster"] + 1,
              "partitioner B1 check: the cluster template did not launch")
        valid = torch.arange(n, device="cuda")[None, :] < batch.n_valid[:, None].long()
        check(torch.equal(torch.where(valid, k_out[0], -1), torch.where(valid, p_out[0], -1)),
              f"partitioner B1 bucket {n}: orders differ from the plain version")
        err = max(float((k_out[1] - p_out[1]).abs().max()), float((k_out[2] - p_out[2]).abs().max()))
        check(err <= TOL_LOGP, f"partitioner B1 bucket {n}: logp/entropy error {err:.3e}")
        ev_ms = cuda_ms(lambda: decode_batch(*args), iters=5)
        dev_ms = device_ms(lambda: decode_batch(*args), "ptr_decode_cluster", iters=5)
        plain_ms = cuda_ms(lambda: decode_batch_reference(*args), iters=2)
    b_ms, b_by = bound(*decode_work(gs, k_out[0].cpu().numpy(), n, net.hidden, D))
    print(f"ptr_decode partitioner bucket {n}, B={len(gs)} "
          f"({', '.join(ARCH_IDS[i] for i in by_bucket[n])}) H={net.hidden} "
          f"(ptr_decode_cluster) on {card}: kernel {ev_ms:.4f} ms (CUDA events; device "
          f"{dev_ms:.4f} ms), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), orders "
          f"equal, max |err| logp/ent {err:.2e} (tolerance {TOL_LOGP})", flush=True)
    del sched, net
    return [{"name": "ptr_decode_cluster (partitioner)", "route": "cuda",
             "source": "src/repro_torch/kernels/ptr/csrc/ptr_decode.cu",
             "replaces": "src/repro/kernels/ptr/decode.py:84",
             "launches": launches["ptr_decode_cluster"], "max_abs_err": err,
             "ms": reported_ms(ev_ms, dev_ms), "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None}]


# ---------------------------------------------------------------------- #
# the LM zoo's training path: whisper-tiny (B3) and xlstm-350m (B4) train
# ---------------------------------------------------------------------- #
LM_TRAIN_GOLDEN = ROOT / "tests" / "golden" / "torch_lm_train_steps.json"
# (batch, tokens, steps) of the full-width runs (examples/train_lm.py's TrainConfig:
# microbatches 2, lr 1e-3, warmup 10, weight decay 0.01); whisper also takes 1500 frames.
# xlstm's S is cut from its served 1024: the sLSTM's eager loop sets the step's time
LM_TRAIN = {"whisper-tiny": (8, 128, 6), "xlstm-350m": (2, 256, 3)}
# layers trained where the depth is cut: xlstm-350m's 24 to 4 (two xs units) by the script's clock
LM_TRAIN_LAYERS = {"xlstm-350m": 4}
# a microbatch's forward: whisper 4 encoder + 4 decoder self + 4 cross B3 launches (the bf16
# template); xlstm 2 mLSTM layers x 2 scans, B4's tiled bf16 template; the backwards launch neither
LM_TRAIN_PER_MB = {"whisper-tiny": ("flash_fwd", "flash_fwd_bf16", 12),
                   "xlstm-350m": ("ssd_scan", SSD_TILED_BF16, 4)}
# relative, as tests/test_torch_lm_train.py holds the CPU to the same file
TOL_LM_GOLDEN = {"loss": 1e-4, "grad_norm": 1e-3, "leaf_norm": 1e-4}
# x max(1, |x|): the loss and every gradient leaf of a float32 unit, kernel path against plain
# path, and B4's Function against plain autograd (measured at most 8.6e-08 on an H100)
TOL_LM_UNIT = 3e-6
# B3's float32 lse against the plain version's (measured at most 1.43e-06 absolute)
TOL_LSE = (5e-5, 0.0)
# x max(1, max|g|): bf16 dq, dk, dv of the Function against plain autograd, which keeps P and
# dS in float32 where the Function (as the reference) rounds them to bf16 for the products
# (measured at most 6.2e-03: under one bf16 step of 2^-7)
TOL_FLASH_GRAD = 5e-2


def flash_bwd_work(b, hq, hkv, sq, sk, d, dv, itemsize, causal) -> tuple[float, float]:
    """(bytes, flops) of the flash backward: q, k, v, o, dO and the float32
    lse read once, dq, dk, dv written once; five products over the kept
    (query, key) pairs (S recomputed, dV, dP, dQ, dK: 2.5x the forward's)."""
    from repro_torch.kernels.flash.kernel import attention_flops
    flops = 2.5 * attention_flops(b, hq, sq, sk, d, dv, causal)
    nbytes = itemsize * b * (2 * hq * sq * d + 2 * hkv * sk * (d + dv) + 2 * hq * sq * dv) \
        + 4 * b * hq * sq
    return nbytes, flops


def grads_within(got: dict, want: dict, tol: float) -> float:
    """Largest |got - want| / max(1, max|want|) over the leaves; fails
    above ``tol``."""
    from repro_torch.launch import named_leaves
    worst = 0.0
    for (n, g), (m, w) in zip(named_leaves(got), named_leaves(want)):
        check(n == m, f"gradient trees differ at {n} / {m}")
        e = float((g.float() - w.float()).abs().max()) / max(1.0, float(w.float().abs().max()))
        check(e <= tol, f"{n}: kernel path and plain path gradients differ ({e:.3e} > {tol})")
        worst = max(worst, e)
    return worst


def flash_train_case(card: str, gen, label: str, b, hq, hkv, sq, sk, d, dv, causal,
                     timed: bool) -> tuple[str, dict]:
    """B3 under autograd at one shape, bf16 in the path's layout: its lse
    and output against the plain version's (TOL_LSE, TOL_BF16_OUT), dq, dk,
    dv of the Function against plain autograd (TOL_FLASH_GRAD); ``timed``
    adds B3's device time without and with the lse, the plain version's,
    the forward's bound, the flash backward (key blocks of BLOCK_K and of
    128) with its bound, and scaled_dot_product_attention's forward and
    forward + backward.  Returns the printed line and the numbers."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import vjp
    from repro_torch.kernels.flash.kernel import flash_attention_cuda
    from repro_torch.kernels.flash.ref import attention_with_lse, reference_attention

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = randn(b, sq, hq, d).transpose(1, 2)          # the path's layout
    k = randn(b, sk, hkv, d).transpose(1, 2)
    v = randn(b, sk, hkv, dv).transpose(1, 2)
    dout = randn(b, hq, sq, dv)
    scale = d ** -0.5
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=scale, return_lse=True)
    want_out, want_lse = attention_with_lse(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    atol, rtol = TOL_LSE
    lse_err = float((lse - want_lse).abs().max())
    check(bool(((lse - want_lse).abs() <= atol + rtol * want_lse.abs()).all()),
          f"flash lse {label}: kernel and plain version differ ({lse_err:.3e})")
    out_err = float((out.float() - want_out.float()).abs().max())
    check(bool(((out.float() - want_out.float()).abs()
                <= TOL_BF16_OUT[0] + TOL_BF16_OUT[1] * want_out.float().abs()).all()),
          f"flash {label} with lse: output differs from the plain version ({out_err:.3e})")
    del want_out, want_lse
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(flash_ops.flash_attention(*leaves, causal=causal), leaves, dout)
    plain = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(reference_attention(*plain, causal=causal), plain, dout)
    gerr = 0.0
    for nm, g, w in zip("qkv", got, want):
        e = float((g.float() - w.float()).abs().max()) / max(1.0, float(w.float().abs().max()))
        check(e <= TOL_FLASH_GRAD, f"flash {label}: d{nm} of the Function against plain "
              f"autograd {e:.3e} (tolerance {TOL_FLASH_GRAD})")
        gerr = max(gerr, e)
    del plain, want, got
    st = {"lse_err": lse_err, "out_err": out_err, "grad_err": gerr}
    line = f"flash {label} B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} Dv={dv} bf16 " \
           f"{'causal' if causal else 'non-causal'} on {card}: lse max |err| {lse_err:.3e} " \
           f"(tolerance atol, rtol {TOL_LSE}), out {out_err:.3e}; dq, dk, dv against plain " \
           f"autograd {gerr:.3e} x max(1, max|g|) (tolerance {TOL_FLASH_GRAD})"
    if timed:
        st["fwd"] = device_ms(lambda: flash_attention_cuda(q, k, v, causal=causal, scale=scale),
                              "flash_fwd_bf16", iters=10)
        st["fwd_lse"] = device_ms(lambda: flash_attention_cuda(q, k, v, causal=causal,
                                                               scale=scale, return_lse=True),
                                  "flash_fwd_bf16", iters=10)
        block = flash_ops.BLOCK_K
        st["bwd"] = cuda_ms(lambda: vjp.flash_backward(q, k, v, out, lse, dout, causal=causal,
                                                       scale=scale, block_k=block), iters=3)
        st["bwd_128"] = cuda_ms(lambda: vjp.flash_backward(q, k, v, out, lse, dout,
                                                           causal=causal, scale=scale,
                                                           block_k=128), iters=3)
        st["fwd_bwd"] = cuda_ms(lambda: torch.autograd.grad(
            flash_ops.flash_attention(*leaves, causal=causal), leaves, dout), iters=3)
        st["sdpa_fwd_bwd"] = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=hq != hkv), leaves, dout), iters=5)
        st["bwd_bound"], st["bwd_bound_by"] = bound(
            *flash_bwd_work(b, hq, hkv, sq, sk, d, dv, 2, causal), BF16_FLOPS_PER_S)
        st["plain_lse"] = cuda_ms(lambda: attention_with_lse(q, k, v, causal=causal,
                                                             scale=scale), iters=3)
        st["sdpa_fwd"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=hq != hkv), iters=10)
        st["bound"], st["bound_by"] = bound(*flash_work(b, hq, hkv, sq, sk, d, dv, 2, causal),
                                            BF16_FLOPS_PER_S)
        line += (f"; B3 device {st['fwd']:.4f} ms without lse, {st['fwd_lse']:.4f} ms with it "
                 f"(plain {st['plain_lse']:.3f} ms, forward bound {st['bound']:.5f} ms "
                 f"({st['bound_by']}), scaled_dot_product_attention's forward "
                 f"{st['sdpa_fwd']:.4f} ms); the flash backward {st['bwd']:.3f} ms with key "
                 f"blocks of {block} ({st['bwd_128']:.3f} ms with 128; bound "
                 f"{st['bwd_bound']:.5f} ms ({st['bwd_bound_by']})), forward + backward "
                 f"{st['fwd_bwd']:.3f} ms against scaled_dot_product_attention's "
                 f"{st['sdpa_fwd_bwd']:.3f} ms (CUDA events)")
    del q, k, v, out, lse, leaves, dout
    return line, st


def flash_train_row(label: str, st: dict, launches=None) -> dict:
    """The JSON kernel row of a timed ``flash_train_case``."""
    return {"name": f"flash_fwd ({label}, train: with lse)", "route": "cuda",
            "source": FLASH_SRC, "replaces": "src/repro/kernels/flash/kernel.py:43",
            "launches": launches, "max_abs_err": max(st["lse_err"], st["out_err"]),
            "ms": st["fwd_lse"], "plain_ms": st["plain_lse"], "bound_ms": st["bound"],
            "bound_by": st["bound_by"], "library_ms": st["sdpa_fwd"]}


def lm_train_phase(card: str) -> list[dict]:
    """The LM zoo's training path on the card (see the module docstring,
    items 21-23): B3/B4 under autograd at the paths' shapes first (their
    device times want a profiler that has not yet traced a whole step), then
    agreement, then full-width training through TrainLoop.  The profiled
    steps come last in the script (``lm_train_split_phase``)."""
    import signal

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.launch import make_optimizer, make_train_fn, named_leaves, value_and_grad
    from repro_torch.models.model import build_model, count_params
    from repro_torch.train_lm import batch_fn_for, make_loop, train_config

    torch.backends.cuda.matmul.allow_tf32 = False      # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    root = ROOT / "build" / "chip_smoke_lm"
    shutil.rmtree(root, ignore_errors=True)
    counted: dict[str, int] = {}

    # ---- (c) B3 and B4 under autograd at the paths' shapes ------------- #
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    flash_row = None
    for label, b, hq, hkv, sq, sk, d, dv, causal in (
            ("zamba2-7b prefill", 2, 32, 32, 2048, 2048, 112, 112, True),
            ("whisper-tiny encoder", 4, 6, 6, 1500, 1500, 64, 64, False),
            ("whisper-tiny cross", 4, 6, 6, 128, 1500, 64, 64, False),
            ("whisper-tiny decoder self", 4, 6, 6, 128, 128, 64, 64, True),
            ("GQA group 4", 1, 32, 8, 1000, 1000, 112, 112, True),
            ("Dv != D", 2, 32, 32, 1000, 1000, 112, 64, True)):
        line, st = flash_train_case(card, gen, label, b, hq, hkv, sq, sk, d, dv, causal,
                                    timed=label.startswith(("zamba2", "whisper")))
        print(line, flush=True)
        if label == "whisper-tiny encoder":
            flash_row = flash_train_row("whisper-tiny encoder", st)
        torch.cuda.empty_cache()

    ssd_row = None
    for label, bt, s, h, p, g, n, chunk, scaled in (
            ("zamba2-7b prefill", 2, 2048, 112, 64, 2, 64, 64, False),
            ("xlstm-350m numerator", 1, 256, 4, 512, 4, 512, 64, True),
            ("xlstm-350m normalizer", 1, 256, 4, 1, 4, 512, 64, True)):
        x = randn(bt, s, h, p)
        Bm, Cm = randn(bt, s, g, n) * n ** -0.5, randn(bt, s, g, n)
        dt = F.softplus(torch.randn((bt, s, h), generator=gen, device="cuda") * 0.5 - 2.0)
        A = torch.exp(0.2 * torch.randn((h,), generator=gen, device="cuda"))
        sc = torch.rand((bt, s, h), generator=gen, device="cuda") if scaled else None
        dy, dh = randn(bt, s, h, p), torch.randn((bt, h, n, p), generator=gen, device="cuda")
        ins = [x, dt, A, Bm, Cm] + ([sc] if scaled else [])
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]

        def fwd(leaves=leaves, scaled=scaled, chunk=chunk):
            return ssd_ops.ssd_scan(*leaves[:5], chunk=chunk,
                                    in_scale=leaves[5] if scaled else None)
        y, hf = fwd()
        plain = [t.detach().clone().requires_grad_(True) for t in ins]
        wy, wh = ssd_chunked(*plain[:5], chunk=chunk, in_scale=plain[5] if scaled else None)
        wy = wy.to(x.dtype)
        # B4's own outputs at these shapes, against the plain version's
        errs = {}
        for nm, o, w, (atol, rtol) in (("y", y, wy, TOL_BF16_OUT), ("h_final", hf, wh,
                                                                      TOL_SSD_STATE)):
            d = (o.detach().float() - w.detach().float()).abs()
            errs[nm] = float(d.max())
            check(bool((d <= atol + rtol * w.detach().float().abs()).all()),
                  f"ssd {label}: B4's {nm} differs from the plain version ({errs[nm]:.3e}, "
                  f"tolerance atol, rtol {(atol, rtol)})")
        # the Function's wiring (padding, in_scale, a None h_final cotangent's zero): its
        # backward recomputes this same plain scan, so the two agree by construction
        got = torch.autograd.grad((y, hf), leaves, (dy, dh), retain_graph=True)
        want = torch.autograd.grad((wy, wh), plain, (dy, dh))
        gerr = 0.0
        for nm, gg, w in zip(("x", "dt", "A", "B", "C", "in_scale"), got, want):
            e = float((gg.float() - w.float()).abs().max()) / max(1.0, float(w.float().abs().max()))
            check(e <= TOL_LM_UNIT, f"ssd {label}: d{nm} of the Function against plain autograd "
                  f"{e:.3e} (tolerance {TOL_LM_UNIT})")
            gerr = max(gerr, e)
        template = SSD_TILED_BF16 if max(n, p) > 128 else "ssd_scan_bf16_kernel"
        # the Function's forward launches exactly this kernel, by profiler name; its time by CUDA
        # events and, where the window shows it, device time (late windows may lose kernels)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: fwd(ins), iters=20)
            seen = ssd_templates(lambda: fwd(ins))
        only_template(seen, template, f"ssd {label}")
        fwd_dev = next(iter(seen.values()))[1]
        bwd_ms = cuda_ms(lambda: torch.autograd.grad((y, hf), leaves, (dy, dh),
                                                     retain_graph=True), iters=3)
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: ssd_chunked(*ins[:5], chunk=chunk,
                                                   in_scale=sc if scaled else None), iters=2)
        nbytes, flops = ssd_work(bt, s, h, p, g, n, chunk, 2, scaled)
        f_ms, f_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        b_ms, b_by = bound(2 * nbytes, 2 * flops, BF16_FLOPS_PER_S)
        print(f"ssd {label} Bt={bt} S={s} H={h} P={p} G={g} N={n} chunk {chunk} bf16 on {card}: "
              f"B4's y max |err| {errs['y']:.3e} (tolerance atol, rtol {TOL_BF16_OUT}), h_final "
              f"{errs['h_final']:.3e} (tolerance {TOL_SSD_STATE}) against the plain version; "
              f"the Function's wiring: its gradients against plain autograd of the same plain "
              f"scan {gerr:.3e} x max(1, max|g|) (tolerance {TOL_LM_UNIT}); B4 {template} "
              f"{fwd_ms:.4f} ms (CUDA events; device {fwd_dev:.5f} ms; bound "
              f"{f_ms:.5f} ms, {f_by}, {f_ms / fwd_dev:.4f} of the device time), the recompute "
              f"backward {bwd_ms:.3f} ms (CUDA events; "
              f"bound {b_ms:.5f} ms, {b_by}: the gradients' products, twice the scan's), plain "
              f"forward {plain_ms:.3f} ms", flush=True)
        if label == "xlstm-350m numerator":
            ssd_row = {"name": "ssd_scan (xlstm-350m numerator, train)", "route": "cuda",
                       "source": SSD_SRC, "replaces": "src/repro/kernels/ssd/kernel.py:41",
                       "launches": None, "max_abs_err": max(errs.values()),
                       "ms": reported_ms(fwd_ms, fwd_dev),
                       "plain_ms": plain_ms, "bound_ms": f_ms, "bound_by": f_by,
                       "library_ms": None}
        del leaves, plain, got, want, y, hf
        torch.cuda.empty_cache()

    # ---- (b) agreement: the float32 SMOKE steps against the golden file  #
    golden = json.loads(LM_TRAIN_GOLDEN.read_text())
    conf = golden["config"]
    for arch, rec in golden["archs"].items():
        cfg = get_smoke_config(arch).scaled(dtype=conf["dtype"])
        model = build_model(cfg, remat=False)
        params = model.init_params(seed=conf["seed"], host=True)   # the file's weights
        tcfg = train_config(conf["total_steps"])
        opt = make_optimizer(tcfg)
        step_fn, state = make_train_fn(model, tcfg, opt), opt.init(params)
        sha = hashlib.sha256()
        for _, leaf in named_leaves(params):
            sha.update(leaf.detach().float().cpu().numpy().astype("<f4").tobytes())
        check(sha.hexdigest() == rec["init_sha256"],
              f"{arch} smoke f32: the host-drawn weights differ from the golden file's")
        # the file's tokens (another numpy may draw another Zipf stream; said below)
        stream = TokenStream(cfg.vocab_size, conf["seq"], conf["batch"],
                             seed=conf["stream_seed"])
        same_stream = all(stream.batch_at(i)["tokens"].tolist() == st["tokens"]
                          for i, st in enumerate(rec["steps"]))

        def batch_fn(step, cfg=cfg, rec=rec):
            tokens = torch.tensor(rec["steps"][step]["tokens"], dtype=torch.int32, device="cuda")
            out = {"tokens": tokens}
            if cfg.family == "audio":
                out["audio_embed"] = torch.zeros((tokens.shape[0], cfg.encoder_seq, cfg.d_model),
                                                 dtype=torch.bfloat16, device="cuda")
            return out
        before = dict(kbuild.LAUNCHES)
        errs = {"loss": 0.0, "grad_norm": 0.0, "leaf_norm": 0.0}
        first: list = []         # step 1 profiled: which templates ran
        names = kernel_names(lambda: first.append(step_fn(params, state, batch_fn(0))))
        for step, want in enumerate(rec["steps"]):
            params, state, metrics = first.pop() if first else step_fn(params, state,
                                                                         batch_fn(step))
            for k in ("loss", "grad_norm"):
                errs[k] = max(errs[k], abs(float(metrics[k]) / want[k] - 1))
            check(int(metrics["step"]) == want["step"], f"{arch}: step count")
        for n, t in named_leaves(params):
            w = rec["leaf_norms"][n]
            got = float(np.linalg.norm(t.detach().double().cpu().numpy().ravel()))
            errs["leaf_norm"] = max(errs["leaf_norm"], abs(got - w) / max(w, 1e-30))
        ran = {k: kbuild.LAUNCHES[k] - before[k] for k in ("flash_fwd", "ssd_scan")}
        f32 = {t: sum(t in nm for nm in names) for t in ("flash_fwd_f32", "flash_fwd_bf16",
                                                          "ssd_scan_f32", "ssd_scan_bf16",
                                                          SSD_TILED_BF16, SSD_TILED_F32)}
        check(all(errs[k] <= TOL_LM_GOLDEN[k] for k in errs),
              f"{arch} smoke f32: golden steps differ {errs} (tolerances {TOL_LM_GOLDEN})")
        # by name only what ran not: late in the script a window may lose its first kernels
        check(any(ran.values()) and not f32["flash_fwd_bf16"] and not f32["ssd_scan_bf16"]
              and not f32[SSD_TILED_BF16] and not f32[SSD_TILED_F32],
              f"{arch} smoke f32: launches {ran}, templates {f32}")
        print(f"{arch} SMOKE float32, {len(rec['steps'])} steps on {card} against "
              f"tests/golden/torch_lm_train_steps.json: loss {errs['loss']:.2e}, grad_norm "
              f"{errs['grad_norm']:.2e}, leaf norms {errs['leaf_norm']:.2e} relative "
              f"(tolerances {TOL_LM_GOLDEN}); initial weights' sha256 equal; TokenStream "
              f"(numpy {np.__version__}) draws the file's tokens: {same_stream}; launches {ran}, "
              f"step 1's templates by profiler name {f32}", flush=True)
        del model, params, state

    # ---- (b) agreement: full-width float32 units, kernel path vs plain  #
    for arch, kw, b, s, want_k in (
            ("whisper-tiny", {"encoder_layers": 1, "n_layers": 1}, 2, 64, {"flash_fwd": 3}),
            ("xlstm-350m", {"n_layers": 2}, 1, 256, {"ssd_scan": 2})):
        cfg = get_config(arch).scaled(dtype="float32", **kw)
        model = build_model(cfg, remat=False)
        params = model.init_params(seed=1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")}
        if cfg.family == "audio":
            batch["audio_embed"] = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                                               device="cuda")
        before = dict(kbuild.LAUNCHES)
        loss, grads = value_and_grad(model.loss, params, batch)
        mid = dict(kbuild.LAUNCHES)
        with plain_kernels():
            ploss, pgrads = value_and_grad(model.loss, params, batch)
        torch.cuda.synchronize()
        ran = {k: mid[k] - before[k] for k in ("flash_fwd", "ssd_scan") if mid[k] > before[k]}
        check(ran == want_k and kbuild.LAUNCHES == mid,
              f"{arch} f32 train unit: launches {ran}, expected {want_k}")
        lerr = abs(float(loss) - float(ploss)) / max(1.0, abs(float(ploss)))
        check(lerr <= TOL_LM_UNIT, f"{arch} f32 train unit: loss {float(loss)} against the plain "
              f"path's {float(ploss)}")
        gerr = grads_within(grads, pgrads, TOL_LM_UNIT)
        unit = "ec" if cfg.encoder_layers else cfg.pattern()
        print(f"{arch} f32 train unit ({unit}, d_model {cfg.d_model}), B={b} S={s}: kernel path "
              f"vs plain path on the card, loss {float(loss):.6f} ({lerr:.2e} relative), every "
              f"one of {len(named_leaves(grads))} gradient leaves within {gerr:.3e} x max(1, "
              f"max|g|) (tolerance {TOL_LM_UNIT}); launches {ran}", flush=True)
        del model, params, grads, pgrads
        torch.cuda.empty_cache()

    # ---- (a) full-width training through TrainLoop + make_train_fn ----- #
    for arch, (b, s, steps) in LM_TRAIN.items():
        full = get_config(arch)
        cfg = full.scaled(n_layers=LM_TRAIN_LAYERS[arch]) if arch in LM_TRAIN_LAYERS else full
        kern, template, per_mb = LM_TRAIN_PER_MB[arch]
        model = build_model(cfg, remat=False)
        params0 = model.init_params(seed=0)
        batch_fn = batch_fn_for(cfg, TokenStream(cfg.vocab_size, s, b, seed=0), model.device)
        mb = {k: v[: b // 2] for k, v in batch_fn(0).items()}
        loss0, grads = value_and_grad(model.loss, params0, mb)
        bad = [n for n, g in named_leaves(grads)
               if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0.0]
        check(bool(torch.isfinite(loss0)) and not bad,
              f"{arch}: first microbatch's loss {float(loss0)}, zero or non-finite gradients {bad}")
        n_leaves = len(named_leaves(grads))
        del grads
        # the path, counted: half the steps, a save, a resume for the rest
        ckpt = root / arch
        for k in kbuild.LAUNCHES:
            kbuild.LAUNCHES[k] = 0
        loop = make_loop(cfg, steps=steps // 2, batch=b, seq=s, ckpt_dir=ckpt,
                         save_every=steps // 2, metrics_path=ckpt / "metrics.jsonl",
                         params=params0, log_every=1)
        loop.run()
        loop2 = make_loop(cfg, steps=steps, batch=b, seq=s, ckpt_dir=ckpt, save_every=steps,
                          metrics_path=ckpt / "metrics.jsonl", params=params0, log_every=1)
        out = loop2.run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kbuild.LAUNCHES.items() if v}
        counted[arch] = launches.get(kern, 0)
        recs = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in recs]
        check(loop2.start_step == steps // 2 and out["final_step"] == steps
              and [r["step"] for r in recs] == list(range(1, steps + 1)),
              f"{arch}: resume at {loop2.start_step}, final step {out['final_step']}, logged "
              f"steps {[r['step'] for r in recs]}")
        check(all(np.isfinite(losses)), f"{arch}: losses {losses}")
        check(launches == {kern: steps * 2 * per_mb},
              f"{arch}: launches {launches}, expected {steps * 2 * per_mb} {kern} "
              f"({per_mb} a microbatch forward)")
        times = list(loop.timer.history) + list(loop2.timer.history)
        med = statistics.median(times)
        cut = "full config" if cfg is full else \
            f"full width, {cfg.n_layers} of {full.n_layers} layers (the script's clock)"
        print(f"{arch} trained on {card}: {cut} ({count_params(model)} parameters, "
              f"{cfg.dtype}), B={b} S={s}" + (f" + {cfg.encoder_seq} frames" if cfg.encoder_layers
                                              else "")
              + f", {steps} steps through TrainLoop (saved at step {steps // 2}, resumed there), "
              f"microbatches 2: losses {[round(x, 4) for x in losses]}; launches {launches} "
              f"({per_mb} a microbatch forward); all {n_leaves} gradient leaves non-zero and "
              f"finite in the first microbatch; {med * 1e3:.1f} ms a step = "
              f"{b * s / med:.0f} tokens/s (host clock around synchronized steps, median of "
              f"{len(times)}; steps {[round(t * 1e3, 1) for t in times]} ms)", flush=True)
        if arch == "whisper-tiny":   # an uninterrupted run gives the same steps
            loop3 = make_loop(cfg, steps=steps, batch=b, seq=s, ckpt_dir=root / f"{arch}-whole",
                              save_every=steps, metrics_path=root / f"{arch}-whole.jsonl",
                              params=params0, log_every=steps)
            loop3.run()
            whole = [json.loads(line)["loss"]
                     for line in (root / f"{arch}-whole.jsonl").read_text().splitlines()]
            same = all(torch.equal(x, y) for (_, x), (_, y) in
                       zip(named_leaves(loop3.params), named_leaves(loop2.params)))
            err = max(abs(x - y) / abs(y) for x, y in zip(losses, whole))
            check(err <= 1e-6, f"{arch}: resumed losses {losses}, uninterrupted {whole}")
            print(f"{arch} resume against an uninterrupted run: losses within {err:.2e} "
                  f"relative, final parameters bit-equal: {same}", flush=True)
            del loop3
        del loop, loop2, model, params0
        torch.cuda.empty_cache()
    for sig, h in handlers.items():     # TrainLoop installed its preemption flag
        signal.signal(sig, h)

    flash_row["launches"], ssd_row["launches"] = counted["whisper-tiny"], counted["xlstm-350m"]
    shutil.rmtree(root, ignore_errors=True)
    rows = [flash_row, ssd_row]
    print(f"lm train phase on {card}: {time.perf_counter() - t_phase:.1f} s; launches on the "
          f"training paths {counted}", flush=True)
    return rows


def lm_train_split_phase(card: str) -> None:
    """One profiled train step of each full-width training run (module
    docstring, item 24): its split over the lm.* ranges, the device's idle
    share, and B3's or B4's template by kernel name.  After the training
    phase: a profile of ~50k kernels leaves later profiler windows without
    kernels."""
    from repro_torch.configs import get_config

    for arch, (b, s, steps) in LM_TRAIN.items():
        cfg = get_config(arch)
        kern, template, per_mb = LM_TRAIN_PER_MB[arch]
        label = f"{arch} step B={b} S={s}"
        if arch != "whisper-tiny":   # one of the 12 xs units (a whole step: ~400k launches)
            cfg, per_mb = cfg.scaled(n_layers=2), 2
            label = f"{arch} one xs unit, step B={b} S={s}"
        train_step_split(card, label, cfg, b, s, steps, kern, template, 2 * per_mb)


def train_step_split(card: str, label: str, cfg, b: int, s: int, steps: int, kern: str,
                     template: str, want_ran: int) -> None:
    """One profiled train step of ``cfg`` (B = ``b``, S = ``s``, two
    microbatches): its split over the lm.* ranges, the device's idle share,
    and ``want_ran`` launches of ``template`` by kernel name (``kern``'s
    counter)."""
    import torch

    from repro_torch.data import TokenStream
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import make_optimizer, make_train_fn, value_and_grad
    from repro_torch.models.model import build_model
    from repro_torch.train_lm import batch_fn_for, train_config

    pm = build_model(cfg, remat=False)
    pparams = pm.init_params(seed=0)
    pbatch = batch_fn_for(cfg, TokenStream(cfg.vocab_size, s, b, seed=0), pm.device)(0)
    tcfg = train_config(steps)
    opt = make_optimizer(tcfg)
    step_fn = make_train_fn(pm, tcfg, opt)
    pstate = opt.init(pparams)
    before = kbuild.LAUNCHES[kern]
    step_fn(pparams, pstate, pbatch)              # warm
    torch.cuda.synchronize()

    def two_steps():    # the second is read: a late window may lose its first kernels
        step_fn(pparams, pstate, pbatch)
        torch.cuda.synchronize()
        torch.cuda._sleep(1)        # the steps' boundary on the device's clock
        step_fn(pparams, pstate, pbatch)
    seen = []
    for attempt in range(3):    # as device_ms: a window short of kernels is profiled again
        kernels, ranges, marks = profile_ranges(two_steps, "lm.", marks=True)
        check(len(marks) == 1, f"{label}: {len(marks)} marks between the profiled steps, "
                               "expected 1")
        first_end = min(en for nm, _, en in ranges if nm == "lm.optimizer")
        ranges = [r for r in ranges if r[1] > first_end]
        kernels = [k for k in kernels if k[1] >= marks[0][1]]
        ran = sum(template in nm for nm, _, _ in kernels)
        seen.append(ran)
        if ran == want_ran:
            break
    check(ran == want_ran and kbuild.LAUNCHES[kern] - before == (1 + 2 * len(seen)) * want_ran,
          f"{label}: {seen} {template} kernels by profiler name in the second profiled "
          f"step of {len(seen)} windows, expected {want_ran}")
    # the device clock against the host's: where the step's first kernel
    # falls from its first host range's start (it cannot start before it)
    early = sum(st < ranges[0][1] for _, st, _ in kernels)
    skew = (kernels[0][1] - ranges[0][1]) / 1e3
    split: dict[str, float] = {}
    for name, st, en in ranges:
        split[name] = split.get(name, 0.0) + (en - st) / 1e3
    t0 = min(st for _, st, _ in ranges)
    total = (max(en for _, _, en in ranges) - t0) / 1e3
    busy, window = busy_window([(st, en) for _, st, en in kernels])
    kms = sum(en - st for nm, st, en in kernels if template in nm) / 1e3
    print(f"{label} split on {card}, from the second of two profiled steps (the lm.* ranges, "
          f"host clock; "
          f"{total:.1f} ms from the first range's start to the last's end): "
          + ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
          + f"; device: {len(kernels)} kernels, busy {busy / 1e3:.2f} ms of a "
          f"{window / 1e3:.2f} ms window (idle {100 * (1 - busy / window):.1f}%), "
          f"{template} {ran} launches {kms:.3f} ms (profiler windows' counts {seen}); the "
          f"step's first kernel {skew:+.3f} ms from its first host range's start, {early} "
          f"kernels before it (the profiler's two clocks)", flush=True)
    del pm, pparams, pstate, pbatch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# the zoo's other archs train: B3 under autograd, float32 units, TrainLoop
# ---------------------------------------------------------------------- #
# (B, text tokens, patches) a training shape: the served shapes of ZOO_ARCHS, internlm2 as the
# dense archs.  kimi-k2-1t-a32b trains on the CPU only: one block is 19.4 G parameters
# (~155 GB in float32 with its gradients, ~78 GB in bf16), past the card's 80 GB
ZOO_TRAIN_SHAPES = {a: ZOO_ARCHS[a][1:4] for a in ("minicpm3-4b", "llava-next-mistral-7b",
                                                    "qwen3-14b", "qwen3-moe-235b-a22b")}
ZOO_TRAIN_SHAPES["internlm2-1.8b"] = (2, 1024, 0)
# (layers kept, B, S, steps) of the timed bf16 TrainLoop runs; an AdamW step as
# repro_torch.optim.adamw writes it holds ~24 bytes a parameter (bf16 params and grads 4, float32
# mu and nu 8, the new mu and nu and update's float32 base 12): internlm2-1.8b in full
# (1.89 G: ~45 GB), minicpm3-4b cut to 24 of 62 layers (1.88 G: ~45 GB; all 62, 4.26 G: ~102 GB);
# minicpm3 runs at 6 layers, internlm2 at 12 of 24 and both at two steps, by the script's clock
ZOO_TRAIN_LOOP = {"internlm2-1.8b": (12, 2, 1024, 2), "minicpm3-4b": (6, 2, 1024, 2)}


def zoo_train_unit(arch: str, card: str, gen) -> str:
    """One full-width layer of ``arch`` in float32 under ``Model.loss``,
    kernel path against plain path on the card: the loss and every gradient
    leaf within TOL_ZOO_F32 x max(1, |x|), every leaf non-zero, one B3 launch
    in the forward; for a MoE arch its routes compared as moe_block_f32
    does (a flip is a fault above TOL_MOE_FLIP).  Returns the printed line."""
    import contextlib

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import named_leaves, value_and_grad
    from repro_torch.models import mlp
    from repro_torch.models.model import build_model, count_params

    b, s, n_patches = ZOO_TRAIN_SHAPES[arch]
    c32 = get_config(arch).scaled(n_layers=1, dtype="float32")
    model = build_model(c32, remat=False)
    params = model.init_params(seed=1)
    batch = zoo_batch(c32, b, s, n_patches, torch.float32, gen)

    def run(plain: bool):
        with contextlib.ExitStack() as stack:
            routes = stack.enter_context(mlp.recorded_routes())
            if plain:
                stack.enter_context(plain_kernels())
            loss, grads = value_and_grad(model.loss, params, batch)
        torch.cuda.synchronize()
        return loss, grads, routes

    before = dict(kbuild.LAUNCHES)
    loss, grads, routes = run(False)
    ran = {k: n - before[k] for k, n in kbuild.LAUNCHES.items() if n > before[k]}
    check(ran == {"flash_fwd": 1}, f"{arch} f32 train unit: launches {ran}, expected one "
          "flash_fwd in the forward")
    mid = dict(kbuild.LAUNCHES)
    ploss, pgrads, proutes = run(True)
    check(kbuild.LAUNCHES == mid, f"{arch} f32 train unit: the plain path launched a kernel")
    flips = ""
    if c32.moe is not None:
        gates, top_e, want_e = routes[0].gates, routes[0].top_e, proutes[0].top_e
        k = c32.moe.top_k
        flipped = (top_e.sort(-1).values != want_e.sort(-1).values).any(-1)
        srt = torch.topk(gates.detach(), k + 1, dim=-1).values
        margin = srt[:, k - 1] - srt[:, k]
        flip_margins = [float(m) for m in margin[flipped]]
        check(all(m <= TOL_MOE_FLIP for m in flip_margins),
              f"{arch} f32 train unit: routes flipped at gate margins {flip_margins} (a flip "
              f"above {TOL_MOE_FLIP} is a fault)")
        flips = (f"; routes of {b * s} tokens: {len(flip_margins)} flipped"
                 + (f" at gate margins {flip_margins}" if flip_margins else "")
                 + f" (smallest k-th/(k+1)-th margin {float(margin.min()):.3e})")
        del gates, top_e, want_e, srt, margin
    del routes, proutes
    lerr = abs(float(loss) - float(ploss)) / max(1.0, abs(float(ploss)))
    check(lerr <= TOL_ZOO_F32, f"{arch} f32 train unit: loss {float(loss)} against the plain "
          f"path's {float(ploss)}")
    zero = [n for n, g in named_leaves(grads) if float(g.abs().max()) == 0.0]
    check(not zero, f"{arch} f32 train unit: zero gradient leaves {zero}")
    gerr = grads_within(grads, pgrads, TOL_ZOO_F32)
    n_leaves, n_params = len(named_leaves(grads)), count_params(model)
    del model, params, batch, grads, pgrads
    torch.cuda.empty_cache()
    return (f"{arch} f32 train unit (1 layer at full width, d_model {c32.d_model}, {n_params} "
            f"parameters), B={b} S={s}" + (f" after {n_patches} patches" if n_patches else "")
            + f": kernel path vs plain path on the card, loss {float(loss):.6f} ({lerr:.2e} "
            f"relative), every one of {n_leaves} gradient leaves non-zero and within {gerr:.3e} x "
            f"max(1, max|g|) (tolerance {TOL_ZOO_F32}); launches {ran} in the forward" + flips)


def zoo_train_phase(card: str) -> list[dict]:
    """The zoo's other archs on the training path (see the module docstring,
    items 36-39): B3 under autograd at their training shapes, a float32
    unit of one layer of each family, timed bf16 TrainLoop steps of
    internlm2-1.8b (12 of 24 layers) and minicpm3-4b (6 of 62), one profiled step of
    each."""
    import signal

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import named_leaves, value_and_grad
    from repro_torch.models.model import build_model, count_params
    from repro_torch.train_lm import batch_fn_for, make_loop

    torch.backends.cuda.matmul.allow_tf32 = False      # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    handlers = {sg: signal.getsignal(sg) for sg in (signal.SIGTERM, signal.SIGINT)}
    root = ROOT / "build" / "chip_smoke_zoo_train"
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(7)

    # ---- (a) B3 under autograd at each training shape ------------------- #
    stats = {}
    for arch, (b, s, n_patches) in ZOO_TRAIN_SHAPES.items():
        hq, hkv, d, dv = attn_heads(get_config(arch))
        seq = s + n_patches
        line, stats[arch] = flash_train_case(card, gen, f"{arch} train", b, hq, hkv, seq, seq,
                                             d, dv, True, timed=True)
        print(line, flush=True)
        torch.cuda.empty_cache()

    # ---- (b) one float32 layer of each family, kernel path vs plain ------ #
    for arch in ZOO_TRAIN_SHAPES:
        print(zoo_train_unit(arch, card, gen), flush=True)

    # ---- (c) timed bf16 steps through TrainLoop ------------------------- #
    counted = {}
    for arch, (layers, b, s, steps) in ZOO_TRAIN_LOOP.items():
        full = get_config(arch)
        cfg = full if layers is None else full.scaled(n_layers=layers)
        per_mb = cfg.pattern().count("a")
        model = build_model(cfg, remat=False)
        n_params = count_params(model)
        params0 = model.init_params(seed=0)
        batch_fn = batch_fn_for(cfg, TokenStream(cfg.vocab_size, s, b, seed=0), model.device)
        mb = {k: v[: b // 2] for k, v in batch_fn(0).items()}
        loss0, grads = value_and_grad(model.loss, params0, mb)
        bad = [n for n, g in named_leaves(grads)
               if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0.0]
        check(bool(torch.isfinite(loss0)) and not bad,
              f"{arch}: first microbatch's loss {float(loss0)}, zero or non-finite gradients {bad}")
        n_leaves = len(named_leaves(grads))
        del grads, mb, model
        torch.cuda.empty_cache()
        for k in kbuild.LAUNCHES:
            kbuild.LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        loop = make_loop(cfg, steps=steps, batch=b, seq=s, ckpt_dir=root / arch,
                         save_every=steps, metrics_path=root / arch / "metrics.jsonl",
                         params=params0, log_every=1)
        del params0
        saves = []       # a checkpoint here is ~10 bytes a parameter: the saves are counted,
        loop.ckpt.save = lambda step, state, blocking=True: saves.append(step)   # not written
        out = loop.run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v for k, v in kbuild.LAUNCHES.items() if v}
        counted[arch] = launches.get("flash_fwd", 0)
        losses = [json.loads(line)["loss"]
                  for line in (root / arch / "metrics.jsonl").read_text().splitlines()]
        check(out["final_step"] == steps and len(losses) == steps and saves == [steps, steps],
              f"{arch}: final step {out['final_step']}, {len(losses)} logged, saves {saves}")
        check(all(np.isfinite(losses)), f"{arch}: losses {losses}")
        check(launches == {"flash_fwd": steps * 2 * per_mb},
              f"{arch}: launches {launches}, expected {steps * 2 * per_mb} flash_fwd ({per_mb} a "
              "microbatch forward)")
        times = list(loop.timer.history)
        med = statistics.median(times)
        cut = "full config" if layers is None else \
            f"full width, {layers} of {full.n_layers} layers (the card's 80 GB; the script's clock)"
        print(f"{arch} trained on {card}: {cut} ({n_params} parameters, bf16), B={b} S={s}, "
              f"{steps} steps through TrainLoop, microbatches 2 (checkpoints counted, not "
              f"written: saves at steps {saves}): losses {[round(x, 4) for x in losses]}; "
              f"launches {launches} ({per_mb} a microbatch forward, one a layer); all {n_leaves} "
              f"gradient leaves non-zero and finite in the first microbatch; {med * 1e3:.1f} ms a "
              f"step = {b * s / med:.0f} tokens/s (host clock around synchronized steps, median "
              f"of {len(times)}; steps {[round(t * 1e3, 1) for t in times]} ms); peak allocated "
              f"{peak / 1e9:.2f} GB", flush=True)
        del loop
        torch.cuda.empty_cache()
    for sg, h in handlers.items():     # TrainLoop installed its preemption flag
        signal.signal(sg, h)
    shutil.rmtree(root, ignore_errors=True)

    # ---- one profiled step of each TrainLoop run ------------------------- #
    for arch, (layers, b, s, steps) in ZOO_TRAIN_LOOP.items():
        cfg = get_config(arch)
        label = f"{arch} step B={b} S={s}"
        if layers is not None:
            cfg = cfg.scaled(n_layers=layers)
            label = f"{arch} ({layers} layers) step B={b} S={s}"
        train_step_split(card, label, cfg, b, s, steps, "flash_fwd", "flash_fwd_bf16",
                         2 * cfg.pattern().count("a"))

    # launches: a TrainLoop run's where the arch has one, else its float32 unit's one
    rows = [flash_train_row(arch, st, counted.get(arch, 1))
            for arch, st in stats.items()]
    print(f"zoo train phase on {card}: {time.perf_counter() - t_phase:.1f} s; B3 launches in the "
          f"TrainLoop runs {counted}, one in each float32 unit's forward", flush=True)
    return rows


# zoo training's setting before its last depth cut: 12 of 62 layers, B = 2, S = 1024
REMAT_ARCH, REMAT_LAYERS, REMAT_B, REMAT_S = "minicpm3-4b", 12, 2, 1024
# remat against no remat: the same kernels on the same inputs, so every value
# should be bit-equal; this bound (x max(1, |x|), each gradient leaf by its largest
# entry) leaves room only for an unordered scatter's rounding
TOL_REMAT = 1e-3


def remat_phase(card: str) -> None:
    """Item 39a: one train step of minicpm3-4b (REMAT_LAYERS of its layers,
    microbatches 2, the seeded weights and the token stream's first batch)
    with remat off and one with it on, each from the same fresh state, after
    the loss's gradients of its first microbatch alone (their peak above the
    parameters is the activations' and the gradients': what remat moves;
    the step's peak is AdamW's update).  The remat-on loss and every
    gradient leaf of that microbatch, and the step's loss and grad_norm, are
    held to the remat-off ones within TOL_REMAT."""
    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import make_optimizer, make_train_fn, named_leaves, value_and_grad
    from repro_torch.models.model import build_model
    from repro_torch.train_lm import batch_fn_for

    t_phase = time.perf_counter()
    layers, b, s = REMAT_LAYERS, REMAT_B, REMAT_S
    full = get_config(REMAT_ARCH)
    cfg = full.scaled(n_layers=layers)
    tcfg = TrainConfig(microbatches=2)
    per_mb = cfg.pattern().count("a")
    res, off_grads, grad_err, n_leaves, n_equal = {}, {}, 0.0, 0, 0
    for remat in (False, True):
        model = build_model(cfg, remat=remat)
        params = model.init_params(seed=0)
        batch = batch_fn_for(cfg, TokenStream(cfg.vocab_size, s, b, seed=0), model.device)(0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        launched = kbuild.LAUNCHES["flash_fwd"]
        loss, grads = value_and_grad(model.loss, params, {k: v[: b // 2] for k, v in batch.items()})
        torch.cuda.synchronize()
        loss_peak = torch.cuda.max_memory_allocated() - base
        loss_launches = kbuild.LAUNCHES["flash_fwd"] - launched
        for name, g in named_leaves(grads):
            if not remat:                   # on the host: the remat run's peak is its own
                off_grads[name] = g.detach().cpu()
                continue
            want = off_grads.pop(name).to(g.device)
            scale = max(1.0, float(want.abs().max()))
            err = float((g.detach().double() - want.double()).abs().max())
            check(err <= TOL_REMAT * scale and bool(torch.isfinite(g).all()),
                  f"remat {REMAT_ARCH}: gradient {name} off by {err:.3e} from the remat-off "
                  f"one's (max |g| {scale:.3e}; tolerance {TOL_REMAT} x max(1, max|g|))")
            grad_err = max(grad_err, err / scale)
            n_leaves, n_equal = n_leaves + 1, n_equal + bool(torch.equal(g, want))
            del want
        check(not off_grads or not remat, f"remat {REMAT_ARCH}: leaves {sorted(off_grads)} "
              "missing from the remat run's gradients")
        first_loss = float(loss)
        del loss, grads
        opt = make_optimizer(tcfg)
        step, state = make_train_fn(model, tcfg, opt), opt.init(params)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for k in kbuild.LAUNCHES:
            kbuild.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        res[remat] = {"ms": (time.perf_counter() - t0) * 1e3, "loss_peak": loss_peak,
                      "first_loss": first_loss,
                      "loss_launches": loss_launches, "params": base,
                      "peak": torch.cuda.max_memory_allocated(), "resident": resident,
                      "launches": {k: v for k, v in kbuild.LAUNCHES.items() if v},
                      "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        del model, params, state, step, m, batch
        torch.cuda.empty_cache()
    off, on = res[False], res[True]
    for k in ("first_loss", "loss", "grad_norm"):
        check(abs(on[k] - off[k]) <= TOL_REMAT * max(1.0, abs(off[k])) and math.isfinite(on[k]),
              f"remat {REMAT_ARCH}: {k} {on[k]} with remat, {off[k]} without (tolerance "
              f"{TOL_REMAT} x max(1, |x|))")
    fwd = 2 * per_mb                                    # a layer a microbatch
    check(off["launches"] == {"flash_fwd": fwd} and on["launches"] == {"flash_fwd": 2 * fwd},
          f"remat {REMAT_ARCH}: B3 launches {off['launches']} without remat, {on['launches']} "
          f"with; expected {fwd} and {2 * fwd} (one recomputed forward a layer a microbatch)")
    check(on["loss_peak"] < off["loss_peak"] and on["loss_launches"] == 2 * per_mb
          and off["loss_launches"] == per_mb,
          f"remat {REMAT_ARCH}: the loss's gradients peaked {on['loss_peak']} bytes above the "
          f"parameters with remat ({on['loss_launches']} B3 launches), {off['loss_peak']} "
          f"without ({off['loss_launches']})")
    gib = 2 ** 30
    print(f"remat {REMAT_ARCH} on {card}: full width, {layers} of {full.n_layers} layers, bf16, "
          f"B={b} S={s}, one train step (microbatches 2) from the same seeded state: loss "
          f"{off['loss']:.6f} without remat, {on['loss']:.6f} with; grad_norm "
          f"{off['grad_norm']:.6f}, {on['grad_norm']:.6f}; the first microbatch's loss "
          f"{off['first_loss']:.6f}, {on['first_loss']:.6f} and its {n_leaves} gradient "
          f"leaves with remat within {grad_err:.3e} x max(1, max|g|) of those without "
          f"({n_equal} bit-equal; every bound {TOL_REMAT} x max(1, |x|)); that microbatch's loss "
          f"and gradients peaked "
          f"{off['loss_peak'] / gib:.3f} GiB above the {off['params'] / gib:.3f} GiB of "
          f"parameters without remat, {on['loss_peak'] / gib:.3f} GiB with; the step's peak "
          f"allocated {off['peak'] / gib:.3f} GiB without, "
          f"{on['peak'] / gib:.3f} GiB with ({(off['peak'] - off['resident']) / gib:.3f} and "
          f"{(on['peak'] - on['resident']) / gib:.3f} GiB above the {off['resident'] / gib:.3f} "
          f"GiB of parameters and AdamW state); B3 launches {off['launches']} without, "
          f"{on['launches']} with ({fwd} forward + {fwd} recomputed in the backward, one a layer "
          f"a microbatch); host-clock ms a step {off['ms']:.1f} without, {on['ms']:.1f} with "
          f"(one step each, after one microbatch's gradients: not a speed)", flush=True)
    print(f"remat phase on {card}: {time.perf_counter() - t_phase:.1f} s", flush=True)


# --------------------------------------------------------------------- #
# data and pipeline parallelism (items 29-33)
# --------------------------------------------------------------------- #
DP_RANKS = 2                    # gloo ranks on the one card
DP_TIMED_STEPS = 6              # bucket-32 steps timed in each run (the first is a warm-up)
PIPE_ARCH = "qwen3-14b"
PIPE = dict(n_stages=4, n_micro=4, b_mb=1, seq=2048)   # the cut and the microbatches
PIPE_REPEATS = 3                # pipelined against sequential, this many times
TOL_PIPE = 1e-3                 # the reference's pipelined-vs-sequential bound (0 expected)
PIPE_UNIT = dict(n_layers=4, stages=[[0, 1], [2, 3]], n_micro=2, seq=1024)   # float32 unit
TOL_COMPRESS = 1e-6             # x max |mean|: means and errors on the card against the CPU's
TRAIN_RESPECT_ARGS = ["--devices", "2", "--backend", "gloo", "--share-device",
                      "--save-every", "2", "--eval-every", "2"]
RELEASE_DP_ARGS = ["--devices", "2", "--backend", "gloo", "--share-device", "--max-steps", "2",
                   "--eval-every", "1", "--batch", "16", "--n-max", "20", "--stage-counts", "2,4",
                   "--ramp-batches", "1"]


def _leaf_diff(a: dict, b: dict) -> float:
    import numpy as np
    from repro_torch.checkpoint.manager import flatten_leaves
    la, lb = flatten_leaves(a), flatten_leaves(b)
    check([n for n, _ in la] == [n for n, _ in lb], "parameter trees differ")
    return max(float(np.abs(x.astype(np.float64) - y).max()) for (_, x), (_, y) in zip(la, lb))


def data_parallel_phase(card: str) -> None:
    """(a) two gloo ranks on the card reproduce the golden train steps, and
    a timed 2-rank run beside the single-process step; (b) the compressed
    all-reduce on two ranks against its CPU result; (c) the train_respect
    twin on two ranks, stopped and resumed; (d) the release trainer's rank
    body on two ranks (items 29-31, 35)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import flatten_leaves
    from repro_torch.core import (DagSampler, PipelineSystem, RespectScheduler,
                                  build_model_graph, prng, validate_monotone)
    from repro_torch.core import rl
    from repro_torch.core.ptrnet import param_tree, params_to_numpy
    from repro_torch import train_release
    from repro_torch.checkpoint import params_sha256, verify_release
    from repro_torch.optim import compress
    from repro_torch.parallel.data import run_ranks

    gold = json.loads(TRAIN_GOLDEN.read_text())
    c = gold["meta"]["config"]
    system = PipelineSystem(c["n_stages"])
    root = prng.PRNGKey(c["key_seed"])
    trainer_kw = dict(system=system, hidden=c["hidden"], lr=c["lr"], seed=c["seed"],
                      stage_counts=tuple(c["stage_counts"]))
    stream = DagSampler(seed=c["seed"], n=tuple(c["n"])).packed_stream(
        c["batch"], c["n_stages"], system=system, batches_per_epoch=TRAIN_DRAWS, epochs=1,
        batch_divisor=DP_RANKS)
    packs = list(stream)
    steps = len(gold["steps"])
    keys = [prng.fold_in(root, i) for i in range(len(packs))]

    # ---- (a) the golden steps on 2 ranks, counted in the ranks --------- #
    t0 = time.perf_counter()
    out = rl.train_data_parallel(packs[:steps], keys[:steps], DP_RANKS, backend="gloo",
                                 device="cuda", share_device=True, n_stages=c["n_stages"],
                                 record=True, timeout_s=600, **trainer_kw)
    t_run = time.perf_counter() - t0
    errs = {"reward": 0.0, "rel": 0.0, "param": 0.0, "norm": 0.0}
    for i, (pack, want) in enumerate(zip(packs, gold["steps"])):
        valid = pack.valid_mask()
        roll = {f: np.concatenate([o["rollouts"][i][f] for o in out])
                for f in out[0]["rollouts"][i]}
        got = {"bucket_n": pack.bucket_n, "batch": pack.batch,
               "n_valid_sha256": int_digest(pack.n_valid),
               "label_assign_sha256": int_digest(pack.label_assign),
               "metrics": out[0]["metrics"][i]}
        for p in ("sample", "baseline"):
            got[f"{p}_order_sha256"] = int_digest(np.where(valid.numpy(), roll[f"{p}_order"], -1))
            got[f"{p}_assign_sha256"] = int_digest(roll[f"{p}_assign"])
            got[f"{p}_rewards_sha256"] = f32_digest(roll[f"{p}_rewards"])
        after = dict(flatten_leaves(out[0]["params_by_step"][i]))
        e = golden_errors(want, got, after)
        errs = {k: max(errs[k], e[k]) for k in errs}
    for o in out:
        check(_leaf_diff(o["params"], out[0]["params"]) == 0.0,
              f"data parallel: rank {o['rank']}'s parameters differ from rank 0's")
        check(o["launches"]["ptr_decode_cluster"] == steps and o["launches"]["ptr_step"] == 0,
              f"data parallel rank {o['rank']}: launches {o['launches']}, expected one "
              f"ptr_decode_cluster a step ({steps})")
    print(f"data parallel golden on {card}: {DP_RANKS} gloo ranks sharing cuda:0 took the first "
          f"{steps} steps of tests/golden/torch_train_steps.json ({t_run:.1f} s with the ranks' "
          "start): labels, sampled and baseline orders, assignments and per-graph rewards equal "
          f"(each rank's slice); max error reward means {errs['reward']:.2e} (tolerance "
          f"{TOL_TRAIN_REWARD}), loss/entropy/advantage/grad_norm {errs['rel']:.2e} relative "
          f"({TOL_TRAIN_REL}), leaf norms {errs['norm']:.2e} ({TOL_TRAIN_REL}), parameter "
          f"entries {errs['param']:.2e} ({TOL_TRAIN_PARAM}); ranks' parameters equal; B1 "
          f"launches by rank {[o['launches']['ptr_decode_cluster'] for o in out]} "
          f"(one a step each)", flush=True)

    # ---- ms a step at bucket 32, two ranks beside one process ------------ #
    b32 = next(p for p in packs if p.bucket_n == 32)
    timed_keys = [prng.fold_in(root, 100 + i) for i in range(DP_TIMED_STEPS)]
    dp = rl.train_data_parallel([b32] * DP_TIMED_STEPS, timed_keys, DP_RANKS, backend="gloo",
                                device="cuda", share_device=True, n_stages=c["n_stages"],
                                timeout_s=600, **trainer_kw)
    single = rl.RLTrainer(**trainer_kw)
    t_single = []
    for k in timed_keys:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single.train_step(b32, k, n_stages=c["n_stages"])
        torch.cuda.synchronize()
        t_single.append(time.perf_counter() - t0)
    d = _leaf_diff(dp[0]["params"], params_to_numpy(single.params))
    check(d <= TOL_TRAIN_PARAM, f"data parallel bucket 32: parameters {d:.3e} from the "
          f"single-process run's (tolerance {TOL_TRAIN_PARAM})")
    ms_dp = [1e3 * statistics.median(o["step_s"][1:]) for o in dp]
    ms_one = 1e3 * statistics.median(t_single[1:])
    print(f"data parallel step on {card} (a correctness rig, not scaling: {DP_RANKS} gloo ranks "
          f"share one card and its host): bucket 32, B = {b32.batch} ({b32.batch // DP_RANKS} a "
          f"rank), {DP_TIMED_STEPS - 1} steps after a warm-up: {ms_dp[0]:.2f} ms a step (rank 0, "
          f"median; rank 1 {ms_dp[1]:.2f}) against {ms_one:.2f} ms in one process (host clock, "
          f"synchronized); parameters after {DP_TIMED_STEPS} steps {d:.2e} from the "
          "single-process run's", flush=True)
    del single

    # ---- (b) the compressed all-reduce over respect-v1's gradient shapes  #
    net = RespectScheduler.from_release(device="cpu").net
    rng = np.random.default_rng(7)
    stacked = optim_tree_numpy(param_tree(net), lambda a: (rng.normal(size=(DP_RANKS,) + a.shape)
                                                         * 1e-2).astype(np.float32))
    t0 = time.perf_counter()
    on_card = run_ranks(compress.compressed_all_reduce_rows, DP_RANKS, backend="gloo",
                        device="cuda", share_device=True, timeout_s=300, args=(stacked, None))
    t_card = time.perf_counter() - t0
    on_cpu = run_ranks(compress.compressed_all_reduce_rows, DP_RANKS, backend="gloo",
                       device="cpu", timeout_s=300, args=(stacked, None))
    worst = {"mean": 0.0, "err": 0.0}
    for a, b in zip(on_card, on_cpu):
        for part in ("q", "total", "scale"):
            check(_leaf_diff(a[part], b[part]) == 0.0,
                  f"compressed all-reduce: {part} on the card differs from the CPU's")
        for part in worst:
            worst[part] = max(worst[part], _leaf_diff(a[part], b[part]))
    scale = max(float(np.abs(x).max()) for _, x in flatten_leaves(on_cpu[0]["mean"]))
    check(max(worst.values()) <= TOL_COMPRESS * scale,
          f"compressed all-reduce: means/errors {worst} from the CPU's (|mean| up to {scale:.3e})")
    n_leaf = len(flatten_leaves(stacked))
    print(f"compressed all-reduce on {card}: {DP_RANKS} gloo ranks on cuda:0 over respect-v1's "
          f"{n_leaf} gradient leaves ({sum(x[0].size for _, x in flatten_leaves(stacked))} "
          f"floats a rank; {t_card:.1f} s with the ranks' start): int8 payloads, int32 totals and "
          f"scales equal the CPU ranks'; means max |diff| {worst['mean']:.2e}, error feedback "
          f"{worst['err']:.2e} (tolerance {TOL_COMPRESS} x |mean| {scale:.3e})", flush=True)

    # ---- (c) python -m repro_torch.train_respect on 2 ranks, resumed ----- #
    work = ROOT / "build" / "train_respect_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    common = [sys.executable, "-m", "repro_torch.train_respect", *TRAIN_RESPECT_ARGS,
              "--ckpt-dir", str(work / "ckpt"), "--out", str(work / "agent"),
              "--label-cache", str(work / "labels"), "--metrics", str(work / "metrics.jsonl")]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for steps_to in (2, 4):   # cut from 4 + 2 to 2 + 2 (the script's clock)
        t0 = time.perf_counter()
        proc = subprocess.run(common + ["--steps", str(steps_to)], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=900)
        dt = time.perf_counter() - t0
        check(proc.returncode == 0, f"train_respect --steps {steps_to} exited "
              f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
        print(f"train_respect --devices 2 --steps {steps_to} on {card} ({dt:.1f} s): "
              + " | ".join(lines[-4:]), flush=True)
        if steps_to == 4:
            check(any(ln.startswith("[resume] restored trainer checkpoint at step 2")
                      for ln in lines), "train_respect did not resume at step 2")
    logged = [json.loads(ln)["step"] for ln in (work / "metrics.jsonl").read_text().splitlines()]
    check(logged == list(range(1, 5)), f"train_respect logged steps {logged}")
    sched = RespectScheduler.load(work / "agent")
    golden = json.loads(GOLDEN.read_text())
    table1 = [build_model_graph(nm) for nm in golden["models"]]
    res = sched.schedule_many(table1, STAGES, use_cache=False)
    check(all(validate_monotone(g, r["assignment"], STAGES) for g, r in zip(table1, res)),
          "train_respect's agent: an invalid Table-I schedule")
    print(f"train_respect agent on {card}: loaded into RespectScheduler (hidden "
          f"{sched.hidden}) and scheduled the {len(table1)} Table-I graphs at k = {STAGES}, "
          "every schedule valid", flush=True)

    # ---- (d) the release trainer on 2 ranks: main's rank body, run_ranks - #
    argv = RELEASE_DP_ARGS + ["--out", str(work / "rel"), "--ckpt-dir", str(work / "rel_ckpt"),
                              "--label-cache", str(work / "labels")]
    args = train_release.parse_args(argv)
    t0 = time.perf_counter()
    ranks = run_ranks(train_release.train, args.devices, backend=args.backend,
                      share_device=args.share_device, timeout_s=600, args=(args, argv))
    dt = time.perf_counter() - t0
    _, manifest = verify_release(work / "rel")
    check(all(r == ranks[0] for r in ranks) and ranks[0]["steps"] == args.max_steps,
          f"train_release --devices {args.devices}: the ranks returned {ranks}")
    check(manifest["params_sha256"] == ranks[0]["params_sha256"]
          and manifest["train"]["steps"] == args.max_steps,
          "train_release --devices: the release holds other weights than the ranks")
    init = RespectScheduler.init(seed=0, hidden=args.hidden, device="cpu").net
    check(manifest["params_sha256"] != params_sha256(param_tree(init)),
          "train_release --devices: the weights did not move off their seeded init")
    print(f"train_release {' '.join(RELEASE_DP_ARGS)} on {card} ({dt:.1f} s with the ranks' "
          f"start): {args.max_steps} steps, the {args.devices} ranks' parameters equal (sha256 "
          f"{ranks[0]['params_sha256'][:16]}..., the release's), held-out exact-match "
          f"{ranks[0]['exact_match']:.3f} on every rank", flush=True)
    shutil.rmtree(work, ignore_errors=True)


def optim_tree_numpy(tree: dict, fn) -> dict:
    """``fn`` of each leaf of a tree of tensors, as numpy."""
    return {k: optim_tree_numpy(v, fn) if isinstance(v, dict) else fn(v.detach().cpu().numpy())
            for k, v in tree.items()}


def pipeline_phase(card: str) -> list[dict]:
    """(d) qwen3-14b at full width as a four-stage pipeline on the card, cut
    by the respect cut at train_4k (B1), against its sequential forward;
    B3 at the path's shape; (e) a float32 unit of 4 layers in 2 stages,
    kernel path against plain path (items 32-33)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import RespectScheduler
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.parallel.pipeline import PipelineRunner
    from repro_torch.pipeline_demo import layer_stages, partition_table, print_table

    torch.cuda.empty_cache()
    cfg = get_config(PIPE_ARCH)
    n_stages, n_micro, b_mb, seq = (PIPE[k] for k in ("n_stages", "n_micro", "b_mb", "seq"))
    sched = RespectScheduler.from_release()
    for k in kbuild.LAUNCHES:
        kbuild.LAUNCHES[k] = 0
    rows = partition_table(cfg, SHAPES["train_4k"], n_stages, sched)
    cut = dict(kbuild.LAUNCHES)
    print_table(rows, n_stages)
    check(cut["ptr_decode_cluster"] == 1 and sum(cut.values()) == 1,
          f"respect cut of {PIPE_ARCH}: launches {cut}, expected one ptr_decode_cluster")
    assign = next(a for m, a, _ in rows if m == "respect")
    stages = layer_stages(cfg, assign, n_stages)
    del sched
    runner = PipelineRunner(cfg, stages, n_micro=n_micro)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = runner.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    slots = n_stages * runner.l_max
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((n_micro, b_mb, seq, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    n_flash = cfg.n_layers * n_micro
    # ---- the path, counted: one pipelined forward ----------------------- #
    for k in kbuild.LAUNCHES:
        kbuild.LAUNCHES[k] = 0
    with torch.no_grad():
        y = runner.forward(params, x)
    torch.cuda.synchronize()
    ran = {k: n for k, n in kbuild.LAUNCHES.items() if n}
    check(ran == {"flash_fwd": n_flash},
          f"{PIPE_ARCH} pipeline: launches {ran}, expected {n_flash} flash_fwd "
          f"({cfg.n_layers} layers x {n_micro} microbatches)")
    check(y.shape == x.shape and bool(torch.isfinite(y.float()).all()),
          f"{PIPE_ARCH} pipeline: output not finite or misshapen")
    errs = []
    with torch.no_grad():
        for _ in range(PIPE_REPEATS):
            yp = runner.forward(params, x)
            ys = runner.sequential_forward(params, x)
            errs.append(float((yp.float() - ys.float()).abs().max()))
    check(max(errs) <= TOL_PIPE, f"{PIPE_ARCH} pipeline: pipelined vs sequential {errs}")
    del yp, ys
    with torch.no_grad():
        t_pipe = wall(lambda: runner.forward(params, x), reps=3)
        t_seq = wall(lambda: runner.sequential_forward(params, x), reps=3)
    peak = torch.cuda.max_memory_allocated()
    print(f"{PIPE_ARCH} pipeline on {card}: full width (d_model {cfg.d_model}, {cfg.n_layers} "
          f"layers, bf16, seeded weights drawn in {t_init:.2f} s), respect cut at train_4k "
          f"stage sizes {[len(s) for s in stages]} ({slots} stacked block slots), {n_micro} "
          f"microbatches of {b_mb} x {seq}: launches {ran}; pipelined vs sequential max |err| "
          f"{errs} (tolerance {TOL_PIPE}); pipelined {t_pipe * 1e3:.1f} ms, sequential "
          f"{t_seq * 1e3:.1f} ms (host clock, median of 3); bubble share "
          f"{runner.bubble_fraction:.3f} ({n_stages - 1} of {runner.ticks} ticks); peak "
          f"allocated {peak} bytes ({peak / 1e9:.2f} GB)", flush=True)
    for label, fn in (("pipelined", runner.forward), ("sequential", runner.sequential_forward)):
        for _ in range(3):
            with torch.no_grad():
                names = device_split(f"{PIPE_ARCH} {label} forward", card, lambda: fn(params, x))
            seen = sum("flash_fwd_bf16" in nm for nm in names)
            if not names or seen == n_flash:
                break
        if names:
            check(seen == n_flash and not any("flash_fwd_f32" in nm for nm in names),
                  f"{PIPE_ARCH} {label} forward ran {seen} flash_fwd_bf16 of {n_flash}")
            print(f"{PIPE_ARCH} {label} forward: {seen} flash_fwd_bf16 kernels by profiler name",
                  flush=True)
    del params, x, y, runner
    torch.cuda.empty_cache()

    # ---- B3 at the path's shape against its plain version ---------------- #
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = (torch.randn((b_mb, seq, h, d), generator=gen, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for h in (hq, hkv, hkv))

    def call():
        return flash_ops.flash_attention(q, k, v, causal=True, scale=d ** -0.5)
    got = call()
    with plain_kernels():
        ref = call()
        plain_ms = cuda_ms(call, iters=3)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max())
    check(bool((diff <= TOL_BF16_OUT[0] + TOL_BF16_OUT[1] * ref.float().abs()).all()),
          f"flash {PIPE_ARCH} pipeline: kernel and plain version differ (max |err| {err:.3e})")
    ev_ms = cuda_ms(call, iters=10)
    dev_ms = device_ms(call, "flash_fwd_bf16", iters=10)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=d ** -0.5, enable_gqa=hq != hkv), iters=10)
    b_ms, b_by = bound(*flash_work(b_mb, hq, hkv, seq, seq, d, d, 2), BF16_FLOPS_PER_S)
    print(f"flash_fwd {PIPE_ARCH} pipeline B={b_mb} Hq={hq} Hkv={hkv} S={seq} D={d} bf16 causal "
          f"on {card}: max |err| {err:.3e} (tolerance atol, rtol {TOL_BF16_OUT}); kernel "
          f"{ev_ms:.4f} ms (CUDA events; device {dev_ms:.4f} ms), plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})",
          flush=True)
    row = {"name": f"flash_fwd ({PIPE_ARCH} pipeline)", "route": "cuda", "source": FLASH_SRC,
           "replaces": "src/repro/kernels/flash/kernel.py:43", "launches": ran["flash_fwd"],
           "max_abs_err": err, "ms": reported_ms(ev_ms, dev_ms), "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    del q, k, v, got, ref

    # ---- (e) float32: 4 full-width layers in 2 stages, kernels vs plain -- #
    u = PIPE_UNIT
    c32 = cfg.scaled(n_layers=u["n_layers"], dtype="float32")
    r32 = PipelineRunner(c32, u["stages"], n_micro=u["n_micro"])
    p32 = r32.init_params(torch.Generator(device="cuda").manual_seed(2))
    x32 = torch.randn((u["n_micro"], 1, u["seq"], c32.d_model), generator=gen, device="cuda")
    before = dict(kbuild.LAUNCHES)
    with torch.no_grad():
        got = r32.forward(p32, x32)
        mid = dict(kbuild.LAUNCHES)
        with plain_kernels():
            ref = r32.forward(p32, x32)
    torch.cuda.synchronize()
    check(mid["flash_fwd"] - before["flash_fwd"] == u["n_layers"] * u["n_micro"]
          and kbuild.LAUNCHES == mid, f"{PIPE_ARCH} f32 pipeline unit: unexpected launches")
    err32 = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(err32 <= TOL_ZOO_F32 * max(1.0, scale),
          f"{PIPE_ARCH} f32 pipeline unit: kernel path and plain path differ (max |err| "
          f"{err32:.3e}, |x| {scale:.3f})")
    print(f"{PIPE_ARCH} f32 pipeline unit ({u['n_layers']} layers, d_model {c32.d_model}, "
          f"stages {u['stages']}, {u['n_micro']} microbatches of 1 x {u['seq']}) on {card}: "
          f"kernel path vs plain path max |err| {err32:.3e} (|x| up to {scale:.3f}, tolerance "
          f"{TOL_ZOO_F32} x max(1, |x|))", flush=True)
    del r32, p32, x32, got, ref
    torch.cuda.empty_cache()
    return [row]


# --------------------------------------------------------------------- #
# the example scripts and the sharding layer (items 40-44)
# --------------------------------------------------------------------- #
EDGE_DEPLOY = ROOT / "tests" / "golden" / "torch_edge_deploy.json"
TOL_DEPLOY = 1e-12      # relative: float64 re-derivations from equal assignments
SERVE_REQUESTS = 80     # serve_traffic's default, two bursts
SHARD_ARCH, SHARD_B, SHARD_S = "internlm2-1.8b", 2, 1024


def same_deploy_record(got: dict, want: dict, label: str) -> None:
    check(got["assign_sha256"] == want["assign_sha256"] and got["monotone"] == want["monotone"],
          f"{label}: assignment or monotone flag differs from {EDGE_DEPLOY.name}")
    rel = abs(got["bottleneck_s"] - want["bottleneck_s"]) / abs(want["bottleneck_s"])
    check(rel <= TOL_DEPLOY, f"{label}: bottleneck_s {got['bottleneck_s']!r} against "
          f"{want['bottleneck_s']!r} ({rel:.2e} relative, tolerance {TOL_DEPLOY})")


def examples_phase(card: str) -> list[dict]:
    """The example scripts' twins on the card (see the module docstring,
    items 40-42): edge_pipeline_deploy's table and quickstart held to
    tests/golden/torch_edge_deploy.json through the B1 template the rule
    picks for one graph (the wide one), serve_traffic's two bursts held to
    schedule_many and the golden pool; at the table's largest bucket the
    wide and the block template held to the plain version and timed in
    turns."""
    import numpy as np
    import torch

    from repro_torch import edge_pipeline_deploy as deploy
    from repro_torch.core import RespectScheduler, batching, build_model_graph
    from repro_torch.core.batching import bucket_for, pack_padded
    from repro_torch.kernels import build
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import (ARGTYPES, decode_batch, decode_batch_reference,
                                                decode_template, launch, wide_clusters)
    from repro_torch.quickstart import quickstart
    from repro_torch.serve_traffic import serve_traffic

    gold = json.loads(EDGE_DEPLOY.read_text())
    sched, trained = deploy.load_agent(ROOT / deploy.AGENT, None)
    check(not trained and sched.device.type == "cuda"
          and sched.hidden == gold["meta"]["hidden"],
          f"examples: expected the untrained seed-0 agent on the card, got trained={trained} "
          f"hidden {sched.hidden} on {sched.device}")

    # ---- edge_pipeline_deploy's table, counted, its time split --------- #
    # each part's host-clock seconds, the card synchronized around each call
    split = dict.fromkeys(("compiler emulation", "exact solver", "evaluation", "schedule",
                           "encode", "B1"), 0.0)

    def timed(part, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                split[part] += time.perf_counter() - t
        return run

    module_parts = ((deploy, "compiler_partition", "compiler emulation"),
                    (deploy, "exact_dp", "exact solver"), (deploy, "evaluate_schedule", "evaluation"),
                    (batching, "decode_batch", "B1"))
    originals = [getattr(m, name) for m, name, _ in module_parts]
    for (m, name, part), fn in zip(module_parts, originals):
        setattr(m, name, timed(part, fn))
    sched.schedule = timed("schedule", sched.schedule)
    sched.net.encode = timed("encode", sched.net.encode)
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    try:
        t0 = time.perf_counter()
        rows = deploy.deploy_table(sched)
        torch.cuda.synchronize()
        t_table = time.perf_counter() - t0
    finally:
        for (m, name, _), fn in zip(module_parts, originals):
            setattr(m, name, fn)
        del sched.schedule, sched.net.encode
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(len(rows) == len(gold["deploy"]) == 30, f"examples: {len(rows)} deploy rows")
    for got, want in zip(rows, gold["deploy"]):
        check((got["model"], got["k"], got["n"]) == (want["model"], want["k"], want["n"]),
              f"deploy rows out of order: {got['model']} k={got['k']}")
        for method in deploy.METHODS:
            same_deploy_record(got[method], want[method],
                               f"edge_pipeline_deploy {got['model']} k={got['k']} {method}")
    # one graph a schedule call: the rule's template at each row's bucket,
    # with the card's count of wide clusters there
    H, D = sched.hidden, sched.max_deg

    def one_graph(n):
        b = bucket_for(n)
        return decode_template(b, H, D, batch=1, clusters=wide_clusters(b, H, D))

    d_want = {}
    for r in rows:
        d_want[one_graph(r["n"])] = d_want.get(one_graph(r["n"]), 0) + 1
    check(d_want == {"ptr_decode_wide_f32": 30}, f"edge_pipeline_deploy: the rule picks {d_want}")
    check(launches == d_want, f"edge_pipeline_deploy: launches {launches}, expected {d_want} "
          "(one a schedule call, hidden 256)")
    differ = [f"{r['model']} k={r['k']}" for r in rows
              if r["respect"]["assign_sha256"] != r["exact"]["assign_sha256"]]
    speedups = [r["speedup"] for r in rows]
    rest = split["schedule"] - split["encode"] - split["B1"]
    parts = sum(split[k] for k in ("compiler emulation", "exact solver", "evaluation",
                                   "schedule"))
    print(f"edge_pipeline_deploy on {card}: 30 rows (10 Table-I models x k = 4, 5, 6) equal "
          f"{EDGE_DEPLOY.name} (sha256 and monotone flags equal, bottleneck_s within "
          f"{TOL_DEPLOY} relative) in {t_table:.3f} s (host clock, first call, exact solver and "
          f"compiler emulation included): compiler emulation {split['compiler emulation']:.3f} "
          f"s, exact solver {split['exact solver']:.3f} s, evaluation {split['evaluation']:.3f} "
          f"s, RESPECT's schedule calls {split['schedule']:.3f} s (encode {split['encode']:.3f}, "
          f"B1 {split['B1']:.3f}, pack, rho, repair and the rest {rest:.3f}), other "
          f"{t_table - parts:.3f} s; B1 launches by template {launches}; RESPECT differs "
          f"from exact in {len(differ)} rows ({', '.join(differ)}); mean RESPECT speedup over "
          f"the compiler emulation {np.mean(speedups):.4f}x (max {np.max(speedups):.4f}x)",
          flush=True)

    # ---- quickstart on ResNet50 at k = 4, counted --------------------- #
    want = gold["quickstart"]
    sched.clear_cache()
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    out = quickstart(sched, want["model"], want["stages"])
    torch.cuda.synchronize()
    q_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    q_want = {one_graph(build_model_graph(want["model"]).n): 1}
    check(q_launches == q_want, f"quickstart: launches {q_launches}, expected {q_want}")
    by_name = {r["scheduler"]: r for r in out["rows"]}
    for name, method in (("compiler", "compiler"), ("exact", "exact"), ("RESPECT", "respect")):
        same_deploy_record(by_name[name], want[method], f"quickstart {name}")
    check([(p["stage"], p["ops"], p["over_cache"]) for p in out["placement"]]
          == [(p["stage"], p["ops"], p["over_cache"]) for p in want["placement"]]
          and all(abs(p["param_bytes"] - w["param_bytes"]) <= TOL_DEPLOY * w["param_bytes"]
                  for p, w in zip(out["placement"], want["placement"])),
          "quickstart: RESPECT's per-stage placement differs from the golden file")
    print(f"quickstart {want['model']} k={want['stages']} on {card}: the three schedules and "
          f"RESPECT's per-stage placement equal {EDGE_DEPLOY.name}; RESPECT "
          f"{by_name['RESPECT']['solve_s'] * 1e3:.2f} ms to solve (host clock), launches "
          f"{q_launches}", flush=True)

    # ---- B1 at the table's largest bucket: the wide template, and the
    # block template forced, in turns, each against the plain version ---- #
    g = build_model_graph("InceptionResNetv2")
    net = sched.net
    batch = pack_padded([g], max_deg=D).to("cuda")
    n = batch.bucket_n
    wide_name = one_graph(g.n)
    force_block = build.load_function("ptr_decode", "ptr_decode_launch", ARGTYPES, FORCE_BLOCK)
    unif = torch.rand((1, n), generator=torch.Generator(device="cuda").manual_seed(n),
                      device="cuda")
    with torch.inference_mode():
        C, (h0, c0), emb = net.encode(batch.feats, batch.n_valid)
        args = (net, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
        before = ops.LAUNCHES[wide_name]
        k_out = decode_batch(*args)
        k_smp = decode_batch(*args, unif)
        *b_out, b_ran = launch(force_block, *args)
        plain_ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        plain_ev[0].record()
        p_out = decode_batch_reference(*args)
        plain_ev[1].record()
        p_smp = decode_batch_reference(*args, unif)
        torch.cuda.synchronize()
        check(ops.LAUNCHES[wide_name] == before + 2 and b_ran == "ptr_decode_block",
              f"examples B1 check: ran {b_ran} forced, {wide_name} "
              f"{ops.LAUNCHES[wide_name] - before} times")
        valid = torch.arange(n, device="cuda")[None, :] < batch.n_valid[:, None].long()
        errs = {}
        # greedy: the wide and the block template; sampled: the wide one
        for name, out, want in ((wide_name, k_out, p_out), ("ptr_decode_block", b_out, p_out),
                                (wide_name, k_smp, p_smp)):
            check(torch.equal(torch.where(valid, out[0], -1), torch.where(valid, want[0], -1)),
                  f"examples B1 bucket {n} {name}: orders differ from the plain version")
            errs[name] = max(errs.get(name, 0.0), float((out[1] - want[1]).abs().max()),
                             float((out[2] - want[2]).abs().max()))
            check(errs[name] <= TOL_LOGP,
                  f"examples B1 bucket {n} {name}: logp/entropy error {errs[name]:.3e}")
        same = all(torch.equal(a, b) for a, b in zip(k_out, b_out))
        ev_ms = cuda_ms(lambda: decode_batch(*args), iters=5)
        # each turn runs only its own template, by exact profiler name
        turns = turns_ms({wide_name: lambda: decode_batch(*args),
                          "ptr_decode_block": lambda: launch(force_block, *args)},
                         ("ptr_decode_block", wide_name, wide_name, "ptr_decode_block"), iters=3)
    plain_ms = plain_ev[0].elapsed_time(plain_ev[1])
    dev = {k: statistics.mean(v) for k, v in turns.items()}
    b_ms, b_by = bound(*decode_work([g], k_out[0].cpu().numpy(), n, H, D))
    print(f"ptr_decode edge_pipeline_deploy bucket {n}, B=1 (InceptionResNetv2) H={H} "
          f"({wide_name}) on {card}: kernel {ev_ms:.4f} ms (CUDA events), device time in turns "
          + ", ".join(f"{k} {' '.join(f'{x:.4f}' for x in v)} ms" for k, v in turns.items())
          + f" (block / wide {dev['ptr_decode_block'] / dev[wide_name]:.2f}), plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); orders equal the plain version's "
          f"(wide greedy and sampled, block greedy), max |err| logp/ent {errs[wide_name]:.2e} and "
          f"{errs['ptr_decode_block']:.2e} (tolerance {TOL_LOGP}); wide and block equal bit for "
          f"bit: {same}", flush=True)
    kernel_rows = [{"name": f"{wide_name} (edge_pipeline_deploy)", "route": "cuda",
                    "source": "src/repro_torch/kernels/ptr/csrc/ptr_decode.cu",
                    "replaces": "src/repro/kernels/ptr/decode.py:84",
                    "launches": launches.get(wide_name, 0), "max_abs_err": errs[wide_name],
                    "ms": reported_ms(ev_ms, dev[wide_name]), "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}]
    del sched, net, C, emb, args

    # ---- serve_traffic: two bursts of 80 requests, counted ------------ #
    serve_gold = gold["serve_traffic"]
    small = RespectScheduler.init(seed=0, hidden=serve_gold["hidden"])
    small.load_kernels()
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    out = serve_traffic(small, SERVE_REQUESTS, stages=serve_gold["stages"])
    torch.cuda.synchronize()
    s_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    pool, st = out["pool"], out["stats"]
    want = small.schedule_many(pool, serve_gold["stages"], use_cache=False)
    for burst in out["bursts"]:
        for i, r in zip(burst["pool_index"], burst["results"]):
            check(np.array_equal(r.assignment, want[i].assignment)
                  and r.assignment.tolist() == serve_gold["pool"][i]["assignment"]
                  and r["served_by"] == "policy",
                  f"serve_traffic {burst['tag']}: pool graph {i} differs from schedule_many's "
                  "or the golden pool's")
    second = out["bursts"][1]
    first_idx = set(out["bursts"][0]["pool_index"])
    check(st.failed == 0 and st.degraded == 0 and st.retries == 0 and st.worker_restarts == 0
          and st.completed == st.requests == 2 * SERVE_REQUESTS,
          f"serve_traffic: failed {st.failed}, degraded {st.degraded}, retries {st.retries}, "
          f"restarts {st.worker_restarts}, completed {st.completed} of {st.requests}")
    check(first_idx == set(range(len(pool))) and all(r["cache_hit"] for r in second["results"])
          and st.cache_misses == len(pool),
          f"serve_traffic: burst 2 not served from the cache and dedup (burst 1 drew "
          f"{sorted(first_idx)}, misses {st.cache_misses})")
    check(set(s_launches) == {"ptr_decode_cluster"},
          f"serve_traffic: launches {s_launches}, expected ptr_decode_cluster only (hidden 64)")
    rates = ", ".join(f"{b['tag'].split(' (')[0]} {len(b['results']) / b['seconds']:.1f} graphs/s"
                      f" ({b['seconds']:.3f} s)" for b in out["bursts"])
    print(f"serve_traffic on {card}: warm-up {out['warm_s']:.3f} s ({len(out['warm_keys'])} "
          f"batch shapes), {rates} (host clock); p50 {st.p50_ms:.2f} ms p99 {st.p99_ms:.2f} ms; "
          f"batches {st.batches} (largest {st.max_batch_observed}), hits {st.cache_hits}, "
          f"misses {st.cache_misses}, dedups {st.dedup_hits}; 0 failed, degraded or retried; "
          f"every result equal to schedule_many's and the golden pool's; launches {s_launches}",
          flush=True)
    del small
    return kernel_rows


def sharding_phase(card: str) -> list[dict]:
    """The sharded step makers on a one-device DeviceMesh on the card (see
    the module docstring, items 43-44): internlm2-1.8b at full width in
    bf16, prefill, one decode step and one train step through the step makers
    against the single-device calls; every returned sharding against the
    resolver's; B3 at the prefill's shape held to its plain version."""
    import warnings

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import (make_decode_step, make_optimizer, make_prefill_step,
                                    make_train_fn, make_train_step, named_leaves,
                                    single_device_mesh)
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import NamedSharding, axis_sizes, resolve_axes

    t_phase = time.perf_counter()
    had_group = dist.is_initialized()
    mesh = single_device_mesh()
    check(mesh.device_type == "cuda" and axis_sizes(mesh) == {"data": 1, "model": 1},
          f"sharding: mesh {mesh}")
    cfg = get_config(SHARD_ARCH)
    model = build_model(cfg, remat=False)
    meta = build_model(cfg, device="meta")
    params = model.init_params(seed=0)
    b, s = SHARD_B, SHARD_S
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    n_attn = cfg.pattern().count("a")

    def resolved(axes_tree, shapes, sh_tree, label) -> int:
        """Every leaf's sharding is the resolver's on ``mesh``; returns the
        leaf count."""
        axes = dict(named_leaves(axes_tree))
        shp = dict(named_leaves(shapes))
        got = dict(named_leaves(sh_tree))
        check(set(axes) == set(shp) == set(got), f"sharding {label}: trees differ")
        for name, ax in axes.items():
            want = NamedSharding(mesh, resolve_axes(ax, tuple(shp[name].shape), mesh))
            check(got[name] == want, f"sharding {label} {name}: {got[name]} against {want}")
        return len(axes)

    def cache_equal(a: dict, c: dict) -> bool:
        la, lc = named_leaves(a), named_leaves(c)
        return [n for n, _ in la] == [n for n, _ in lc] and all(
            torch.equal(x, y) for (_, x), (_, y) in zip(la, lc))

    # ---- prefill through its step maker, counted ------------------------- #
    specs, axes = model.input_records(ShapeConfig("sharding", s, b, "prefill"))
    fn, (p_sh, b_sh) = make_prefill_step(model, mesh, specs, axes)
    n_p = resolved(model.param_axes(), meta.init_params(), p_sh, "params")
    resolved(axes, specs, b_sh, "batch")
    # on the one-device mesh each placement puts the whole tensor on the card
    for name, leaf in named_leaves(params)[:4]:
        sh = dict(named_leaves(p_sh))[name]
        check(torch.equal(distribute_tensor(leaf, mesh, sh.placements).to_local(), leaf),
              f"sharding: {name} distributed by {sh.placements} is not the whole tensor")
    for key in kbuild.LAUNCHES:
        kbuild.LAUNCHES[key] = 0
    logits, cache = fn(params, {"tokens": tokens})
    torch.cuda.synchronize()
    launches = {k: v for k, v in kbuild.LAUNCHES.items() if v}
    check(launches == {"flash_fwd": n_attn},
          f"sharded prefill: launches {launches}, expected {n_attn} flash_fwd (one a layer)")
    want_logits, want_cache = model.prefill(params, {"tokens": tokens})
    check(torch.equal(logits, want_logits) and cache_equal(cache, want_cache),
          "sharded prefill: logits or cache differ from Model.prefill's")
    del cache, want_cache

    # ---- one decode step through its step maker -------------------------- #
    dfn, (p_sh2, tok_sh, c_sh) = make_decode_step(model, mesh, b, s + 1)
    check(p_sh2 == p_sh, "sharding: the decode step's parameter shardings differ")
    check(tok_sh == NamedSharding(mesh, resolve_axes(("batch", None), (b, 1), mesh)),
          f"sharding: token sharding {tok_sh}")
    n_c = resolved(model.cache_axes(), meta.init_cache(b, s + 1), c_sh, "cache")
    _, cache = model.prefill(params, {"tokens": tokens}, max_len=s + 1)
    ref_cache = copy.deepcopy(cache)
    tok = logits.argmax(-1)
    for key in kbuild.LAUNCHES:
        kbuild.LAUNCHES[key] = 0
    step_logits, cache = dfn(params, tok, cache, s)
    torch.cuda.synchronize()
    d_launches = {k: v for k, v in kbuild.LAUNCHES.items() if v}
    ref_logits, ref_cache = model.decode_step(params, tok, ref_cache, s)
    check(torch.equal(step_logits, ref_logits) and cache_equal(cache, ref_cache),
          "sharded decode step: logits or cache differ from Model.decode_step's")
    check(not d_launches, f"sharded decode step: launches {d_launches}, expected none")
    del cache, ref_cache

    # ---- one train step through its step maker --------------------------- #
    tcfg = TrainConfig(microbatches=1, lr=1e-3, warmup_steps=10, weight_decay=0.01)
    tspecs, taxes = model.input_records(ShapeConfig("sharding", s, b, "train"))
    tfn, (tp_sh, o_sh, tb_sh), optimizer = make_train_step(model, mesh, tcfg, tspecs, taxes)
    check(tp_sh == p_sh and o_sh.mu == p_sh and o_sh.nu == p_sh and o_sh.master is None
          and o_sh.step == NamedSharding(mesh, resolve_axes((), (), mesh)),
          "sharding: the optimizer state's shardings do not mirror the parameters'")
    resolved(taxes, tspecs, tb_sh, "train batch")
    batch = {"tokens": tokens}

    def one_step(step_fn, opt):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # cuBLAS' workspace note under deterministic mode
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                new_p, _, metrics = step_fn(params, opt.init(params), batch)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        host = {n: t.cpu() for n, t in named_leaves(new_p)}
        return host, {k: v.cpu() for k, v in metrics.items()}

    for key in kbuild.LAUNCHES:
        kbuild.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    got_p, got_m = one_step(tfn, optimizer)
    t_step = time.perf_counter() - t0
    t_launches = {k: v for k, v in kbuild.LAUNCHES.items() if v}
    ref_opt = make_optimizer(tcfg)
    want_p, want_m = one_step(make_train_fn(model, tcfg, ref_opt), ref_opt)
    moved = max(float((got_p[n].float() - p.cpu().float()).abs().max())
                for n, p in named_leaves(params))
    same = [n for n in got_p if torch.equal(got_p[n], want_p[n])]
    check(all(torch.equal(got_m[k], want_m[k]) for k in ("loss", "grad_norm", "step"))
          and len(same) == len(got_p),
          f"sharded train step: metrics {got_m} against {want_m}; {len(got_p) - len(same)} of "
          f"{len(got_p)} parameter leaves differ")
    check(bool(torch.isfinite(got_m["loss"])) and moved > 0,
          f"sharded train step: loss {got_m['loss']}, parameters moved {moved}")
    check(t_launches == {"flash_fwd": n_attn},
          f"sharded train step: launches {t_launches}, expected {n_attn} flash_fwd (forward)")
    print(f"sharding {SHARD_ARCH} on {card}: full config ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, bf16, seeded weights), B={b} S={s} on a one-device DeviceMesh "
          f"(data=1, model=1, cuda, one gloo rank): {n_p} parameter, {n_c} cache and the batch's "
          f"shardings equal the resolver's; make_prefill_step bit-equal to Model.prefill "
          f"(launches {launches}); make_decode_step (one step) bit-equal to Model.decode_step "
          f"(logits and cache; no kernel launch); make_train_step (one step, microbatches 1, "
          f"under torch.use_deterministic_algorithms) equal to make_train_fn's: loss "
          f"{float(got_m['loss']):.6f}, grad_norm {float(got_m['grad_norm']):.6f} and all "
          f"{len(got_p)} parameter leaves bit-equal (moved up to {moved:.3e}); {t_step:.3f} s a "
          f"step (host clock, first call), launches {t_launches}", flush=True)
    del got_p, want_p, params, model
    torch.cuda.empty_cache()
    row = flash_prefill_row(card, gen, f"{SHARD_ARCH} sharded prefill", cfg, b, s,
                            launches.get("flash_fwd", 0))
    if not had_group and dist.is_initialized():
        dist.destroy_process_group()
    print(f"sharding phase on {card}: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return [row]


DRYRUN_GOLDEN = ROOT / "tests" / "golden" / "torch_dryrun.json"
DRYRUN_TIMEOUT = 900
DRYRUN_REPS = 5          # timed calls of each step on the card (median)
# the dry run, in processes of their own (one fake process group a process):
# the golden cells in three shares, one with internlm2-1.8b at the sharding
# phase's shapes on a 1 x 1 mesh (prefill, and a train step of one microbatch)
DRYRUN_SHARES = 3
DRYRUN_CHILD = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import lower_cell, trace_step
from repro_torch.launch.roofline import roofline_from_cost
from repro_torch.models.model import analytic_flops
cells, arch, b, s = json.loads(sys.argv[1]), sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
out = {"golden": {}, "card": {}}
for key in cells:
    a, shape, mesh = key.split("__")
    t0 = time.perf_counter()
    rec = lower_cell(a, shape, mesh == "multi")
    out["golden"][key] = {k: rec[k] for k in ("memory", "roofline", "outputs", "fallbacks")}
    out["golden"][key]["seconds"] = time.perf_counter() - t0
for kind in ("prefill", "train") if arch else ():
    cfg = get_config(arch)
    shape = ShapeConfig("card", s, b, kind)
    res = trace_step(cfg, shape, (1, 1), ("data", "model"), microbatches=1, scopes=False)
    rl = roofline_from_cost(res["cost"], 1, analytic_flops(cfg, shape))
    out["card"][kind] = {"memory": res["memory"], "roofline": rl.as_dict()}
print(json.dumps(out))
"""


def start_dryrun() -> list[subprocess.Popen]:
    """The dry run's processes: they work on the host (meta tensors; the
    card is hidden from them) beside the card's last phases, their output
    in temporary files."""
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["CUDA_VISIBLE_DEVICES"] = ""
    cells = sorted(json.loads(DRYRUN_GOLDEN.read_text())["cells"])
    procs = []
    for i in range(DRYRUN_SHARES):
        files = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
        proc = subprocess.Popen(     # the second share is the lightest: it takes the card's
            [sys.executable, "-c", DRYRUN_CHILD, json.dumps(cells[i::DRYRUN_SHARES]),
             SHARD_ARCH if i == 1 else "", str(SHARD_B), str(SHARD_S)],
            cwd=ROOT, env=env, stdout=files[0], stderr=files[1])
        proc.output_files = files
        procs.append(proc)
    return procs


def dryrun_output(proc: subprocess.Popen) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of the dry run's process, waited for."""
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure(f"dryrun: the dry run's process ran past {DRYRUN_TIMEOUT} s")
    outs = []
    for f in proc.output_files:
        f.seek(0)
        outs.append(f.read())
        f.close()
    return rc, outs[0], outs[1]


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return 0 if tree is None else tree.numel() * tree.element_size()


def dryrun_phase(card: str, procs: list) -> None:
    """(a) the dry run's golden cells against tests/golden/torch_dryrun.json
    (the reference's, as tests/test_torch_dryrun.py holds them); (b)
    internlm2-1.8b at the sharding phase's shapes on a 1 x 1 mesh: the
    argument bytes equal to what the card holds, the peak estimate beside
    torch.cuda.max_memory_allocated, the roofline's bound at most the
    measured median step (prefill and a train step)."""
    import torch

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import make_prefill_step, make_train_step, single_device_mesh
    from repro_torch.launch.dryrun import reference_problems
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    res = {"golden": {}, "card": {}}
    for proc in procs:
        rc, out, err = dryrun_output(proc)
        check(rc == 0, f"dryrun: a dry run's process failed: {err[-3000:]}")
        share = json.loads(out.strip().splitlines()[-1])
        res["golden"].update(share["golden"])
        res["card"].update(share["card"])
    golden = json.loads(DRYRUN_GOLDEN.read_text())["cells"]
    check(set(res["golden"]) == set(golden), "dryrun: golden cells differ")
    for key, rec in sorted(res["golden"].items()):
        ref, rl, mem = golden[key], rec["roofline"], rec["memory"]
        problems = reference_problems(   # a prefill's cache in the decode layout (ROADMAP §C)
            mem, rl["flops_per_device"], rl["model_flops"], ref,
            rec["outputs"] if "__prefill_" in key else None)
        check(not problems, f"dryrun {key}: {problems}")
        print(f"dryrun {key} (model at published H100 peaks, not a measurement; reference "
              f"flops ratio {rl['flops_per_device'] / ref['hlo_cost']['flops_per_device']:.4f}): "
              f"compute {rl['compute_s']:.6g} s, memory {rl['memory_s']:.6g} s, collective "
              f"{rl['collective_s']:.6g} s, dominant {rl['dominant']}, mfu_bound "
              f"{rl['mfu_bound']:.4f}, {mem['peak_estimate_bytes'] / 2**30:.2f} GiB a device; "
              f"traced in {rec['seconds']:.1f} s", flush=True)

    # ---- (b) the one-card check: internlm2-1.8b, B = 2, S = 1024 -------- #
    cfg = get_config(SHARD_ARCH)
    model = build_model(cfg, remat=False)
    params = model.init_params(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (SHARD_B, SHARD_S), generator=gen,
                           device="cuda").to(torch.int32)
    batch = {"tokens": tokens}
    mesh = single_device_mesh()
    n_attn = cfg.pattern().count("a")

    def timed(fn) -> tuple[float, int]:
        """Median ms of DRYRUN_REPS calls (CUDA events, after one warm-up)
        and the peak bytes allocated during them."""
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(DRYRUN_REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), torch.cuda.max_memory_allocated()

    specs, axes = model.input_records(ShapeConfig("card", SHARD_S, SHARD_B, "prefill"))
    prefill, _ = make_prefill_step(model, mesh, specs, axes)
    for key in kbuild.LAUNCHES:
        kbuild.LAUNCHES[key] = 0
    prefill(params, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kbuild.LAUNCHES.items() if v}
    check(launches == {"flash_fwd": n_attn},
          f"dryrun prefill: launches {launches}, expected {n_attn} flash_fwd")
    held = {"prefill": tree_bytes(params) + tree_bytes(batch)}
    ms = {}
    ms["prefill"], peak_prefill = timed(lambda: prefill(params, batch))

    tcfg = TrainConfig(microbatches=1, master_fp32=False)
    tspecs, taxes = model.input_records(ShapeConfig("card", SHARD_S, SHARD_B, "train"))
    train, _, optimizer = make_train_step(model, mesh, tcfg, tspecs, taxes)
    opt = optimizer.init(params)
    held["train"] = (tree_bytes(params) + tree_bytes(batch) + tree_bytes(opt.mu)
                     + tree_bytes(opt.nu) + tree_bytes(opt.master) + tree_bytes(opt.step))
    ms["train"], peak_train = timed(lambda: train(params, opt, batch))
    peaks = {"prefill": peak_prefill, "train": peak_train}
    for kind in ("prefill", "train"):
        dry = res["card"][kind]
        bound_ms = dry["roofline"]["step_lower_bound_s"] * 1e3
        check(dry["memory"]["argument_bytes"] == held[kind],
              f"dryrun {kind}: argument bytes {dry['memory']['argument_bytes']} against "
              f"{held[kind]} held on the card")
        check(bound_ms <= ms[kind], f"dryrun {kind}: measured {ms[kind]:.3f} ms is below the "
              f"roofline's bound {bound_ms:.3f} ms: the roofline is wrong")
        print(f"dryrun one-card {SHARD_ARCH} {kind} B={SHARD_B} S={SHARD_S} on {card}: "
              f"argument bytes {held[kind]} equal to the card's; measured median "
              f"{ms[kind]:.3f} ms against the bound {bound_ms:.3f} ms ({dry['roofline']['dominant']}"
              f"-bound; measured / bound {ms[kind] / bound_ms:.3f}); peak estimate "
              f"{dry['memory']['peak_estimate_bytes'] / 2**30:.3f} GiB beside "
              f"max_memory_allocated {peaks[kind] / 2**30:.3f} GiB", flush=True)
    del params, opt, model
    torch.cuda.empty_cache()
    print(f"dryrun phase on {card}: {time.perf_counter() - t_phase:.1f} s", flush=True)


SX_RANKS = 4                         # ranks of the sharded-execution world
SX_ARCH, SX_MESH, SX_B, SX_S = "internlm2-1.8b", (2, 2), 2, 1024
SX_DECODE, SX_TRAIN_STEPS = 8, 2
SX_LAYERS = 4                        # the prefill's and decode's depth cut (the script's clock)
SX_TRAIN_LAYERS = 2                  # the train step's depth cut (layers only; see CHANGES.md)
SX_RESUME_MESH = (4, 1)              # where the (2, 2) state is restored
SX_UNIT = dict(arch="zamba2-7b", mesh=(1, 4), b=2, s=256, decode=4, layers=6)  # float32
# slices a and b of the zoo on real ranks: full widths, depth cut to the
# script's clock and to one card shared by four ranks (PERF.md §4).  Each
# cell's B3/B4 launches a rank by phase, and its kernels by profiler name
# in the profiled prefill.
SX_CELLS = (
    dict(name="whisper-tiny", arch="whisper-tiny", mesh=(2, 2), dtype="bfloat16", layers=None,
         b=4, s=64, max_len=80, decode=8, train=2, grads=False, feed=True,
         launches={"prefill": (12, 0), "decode": (0, 0), "train": (48, 0)},
         names={"flash_fwd_bf16": 12}),
    dict(name="xlstm-350m f32 unit", arch="xlstm-350m", mesh=(1, 4), dtype="float32", layers=2,
         b=2, s=256, max_len=None, decode=4, train=0, grads=True, feed=False,
         launches={"prefill": (0, 2), "decode": (0, 0), "grads": (0, 2)},
         names={SSD_TILED_F32: 2}),
    dict(name="xlstm-350m bf16 prefill", arch="xlstm-350m", mesh=(1, 4), dtype="bfloat16",
         layers=2, b=2, s=256, max_len=None, decode=0, train=0, grads=False, feed=False,
         launches={"prefill": (0, 2)}, names={SSD_TILED_BF16: 2}),
    # the loss's gradients, not train steps: with AdamW's moments the 151936-word
    # embedding and head need ~19 GB on each of the four ranks, past the shared
    # card.  The vocabulary's two gradients (3.1 GB in the reference's file) fit the
    # host as the ranks map that file (one copy in the page cache) and compare by blocks
    dict(name="qwen3-14b", arch="qwen3-14b", mesh=(2, 2), dtype="bfloat16", layers=2, b=2,
         s=1024, max_len=None, decode=8, train=0, grads=True, feed=True,
         launches={"prefill": (2, 0), "decode": (0, 0), "grads": (2, 0)},
         names={"flash_fwd_bf16": 2}),
    dict(name="llava-next-mistral-7b f32", arch="llava-next-mistral-7b", mesh=(2, 2),
         dtype="float32", layers=2, b=2, s=64, max_len=None, decode=4, train=0, grads=True,
         feed=False, launches={"prefill": (2, 0), "decode": (0, 0), "grads": (2, 0)},
         names={"flash_fwd_f32": 2}),
    # slices c and d: the loss's gradients under remat (B3 once more a layer in the
    # backward's recompute), not train steps, as qwen3-14b's (the vocabulary's AdamW
    # moments); qwen3-moe's 2 layers hold 9.6 GB of experts, at the rank tests'
    # capacity factor 1.0 (the mean load: every layer's prefill drops slots, so the
    # cross-rank slot positions decide which)
    dict(name="minicpm3-4b", arch="minicpm3-4b", mesh=(2, 2), dtype="bfloat16", layers=2,
         b=2, s=1024, max_len=None, decode=8, train=0, grads=True, feed=True, remat=True,
         launches={"prefill": (2, 0), "decode": (0, 0), "grads": (4, 0)},
         names={"flash_fwd_bf16": 2}),
    dict(name="qwen3-moe-235b-a22b", arch="qwen3-moe-235b-a22b", mesh=(2, 2), dtype="bfloat16",
         layers=2, b=2, s=512, max_len=None, decode=4, train=0, grads=True, feed=True,
         remat=True, capacity_factor=1.0, launches={"prefill": (2, 0), "decode": (0, 0), "grads": (4, 0)},
         names={"flash_fwd_bf16": 2}),
)
# a bf16 MoE router fed hidden states that differ by a rounding (another order of
# the tensor-parallel sums) may pick another expert where its k-th and (k+1)-th
# gates are that close: tests/test_torch_zoo_archs.py's NEAR_TIE.  A flip at a
# larger margin of the single process is a fault
NEAR_TIE = 2.0 ** -9
TOL_SX_BF16 = (0.12, 2e-2)           # the zoo's bf16 bound (PERF.md §2, "Their agreement")
TOL_SX_F32 = 1e-4                    # x max(1, |x|): the zoo's float32 bound
SX_DIR = ROOT / "build" / "sharded_exec"


def _sx_references(seed_tokens: int, arch: str, n_layers, dtype: str, b: int, s: int,
                   decode: int, train: int, train_layers, grads: bool,
                   max_len=None, remat: bool = False,
                   capacity_factor=None) -> tuple[dict, dict]:
    """The single-process calls on the card that the ranks are held to:
    prefill (cache of ``max_len``, default the VLM's patches + s + decode),
    ``decode`` greedy steps, ``train`` train steps (microbatches 2; a model
    of ``train_layers`` layers) and, with ``grads``, the loss and every
    gradient (``remat``: the loss rematerializes its layers), on ``b`` x
    ``s`` tokens and the model's other inputs (``launch.ranks.model_inputs``,
    kept under ``inputs/``); an MoE at ``capacity_factor`` where given.
    Returns (reference tensors on the host, host-clock ms of each call)."""
    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig
    from repro_torch.launch import (make_optimizer, make_train_fn, named_leaves, ranks,
                                    value_and_grad)
    from repro_torch.models.model import build_model

    cfg = ranks.config_of(arch, False, dtype, n_layers, capacity_factor)
    model = build_model(cfg, remat=remat)
    params = model.init_params(seed=0)
    tokens = np.random.default_rng(seed_tokens).integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)
    arrays = ranks.model_inputs(model, tokens, seed_tokens)
    specs, _ = ranks.input_records(model, b, s)
    batch = ranks.batch_of(arrays, specs, "cuda")
    ref, ms = {"tokens": torch.from_numpy(tokens)}, {}
    ref.update({f"inputs/{k}": torch.from_numpy(v) for k, v in arrays.items() if k != "tokens"})
    s += ranks.n_prefix(cfg)
    max_len = max_len or s + decode

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    logits, cache = timed("prefill", lambda: model.prefill(params, batch, max_len=max_len))
    ref["prefill/logits"] = logits.float().cpu()
    ref.update({f"prefill/cache/{n}": t.float().cpu() for n, t in named_leaves(cache)})
    for i in range(decode):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        ref[f"decode/{i}/token"] = tok.cpu()
        logits, cache = timed("decode", lambda: model.decode_step(params, tok, cache, s + i))
        ref[f"decode/{i}/logits"] = logits.float().cpu()
    del cache, logits
    if grads:
        loss, g = timed("grads", lambda: value_and_grad(model.loss, params, batch))
        ref["grads/loss"] = loss.float().cpu()
        # in their own dtype: a bf16 gradient is held in float64, exactly, and its
        # file is half a float32 one's (qwen3-14b's vocabulary: 3.1 GB)
        ref.update({f"grads/{n}": t.detach().cpu() for n, t in named_leaves(g)})
        del g
    if train:
        if train_layers is not None:
            del params
            model = build_model(cfg.scaled(n_layers=train_layers), remat=remat)
            params = model.init_params(seed=0)
        tcfg = TrainConfig(microbatches=2)
        opt = make_optimizer(tcfg)
        fn = make_train_fn(model, tcfg, opt)
        state = opt.init(params)
        for i in range(train):
            params, state, m = timed("train", lambda: fn(params, state, batch))
            ref[f"train/{i}/loss"] = m["loss"].float().cpu()
            ref[f"train/{i}/grad_norm"] = m["grad_norm"].float().cpu()
        del state
    del params, model
    torch.cuda.empty_cache()
    return ref, ms


def _sx_errors(res: list, names, tol, label: str, f32: bool) -> float:
    """Check every rank's errors of ``names`` against the reference; the
    largest error.  bf16 (``tol`` (atol, rtol)): max(|d| - rtol |want|) <=
    atol; float32 (``tol`` a factor): max |d| <= tol x max(1, max |want|)."""
    worst = 0.0
    for r in res:
        for name in names:
            check(name in r["errors"], f"{label}: rank {r['rank']} reported no {name}")
            err, scale, over = r["errors"][name]
            ok = err <= tol * max(1.0, scale) if f32 else over <= tol[0]
            check(ok, f"{label}: rank {r['rank']} {name} off by {err:.3e} (reference max "
                      f"{scale:.3e}; tolerance {tol})")
            worst = max(worst, err)
    return worst


def _sx_flash_row(card: str, gen, label: str, shape: tuple, dtype, launches: int,
                  causal: bool = True, dv: int | None = None) -> dict:
    """B3 at one rank's local shape (b, hq, hkv, sq, sk, d; values of ``dv``,
    default d), held to its plain version and timed beside SDPA: a
    kernels-line row with ``launches`` (summed over the ranks)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import ops as flash_ops

    b, hq, hkv, sq, sk, d = shape
    dv = dv or d
    f32 = dtype == torch.float32
    q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k, v = (torch.randn((b, sk, hkv, w), generator=gen, device="cuda").to(dtype).transpose(1, 2)
            for w in (d, dv))

    def call():
        return flash_ops.flash_attention(q, k, v, causal=causal, scale=d ** -0.5)
    got = call()
    with plain_kernels():
        want = call()
        plain_ms = cuda_ms(call, iters=3)
    err = float((got.float() - want.float()).abs().max())
    if f32:
        check(err <= TOL_SX_F32 * max(1.0, float(want.abs().max())),
              f"flash {label}: kernel and plain version differ (max |err| {err:.3e})")
    else:
        check(bool(((got.float() - want.float()).abs() <= TOL_BF16_OUT[0] + TOL_BF16_OUT[1]
                    * want.float().abs()).all()),
              f"flash {label}: kernel and plain version differ (max |err| {err:.3e})")
    ev_ms = cuda_ms(call, iters=10)
    dev_ms = device_ms(call, "flash_fwd_f32" if f32 else "flash_fwd_bf16", iters=10)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=d ** -0.5, enable_gqa=hq != hkv), iters=10)
    b_ms, b_by = bound(*flash_work(b, hq, hkv, sq, sk, d, dv, 4 if f32 else 2, causal),
                       F32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S)
    print(f"flash_fwd {label} rank-local B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} Dv={dv} "
          f"{'float32' if f32 else 'bf16'} {'causal' if causal else 'non-causal'} on {card}: "
          f"max |err| {err:.3e}; kernel {ev_ms:.4f} ms (CUDA events; device {dev_ms:.4f} ms), "
          f"plain {plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}); {launches} launches over the ranks", flush=True)
    return {"name": f"flash_fwd ({label} rank-local)", "route": "cuda", "source": FLASH_SRC,
            "replaces": "src/repro/kernels/flash/kernel.py:43", "launches": launches,
            "max_abs_err": err, "ms": reported_ms(ev_ms, dev_ms), "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def _sx_ssd_row(card: str, gen, label: str, shape: tuple, dtype, launches: int,
                in_scale: bool = False) -> dict:
    """B4 at one rank's local shape (bt, s, h, p, g, n, chunk), with the
    mLSTM's ``in_scale`` where asked, held to its plain version and timed:
    a kernels-line row with ``launches`` (summed over the ranks)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ops as ssd_ops

    bt, s, h, p, g, n, chunk = shape
    f32 = dtype == torch.float32
    x = torch.randn((bt, s, h, p), generator=gen, device="cuda").to(dtype)
    Bm, Cm = (torch.randn((bt, s, g, n), generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    dt = F.softplus(torch.randn((bt, s, h), generator=gen, device="cuda") * 0.5 - 2.0)
    A = torch.exp(0.2 * torch.randn((h,), generator=gen, device="cuda"))
    sc = torch.rand((bt, s, h), generator=gen, device="cuda") if in_scale else None

    def scan():
        return ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, in_scale=sc)
    y, hf = scan()
    with plain_kernels():
        wy, wh = scan()
        plain_ms = cuda_ms(scan, iters=2)
    err = max(float((y.float() - wy.float()).abs().max()), float((hf - wh).abs().max()))
    if f32:
        check(err <= TOL_SX_F32 * max(1.0, float(wy.abs().max()), float(wh.abs().max())),
              f"ssd {label}: kernel and plain version differ (max |err| {err:.3e})")
    else:
        check(bool(((y.float() - wy.float()).abs() <= TOL_BF16_OUT[0] + TOL_BF16_OUT[1]
                    * wy.float().abs()).all()) and float((hf - wh).abs().max()) <= 1e-4 * max(
                        1.0, float(wh.abs().max())),
              f"ssd {label}: kernel and plain version differ (max |err| {err:.3e})")
    ev_ms = cuda_ms(scan, iters=10)
    name = (SSD_TILED_F32 if f32 else SSD_TILED_BF16) if max(n, p) > 128 else (
        "ssd_scan_f32" if f32 else "ssd_scan_bf16")
    dev_ms = device_ms(scan, name, iters=10)
    b_ms, b_by = bound(*ssd_work(bt, s, h, p, g, n, chunk, 4 if f32 else 2, in_scale),
                       F32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S)
    print(f"ssd_scan {label} rank-local Bt={bt} S={s} H={h} P={p} G={g} N={n} chunk {chunk} "
          f"{'float32' if f32 else 'bf16'}{' in_scale' if in_scale else ''} on {card}: max "
          f"|err| {err:.3e}; kernel {ev_ms:.4f} ms (CUDA events; device {dev_ms:.4f} ms, {name}), "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}); {launches} launches over "
          "the ranks", flush=True)
    return {"name": f"ssd_scan ({label} rank-local)", "route": "cuda", "source": SSD_SRC,
            "replaces": "src/repro/kernels/ssd/kernel.py:41", "launches": launches,
            "max_abs_err": err, "ms": reported_ms(ev_ms, dev_ms), "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def sharded_exec_phase(card: str) -> list[dict]:
    """Item 47: the LM zoo's steps on four real ranks against the single
    process, with B3/B4 on each rank's local shards."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import ranks
    from repro_torch.parallel.data import run_ranks

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= SX_RANKS else "gloo"
    shutil.rmtree(SX_DIR, ignore_errors=True)
    SX_DIR.mkdir(parents=True)
    cfg = get_config(SX_ARCH)
    u = SX_UNIT

    # ---- the single-process calls first, each freed before the world ---- #
    ref, ms_single = _sx_references(0, SX_ARCH, SX_LAYERS, "bfloat16", SX_B, SX_S, SX_DECODE,
                                    SX_TRAIN_STEPS, SX_TRAIN_LAYERS, grads=False)
    torch.save(ref, SX_DIR / "internlm2.pt")
    uref, ums_single = _sx_references(1, u["arch"], u["layers"], "float32", u["b"], u["s"],
                                      u["decode"], 0, None, grads=True)
    torch.save(uref, SX_DIR / "zamba2.pt")
    cell_jobs, ms_cells, grad_names = _sx_cell_jobs()
    feed = [ref[f"decode/{i}/token"].numpy() for i in range(SX_DECODE)]
    jobs = [dict(kind="collectives", mesh=(1, SX_RANKS)),
            dict(kind="steps", arch=SX_ARCH, mesh=SX_MESH, tokens=ref["tokens"].numpy(),
                 smoke=False, dtype="bfloat16", n_layers=SX_LAYERS, decode=SX_DECODE, feed=feed,
                 train=SX_TRAIN_STEPS, train_layers=SX_TRAIN_LAYERS, full_params=False,
                 save_dir=str(SX_DIR / "ckpt"), resume_mesh=SX_RESUME_MESH, keep=False,
                 reference=str(SX_DIR / "internlm2.pt"), profile=True),
            dict(kind="steps", arch=u["arch"], mesh=u["mesh"], tokens=uref["tokens"].numpy(),
                 seed=0, smoke=False, dtype="float32", n_layers=u["layers"], decode=u["decode"],
                 grads=True, keep=False, reference=str(SX_DIR / "zamba2.pt"), profile=True)]
    jobs += cell_jobs
    del ref, uref

    # ---- the world -------------------------------------------------------- #
    # four ranks' pools on one 80 GB card: blocks a job freed go back to the
    # card (ranks.run_jobs), and segments grow in place instead of fragmenting
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2 ** 30
    t0 = time.perf_counter()
    out = run_ranks(ranks.run_jobs, SX_RANKS, backend=backend, device="cuda",
                    share_device=backend == "gloo", timeout_s=900, args=(jobs,))
    t_world = time.perf_counter() - t0
    coll, lm, unit, *cells = ([o[j] for o in out] for j in range(len(jobs)))
    print(f"sharded exec world on {card}: backend {backend}, {n_cards} card(s), "
          f"{SX_RANKS} ranks on {[c['device'] for c in coll]} "
          f"({t_world:.1f} s with the ranks' start; this process held {held:.2f} GiB of the "
          f"card while they ran; the single-process references before it "
          f"{t0 - t_phase:.1f} s); rank 0's jobs' seconds "
          f"{[(j.get('arch', j['kind']), o['job_s']) for j, o in zip(jobs, out[0])]}",
          flush=True)

    # ---- the collectives DTensor issues here ------------------------------ #
    for c in coll:
        check(all(c["ok"].values()), f"sharded exec: rank {c['rank']} collectives {c['ok']}")
    uses = [dict(c["shared_card_uses"]) for c in coll]
    print(f"sharded exec collectives on {card} ({backend}, CUDA tensors, along a 4-way axis): "
          f"{sorted(coll[0]['ok'])} equal to the host's results on every rank; the shared "
          f"card's all-gather taken {uses} times by rank (the functional all-gather through "
          "it, and once called directly)", flush=True)
    if backend == "gloo":
        check(all(u_.get("all_gather_into_tensor", 0) == 2 for u_ in uses),
              f"sharded exec: the shared card's all-gather taken {uses} times, expected 2 a rank")

    # ---- internlm2-1.8b on (2, 2) ----------------------------------------- #
    names = (["prefill/logits"] + [f"decode/{i}/logits" for i in range(SX_DECODE)]
             + [k for k in lm[0]["errors"] if k.startswith("prefill/cache/")])
    err_serve = _sx_errors(lm, names, TOL_SX_BF16, f"{SX_ARCH} {SX_MESH}", f32=False)
    train_names = [f"train/{i}/{k}" for i in range(SX_TRAIN_STEPS) for k in ("loss", "grad_norm")]
    err_train = _sx_errors(lm, train_names, TOL_SX_BF16, f"{SX_ARCH} {SX_MESH} train", f32=False)
    same_tok = sum(lm[0]["errors"][f"decode/{i}/token"][0] == 0 for i in range(SX_DECODE))
    n_train_layers = SX_TRAIN_LAYERS or cfg.n_layers
    for r in lm:
        want = {"prefill": SX_LAYERS, "decode": 0, "train": 2 * n_train_layers * SX_TRAIN_STEPS}
        got = {ph: r["launches"][ph]["flash_fwd"] for ph in want}
        check(got == want and all(r["launches"][ph]["ssd_scan"] == 0 for ph in want),
              f"{SX_ARCH} {SX_MESH} rank {r['rank']}: B3 launches {got}, expected {want}")
        named = sum(v for k, v in r["kernel_names"].items() if "flash_fwd_bf16" in k)
        check(named == SX_LAYERS and len(r["kernel_names"]) == 1,
              f"{SX_ARCH} {SX_MESH} rank {r['rank']}: kernels by name {r['kernel_names']}")
        check(r["cache_at_shardings"] and r["train_at_shardings"],
              f"{SX_ARCH} rank {r['rank']}: outputs off their shardings")
        res = r["resume"]
        check(res["equal"] == res["leaves"] and res["at_shardings"],
              f"{SX_ARCH} rank {r['rank']}: restore onto {SX_RESUME_MESH}: {res}")
    for group in (lm, unit):
        for r in group[1:]:
            diff = [k for k, v in group[0]["digests"].items() if r["digests"].get(k) != v]
            check(not diff, f"sharded exec: rank {r['rank']} differs from rank 0 in {diff[:4]}")

    def med(xs):
        return statistics.median(xs) if xs else float("nan")
    rk = lm[0]["ms"]
    print(f"{SX_ARCH} sharded on {card}: {SX_MESH} (data, model), {backend}, full width "
          f"({SX_LAYERS} of {cfg.n_layers} layers: depth cut, d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} "
          f"heads, bf16, seeded), B={SX_B} S={SX_S}: prefill logits and cache, {SX_DECODE} "
          f"decode steps' logits (fed the single process's greedy tokens; the ranks' own argmax "
          f"agreed at {same_tok} of {SX_DECODE}) within the zoo's bf16 bound {TOL_SX_BF16} of "
          f"the single process (max |err| {err_serve:.3e}); {SX_TRAIN_STEPS} train steps "
          f"(microbatches 2, {n_train_layers} of {cfg.n_layers} layers: depth cut) loss and "
          f"grad_norm max |err| {err_train:.3e}; B3 launches by rank "
          f"{[r['launches']['prefill']['flash_fwd'] for r in lm]} a prefill, "
          f"{[r['launches']['train']['flash_fwd'] for r in lm]} in the train steps, 0 in decode; "
          f"by profiler name {[r['kernel_names'] for r in lm][0]} on rank 0; every replicated "
          f"value equal on the {SX_RANKS} ranks", flush=True)
    rig = ("ranks sharing one card: a correctness rig, not scaling" if backend == "gloo"
           else "one rank a card")
    print(f"{SX_ARCH} sharded host-clock ms on {card} (rank 0 beside the single process; "
          f"{rig}): "
          f"prefill {med(rk['prefill']):.1f} (under the profiler) against "
          f"{med(ms_single['prefill']):.1f}, decode "
          f"step {med(rk['decode']):.1f} against {med(ms_single['decode']):.1f}, train step "
          f"{med(rk['train']):.1f} against {med(ms_single['train']):.1f}; peak allocated by "
          f"rank {[round(r['peak_bytes'] / 2 ** 30, 2) for r in lm]} GiB", flush=True)
    res = lm[0]["resume"]
    print(f"{SX_ARCH} elastic resume on {card}: the trained state ({res['leaves']} leaves) saved "
          f"on {SX_MESH} in {med(rk['save']):.0f} ms and restored onto {tuple(res['mesh'])} in "
          f"{med(rk['restore']):.0f} ms: every leaf bit-equal, at the target's placements, on "
          f"every rank", flush=True)

    # ---- the float32 zamba2-7b unit on (1, 4) ------------------------------ #
    unames = (["prefill/logits", "grads/loss"] + [f"decode/{i}/logits" for i in range(u["decode"])]
              + [k for k in unit[0]["errors"] if k.startswith(("prefill/cache/", "grads/"))])
    err_unit = _sx_errors(unit, unames, TOL_SX_F32, f"{u['arch']} unit {u['mesh']}", f32=True)
    toks = [unit[0]["errors"][f"decode/{i}/token"][0] for i in range(u["decode"])]
    check(not any(toks), f"{u['arch']} unit: greedy tokens differ from the single process's")
    for r in unit:
        got = {ph: r["launches"][ph] for ph in ("prefill", "decode", "grads")}
        want = {"prefill": {"flash_fwd": 1, "ssd_scan": 5}, "decode": {"flash_fwd": 0,
                "ssd_scan": 0}, "grads": {"flash_fwd": 1, "ssd_scan": 5}}
        check(got == want, f"{u['arch']} unit rank {r['rank']}: launches {got}, expected {want}")
        names_ = r["kernel_names"]
        check(sum(v for k, v in names_.items() if "flash_fwd_f32" in k) == 1
              and sum(v for k, v in names_.items() if "ssd_scan_f32" in k) == 5,
              f"{u['arch']} unit rank {r['rank']}: kernels by name {names_}")
    uk = unit[0]["ms"]
    print(f"{u['arch']} float32 unit sharded on {card}: {u['mesh']} (data, model), full width, "
          f"{u['layers']} layers mmmmmA, B={u['b']} S={u['s']}: prefill logits and cache, "
          f"{u['decode']} greedy decode steps (tokens equal), the loss and every gradient within "
          f"{TOL_SX_F32} x max(1, |x|) of the single process (max |err| {err_unit:.3e}); launches "
          f"by rank {[r['launches']['prefill'] for r in unit]} a prefill and a loss, 0 in "
          f"decode; by profiler name {unit[0]['kernel_names']} on rank 0; host-clock ms rank 0 "
          f"beside the single process: prefill {med(uk['prefill']):.1f} (under the profiler) "
          f"against "
          f"{med(ums_single['prefill']):.1f}, decode step {med(uk['decode']):.1f} against "
          f"{med(ums_single['decode']):.1f}, loss and gradients {med(uk['grads']):.1f} against "
          f"{med(ums_single['grads']):.1f}", flush=True)

    # ---- slices a and b: whisper-tiny, xlstm-350m, qwen3-14b, llava-next -- #
    _sx_check_cells(card, cells, ms_cells, grad_names)

    # ---- B3/B4 at the ranks' local shapes against their plain versions ----- #
    gen = torch.Generator(device="cuda").manual_seed(29)
    data, model_ax = SX_MESH
    lm_launches = {k: sum(r["launches"][ph][k] for r in lm for ph in r["launches"])
                   for k in ranks.KERNELS}
    u_launches = {k: sum(r["launches"][ph][k] for r in unit for ph in r["launches"])
                  for k in ranks.KERNELS}
    rows = [_sx_flash_row(card, gen, f"{SX_ARCH} {SX_MESH}",
                          (SX_B // data, cfg.n_heads // model_ax, cfg.n_kv_heads // model_ax,
                           SX_S, SX_S, cfg.resolved_head_dim), torch.bfloat16,
                          lm_launches["flash_fwd"])]
    ucfg = get_config(u["arch"])
    m = u["mesh"][1]
    nh = ucfg.ssm.expand * ucfg.d_model // ucfg.ssm.head_dim
    label = f"{u['arch']} unit {u['mesh']}"
    rows.append(_sx_flash_row(card, gen, label, (u["b"], ucfg.n_heads // m, ucfg.n_kv_heads // m,
                                                 u["s"], u["s"], ucfg.resolved_head_dim),
                              torch.float32, u_launches["flash_fwd"]))
    rows.append(_sx_ssd_row(card, gen, label, (u["b"], u["s"], nh // m, ucfg.ssm.head_dim, 1,
                                               ucfg.ssm.state_dim, ucfg.ssm.chunk),
                            torch.float32, u_launches["ssd_scan"]))
    rows += _sx_cell_rows(card, gen, cells)
    shutil.rmtree(SX_DIR, ignore_errors=True)
    print(f"sharded exec phase on {card}: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def _sx_cell_jobs() -> tuple[list, dict, dict]:
    """The single-process references of :data:`SX_CELLS`, each made and freed
    in turn and saved under :data:`SX_DIR`, and their rank jobs.  Returns
    (jobs, host-clock ms of the single process by cell, the names of each
    cell's reference gradients)."""
    import torch
    jobs, ms, grad_names = [], {}, {}
    for i, c in enumerate(SX_CELLS):
        ref, ms[c["name"]] = _sx_references(100 + i, c["arch"], c["layers"], c["dtype"], c["b"],
                                            c["s"], c["decode"], c["train"], None, c["grads"],
                                            c["max_len"], c.get("remat", False),
                                            c.get("capacity_factor"))
        path = SX_DIR / f"cell{i}.pt"
        torch.save(ref, path)
        grad_names[c["name"]] = {k for k in ref if k.startswith("grads/")}
        feed = [ref[f"decode/{j}/token"].numpy() for j in range(c["decode"])] if c["feed"] \
            else None
        torch.cuda.empty_cache()        # the reference's blocks, freed with its frame
        jobs.append(dict(kind="steps", arch=c["arch"], mesh=c["mesh"],
                         tokens=ref["tokens"].numpy(),
                         inputs={k[len("inputs/"):]: v.numpy() for k, v in ref.items()
                                 if k.startswith("inputs/")},
                         seed=0, smoke=False, dtype=c["dtype"], n_layers=c["layers"],
                         max_len=c["max_len"], decode=c["decode"], feed=feed, train=c["train"],
                         full_params=False, grads=c["grads"], reference=str(path), profile=True,
                         remat=c.get("remat", False), capacity_factor=c.get("capacity_factor"),
                         keep=("prefill/", "decode/") if _sx_routed(c) else False))
        del ref
    return jobs, ms, grad_names


def _sx_check_cells(card: str, cells: list, ms_single: dict, grad_names: dict) -> None:
    """Each cell of :data:`SX_CELLS` on its ranks against the single process:
    bf16 cells within the zoo's bound, float32 ones within 1e-4 x max(1,
    |x|) with the greedy tokens equal, every gradient in ``grad_names``
    reported by every rank; B3/B4 launches a rank by counter and by profiler name; every
    replicated value equal on the ranks."""
    import statistics

    from repro_torch.configs import get_config
    for i, (c, res) in enumerate(zip(SX_CELLS, cells)):
        f32 = c["dtype"] == "float32"
        label = f"{c['name']} {c['mesh']}"
        errs = res[0]["errors"]
        served = (["prefill/logits"] + [f"decode/{i}/logits" for i in range(c["decode"])]
                  + [k for k in errs if k.startswith("prefill/cache/")])
        routed = _sx_routed(c)
        names = ([] if routed else served) + sorted(grad_names[c["name"]]) + [
            f"train/{i}/{k}" for i in range(c["train"]) for k in ("loss", "grad_norm")]
        err = _sx_errors(res, names, TOL_SX_F32 if f32 else TOL_SX_BF16, label, f32=f32)
        flips = ""
        if routed:
            serve_err, flips = _sx_moe_served(label, res[0]["arrays"], SX_DIR / f"cell{i}.pt",
                                              c, served)
            err = max(err, serve_err)
        same_tok = sum(errs[f"decode/{i}/token"][0] == 0 for i in range(c["decode"]))
        if not c["feed"]:
            check(same_tok == c["decode"], f"{label}: greedy tokens differ from the single "
                                           "process's")
        for r in res:
            got = {ph: (r["launches"][ph]["flash_fwd"], r["launches"][ph]["ssd_scan"])
                   for ph in c["launches"]}
            check(got == c["launches"], f"{label} rank {r['rank']}: (B3, B4) launches {got}, "
                                        f"expected {c['launches']}")
            named = {want: sum(v for k, v in r["kernel_names"].items() if want in k)
                     for want in c["names"]}
            check(named == c["names"] and sum(r["kernel_names"].values()) == sum(
                c["names"].values()), f"{label} rank {r['rank']}: kernels by name "
                                      f"{r['kernel_names']}, expected {c['names']}")
            check(r["cache_at_shardings"] and (not c["train"] or r["train_at_shardings"]),
                  f"{label} rank {r['rank']}: outputs off their shardings")
        for r in res[1:]:
            diff = [k for k, v in res[0]["digests"].items() if r["digests"].get(k) != v]
            check(not diff, f"{label}: rank {r['rank']} differs from rank 0 in {diff[:4]}")
        cfg = get_config(c["arch"])
        depth = f"{c['layers']} of {cfg.n_layers} layers: depth cut" if c["layers"] else \
            "full depth"
        rk, single = res[0]["ms"], ms_single[c["name"]]
        times = ", ".join(f"{ph} {statistics.median(rk[ph]):.1f} against "
                          f"{statistics.median(single[ph]):.1f}" for ph in rk if ph in single)
        extra = (f", the VLM's {cfg.n_patches} patches before the text" if cfg.family == "vlm"
                 else f", {cfg.encoder_seq} frames" if cfg.family == "audio" else "")
        print(f"sharded exec {label} on {card}: full width ({depth}), {c['dtype']}, "
              f"B={c['b']} S={c['s']}{extra}: prefill logits and cache"
              + (f", {c['decode']} decode steps' logits" if c["decode"] else "")
              + (f" (fed the single process's greedy tokens; the ranks' own argmax agreed at "
                 f"{same_tok} of {c['decode']})" if c["feed"] else
                 " (greedy tokens equal)" if c["decode"] else "")
              + (", the loss and every gradient" if c["grads"] else "")
              + (f", {c['train']} train steps' loss and grad_norm" if c["train"] else "")
              + f" within {TOL_SX_F32 if f32 else TOL_SX_BF16} of the single process (max "
              f"|err| {err:.3e}{flips}); (B3, B4) launches a rank by phase "
              f"{res[0]['launches']}{' (remat: B3 once more a layer in the backward)' if c.get('remat') else ''}; by "
              f"profiler name on every rank {res[0]['kernel_names']}; every replicated value "
              f"equal on the {SX_RANKS} ranks; host-clock ms rank 0 beside the single process: "
              f"{times}", flush=True)


def _sx_routed(c) -> bool:
    """A bf16 MoE cell: its served values are held route by route."""
    from repro_torch.configs import get_config
    return c["dtype"] == "bfloat16" and get_config(c["arch"]).moe is not None


def _sx_moe_served(label: str, got: dict, path, c, names) -> tuple[float, str]:
    """A bf16 MoE cell's served values (rank 0's, gathered: ``names``)
    against the single process fed the ranks' routes.  A bf16 router fed
    hidden states that differ by a rounding (the tensor-parallel sums in
    another order) may pick another expert near a tie, and a flipped token's
    output then differs by far more than a rounding, in every later layer
    and step that reads it.  So the single process runs the prefill and the
    decode steps (fed the tokens the ranks were fed) again, each MoE layer
    taking the ranks' recorded experts (their gates from its own router),
    and every value must then be within TOL_SX_BF16; where its own top-k
    differs from the ranks', its k-th/(k+1)-th gate margin must be below
    :data:`NEAR_TIE`, else the flip is a fault.  Given the same experts, its
    slot positions and kept slots (an integer cumsum over the whole token
    axis, which the ranks split) must equal the ranks' exactly, and every
    layer's prefill must drop slots.  Returns (the largest error, a
    summary)."""
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.launch import named_leaves, ranks
    from repro_torch.models import mlp
    from repro_torch.models.model import build_model

    ref = torch.load(path, map_location="cpu", mmap=True)
    cfg = ranks.config_of(c["arch"], False, c["dtype"], c["layers"], c.get("capacity_factor"))
    model = build_model(cfg)
    params = model.init_params(seed=0)
    b, s = c["b"], c["s"]
    arrays = {"tokens": ref["tokens"].numpy(), **{k[len("inputs/"):]: v.numpy()
                                                  for k, v in ref.items() if k.startswith("inputs/")}}
    specs, _ = ranks.input_records(model, b, s)
    batch = ranks.batch_of(arrays, specs, "cuda")
    k = cfg.moe.top_k
    real = mlp.moe_route

    def forced(prefix: str, routes: list):
        """The router's gates with the ranks' experts of the call at ``prefix``."""
        def fn(p, cfg_, xf):
            gates, _, _ = real(p, cfg_, xf)
            top_e = torch.from_numpy(got[f"{prefix}/routes/{len(routes)}/top_e"]).to("cuda")
            top_p = gates.gather(-1, top_e)
            return gates, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e
        return fn

    mine, replayed = {}, {}
    with mlp.recorded_routes() as routes, \
            mock.patch.object(mlp, "moe_route", forced("prefill", routes)):
        logits, cache = model.prefill(params, batch, max_len=s + c["decode"])
    replayed["prefill"] = routes
    mine["prefill/logits"] = logits.float().cpu()
    mine.update({f"prefill/cache/{n}": t.float().cpu() for n, t in named_leaves(cache)})
    for i in range(c["decode"]):
        tok = ref[f"decode/{i}/token"].to("cuda")
        with mlp.recorded_routes() as routes, \
                mock.patch.object(mlp, "moe_route", forced(f"decode/{i}", routes)):
            logits, cache = model.decode_step(params, tok, cache, s + i)
        replayed[f"decode/{i}"] = routes
        mine[f"decode/{i}/logits"] = logits.float().cpu()
    del model, params, cache, logits
    torch.cuda.empty_cache()
    n_calls = sum(len(r) for r in replayed.values())
    check(n_calls == c["layers"] * (1 + c["decode"]) and all(
        len(r) == c["layers"] for r in replayed.values()),
        f"{label}: {n_calls} MoE calls replayed, expected {c['layers'] * (1 + c['decode'])}")
    margins, n_tok = [], 0
    for prefix, routes in replayed.items():
        for j, r in enumerate(routes):
            own = torch.topk(r.gates, k, dim=-1).indices
            flip = (own.sort(-1).values != r.top_e.sort(-1).values).any(-1)
            srt = torch.sort(r.gates, dim=-1, descending=True).values
            margins.extend((srt[:, k - 1] - srt[:, k])[flip].tolist())
            n_tok += int(r.top_e.shape[0])
            for name in ("pos", "keep"):
                want = got[f"{prefix}/routes/{j}/{name}"]
                check(np.array_equal(getattr(r, name).cpu().numpy(), want),
                      f"{label}: {prefix} MoE call {j}: the ranks' slot {name} differ from the "
                      f"single process's on the same experts")
    check(all(m < NEAR_TIE for m in margins), f"{label}: the ranks' routes differ from the single "
          f"process's at gate margins {sorted(margins)[-4:]} (above {NEAR_TIE} is a fault)")
    dropped = [int((~r.keep).sum()) for r in replayed["prefill"]]
    check(all(n > 0 for n in dropped), f"{label}: the prefill's MoE layers dropped {dropped} "
          "slots: the drop path did not run in every layer")
    dropped_dec = sum(int((~r.keep).sum()) for p_, rs in replayed.items() if p_ != "prefill"
                      for r in rs)
    atol, rtol = TOL_SX_BF16
    worst = 0.0
    for name in names:
        want, mine_ = mine[name].double().numpy(), got[name].astype(np.float64)
        d = np.abs(mine_ - want)
        check(float((d - rtol * np.abs(want)).max()) <= atol,
              f"{label}: {name} off by {float(d.max()):.3e} from the single process fed the "
              f"ranks' routes (tolerance {TOL_SX_BF16})")
        worst = max(worst, float(d.max()))
    return worst, (f"; the single process fed the ranks' routes: {len(margins)} of "
                   f"{n_tok} token routes its own router would have picked "
                   f"otherwise, at gate margins up to "
                   f"{max(margins, default=0.0):.3e} (below {NEAR_TIE}); on the same experts its "
                   f"slot positions and kept slots equal the ranks' in all {n_calls} MoE calls "
                   f"(capacity factor {cfg.moe.capacity_factor}: the prefill dropped {dropped} "
                   f"of {b * s * k} slots by layer, the {c['decode']} decode steps "
                   f"{dropped_dec})")


def _sx_cell_rows(card: str, gen, cells: list) -> list[dict]:
    """B3/B4 at each cell's rank-local shapes: kernels-line rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import ranks
    rows = []
    for c, res in zip(SX_CELLS, cells):
        total = {k: sum(r["launches"][ph][k] for r in res for ph in r["launches"])
                 for k in ranks.KERNELS}
        cfg = get_config(c["arch"])
        data, model_ax = c["mesh"]
        b = c["b"] // data
        dtype = torch.float32 if c["dtype"] == "float32" else torch.bfloat16
        label = f"{c['name']} {c['mesh']}"
        hq, hkv, d = cfg.n_heads // model_ax, cfg.n_kv_heads // model_ax, cfg.resolved_head_dim
        if cfg.attention == "mla":                  # the materialized K: D = nope + rope
            rows.append(_sx_flash_row(card, gen, label, (b, hq, hq, c["s"], c["s"],
                                                         cfg.qk_nope_head_dim + cfg.qk_rope_head_dim),
                                      dtype, total["flash_fwd"], dv=cfg.v_head_dim))
        elif cfg.family == "audio":
            per = total["flash_fwd"] // 3            # the three shapes launch alike
            for part, sq, sk, causal in (("encoder", cfg.encoder_seq, cfg.encoder_seq, False),
                                         ("self", c["s"], c["s"], True),
                                         ("cross", c["s"], cfg.encoder_seq, False)):
                rows.append(_sx_flash_row(card, gen, f"{label} {part}", (b, hq, hkv, sq, sk, d),
                                          dtype, per, causal))
        elif cfg.ssm is None:
            sq = c["s"] + (cfg.n_patches if cfg.family == "vlm" else 0)
            rows.append(_sx_flash_row(card, gen, label, (b, hq, hkv, sq, sq, d), dtype,
                                      total["flash_fwd"]))
        else:                                       # the mLSTM's two scans on local heads
            ph = cfg.ssm.expand * cfg.d_model // cfg.n_heads
            for part, p in (("numerator", ph), ("normalizer", 1)):
                rows.append(_sx_ssd_row(card, gen, f"{label} {part}",
                                        (b, c["s"], hq, p, hq, ph, cfg.ssm.chunk), dtype,
                                        total["ssd_scan"] // 2, in_scale=True))
    return rows


def run() -> dict:
    """Every phase; the dry run's process (the last phase's) never outlives
    the run."""
    import torch

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    dry = []
    try:
        return run_phases(card, dry)
    finally:
        for proc in dry:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(card: str, dry: list) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import (PipelineSystem, RespectScheduler, build_model_graph,
                                  sample_batch, validate_monotone)
    from repro_torch.core.batching import bucketize, pack_padded
    from repro_torch.core.segment import repair, rho_dp
    from repro_torch.kernels.ptr import ops
    from repro_torch.kernels.ptr.decode import (TEMPLATES, decode_batch, decode_batch_reference,
                                                decode_template, wide_clusters)
    from repro_torch.kernels.ptr.kernel import pointer_step_cuda, step_cluster_size
    from repro_torch.kernels.ptr.ref import reference_pointer_step

    # the four kernels, and B1 with its block template forced (the
    # examples' A/B at B = 1): one nvcc a library, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda a: ops.build_kernels(*a), [(), (["ptr_decode"], FORCE_BLOCK)]))
    print(f"build: all four kernels and B1's forced-block variant in "
          f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a, in parallel)", flush=True)

    golden = json.loads(GOLDEN.read_text())
    seeded_gold = json.loads(SEEDED_GOLDEN.read_text())["seeded"]
    names = list(golden["models"])
    table1 = [build_model_graph(nm) for nm in names]
    synth = sample_batch(np.random.default_rng(0), 64, n=30)
    sched = RespectScheduler.from_release()            # device: cuda
    check(sched.device.type == "cuda", "scheduler is not on the card")
    check(sched.release is not None
          and sched.release["params_sha256"] == golden["meta"]["params_sha256"],
          "release did not load or is not the golden one")
    wide = RespectScheduler.init(seed=0)               # default width 256, seeded; cuda
    check(wide.hidden == 256, "RespectScheduler.init's default width is not 256")
    hsys = PipelineSystem(**HETERO)
    hetero_graphs = [table1[names.index("InceptionResNetv2")], table1[names.index("ResNet50")]]
    hetero_graphs += synth[:16]

    # ---- the main path, counted ------------------------------------- #
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = sched.schedule_many(table1 + synth, STAGES, use_cache=False)
    torch.cuda.synchronize()
    t_uniform = time.perf_counter() - t0
    uniform_launches = dict(ops.LAUNCHES)
    res_w = wide.schedule_many(synth, STAGES, use_cache=False)
    torch.cuda.synchronize()
    wide_launches = {k: ops.LAUNCHES[k] - uniform_launches[k] for k in ops.LAUNCHES}
    # the first 14: two waves of the wide template's 16-block clusters
    before = dict(ops.LAUNCHES)
    res_few = wide.schedule_many(synth[:WIDE_BATCH], STAGES, use_cache=False)
    torch.cuda.synchronize()
    few_launches = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    t0 = time.perf_counter()
    res_h = sched.schedule_many(hetero_graphs, STAGES, hsys, use_cache=False)
    torch.cuda.synchronize()
    t_hetero = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"main path: uniform {len(table1) + len(synth)} graphs {t_uniform:.3f} s "
          f"(first call), hetero {len(hetero_graphs)} graphs {t_hetero:.3f} s; "
          f"launches {launches}", flush=True)
    n_buckets = len(bucketize(table1 + synth))
    check(uniform_launches["ptr_decode_cluster"] == n_buckets
          and uniform_launches["ptr_decode_block"] == 0,
          f"respect-v1 uniform batch: B1 launches {uniform_launches}, expected "
          f"{n_buckets} ptr_decode_cluster (one a bucket) and no ptr_decode_block")
    # the rule (decode.decode_template) with the card's own count of wide
    # clusters: 64 graphs of bucket 32 take the block template, 14 the wide
    D = sched.max_deg
    rule = {B: decode_template(32, 256, D, batch=B, clusters=wide_clusters(32, 256, D))
            for B in (len(synth), WIDE_BATCH)}
    check(rule == {len(synth): "ptr_decode_block", WIDE_BATCH: "ptr_decode_wide_f32"},
          f"the template rule at hidden 256, bucket 32: {rule}")
    for label, ran, B in (("width-256 batch", wide_launches, len(synth)),
                          (f"width-256 batch of {WIDE_BATCH}", few_launches, WIDE_BATCH)):
        want = {k: int(k == rule[B]) for k in TEMPLATES.values()}
        check({k: ran[k] for k in TEMPLATES.values()} == want,
              f"{label}: B1 launches {ran}, expected one {rule[B]}")
    check(all(r["assignment"].shape == (g.n,) and validate_monotone(g, r["assignment"], STAGES)
              for g, r in zip(synth, res_w)), "width-256 batch: invalid schedule")
    bad = digest_misses(schedule_digests(res_w), seeded_gold["256"]["synthetic"])
    check(not bad, f"width-256 batch: graphs {bad} differ from the seeded golden file")
    bad = digest_misses(schedule_digests(res_few),
                        {k: v[:WIDE_BATCH] for k, v in seeded_gold["256"]["synthetic"].items()})
    check(not bad, f"width-256 batch of {WIDE_BATCH}: graphs {bad} differ from the seeded "
          "golden file")
    hetero_steps = sum(bucketize(hetero_graphs))   # one B2 launch a step of each bucket
    check(launches["ptr_step"] == hetero_steps,
          f"heterogeneous batch: {launches['ptr_step']} ptr_step launches, expected "
          f"{hetero_steps} (the sum of its buckets' n)")

    # ---- outputs: golden digests and the CPU plain path --------------- #
    cpu = RespectScheduler.from_release(device="cpu")
    bad = []
    for nm, g, r in zip(names, table1, res):
        want = golden["models"][nm]
        ok = (digest(r["order"]) == want["order_sha256"]
              and digest(r["assignment"]) == want["assign_sha256"])
        check(r["assignment"].shape == (g.n,) and validate_monotone(g, r["assignment"], STAGES),
              f"{nm}: invalid schedule")
        if not ok:
            bad.append(f"{nm}: {first_divergence(cpu.net, g, r['order'], cpu.max_deg)}")
    check(not bad, "golden digests differ on the card:\n  " + "\n  ".join(bad))
    print(f"golden: all {len(names)} Table-I order and assignment digests match", flush=True)
    res_cpu = cpu.schedule_many(synth, STAGES, use_cache=False)
    for r, rc in zip(res[len(table1):], res_cpu):
        check(np.array_equal(r["order"], rc["order"])
              and np.array_equal(r["assignment"], rc["assignment"]),
              "synthetic batch: card and CPU plain path disagree")

    def same_as_cpu(label, got, cpu_sched):
        want = cpu_sched.schedule_many(hetero_graphs, STAGES, hsys, use_cache=False)
        bad = [f"{i}: {first_divergence(cpu_sched.net, g, r['order'], D, hsys)}"
               for i, (g, r, rc) in enumerate(zip(hetero_graphs, got, want))
               if not (np.array_equal(r["order"], rc["order"])
                       and np.array_equal(r["assignment"], rc["assignment"]))]
        check(not bad, f"{label}: card and CPU plain path disagree:\n  " + "\n  ".join(bad))

    same_as_cpu("heterogeneous batch", res_h, cpu)
    print(f"outputs: {len(synth)} synthetic and {len(hetero_graphs)} heterogeneous schedules "
          "equal the CPU plain path", flush=True)

    # other widths: the heterogeneous batch at hidden 96 and 640 runs the
    # scan, B2 at every step, as on the CPU (a profile-conditioned batch);
    # a uniform one at hidden 384 runs B1's block template, whose thread
    # groups loop over the columns (the wide one's float32 columns do not fit)
    widths = {}
    for Hw in (96, 640):
        widths[Hw] = RespectScheduler.init(seed=0, hidden=Hw)
        before = ops.LAUNCHES["ptr_step"]
        got = widths[Hw].schedule_many(hetero_graphs, STAGES, hsys, use_cache=False)
        torch.cuda.synchronize()
        ran = ops.LAUNCHES["ptr_step"] - before
        check(ran == hetero_steps,
              f"hidden {Hw}: {ran} ptr_step launches, expected {hetero_steps}")
        same_as_cpu(f"heterogeneous batch at hidden {Hw}", got,
                    RespectScheduler.init(seed=0, hidden=Hw, device="cpu"))
        if str(Hw) in seeded_gold:
            bad = digest_misses(schedule_digests(got), seeded_gold[str(Hw)]["hetero"])
            check(not bad, f"hidden {Hw}: graphs {bad} differ from the seeded golden file")
        print(f"hidden {Hw}: the heterogeneous batch ran {ran} ptr_step launches and its "
              f"{len(hetero_graphs)} schedules equal the CPU plain path", flush=True)
    t0 = time.perf_counter()
    h384 = RespectScheduler.init(seed=0, hidden=384)
    few = synth[:16]
    before = dict(ops.LAUNCHES)
    got = h384.schedule_many(few, STAGES, use_cache=False)
    torch.cuda.synchronize()
    ran = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES if ops.LAUNCHES[k] != before[k]}
    check(ran == {"ptr_decode_block": 1}, f"hidden 384, uniform: launches {ran}, expected one "
          "ptr_decode_block")
    want = RespectScheduler.init(seed=0, hidden=384, device="cpu").schedule_many(
        few, STAGES, use_cache=False)
    bad = [i for i, (r, rc) in enumerate(zip(got, want))
           if not (np.array_equal(r["order"], rc["order"])
                   and np.array_equal(r["assignment"], rc["assignment"]))]
    check(not bad, f"hidden 384, uniform: graphs {bad} differ from the CPU plain path")
    print(f"hidden 384: the uniform batch of {len(few)} synthetic graphs ran {ran} (B1, not "
          f"the scan) and its schedules equal the CPU plain path ({time.perf_counter() - t0:.1f} "
          "s)", flush=True)
    del h384

    # ---- the decode_bf16 path (its own counted run) ------------------- #
    bf16_launches, bf16_runs, bf16_sec = bf16_path(card, table1, names, synth)

    # ---- the seeded and sampled path (its own counted run) ------------ #
    seeded_phase(card, sched, {256: wide, 96: widths[96]}, table1, names, synth,
                 hetero_graphs, hsys)

    # ---- the serving front end (its own counted runs) ----------------- #
    service_phase(card, golden, names, table1, synth, hetero_graphs, hsys, res, res_h, cpu)

    # ---- the RL training engine (its own counted run) ----------------- #
    train_phase(card)

    # ---- the gap-to-optimal eval and the release trainer (counted) ----- #
    eval_phase(card, table1, synth)

    # ---- kernels against their plain versions, at the path's shapes --- #
    net = sched.net
    by_bucket = bucketize(table1)
    big = [table1[i] for i in by_bucket[1024]][-4:]
    kernels = []
    gen = torch.Generator(device="cuda").manual_seed(0)

    def encoded(graphs, dnet=net):
        batch = pack_padded(graphs, max_deg=D).to("cuda")
        with torch.inference_mode():
            C, (h0, c0), emb = dnet.encode(batch.feats, batch.n_valid)
        return batch, C, h0, c0, emb

    def decode_case(label, dnet, graphs, template):
        """Holds B1's float32 ``template`` and its bf16 storage twin to their
        plain versions on the card (greedy and sampled, orders equal,
        logp/entropy within TOL_LOGP), checks that each call ran its own
        template, and times both: their device times in turns in one window
        (float32, bf16, bf16, float32), each plain version by its greedy
        check's own call.  Returns the two rows, float32 first."""
        batch, C, h0, c0, emb = encoded(graphs, dnet)
        B, n, Hd = batch.n_valid.shape[0], batch.bucket_n, dnet.hidden
        args = (dnet, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
        unif = torch.rand((B, n), generator=gen, device="cuda")
        valid = torch.arange(n, device="cuda")[None, :] < batch.n_valid[:, None].long()
        names = {False: template, True: BF16_TWIN[template]}
        checked = {}
        for bf16, name in names.items():
            before = dict(ops.LAUNCHES)
            plain_ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            with torch.inference_mode():
                k_out = decode_batch(*args, bf16=bf16)
                plain_ev[0].record()
                p_out = decode_batch_reference(*args, bf16=bf16)
                plain_ev[1].record()
                k_smp = decode_batch(*args, unif, bf16=bf16)
                p_smp = decode_batch_reference(*args, unif, bf16=bf16)
            torch.cuda.synchronize()
            ran = {t: ops.LAUNCHES[t] - before[t] for t in TEMPLATES.values()}
            check(ran == {t: 2 * (t == name) for t in ran},
                  f"ptr_decode {label} H={Hd}: launched {ran}, expected two {name}")
            err = 0.0
            for what, (ko, kl, ke), (po, pl_, pe) in (("greedy", k_out, p_out),
                                                      ("sampled", k_smp, p_smp)):
                check(torch.equal(torch.where(valid, ko, -1), torch.where(valid, po, -1)),
                      f"ptr_decode {label} H={Hd} {name} {what}: orders differ from the plain "
                      "version")
                e = max(float((kl - pl_).abs().max()), float((ke - pe).abs().max()))
                check(e <= TOL_LOGP,
                      f"ptr_decode {label} H={Hd} {name} {what}: logp/entropy error {e:.3e}")
                err = max(err, e)
            checked[name] = (k_out[0].cpu().numpy(), err, plain_ev[0].elapsed_time(plain_ev[1]))
        with torch.inference_mode():
            refs_ms = cuda_ms(lambda: ops.precompute_refs(dnet, C), iters=20)
            calls = {name: functools.partial(decode_batch, *args, bf16=bf16)
                     for bf16, name in names.items()}
            ev_ms = {name: cuda_ms(fn, iters=5) for name, fn in calls.items()}
            # each turn runs only its own template, by exact name
            turns = turns_ms(calls, (template, names[True], names[True], template), iters=5)
        dev_ms = {name: statistics.mean(xs) for name, xs in turns.items()}
        rows = []
        for bf16, name in names.items():
            order, err, plain_ms = checked[name]
            b_ms, b_by = bound(*decode_work(graphs, order, n, Hd, D, itemsize=2 if bf16 else 4))
            print(f"ptr_decode {label} H={Hd} ({name}) on {card}: kernel {ev_ms[name]:.4f} ms "
                  f"(CUDA events; device {dev_ms[name]:.4f} ms; the wrapper's two C @ W_ref "
                  f"products alone {refs_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}), orders equal greedy and sampled, max |err| "
                  f"logp/ent {err:.2e} (tolerance {TOL_LOGP})", flush=True)
            rows.append({"name": name, "route": "cuda",
                         "source": "src/repro_torch/kernels/ptr/csrc/ptr_decode.cu",
                         "replaces": "src/repro/kernels/ptr/decode.py:84",
                         "launches": (bf16_launches if bf16 else launches)[name],
                         "max_abs_err": err, "ms": reported_ms(ev_ms[name], dev_ms[name]),
                         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": None})
        print(f"ptr_decode {label} H={Hd} device time in turns on {card}: "
              + ", ".join(f"{nm} {' '.join(f'{x:.4f}' for x in xs)} ms"
                          for nm, xs in turns.items())
              + f" (bf16 / float32 {dev_ms[names[True]] / dev_ms[template]:.3f})", flush=True)
        return rows

    # the release's width: the cluster templates at both buckets; then
    # RespectScheduler.init's default width, 256: the block templates at
    # bucket 32, B = 64, the wide ones at bucket 1024, B = 2
    t0 = time.perf_counter()
    kernels += decode_case("bucket 1024, B=4", net, big, "ptr_decode_cluster")
    decode_case("bucket 32, B=64", net, synth, "ptr_decode_cluster")
    kernels += decode_case("bucket 32, B=64", wide.net, synth, "ptr_decode_block")
    kernels += decode_case("bucket 1024, B=2", wide.net, big[-2:], "ptr_decode_wide_f32")
    bf16_sec += time.perf_counter() - t0

    # single step at bucket 1024, B=4, a seeded half-dense mask: the release's
    # width, then the same graphs and mask at hidden 96 and 640
    packed = pack_padded(big, max_deg=D)
    B, n = packed.batch, packed.bucket_n
    valid = torch.arange(n, device="cuda")[None, :] < packed.n_valid.to("cuda")[:, None].long()
    mask = (torch.rand((B, n), generator=gen, device="cuda") < 0.5) & valid

    def half_dense(dnet):
        """Holds B2 to its plain version at the half-dense mask and times
        both; returns (max |err|, ms, plain ms, bound ms, bound by)."""
        _, C, h0, _, _ = encoded(big, dnet)
        Hd = dnet.hidden
        with torch.inference_mode():
            CWg, CWp = ops.precompute_refs(dnet, C)
            g, p = dnet.glimpse, dnet.pointer
            step_args = (C, CWg, CWp, h0, g.w_q, g.v, p.w_q, p.v, mask)
            same, err, rel = compare_logits(pointer_step_cuda(*step_args),
                                            reference_pointer_step(*step_args), mask)
            check(same and rel <= TOL_LOGITS, f"ptr_step bucket 1024, B=4, H={Hd}: masked logits "
                  f"equal: {same}; logits error {err:.3e}, relative {rel:.3e}")
            ev_ms = cuda_ms(lambda: pointer_step_cuda(*step_args), iters=50, warmup=3)
            dev_ms = device_ms(lambda: pointer_step_cuda(*step_args), "ptr_step", iters=50)
            plain_ms = cuda_ms(lambda: reference_pointer_step(*step_args), iters=50, warmup=3)
        b_ms, b_by = bound(*step_work(mask, Hd))
        print(f"ptr_step bucket 1024, B=4, {int(mask.sum())} selectable rows, H={Hd}, clusters of "
              f"{step_cluster_size(n)} blocks on {card}: kernel {ev_ms:.4f} ms (CUDA events around "
              f"50 calls, the host's enqueue included), device {dev_ms:.5f} ms (profiler), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), max |err| {err:.2e}, relative "
              f"{rel:.2e} (tolerance {TOL_LOGITS}), masked logits equal", flush=True)
        return err, reported_ms(ev_ms, dev_ms), plain_ms, b_ms, b_by

    err, ms, plain_ms, b_ms, b_by = half_dense(net)
    step_row = {
        "name": "ptr_step", "route": "cuda",
        "source": "src/repro_torch/kernels/ptr/csrc/ptr_step.cu",
        "replaces": "src/repro/kernels/ptr/kernel.py:42",
        "launches": launches["ptr_step"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    kernels.append(step_row)
    for Hw in (96, 640):
        half_dense(widths[Hw].net)
    del widths

    # ---- end to end: cold-miss rate and where a Table-I batch's time goes #
    def rate(graphs, system=None):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            sched.schedule_many(graphs, STAGES, system, use_cache=False)
            times.append(time.perf_counter() - t0)
        return len(graphs) / statistics.median(times), statistics.median(times)

    for label, graphs, system in (("Table-I (10 graphs)", table1, None),
                                  ("synthetic n=30 (64 graphs)", synth, None),
                                  ("heterogeneous (18 graphs)", hetero_graphs, hsys)):
        gps, sec = rate(graphs, system)
        print(f"cold-miss {label} on {card}: {gps:.2f} graphs/s ({sec:.4f} s a batch, "
              "median of 3)", flush=True)

    split = {"pack": 0.0, "encode": 0.0, "decode": 0.0, "rho": 0.0, "repair": 0.0}
    usys = PipelineSystem(STAGES)
    for bucket_n, idxs in bucketize(table1).items():
        gs = [table1[i] for i in idxs]

        def timed(key, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return out

        with torch.inference_mode():
            batch = timed("pack", lambda: pack_padded(gs, bucket_n, D).to("cuda"))
            C, (h0, c0), emb = timed("encode", lambda: net.encode(batch.feats, batch.n_valid))
            order = timed("decode", lambda: decode_batch(net, C, emb, h0, c0, batch.parent_mat,
                                                         batch.n_valid)[0])
            assign = timed("rho", lambda: rho_dp(order, batch.flops, batch.param_bytes,
                                                 batch.out_bytes, batch.parent_mat, STAGES,
                                                 usys, batch.n_valid).cpu().numpy())
            timed("repair", lambda: [repair(g, assign[r, : g.n], STAGES)
                                     for r, g in enumerate(gs)])
    total = sum(split.values())
    print(f"time split, Table-I batch on {card} (host clock, synchronized): "
          + ", ".join(f"{k} {v * 1e3:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items()),
          flush=True)
    del net, wide
    kernels += clocked("zoo", zoo_phase, card)

    # ---- whisper-tiny and xlstm-350m served; ingest, schedule_model ---- #
    kernels += clocked("served_models", served_models_phase, card)
    # ---- the rest of the zoo served (B3); the partitioner (B1) ---------- #
    kernels += clocked("zoo_archs", zoo_archs_phase, card)
    clocked("ingest", ingest_phase, card)
    kernels += clocked("partitioner", partitioner_phase, card)

    # ---- the heterogeneous batch: B2 at the path's own masks, time split  #
    # after the zoo, with the other profiles of whole batches (see below)
    net = sched.net
    recs = record_scan(net, hetero_graphs, hsys, D)
    check(sum(len(rec["steps"]) for rec in recs) == hetero_steps,
          f"recorded {[len(rec['steps']) for rec in recs]} steps, expected {hetero_steps}")
    dev_total = bound_total = 0.0
    for rec in recs:
        bn = rec["bucket_n"]
        with torch.inference_mode():
            got = replay(net, rec, pointer_step_cuda)
            want = replay(net, rec, reference_pointer_step)
        torch.cuda.synchronize()
        err = rel = 0.0
        for t, ((_, m_t), k_log, p_log) in enumerate(zip(rec["steps"], got, want)):
            same, e, rl = compare_logits(k_log, p_log, m_t)
            check(same and rl <= TOL_LOGITS, f"ptr_step heterogeneous bucket {bn}, step {t}: "
                  f"masked logits equal: {same}; logits error {e:.3e}, relative {rl:.3e}")
            err, rel = max(err, e), max(rel, rl)
        step_row["max_abs_err"] = max(step_row["max_abs_err"], err)
        dev = replay_device_ms(net, rec, pointer_step_cuda, "ptr_step")
        with torch.inference_mode():
            plain_ms = cuda_ms(lambda: replay(net, rec, reference_pointer_step), iters=1)
        b_ms, b_by = steps_bound(net, rec)
        dev_total, bound_total = dev_total + sum(dev), bound_total + b_ms
        sizes = [int(m_t.sum()) for _, m_t in rec["steps"]]
        print(f"ptr_step heterogeneous batch, bucket {bn} (B={rec['B']}, {len(dev)} launches, "
              f"clusters of {step_cluster_size(bn)} blocks; selectable rows a launch "
              f"{min(sizes)}-{max(sizes)}, median {statistics.median(sizes)}) on {card}: device "
              f"{sum(dev):.4f} ms a batch, {statistics.median(dev):.5f} ms a launch (median), "
              f"plain {plain_ms:.3f} ms a batch, bound {b_ms:.5f} ms a batch ({b_by}); every step "
              f"held to the plain version: masked logits equal, max |err| {err:.2e}, relative "
              f"{rel:.2e} (tolerance {TOL_LOGITS})", flush=True)
    print(f"ptr_step heterogeneous batch on {card}: {hetero_steps} launches, device "
          f"{dev_total:.4f} ms, bound {bound_total:.5f} ms", flush=True)
    res = scan_split(net, hetero_graphs, hsys, D, ops.make_logits_fn, "ptr_step", hetero_steps)
    print(split_line(f"heterogeneous batch ({len(hetero_graphs)} graphs, scan + B2)", card, res),
          flush=True)
    check(res["step_names"] == ["ptr_step_cluster"],
          f"heterogeneous scan ran single-step kernels {res['step_names']}, expected only "
          "ptr_step_cluster")

    # ---- which B1 template the respect-v1 path ran, by kernel name ----- #
    # last: after a profile of a whole batch (the encoder's thousands of
    # launches), the zoo's timing windows lost their first kernels
    before = dict(ops.LAUNCHES)
    names_run = kernel_names(lambda: sched.schedule_many(table1 + synth, STAGES, use_cache=False))
    counted = {t: ops.LAUNCHES[t] - before[t] for t in TEMPLATES.values()}
    ran = {t: names_run.count(t) for t in TEMPLATES.values()}
    print(f"respect-v1 path, {n_buckets} buckets: B1 kernels by profiler name {ran}, "
          f"counted {counted}", flush=True)
    check(ran == counted == {t: n_buckets * (t == "ptr_decode_cluster")
                             for t in TEMPLATES.values()},
          f"respect-v1 path ran B1 templates {ran} (counted {counted}), expected only "
          f"{n_buckets} ptr_decode_cluster")
    del sched
    bf16_sec += bf16_names(card, bf16_runs)
    del bf16_runs
    print(f"decode_bf16 phase: {bf16_sec:.1f} s (its counted path, three kernel cases of both "
          "storage types, the profiler's names)", flush=True)

    # ---- last: the LM zoo's training path, whisper-tiny and xlstm-350m;
    # after its runs and profiles the profiler's windows lose kernels,
    # which the B2 replays above count exactly ----------------------------- #
    kernels += clocked("lm_train", lm_train_phase, card)
    clocked("lm_train_split", lm_train_split_phase, card)

    # ---- data and pipeline parallelism: the data-parallel step on two
    # gloo ranks, the compressed all-reduce, the train_respect twin, the
    # qwen3-14b pipeline (B1's cut, B3 a block) ---------------------------- #
    clocked("data_parallel", data_parallel_phase, card)
    kernels += clocked("pipeline", pipeline_phase, card)

    # ---- the zoo's other archs train (B3 under autograd); last, as the
    # largest models of the run's training paths -------------------------- #
    kernels += clocked("zoo_train", zoo_train_phase, card)
    clocked("remat", remat_phase, card)

    # ---- the example scripts' twins (B1), then the sharded step makers
    # on a one-device mesh (B3); the dry run's process works on the host
    # beside them ----------------------------------------------------------- #
    dry += start_dryrun()
    kernels += clocked("examples", examples_phase, card)
    kernels += clocked("sharding", sharding_phase, card)

    # ---- the multi-pod dry run's golden cells and its one-card check ----- #
    clocked("dryrun", dryrun_phase, card, dry)

    # ---- sharded execution on real ranks: four ranks, (2, 2) and (1, 4) -- #
    kernels += clocked("sharded_exec", sharded_exec_phase, card)
    return {"kernels": kernels, "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "card": card}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not ((ROOT / "src" / "repro_torch").is_dir() and GOLDEN.exists()
            and SEEDED_GOLDEN.exists() and TRAIN_GOLDEN.exists() and EVAL_BENCH.exists()
            and INGEST_BENCH.exists() and INGEST_HASHES.exists() and INGEST_ZOO_HASHES.exists()
            and LM_TRAIN_GOLDEN.exists() and PARTITIONS.exists() and EDGE_DEPLOY.exists()):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        out = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s (B4's template "
          f"name checks' profiled windows {SSD_NAME_CHECK_S[0]:.1f} s of it; the zoo's and later "
          f"phases' seconds {PHASE_S})", flush=True)
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": out["device"],
                                             "count": out["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
